"""Mixture-of-Experts FFN: top-k routing, capacity, dispatch and combine
(counterpart of ``repro/models/moe.py``).

Capacity-based top-k routing (GShard/Switch style): each (token, k)
assignment takes the next place in its expert's buffer of ``capacity``
slots, in token-major order over the batch (or over each of
``dispatch_groups`` groups), and an assignment past capacity is dropped
(it falls through the residual, as in GShard).  So a token's routing
depends on its batch-mates, exactly as the reference's does.  Supports
top-1 (Llama-4 Maverick) to top-8 (Kimi-K2), a shared expert (through
``layers.mlp``, so the GAMA GEMM) and the Switch load-balancing loss.

The expert SwiGLU is three batched products over the (G, E, C, d) expert
buffers, as the reference's einsums (outside its Pallas GEMM).  Dispatch
writes each kept token into its own slot (no two kept assignments share
one; dropped ones go to a spare slot that is cut off), and combine sums a
token's k contributions in a fixed order with no atomics: ``"scatter"``
in expert order (the order of the reference's scatter-add over its (E, C)
slots), ``"gather"`` in routing order in f32 (the reference's einsum).
Nothing syncs with the host.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig
from repro_torch.models.quant import maybe_dequant

Params = Dict[str, Any]

__all__ = ["MoEConfig", "Routing", "capacity", "init_moe", "moe_ffn",
           "route"]


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32,
             device: Union[str, torch.device] = "cpu") -> Params:
    """The reference's distributions (``repro/models/moe.py:52-66``): an
    f32 router, (E, d, f) gate/up and (E, f, d) down experts, and the
    shared expert's SwiGLU."""
    e, f = cfg.num_experts, cfg.d_ff

    def normal(shape, scale):
        return L._normal(gen, shape, dtype, device).mul_(scale)

    p = {
        "router": L.dense_init(gen, d_model, e, torch.float32, device),
        "gate": normal((e, d_model, f), d_model ** -0.5),
        "up": normal((e, d_model, f), d_model ** -0.5),
        "down": normal((e, f, d_model), f ** -0.5),
    }
    if cfg.n_shared:
        shared_ff = cfg.shared_d_ff or cfg.d_ff * cfg.n_shared
        p["shared"] = L.mlp_init(gen, d_model, shared_ff, "swiglu", dtype,
                                 device)
    return p


def capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts)
    return max(cfg.min_capacity, c)


class Routing(NamedTuple):
    probs: torch.Tensor      # (G, Tg, E) f32 router softmax
    gates: torch.Tensor      # (G, Tg, k) f32, renormalised over the k
    idx: torch.Tensor        # (G, Tg, k) int64 expert ids, best first
    pos: torch.Tensor        # (G, Tg, k) int64 place in the expert buffer
    keep: torch.Tensor       # (G, Tg, k) bool, pos < capacity
    cap: int


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    by the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, xg: torch.Tensor, cfg: MoEConfig) -> Routing:
    """Route the tokens of xg (G, Tg, d): the f32 router, top-k with
    renormalised gates, and each assignment's place in its expert's
    buffer, a cumsum over the group's (token, k) assignments in
    token-major order; places at or past capacity are dropped."""
    groups, tg, _ = xg.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(tg, cfg)
    logits = L.dense(p["router"], xg.float())                  # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(idx, e).reshape(groups, tg * k, e)        # token-major
    pos = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(-1).reshape(
        groups, tg, k)
    return Routing(probs, gates, idx, pos, pos < cap, cap)


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig, *,
            with_aux: bool = True) -> Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]:
    """x: (B, S, d) -> (out, aux_loss f32 scalar; None without
    ``with_aux``: serving discards it, as the reference's jitted decode
    does)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    groups = (cfg.dispatch_groups
              if t % max(cfg.dispatch_groups, 1) == 0 else 1)
    tg = t // groups
    xt = x.reshape(t, d)
    xg = xt.reshape(groups, tg, d)
    r = route(p, xg, cfg)
    cap = r.cap

    # Dispatch: each kept assignment writes its token into its own slot of
    # the (G, E, C + 1, d) buffers; dropped ones all land in the spare slot
    # C, which is cut off.
    slot = torch.where(r.keep, r.pos, torch.full_like(r.pos, cap))
    gidx = torch.arange(groups, device=x.device)[:, None, None].expand_as(
        r.idx)
    buf = x.new_zeros((groups, e, cap + 1, d))
    buf[gidx, r.idx, slot] = xg[:, :, None, :].expand(groups, tg, k, d)
    expert_in = buf[:, :, :cap]

    g = torch.einsum("gecd,edf->gecf", expert_in,
                     maybe_dequant(p["gate"], x.dtype))
    u = torch.einsum("gecd,edf->gecf", expert_in,
                     maybe_dequant(p["up"], x.dtype))
    h = F.silu(g) * u
    del g, u
    expert_out = torch.einsum("gecf,efd->gecd", h,
                              maybe_dequant(p["down"], x.dtype))

    weights = (r.gates * r.keep).to(x.dtype)                    # (G, Tg, k)
    safe = torch.clamp(r.pos, max=cap - 1)
    out_slots = expert_out[gidx, r.idx, safe]                   # (G,Tg,k,d)
    if cfg.combine == "gather":
        # The reference's einsum over k: products and sum in f32, rounded
        # once.
        prod = out_slots.float() * weights.float()[..., None]
        acc = prod[:, :, 0]
        for j in range(1, k):
            acc = acc + prod[:, :, j]
        out = acc.to(x.dtype)
    else:
        # The reference's scatter-add of each slot's weighted output into
        # its token: a token's kept contributions in expert order, each
        # product and each sum rounded to x's dtype (a dropped one adds a
        # zero, whatever the slot it points at holds).
        contrib = torch.where(r.keep[..., None],
                              out_slots * weights[..., None], 0.0)
        order = torch.argsort(r.idx, dim=-1)
        contrib = torch.gather(contrib, 2, order[..., None].expand_as(contrib))
        out = contrib[:, :, 0]
        for j in range(1, k):
            out = out + contrib[:, :, j]
    out = out.reshape(t, d)
    if cfg.n_shared:
        out = out + L.mlp(p["shared"], xt, "swiglu")

    aux = None
    if with_aux:
        # Load-balance auxiliary loss (Switch): E * sum(frac_tokens *
        # frac_prob), over the top-1 choices.
        me = F.one_hot(r.idx[..., 0], e).float().mean(dim=(0, 1))
        pe = r.probs.mean(dim=(0, 1))
        aux = cfg.aux_loss_weight * e * torch.sum(me * pe)
    return out.reshape(b, s, d), aux
