"""Block stacks (counterpart of ``repro/models/transformer.py``) for the
ported blocks: attention or Mamba mixers with a dense or MoE FFN
(RMSNorm; Jamba interleaves all four), the RWKV-6 ``("rwkv",
"rwkv_cm")`` block (LayerNorm), and the enc-dec decoder block (an
``("attn", "dense")`` block with cross attention between the mixer and the
FFN; the encoder runs ``("attn", "dense")`` blocks, not causally).

The reference stacks each pattern position's parameters over ``n_groups``
and runs them with ``lax.scan``; here a stack is a plain list with one
entry per layer, run by a Python loop.  Caches are per-layer lists too,
each layer's from its own block spec.  Training's rematerialisation wraps
layers or sub-blocks in ``torch.utils.checkpoint``.

Outside remat, every residual add goes with the norm that follows it
(:func:`add_norm`): the mixer's add with ``ln2`` (or ``ln_cross``), the
cross attention's with ``ln2``, the FFN's with the next layer's ``ln1`` or
the final norm.  For an rmsnorm model that is one ``ops.add_rmsnorm``,
which on the card is one launch of the rmsnorm kernel when no gradient
runs through it (serving) and the eager add and the norm otherwise.  The
reference's jitted step leaves that fusion to XLA; the sums and the norms
keep the unfused route's bits.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models.config import BlockSpec, MambaConfig, ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, Any]

# (mixer, ffn) -> the norm the ported block runs with.
_BLOCKS = {("attn", "dense"): "rmsnorm", ("attn", "moe"): "rmsnorm",
           ("mamba", "dense"): "rmsnorm", ("mamba", "moe"): "rmsnorm",
           ("rwkv", "rwkv_cm"): "layernorm"}
REMAT_POLICIES = ("full", "dots", "tp_outs")

# The matrix products the ``dots`` policy keeps: what ``torch.matmul``,
# ``einsum`` and ``x @ w`` reach at the dispatcher.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    """``jax.checkpoint_policies.checkpoint_dots``: every matrix product's
    output is kept, everything else is recomputed in the backward.  The
    hand-written kernels (launched through ctypes, unseen by the dispatcher)
    are recomputed; they are deterministic, so the recomputation gives the
    forward's bits."""
    return create_selective_checkpoint_contexts(_dots_policy)


def check_block(cfg: ModelConfig, spec: BlockSpec) -> None:
    if _BLOCKS.get((spec.mixer, spec.ffn)) != cfg.norm or (
            cfg.encoder_decoder and spec.mixer != "attn"):
        raise NotImplementedError(
            f"{cfg.name}: block {spec} (norm={cfg.norm}, encoder_decoder="
            f"{cfg.encoder_decoder}) is not ported; the ported blocks are "
            f"{sorted(_BLOCKS)} with the norms "
            f"{sorted(set(_BLOCKS.values()))}, an enc-dec decoder's with an "
            f"attention mixer")


def _mamba_cfg(cfg: ModelConfig) -> MambaConfig:
    return cfg.mamba or MambaConfig()


def init_norm(cfg: ModelConfig, device) -> Params:
    if cfg.norm == "layernorm":
        return L.layernorm_init(cfg.d_model, cfg.pdtype, device)
    return L.norm_init(cfg.d_model, cfg.pdtype, device)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return L.layernorm(p, x, cfg.norm_eps)
    return L.rmsnorm(p, x, cfg.norm_eps)


def add_norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
             r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A residual add and the norm ``p`` after it: (s = x + r, norm(s)).
    An rmsnorm model's is ``ops.add_rmsnorm`` (one kernel launch on the
    card unless a gradient runs through it), a layernorm model's the
    eager add and :func:`apply_norm`."""
    if cfg.norm == "rmsnorm":
        return L.add_rmsnorm(p, x, r, cfg.norm_eps)
    s = x + r
    return s, apply_norm(cfg, p, s)


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               device: Union[str, torch.device] = "cpu") -> Params:
    """One layer's parameters, drawn mixer first, then (an enc-dec
    decoder's) the cross attention, then the FFN."""
    check_block(cfg, spec)
    p: Params = {"ln1": init_norm(cfg, device)}
    if spec.mixer == "rwkv":
        p["rwkv_tm"] = R.init_time_mix(gen, cfg.d_model,
                                       cfg.rwkv or R.RwkvConfig(),
                                       cfg.pdtype, device)
    elif spec.mixer == "mamba":
        p["mamba"] = M.init_mamba(gen, cfg.d_model, _mamba_cfg(cfg),
                                  cfg.pdtype, device)
    else:
        p["attn"] = A.init_attention(gen, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.d_head, cfg.qk_norm,
                                     cfg.pdtype, device)
    if cfg.encoder_decoder:
        p["ln_cross"] = init_norm(cfg, device)
        p["cross_attn"] = A.init_attention(gen, cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.d_head,
                                           cfg.qk_norm, cfg.pdtype, device)
    p["ln2"] = init_norm(cfg, device)
    if spec.ffn == "rwkv_cm":
        p["rwkv_cm"] = R.init_channel_mix(gen, cfg.d_model, cfg.d_ff,
                                          cfg.pdtype, device)
    elif spec.ffn == "moe":
        p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.moe, cfg.pdtype, device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                              cfg.pdtype, device)
    return p


def _mixer(p: Params, h: torch.Tensor, cfg: ModelConfig, spec: BlockSpec, *,
           positions, cache, cache_pos, block_tables) -> torch.Tensor:
    if spec.mixer == "rwkv":
        out, state = R.time_mix(p["rwkv_tm"], h, cfg.rwkv or R.RwkvConfig(),
                                None if cache is None else cache["rwkv"])
        if cache is not None:
            cache["rwkv"] = state
        return out
    if spec.mixer == "mamba":
        out, state = M.mamba_forward(p["mamba"], h, _mamba_cfg(cfg),
                                     None if cache is None else cache["mamba"])
        if cache is not None:
            cache["mamba"] = state
        return out
    out, _ = A.attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, positions=positions, rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections, qk_norm=cfg.qk_norm,
        causal=cfg.causal, cache=None if cache is None else cache["attn"],
        cache_pos=cache_pos, block_tables=block_tables)
    return out


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig, spec: BlockSpec,
         cache: Optional[Cache], with_aux: bool
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, the MoE aux loss or None)."""
    if spec.ffn == "rwkv_cm":
        out, state = R.channel_mix(p["rwkv_cm"], h,
                                   None if cache is None else cache["rwkv"])
        if cache is not None:
            cache["rwkv"] = state
        return out, None
    if spec.ffn == "moe":
        return MOE.moe_ffn(p["moe"], h, cfg.moe, with_aux=with_aux)
    return L.mlp(p["mlp"], h, cfg.ffn_kind), None


def _cross(p: Params, h: torch.Tensor, cfg: ModelConfig,
           cache: Optional[Cache], enc_out: Optional[torch.Tensor],
           decode: bool) -> torch.Tensor:
    """The enc-dec decoder block's cross attention: at prefill (or without
    a cache) over ``enc_out``'s projections, written into the ``"cross"``
    cache from row 0; at decode over the cross cache as it is."""
    out, _ = A.attention(
        p["cross_attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, positions=None, qk_norm=cfg.qk_norm, causal=False,
        cache=None if cache is None else cache["cross"],
        cache_pos=None if decode else 0,
        kv_from=None if decode else enc_out, use_cached_kv=decode)
    return out


def _layer(p: Params, x: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
           spec: BlockSpec, *, positions, cache, cache_pos, block_tables,
           enc_out, decode, with_aux
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One layer without remat from ``x`` and ``h = ln1(x)``: (the residual
    stream before the FFN's add, the FFN's output, aux), each add inside
    the layer taken with the norm after it (:func:`add_norm`)."""
    mixed = _mixer(p, h, cfg, spec, positions=positions, cache=cache,
                   cache_pos=cache_pos, block_tables=block_tables)
    cross = "cross_attn" in p
    x, h = add_norm(cfg, p["ln_cross" if cross else "ln2"], x, mixed)
    if cross:
        x, h = add_norm(cfg, p["ln2"], x,
                        _cross(p, h, cfg, cache, enc_out, decode))
    out, aux = _ffn(p, h, cfg, spec, cache, with_aux)
    return x, out, aux


def apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                spec: BlockSpec, *, positions: Optional[torch.Tensor],
                cache: Optional[Cache] = None,
                cache_pos: Union[int, torch.Tensor, None] = None,
                block_tables: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None, decode: bool = False,
                remat_sub_blocks: bool = False, with_aux: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache],
                           Optional[torch.Tensor]]:
    """Returns (x, cache updated in place, the MoE aux loss: None unless
    the block has an MoE FFN and ``with_aux``).  An enc-dec decoder block
    (``cross_attn`` in ``p``) runs its cross attention after the mixer:
    over ``enc_out`` (the encoder's states) at prefill, over its cross
    cache at ``decode``.  ``remat_sub_blocks`` wraps the mixer and the FFN
    (each with its norm) in a checkpoint of its own, so only their outputs
    are kept for the backward (the ``tp_outs`` policy)."""
    check_block(cfg, spec)
    if not remat_sub_blocks:
        x, out, aux = _layer(p, x, apply_norm(cfg, p["ln1"], x), cfg, spec,
                             positions=positions, cache=cache,
                             cache_pos=cache_pos, block_tables=block_tables,
                             enc_out=enc_out, decode=decode,
                             with_aux=with_aux)
        return x + out, cache, aux

    def mixer(x):
        return _mixer(p, apply_norm(cfg, p["ln1"], x), cfg, spec,
                      positions=positions, cache=cache, cache_pos=cache_pos,
                      block_tables=block_tables)

    def ffn(x):
        return _ffn(p, apply_norm(cfg, p["ln2"], x), cfg, spec, cache,
                    with_aux)

    def cross(x):
        return _cross(p, apply_norm(cfg, p["ln_cross"], x), cfg, cache,
                      enc_out, decode)

    x = x + checkpoint(mixer, x, use_reentrant=False)
    if "cross_attn" in p:
        x = x + checkpoint(cross, x, use_reentrant=False)
    out, aux = checkpoint(ffn, x, use_reentrant=False)
    return x + out, cache, aux


def layer_specs(cfg: ModelConfig) -> List[BlockSpec]:
    """The block spec of every layer, in order (pattern cycled)."""
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: Union[str, torch.device] = "cpu",
                     paged: Optional[Tuple] = None,
                     cross_len: int = 0) -> List[Cache]:
    """Per-layer caches, each from its layer's block spec.  An attention
    layer holds KV: dense (batch, Hkv, max_len, D), or with
    ``paged=(num_pages, page_size[, kv_dtype])`` page pools
    (``attention.init_paged_kv_cache``; ``batch`` and ``max_len`` are then
    ignored; the optional ``kv_dtype`` overrides the page dtype).  A Mamba
    layer holds ``{"mamba": mamba.init_mamba_cache(...)}`` (the conv window
    in the cache dtype, the SSM state in f32) and an RWKV layer
    ``{"rwkv": rwkv.init_rwkv_cache(...)}`` (shifts in the cache dtype, the
    WKV state in f32), whatever ``max_len``; a recurrent state has no
    paged form, so ``paged`` raises for an arch with one.  ``cross_len``
    > 0 gives each layer an enc-dec cross cache ``"cross"``, dense
    (batch, Hkv, cross_len, D) in the cache dtype, which has no paged
    form either."""
    specs = layer_specs(cfg)
    if paged is not None and any(s.mixer != "attn" for s in specs):
        raise ValueError(f"{cfg.name}: a recurrent state has no pages")
    if paged is not None and cross_len:
        raise ValueError(f"{cfg.name}: an enc-dec cross cache has no pages")
    caches: List[Cache] = []
    for spec in specs:
        if spec.mixer == "rwkv":
            caches.append({"rwkv": R.init_rwkv_cache(
                batch, cfg.d_model, cfg.rwkv or R.RwkvConfig(), cfg.kvdtype,
                device)})
        elif spec.mixer == "mamba":
            caches.append({"mamba": M.init_mamba_cache(
                batch, cfg.d_model, _mamba_cfg(cfg), cfg.kvdtype, device)})
        elif paged is not None:
            caches.append({"attn": A.init_paged_kv_cache(
                paged[0], cfg.n_kv_heads, paged[1], cfg.d_head, cfg.kvdtype,
                kv_dtype=paged[2] if len(paged) > 2 else None,
                device=device)})
        else:
            caches.append({"attn": A.init_kv_cache(
                batch, cfg.n_kv_heads, max_len, cfg.d_head, cfg.kvdtype,
                device)})
        if cross_len:
            caches[-1]["cross"] = A.init_kv_cache(
                batch, cfg.n_kv_heads, cross_len, cfg.d_head, cfg.kvdtype,
                device)
    return caches


def apply_stack(stack: List[Params], x: torch.Tensor, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor],
                caches: Optional[List[Cache]] = None,
                cache_pos: Union[int, torch.Tensor, None] = None,
                block_tables: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None, decode: bool = False,
                remat: bool = False, remat_policy: str = "full",
                with_aux: bool = False, final_norm: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[List[Cache]],
                           Optional[torch.Tensor]]:
    """Run every layer in order.  Returns (x, caches updated in place,
    aux): with ``with_aux`` the MoE layers' aux losses summed in layer
    order (an f32 zero without MoE layers), else None.  ``enc_out`` and
    ``decode`` are an enc-dec decoder's (:func:`apply_block`).  Given
    ``final_norm``, x is the last layer's output through that norm.

    ``remat`` (training) recomputes activations in the backward instead of
    keeping them: policy ``"full"`` checkpoints each layer (only its input
    is kept), ``"dots"`` each layer keeping every matrix product's output
    (the reference's ``checkpoint_dots``), ``"tp_outs"`` each sub-block
    (the mixer's and FFN's outputs are kept, as the reference's
    ``save_only_these_names("tp_out")``).  Without remat each layer's
    last add goes with the next layer's ``ln1`` or the final norm
    (:func:`add_norm`)."""
    if remat and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {remat_policy!r}")
    if remat and caches is not None:
        raise ValueError("remat is for training: it takes no caches")
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if with_aux else None)
    if not remat and stack:
        h = apply_norm(cfg, stack[0]["ln1"], x)
    for i, (p, spec) in enumerate(zip(stack, layer_specs(cfg))):
        kw = dict(positions=positions,
                  cache=None if caches is None else caches[i],
                  cache_pos=cache_pos, block_tables=block_tables,
                  enc_out=enc_out, decode=decode, with_aux=with_aux)
        if not remat:
            check_block(cfg, spec)
            x, out, a = _layer(p, x, h, cfg, spec, **kw)
            nxt = stack[i + 1]["ln1"] if i + 1 < len(stack) else final_norm
            if nxt is None:
                x = x + out
            else:
                x, h = add_norm(cfg, nxt, x, out)
        elif remat_policy in ("full", "dots"):
            x, a = checkpoint(lambda x, p=p, spec=spec, kw=kw: apply_block(
                p, x, cfg, spec, **kw)[::2], x, use_reentrant=False,
                context_fn=(_dots_contexts if remat_policy == "dots"
                            else noop_context_fn))
        else:
            x, _, a = apply_block(p, x, cfg, spec, remat_sub_blocks=True,
                                  **kw)
        if a is not None:
            aux = aux + a
    if final_norm is None:
        return x, caches, aux
    if remat or not stack:
        h = apply_norm(cfg, final_norm, x)
    return h, caches, aux
