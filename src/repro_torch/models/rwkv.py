"""RWKV-6 (Finch) block (counterpart of ``repro/models/rwkv.py``): the
time-mix (WKV6) and channel-mix sub-blocks of arXiv:2404.05892.

The WKV state per head is an (N, N) matrix,

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t a data-dependent per-channel decay from a low-rank MLP, and
token-shift interpolation (ddlerp) mixing each input with its
predecessor.  Without a cache (training) the recurrence runs from the
zero state through ``ops.wkv`` (the hand-written wkv6 kernels and their
backward on the card).  With a cache (serving: prefill and decode) the
token shift starts from the cached last token and the recurrence from the
cached state, through ``ops.wkv_state`` (the ``wkv6_state`` kernel on the
card, which also returns the final state); the reference runs the same
segment as a ``lax.scan`` of its ``_wkv_step``.  The cache is fixed-size
per sequence, whatever its length.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.quant import maybe_dequant

Params = Dict[str, Any]

_MIX_NAMES = ("w", "k", "v", "r", "g")

@dataclasses.dataclass(frozen=True)
class RwkvConfig:
    head_size: int = 64
    lora_mix: int = 32      # ddlerp low-rank size
    lora_decay: int = 64    # decay-lora low-rank size


def init_time_mix(gen: torch.Generator, d: int, cfg: RwkvConfig,
                  dtype=torch.float32,
                  device: Union[str, torch.device] = "cpu") -> Params:
    """The reference's distributions (``repro/models/rwkv.py:42-63``)."""
    h = d // cfg.head_size

    def normal(shape, scale):
        return L._normal(gen, shape, dtype, device) * scale

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "mu_x": full((d,), 0.5),
        "mu": full((5, d), 0.5),
        "lora_a": normal((d, 5 * cfg.lora_mix), d ** -0.5),
        "lora_b": normal((5, cfg.lora_mix, d), cfg.lora_mix ** -0.5 * 0.1),
        "w0": full((d,), -6.0),   # exp(-exp(-6)) ~ slow decay
        "w_lora_a": normal((d, cfg.lora_decay), d ** -0.5),
        "w_lora_b": normal((cfg.lora_decay, d), cfg.lora_decay ** -0.5 * 0.1),
        "u": normal((h, cfg.head_size), 0.1),
        "wr": L.dense_init(gen, d, d, dtype, device),
        "wk": L.dense_init(gen, d, d, dtype, device),
        "wv": L.dense_init(gen, d, d, dtype, device),
        "wg": L.dense_init(gen, d, d, dtype, device),
        "wo": L.dense_init(gen, d, d, dtype, device),
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
    }


def init_channel_mix(gen: torch.Generator, d: int, d_ff: int,
                     dtype=torch.float32,
                     device: Union[str, torch.device] = "cpu") -> Params:
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": L.dense_init(gen, d, d_ff, dtype, device),
        "wv": L.dense_init(gen, d_ff, d, dtype, device),
        "wr": L.dense_init(gen, d, d, dtype, device),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1}; at t = 0 the cached last token ``prev`` (B,
    d), or zeros without a cache."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor,
            xx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Data-dependent lerp producing the five mixed inputs (w,k,v,r,g)."""
    x_base = x + xx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(L.gemm(x_base, maybe_dequant(p["lora_a"], x.dtype)))
    b, s, _ = x.shape
    lora = lora.reshape(b, s, 5, -1)
    lora_b = maybe_dequant(p["lora_b"], x.dtype)
    out = {}
    for i, name in enumerate(_MIX_NAMES):
        mix = p["mu"][i].to(x.dtype) + L.gemm(lora[:, :, i], lora_b[i])
        out[name] = x + xx * mix
    return out


def time_mix(p: Params, x: torch.Tensor, cfg: RwkvConfig,
             cache: Optional[Params] = None
             ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, d) -> (out (B, S, d), new cache), with ``cache`` =
    {"shift_tm", "shift_cm": (B, d), "wkv": (B, H, N, N) f32} or None
    (training: from the zero state, and the new cache is None)."""
    b, s, d = x.shape
    n = cfg.head_size
    h = d // n
    xx = _shift(x, None if cache is None else cache["shift_tm"]) - x
    mixed = _ddlerp(p, x, xx)

    r = L.dense(p["wr"], mixed["r"]).reshape(b, s, h, n)
    k = L.dense(p["wk"], mixed["k"]).reshape(b, s, h, n)
    v = L.dense(p["wv"], mixed["v"]).reshape(b, s, h, n)
    g = F.silu(L.dense(p["wg"], mixed["g"]))
    w_lora = L.gemm(torch.tanh(L.gemm(mixed["w"],
                                      maybe_dequant(p["w_lora_a"],
                                                    x.dtype))),
                    maybe_dequant(p["w_lora_b"], x.dtype))
    # The decay stays in f32: (B, S, d) in (0, 1).
    w = torch.exp(-torch.exp(p["w0"].float() + w_lora.float()))
    w = w.reshape(b, s, h, n)

    bhsn = lambda z: z.transpose(1, 2)  # noqa: E731
    u = p["u"].float()
    new_cache = None
    if cache is None:
        y = ops.wkv(bhsn(r), bhsn(k), bhsn(v), bhsn(w), u)
    else:
        y, s_final = ops.wkv_state(bhsn(r), bhsn(k), bhsn(v), bhsn(w), u,
                                   cache["wkv"])
        new_cache = dict(cache, shift_tm=x[:, -1], wkv=s_final)
    y = y.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    y = L.groupnorm(y, h, p["gn_scale"], p["gn_bias"], eps=64e-5)
    return L.dense(p["wo"], y * g), new_cache


def channel_mix(p: Params, x: torch.Tensor,
                cache: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    xx = _shift(x, None if cache is None else cache["shift_cm"]) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(L.dense(p["wk"], xk)))
    v = L.dense(p["wv"], k)
    r = torch.sigmoid(L.dense(p["wr"], xr))
    new_cache = None if cache is None else dict(cache, shift_cm=x[:, -1])
    return r * v, new_cache


def init_rwkv_cache(batch: int, d_model: int, cfg: RwkvConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Union[str, torch.device] = "cpu") -> Params:
    """A zero state: both token shifts (B, d) in ``dtype`` (the cache
    dtype), the WKV state (B, H, N, N) in f32."""
    h = d_model // cfg.head_size
    return {
        "shift_tm": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, cfg.head_size, cfg.head_size),
                           dtype=torch.float32, device=device),
    }
