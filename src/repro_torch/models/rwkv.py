"""RWKV-6 (Finch) block, cache-free (counterpart of
``repro/models/rwkv.py``): the time-mix (WKV6) and channel-mix sub-blocks
of arXiv:2404.05892, as training runs them.

The WKV state per head is an (N, N) matrix,

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t a data-dependent per-channel decay from a low-rank MLP, and
token-shift interpolation (ddlerp) mixing each input with its
predecessor.  Without a cache the recurrence runs from the zero state
through ``ops.wkv`` (the hand-written wkv6 kernels on the card).  The
cached prefill/decode branch, ``init_rwkv_cache`` and the serving engine's
recurrent bypass come with the RWKV serving slice (ROADMAP Queue A item
10) and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Dict[str, Any]

_MIX_NAMES = ("w", "k", "v", "r", "g")

_SERVING = ("the cached RWKV branch comes with the RWKV serving slice "
            "(ROADMAP Queue A item 10: the cache branch and the engine's "
            "recurrent bypass)")


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


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift from the zero state: x_{t-1}, zeros at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(p: Params, x: torch.Tensor,
            xx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Data-dependent lerp producing the five mixed inputs (w,k,v,r,g)."""
    x_base = x + xx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(L.gemm(x_base, p["lora_a"].to(x.dtype)))
    b, s, _ = x.shape
    lora = lora.reshape(b, s, 5, -1)
    lora_b = p["lora_b"].to(x.dtype)
    out = {}
    for i, name in enumerate(_MIX_NAMES):
        mix = p["mu"][i].to(x.dtype) + L.gemm(lora[:, :, i], lora_b[i])
        out[name] = x + xx * mix
    return out


def time_mix(p: Params, x: torch.Tensor, cfg: RwkvConfig,
             cache: Optional[Params] = None
             ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, d) -> (out (B, S, d), None)."""
    if cache is not None:
        raise NotImplementedError(f"rwkv time_mix with a cache: {_SERVING}")
    b, s, d = x.shape
    n = cfg.head_size
    h = d // n
    xx = _shift(x) - x
    mixed = _ddlerp(p, x, xx)

    r = L.dense(p["wr"], mixed["r"]).reshape(b, s, h, n)
    k = L.dense(p["wk"], mixed["k"]).reshape(b, s, h, n)
    v = L.dense(p["wv"], mixed["v"]).reshape(b, s, h, n)
    g = F.silu(L.dense(p["wg"], mixed["g"]))
    w_lora = L.gemm(torch.tanh(L.gemm(mixed["w"],
                                      p["w_lora_a"].to(x.dtype))),
                    p["w_lora_b"].to(x.dtype))
    # The decay stays in f32: (B, S, d) in (0, 1).
    w = torch.exp(-torch.exp(p["w0"].float() + w_lora.float()))
    w = w.reshape(b, s, h, n)

    bhsn = lambda z: z.transpose(1, 2)  # noqa: E731
    y = ops.wkv(bhsn(r), bhsn(k), bhsn(v), bhsn(w), p["u"].float())
    y = y.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    y = L.groupnorm(y, h, p["gn_scale"], p["gn_bias"], eps=64e-5)
    return L.dense(p["wo"], y * g), None


def channel_mix(p: Params, x: torch.Tensor,
                cache: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    if cache is not None:
        raise NotImplementedError(f"rwkv channel_mix with a cache: {_SERVING}")
    xx = _shift(x) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(L.dense(p["wk"], xk)))
    v = L.dense(p["wv"], k)
    r = torch.sigmoid(L.dense(p["wr"], xr))
    return r * v, None


def init_rwkv_cache(*args, **kwargs) -> Params:
    raise NotImplementedError(f"init_rwkv_cache: {_SERVING}")
