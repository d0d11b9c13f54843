"""Mamba (S6 selective SSM) block, the Jamba hybrid's recurrent mixer
(counterpart of ``repro/models/mamba.py``).

The recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t`` and its
contraction with C run through ``ops.selective_scan`` (the hand-written
``selective_scan`` kernel on the card, its plain version on the CPU), from
the zero state without a cache and from the cached state with one, for a
prompt and for a decode step alike; the reference runs a prompt as a
chunked associative scan and a decode step as one update, the same
recurrence in another order of operations.  Under autograd (training)
``ops.selective_scan`` goes through ``SelectiveScan``, whose backward is a
hand-written kernel too; the conv, the softplus and the D skip are torch
autograd's.  The cache is the conv window and the SSM state, fixed-size
per sequence, whatever its length.
``dt``'s low-rank projection goes through ``layers.gemm`` (the GAMA
kernel, whose rows do not depend on the batch).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import MambaConfig
from repro_torch.models.quant import maybe_dequant

Params = Dict[str, Any]

__all__ = ["MambaConfig", "init_mamba", "mamba_forward", "init_mamba_cache"]


def init_mamba(gen: torch.Generator, d_model: int, cfg: MambaConfig,
               dtype=torch.float32,
               device: Union[str, torch.device] = "cpu") -> Params:
    """The reference's distributions (``repro/models/mamba.py:40-66``):
    S4D-real A (``a_log = log(1..N)`` per channel), dt's bias the inverse
    softplus of U(0.001, 0.1)."""
    di = cfg.expand * d_model
    dt_rank = cfg.resolve_dt_rank(d_model)
    a_init = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                          device=device)[None, :].repeat(di, 1)
    in_proj = L.dense_init(gen, d_model, 2 * di, dtype, device)
    conv_w = L._normal(gen, (cfg.d_conv, di), dtype, device) * 0.2
    x_proj = L.dense_init(gen, di, dt_rank + 2 * cfg.d_state, dtype, device)
    dt_w = L._normal(gen, (dt_rank, di), dtype, device) * dt_rank ** -0.5
    u = torch.rand((di,), generator=gen, dtype=torch.float32, device=device)
    dt_b = torch.log(torch.expm1(torch.clamp(u * 0.099 + 0.001, min=1e-4)))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": x_proj,
        "dt_proj": {"w": dt_w, "b": dt_b.to(dtype)},
        "a_log": torch.log(a_init),
        "d": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": L.dense_init(gen, di, d_model, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, di); w: (k, di); ``state``: (B,
    k-1, di), the trailing window of the previous call (None: zeros).
    Returns (y, new_state).  The k taps are summed in order from tap 0, in
    x's dtype, as the reference's ``sum`` (``mamba.py:66-80``)."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, S+k-1, di)
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y + b.to(x.dtype), new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` turns
    linear past 20 and would differ there)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_forward(p: Params, x: torch.Tensor, cfg: MambaConfig,
                  cache: Optional[Params] = None
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, d_model) -> (out, new_cache).  ``cache`` = {"conv": (B,
    k-1, di), "ssm": (B, di, N) f32} carries a sequence across calls
    (prefill, then decode); None runs from zeros and returns no cache.
    Casts at the reference's points: dt in the compute dtype, widened to
    f32 for the recurrence; y from the f32 contraction, cast to the
    compute dtype; the D skip and the gate in the compute dtype."""
    d = x.shape[-1]
    di = cfg.expand * d
    n = cfg.d_state
    dt_rank = cfg.resolve_dt_rank(d)

    xz = L.dense(p["in_proj"], x)
    xin, z = xz[..., :di], xz[..., di:]
    xin, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                 None if cache is None else cache["conv"])
    xin = F.silu(xin)

    xdb = L.dense(p["x_proj"], xin)
    dt, bmat, cmat = torch.split(xdb, [dt_rank, n, n], dim=-1)
    dt = softplus(L.gemm(dt, maybe_dequant(p["dt_proj"]["w"], x.dtype))
                  + p["dt_proj"]["b"].to(x.dtype))           # (B, S, di)
    a = -torch.exp(p["a_log"].float())                       # (di, N) f32
    h0 = (cache["ssm"] if cache is not None else
          torch.zeros((x.shape[0], di, n), dtype=torch.float32,
                      device=x.device))
    y, h_final = ops.selective_scan(dt, xin, bmat, cmat, a, h0)
    y = y + xin * p["d"].to(x.dtype)
    out = L.dense(p["out_proj"], y * F.silu(z))
    if cache is None:
        return out, None
    return out, {"conv": new_conv, "ssm": h_final}


def init_mamba_cache(batch: int, d_model: int, cfg: MambaConfig,
                     dtype=torch.bfloat16,
                     device: Union[str, torch.device] = "cpu") -> Params:
    """Zeros: the conv window in ``dtype`` (the cache dtype), the SSM state
    in f32."""
    di = cfg.expand * d_model
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                           device=device),
    }
