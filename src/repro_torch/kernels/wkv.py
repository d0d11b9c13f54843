"""WKV6, the RWKV-6 recurrence, forward and backward, hand-written for
Hopper (``csrc/wkv.cu``).

:func:`wkv6` replaces the Pallas kernel ``repro/kernels/wkv.py:wkv6``:
per (batch, head) an (N, N) f32 state from zero, y_t = r_t (S + diag(u)
k_t^T v_t), S <- diag(w_t) S + k_t^T v_t, with no padding of T.
:func:`wkv6_bwd` is its VJP as a kernel of its own: the JAX package
differentiates through its ``pallas_call``, a launched CUDA kernel has no
autograd.  :class:`WKV6` ties the two into a ``torch.autograd.Function``.

Bound on the card: at the training shape (B=8, H=40, T=64, N=64) the
forward moves 15.7 MB and does 0.34 GFLOP of f32, ~5 us either way;
the serial time loop inside each of the B*H blocks is what the simple
design pays instead.  The backward re-runs the recurrence into a scratch
buffer of every state (B*H*T*N*N f32: 335 MB at the training shape, freed
when the call returns) rather than dividing by decays that underflow.

Each wrapper runs its plain version (:data:`plain`, :data:`plain_bwd`)
for CPU tensors only; for CUDA tensors it launches its kernel or raises.
:data:`launches` counts forward launches, :data:`bwd_launches` backward
ones.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_wkv as plain
from repro_torch.kernels.ref import ref_wkv_bwd as plain_bwd

launches = 0
bwd_launches = 0

# FULL (head size 64, bf16 compute) is the training path.  Head size 16
# and f32 r/k/v are built only for rwkv6 SMOKE (head size 16, f32
# compute), which the training launcher and the restart check run on the
# card; chip_smoke.py holds that build against the plain versions too.
HEAD_SIZES = (16, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv")
    fwd, bwd = lib.wkv6_fwd_launch, lib.wkv6_bwd_launch
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return lib


def _check(name: str, r, k, v, w, u, *more: torch.Tensor) -> None:
    """The checks before a launch: one CUDA device, r/k/v (and gy) of one
    float dtype, w and u f32, the shapes, contiguity and the head size."""
    _build.refuse_autograd(name, r, k, v, w, u, *more)
    tensors = (r, k, v, w, u) + more
    dev = r.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    acts = (r, k, v) + more
    if len({t.dtype for t in acts}) != 1 or r.dtype not in _DTYPES:
        raise ValueError(f"{name} takes r, k, v (and gy) as f32 or bf16 of one "
                         f"dtype, got {[t.dtype for t in acts]}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"{name} takes w and u in f32, got {w.dtype}, "
                         f"{u.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w) + more):
        raise ValueError(f"{name} needs r, k, v, w (B, H, T, N) of one shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, h, t, n = r.shape
    if u.shape != (h, n):
        raise ValueError(f"{name} needs u ({h}, {n}), got {tuple(u.shape)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"{name} takes head sizes {HEAD_SIZES}, got {n}")
    if min(b, h, t) == 0:
        raise ValueError(f"{name} got an empty problem {tuple(r.shape)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} needs contiguous operands")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> torch.Tensor:
    """r/k/v/w: (B, H, T, N); u: (H, N) -> y (B, H, T, N) in r's dtype."""
    if all(t.device.type == "cpu" for t in (r, k, v, w, u)):
        return plain(r, k, v, w, u)
    _check("wkv6", r, k, v, w, u)
    global launches
    b, h, t, n = r.shape
    y = torch.empty_like(r)
    lib = _lib()
    err = lib.wkv6_fwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), b, h, t, n, _DTYPES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, "wkv6", err)
    launches += 1
    return y


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, gy: torch.Tensor
             ) -> Tuple[torch.Tensor, ...]:
    """The VJP of :func:`wkv6` for the output gradient gy (B, H, T, N) in
    r's dtype: (gr, gk, gv) in r's dtype, gw (B, H, T, N) and gu (H, N) in
    f32.  gu is summed over (b, t) in a fixed order: no atomics."""
    if all(t.device.type == "cpu" for t in (r, k, v, w, u, gy)):
        return plain_bwd(r, k, v, w, u, gy)
    _check("wkv6_bwd", r, k, v, w, u, gy)
    global bwd_launches
    b, h, t, n = r.shape
    gr, gk, gv = (torch.empty_like(x) for x in (r, k, v))
    gw = torch.empty_like(w)
    gu = torch.empty_like(u)
    gu_part = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
    states = torch.empty((b * h * t * n * n,), dtype=torch.float32,
                         device=r.device)
    lib = _lib()
    err = lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        gy.data_ptr(), gr.data_ptr(), gk.data_ptr(), gv.data_ptr(),
        gw.data_ptr(), gu.data_ptr(), gu_part.data_ptr(), states.data_ptr(),
        b, h, t, n, _DTYPES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, "wkv6", err)
    bwd_launches += 1
    return gr, gk, gv, gw, gu


class WKV6(torch.autograd.Function):
    """wkv6 with its hand-written backward: CUDA tensors launch the two
    kernels, CPU tensors run ``ref_wkv`` and ``ref_wkv_bwd``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return wkv6(r, k, v, w, u)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        return wkv6_bwd(*ctx.saved_tensors, gy.contiguous())
