"""Mamba's selective scan, hand-written for Hopper
(``csrc/selective_scan.cu``).

It has no Pallas counterpart: the reference runs the S6 recurrence in jnp
(``repro/models/mamba.py:83-114`` for a prompt, ``:151-154`` for decode)
and contracts the states with C (``:158``).  The port's Mamba mixer runs
it here for a prompt and for a decode step alike, one launch a layer: one
thread walks one (sequence, channel) row over time with its N states in
registers and sums the contraction over N in a fixed order, so a row's
bits do not depend on the batch it rides in.

:func:`selective_scan` runs the plain version (:data:`plain`) for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
:data:`launches` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan as plain

launches = 0

MAX_STATE = 16      # the kernel keeps N <= 16 states a row in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def check_shapes(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[int, int, int, int]:
    """(B, T, di, N) of a call; raises on inconsistent shapes."""
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"selective_scan needs dt and x (B, T, di) of one "
                         f"shape, got {tuple(dt.shape)} and "
                         f"{tuple(x.shape)}")
    b, t, di = dt.shape
    n = a.shape[-1] if a.dim() == 2 else -1
    if (a.shape != (di, n) or bm.shape != (b, t, n) or c.shape != (b, t, n)
            or h0.shape != (b, di, n)):
        raise ValueError(f"selective_scan needs bm, c (B={b}, T={t}, N), a "
                         f"(di={di}, N) and h0 (B, di, N), got "
                         f"{tuple(bm.shape)}, {tuple(c.shape)}, "
                         f"{tuple(a.shape)}, {tuple(h0.shape)}")
    return b, t, di, n


def _lib() -> ctypes.CDLL:
    lib = _build.load("selective_scan")
    if lib.selective_scan_launch.argtypes is None:
        lib.selective_scan_launch.argtypes = _ARGTYPES
        lib.selective_scan_launch.restype = ctypes.c_int
    return lib


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x (B, T, di) and bm, c (B, T, N) in the compute dtype (f32 or
    bf16); a (di, N) and h0 (B, di, N) f32 -> (y (B, T, di) in x's dtype,
    the state after step T (B, di, N) f32, a new tensor).  The kernel is
    inference only: it raises if an input requires grad."""
    global launches
    tensors = (dt, x, bm, c, a, h0)
    b, t, di, n = check_shapes(*tensors)
    if all(v.device.type == "cpu" for v in tensors):
        return plain(*tensors)
    _build.refuse_autograd("selective_scan", *tensors)
    if not all(v.is_cuda and v.device == x.device for v in tensors):
        raise ValueError(f"selective_scan needs every input on one CUDA "
                         f"device, got {[str(v.device) for v in tensors]}")
    if x.dtype not in _DTYPES or any(v.dtype != x.dtype for v in (dt, bm, c)):
        raise ValueError(f"selective_scan takes dt, x, bm, c of one dtype, "
                         f"f32 or bf16, got "
                         f"{[v.dtype for v in (dt, x, bm, c)]}")
    if a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise ValueError(f"selective_scan needs a and h0 in f32, got "
                         f"{a.dtype} and {h0.dtype}")
    if n > MAX_STATE or b > 65535:
        raise ValueError(f"the selective_scan kernel takes N <= {MAX_STATE} "
                         f"and B <= 65535, got N={n}, B={b}")
    if t == 0:
        return torch.empty_like(x), h0.clone()
    dt, x, bm, c, a, h0 = (v.contiguous() for v in tensors)
    y = torch.empty_like(x)
    h_end = torch.empty_like(h0)
    lib = _lib()
    err = lib.selective_scan_launch(
        dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_end.data_ptr(), b, t,
        di, n, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "selective_scan", err)
    launches += 1
    return y, h_end
