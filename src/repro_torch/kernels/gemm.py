"""GAMA GEMM, hand-written for Hopper (``csrc/gemm.cu``).

Replaces the Pallas kernel ``repro/kernels/gemm.py:gama_gemm``.  C = A @ B
with f32 accumulation for f32/bf16 inputs and int32 accumulation for int8
inputs, whose int16/int8 outputs go through the requant epilogue (scale in
f32, round half to even, saturate) bit for bit as ``ref.requantize``.

Bound on the card: at decode sizes (M <= 8) every weight is read once, so
device-memory bytes bound it; prefill buckets (M = 16..64) are still below
the bf16 ridge.  The design keeps each output element's K sum in one
thread's registers in a fixed order with one tile shape for every M — no
split K — so a row's result never depends on the batch it rides in.  The
ragged M, K and N edges are masked in the kernel; callers never pad.

:func:`gama_gemm` runs the plain version (``ref.ref_gemm``, imported here
as :data:`plain`) for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  :data:`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_gemm as plain

launches = 0

# (input dtype, output dtype) -> the C entry point's type code.
_CODES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.int8, torch.int32): 2,
    (torch.int8, torch.int16): 3,
    (torch.int8, torch.int8): 4,
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("gemm")
    fn = lib.gama_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def gama_gemm(a: torch.Tensor, b: torch.Tensor, *,
              out_dtype: Optional[torch.dtype] = None,
              scale: float = 1.0) -> torch.Tensor:
    """C[M, N] = A[M, K] @ B[K, N].  Output dtype defaults to int32 for
    int8 inputs, else the input dtype (``repro/kernels/gemm.py:93-97``)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain(a, b, out_dtype=out_dtype, scale=scale)
    _build.refuse_autograd("gama_gemm", a, b)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"gama_gemm needs both operands on one CUDA device, "
                         f"got {a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gama_gemm needs A (M, K) and B (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"gama_gemm operand dtypes differ: {a.dtype} vs "
                         f"{b.dtype}")
    if out_dtype is None:
        out_dtype = torch.int32 if a.dtype == torch.int8 else a.dtype
    code = _CODES.get((a.dtype, out_dtype))
    if code is None:
        raise ValueError(f"gama_gemm does not take {a.dtype} -> {out_dtype} "
                         f"(have {sorted(str(k) for k in _CODES)})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gama_gemm needs contiguous row-major operands")
    m, k = a.shape
    n = b.shape[1]
    if min(m, k, n) == 0:
        raise ValueError(f"gama_gemm got an empty problem ({m}, {k}, {n})")
    global launches
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _lib()
    err = lib.gama_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, code,
        float(scale), torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, "gama_gemm", err)
    launches += 1
    return out
