"""int8 weight dequantization, hand-written for Hopper
(``csrc/dequant.cu``).

It has no Pallas counterpart: the reference dequantizes with jnp on every
weight fetch (``repro/serving/quant.py:44``), one pass once XLA fuses it.
Under ``--quantize`` the port's weight fetch (``models.quant``) runs it
for every weight of every decode step, so its cost is one int8 read and
one bf16 write a parameter a step; the kernel moves just those bytes, 16
codes a thread, and gives the plain version's bits (the product in f32,
rounded to nearest even).

:func:`dequantize` runs the plain version (:data:`plain`) for CPU tensors
only; for CUDA tensors it launches the kernel or raises.
:data:`launches` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dequantize as plain

launches = 0

VEC = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def vec_width(k: int, n: int) -> int:
    """Codes a thread converts at once: 16 when they share a row of scales
    (n a multiple of 16) or one scale (n = 1, k a multiple of 16), else 1.
    The kernel refuses another width."""
    return VEC if n % VEC == 0 or (n == 1 and k % VEC == 0) else 1


def groups_of(q: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int, int]:
    """(G, K, N) of the codes: ``q`` (..., K, N) int8 and ``scale`` (..., N)
    f32, one scale per column of each (K, N) matrix, scale's leading dims
    being q's first ones (none: one row of scales for every row of q, as
    gathered embedding rows have).  Raises on anything else."""
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"dequantize takes int8 codes and f32 scales, got "
                         f"{q.dtype} and {scale.dtype}")
    n = q.shape[-1] if q.dim() else 0
    lead = scale.dim() - 1
    if (q.dim() < 2 or scale.dim() < 1 or scale.shape[-1] != n
            or lead > q.dim() - 2 or q.shape[:lead] != scale.shape[:-1]):
        raise ValueError(f"dequantize needs q (..., K, N) and scale (..., N) "
                         f"over q's leading dims, got {tuple(q.shape)} and "
                         f"{tuple(scale.shape)}")
    g = scale.numel() // max(n, 1)
    return g, q.numel() // max(g * n, 1), n


def _lib() -> ctypes.CDLL:
    lib = _build.load("dequant")
    if lib.dequant_launch.argtypes is None:
        lib.dequant_launch.argtypes = _ARGTYPES
        lib.dequant_launch.restype = ctypes.c_int
    return lib


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """q (..., K, N) int8, scale (..., N) f32 (see :func:`groups_of`) ->
    (..., K, N) in ``dtype`` (f32 or bf16): ``q * scale`` in f32, rounded
    once."""
    global launches
    g, k, n = groups_of(q, scale)
    if dtype not in _DTYPES:
        raise ValueError(f"dequantize writes f32 or bf16, got {dtype}")
    if q.device.type == "cpu" and scale.device.type == "cpu":
        return plain(q, scale, dtype)
    if not (q.is_cuda and scale.device == q.device):
        raise ValueError(f"dequantize needs q and scale on one CUDA device, "
                         f"got {q.device} and {scale.device}")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if q.numel() == 0:
        return out
    q, scale = q.contiguous(), scale.contiguous()
    vec = vec_width(k, n)
    if vec > 1 and q.data_ptr() % 16:
        q = q.clone()                # 16-byte vector loads
    if vec > 1 and n > 1 and scale.data_ptr() % 16:
        scale = scale.clone()
    lib = _lib()
    err = lib.dequant_launch(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), g, k, n,
        _DTYPES[dtype], vec, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "dequant", err)
    launches += 1
    return out
