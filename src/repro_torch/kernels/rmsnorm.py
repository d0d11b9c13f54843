"""RMSNorm with a fixed reduction order, hand-written for Hopper
(``csrc/rmsnorm.cu``).

It has no Pallas counterpart: the reference normalises with jnp
(``repro/models/layers.py:103``).  The port needs a kernel for the bits,
not the speed: chunked prefill and batched decode hold a row's output to
be the same whatever else its call holds, and torch's reductions pick
their summation order from the shape of the call.  The kernel gives each
row to one warp that sums its squares in an order fixed by the row
length alone (see the source), and replaces torch's ~10 launches a norm
with one.

:func:`rmsnorm` runs the plain version (:data:`plain`, float64 sums) for
CPU tensors only; for CUDA tensors it launches the kernel or raises.
:data:`launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as plain

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


def vec_width(d: int, dtype: torch.dtype) -> int:
    """Elements a lane loads at once: 16 bytes' worth when the row is a
    whole number of them, else 1.  A function of (d, dtype) only, so a
    row is always summed in the same order; the kernel refuses another
    width."""
    if dtype not in _DTYPES:
        raise ValueError(f"rmsnorm takes f32 or bf16, got {dtype}")
    wide = 16 // torch.tensor([], dtype=dtype).element_size()
    return wide if d % wide == 0 else 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    if lib.rmsnorm_launch.argtypes is None:
        lib.rmsnorm_launch.argtypes = _ARGTYPES
        lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) f32 or bf16; scale: (d,) -> x's shape and dtype."""
    global launches
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return plain(x, scale, eps)
    _build.refuse_autograd("rmsnorm", x, scale)
    d = x.shape[-1]
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"rmsnorm needs x and scale on one CUDA device, got "
                         f"{x.device} and {scale.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm takes f32 or bf16 x, got {x.dtype}")
    if scale.shape != (d,) or not scale.is_floating_point():
        raise ValueError(f"rmsnorm needs a float scale of shape ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.numel() == 0:
        return torch.empty_like(x)
    rows = x.reshape(-1, d).contiguous()
    out = torch.empty_like(rows)
    vec = vec_width(d, x.dtype)
    if vec > 1 and rows.data_ptr() % 16:
        rows = rows.clone()          # 16-byte vector loads
    scale = scale.float().contiguous()
    lib = _lib()
    err = lib.rmsnorm_launch(
        rows.data_ptr(), scale.data_ptr(), out.data_ptr(), rows.shape[0], d,
        _DTYPES[x.dtype], vec, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "rmsnorm", err)
    launches += 1
    return out.reshape(x.shape)
