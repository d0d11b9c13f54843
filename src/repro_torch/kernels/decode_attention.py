"""Flash decode, hand-written for Hopper (``csrc/decode_attention.cu``).

Replaces the Pallas kernel ``repro/kernels/decode_attention.py:
flash_decode``: one query token per slot against a dense (B, Hkv, Sk, D)
KV cache with a per-slot valid length (a ragged continuous batch); keys
at or past ``length[b]`` are never read and a zero length gives zeros.
(``flash_paged_decode`` over the page pool is not ported yet.)

Bound on the card: decode reads each slot's valid KV prefix once, so
device-memory bytes bound it.  The design gives one block to each
(slot, KV head) and runs the ``group`` query heads that share that KV
head together, so every KV tile is read once per group, not per head.

:func:`flash_decode` runs the plain version (``ref.ref_decode_attention``,
:data:`plain`) for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  :data:`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_DTYPES, HEAD_DIMS,
                                                 check_cuda_operands)
from repro_torch.kernels.ref import ref_decode_attention as plain

launches = 0

MAX_GROUP = 16   # query heads per KV head: 4 warps x 4 heads


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 length: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); k/v: (B, Hkv, Sk, D); length: (B,) int32 ->
    (B, Hq, D)."""
    b, hq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    if all(t.device.type == "cpu" for t in (q, k, v, length)):
        return plain(q, k, v, length=length, scale=scale)
    check_cuda_operands("flash_decode", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv <= 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_decode needs hq % hkv == 0 and a group of "
                         f"at most {MAX_GROUP}, got hq={hq}, hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode takes head dims {HEAD_DIMS}, got {d}")
    if (length.device != q.device or length.dtype != torch.int32
            or length.shape != (b,) or not length.is_contiguous()):
        raise ValueError(f"flash_decode needs length as a contiguous ({b},) "
                         f"int32 tensor on {q.device}, got {length.dtype} "
                         f"{tuple(length.shape)} on {length.device}")
    global launches
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), b, hq, hkv, sk, d, _DTYPES[q.dtype], scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_decode", err)
    launches += 1
    return out
