"""Flash attention (forward), hand-written for Hopper
(``csrc/flash_attention.cu``).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:
flash_attention``: online-softmax attention with GQA (query head h reads
KV head h // group), causal masking at an absolute ``q_offset``, a
``kv_len`` mask, future KV tiles skipped and a zero-denominator guard.
``q_offset`` and ``kv_len`` are runtime arguments.

Bound on the card: on the prefill path Sq is a 16..64-token bucket and Sk
the cache length, so each (b, h) is a few MFLOP — the kernel is bound by
latency and by reading q, k and v once.  The design reads each KV tile
into shared memory once per block of 16 query rows and stops the KV loop
at the last key any of those rows may attend to.

:func:`flash_attention` runs the plain version (``ref.ref_attention``,
:data:`plain`) for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  :data:`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_attention as plain

launches = 0

HEAD_DIMS = (64, 128)   # SmolLM (64) and Qwen3 (128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """The checks every attention kernel makes before a launch: one CUDA
    device, one float dtype the kernel takes, contiguous storage."""
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.dtype for t in tensors}) != 1 or tensors[0].dtype not in _DTYPES:
        raise ValueError(f"{name} takes f32 or bf16 operands of one dtype, "
                         f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    kv_len = sk if kv_len is None else int(kv_len)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                     kv_len=kv_len)
    _build.refuse_autograd("flash_attention", q, k, v)
    check_cuda_operands("flash_attention", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"GQA needs hq % hkv == 0, got hq={hq}, hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len must lie in [0, {sk}], got {kv_len}")
    global launches
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, sk, d, _DTYPES[q.dtype], int(causal), int(q_offset), kv_len,
        scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", err)
    launches += 1
    return out
