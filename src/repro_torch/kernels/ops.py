"""Dispatch wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``).

``mode`` picks the path for every op:

* ``"auto"``: the hand-written kernel for CUDA tensors, the plain version
  for CPU tensors;
* ``"kernel"``: the kernel; CPU tensors raise (a CUDA kernel has no CPU
  build and no interpret mode);
* ``"ref"``: the plain PyTorch version, on whatever device the tensors are.

The TPU padding of the reference (tiles, and the GQA group padded to 8
sublanes) is gone: the CUDA kernels mask their ragged edges themselves.
The reference's pack-context branch of ``matmul`` (the multi-device pack
GEMM, ``repro/kernels/ops.py:99-109``) is left out until the multi-device
slice (ROADMAP Queue A item 12), and so is ``wkv``'s ``chunk`` (a TPU grid
step with no counterpart here; the tuner slice, item 9, decides whether it
gets one).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (flash_decode,
                                                  flash_paged_decode)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import gama_gemm
from repro_torch.kernels.wkv import WKV6

MODES = ("auto", "kernel", "ref")


def _use_kernel(mode: str, *tensors: torch.Tensor) -> bool:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "ref":
        return False
    on_cuda = all(t.is_cuda for t in tensors)
    if mode == "kernel" and not on_cuda:
        raise ValueError(
            "mode='kernel' needs CUDA tensors: the port's kernels are CUDA "
            "C++ for sm_90a and have no CPU build (use 'auto' or 'ref')")
    return on_cuda


def _check_gqa(hq: int, hkv: int) -> None:
    """GQA maps each KV head to hq/hkv query heads; a non-divisible head
    count would silently truncate the group — reject it on every path."""
    if hkv <= 0 or hq % hkv:
        raise ValueError(
            f"GQA needs query heads divisible by KV heads, got "
            f"hq={hq}, hkv={hkv} (hq % hkv = {hq % hkv if hkv else hq})")


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None, scale: float = 1.0,
           mode: str = "auto") -> torch.Tensor:
    """GAMA GEMM.  a: (M, K); b: (K, N)."""
    if not _use_kernel(mode, a, b):
        return ref.ref_gemm(a, b, out_dtype=out_dtype, scale=scale)
    return gama_gemm(a, b, out_dtype=out_dtype, scale=scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, kv_len: Optional[int] = None,
              mode: str = "auto") -> torch.Tensor:
    """Flash attention.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D)."""
    _check_gqa(q.shape[1], k.shape[1])
    if not _use_kernel(mode, q, k, v):
        return ref.ref_attention(q, k, v, causal=causal, scale=scale,
                                 q_offset=q_offset, kv_len=kv_len)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           q_offset=q_offset, kv_len=kv_len)


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           length: Optional[torch.Tensor] = None,
           scale: Optional[float] = None, mode: str = "auto") -> torch.Tensor:
    """Single-token decode attention.  q: (B, Hq, D); k/v: (B, Hkv, Sk, D).

    ``length`` is a (B,) vector of *per-slot* valid-prefix lengths (a
    ragged continuous batch: each slot attends only to its own prefix).
    """
    _check_gqa(q.shape[1], k.shape[1])
    b, sk = q.shape[0], k.shape[2]
    if length is None:
        length = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    else:
        length = torch.as_tensor(length, dtype=torch.int32, device=q.device)
        if length.shape != (b,):
            raise ValueError(
                f"decode length must be per-slot with shape ({b},), got "
                f"{tuple(length.shape)} — a scalar would silently mask every "
                f"slot to one shared prefix")
        # An over-long slot (stale host bookkeeping) must not read past
        # the cache as valid history.
        length = torch.clamp(length, max=sk)
    if not _use_kernel(mode, q, k, v):
        return ref.ref_decode_attention(q, k, v, length=length, scale=scale)
    return flash_decode(q, k, v, length=length.contiguous(), scale=scale)


def decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, *, block_tables: torch.Tensor,
                 length: torch.Tensor, scale: Optional[float] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None, buffers: int = 2,
                 mode: str = "auto") -> torch.Tensor:
    """Single-token decode attention over a **paged** KV cache
    (``repro_torch.serving.kvpool``).  q: (B, Hq, D); k_pages/v_pages:
    (P, Hkv, page_size, D) pools; block_tables: (B, max_pages) page ids;
    length: (B,) per-slot valid rows.  int8 pools pass per-row
    ``k_scale``/``v_scale`` rows (P, Hkv, page_size) f32.  ``buffers``
    picks the kernel's tile pipeline (1 or 2, bit-identical)."""
    _check_gqa(q.shape[1], k_pages.shape[1])
    b = q.shape[0]
    page_size = k_pages.shape[2]
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be (B={b}, max_pages), got "
                         f"{tuple(block_tables.shape)}")
    length = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    if length.shape != (b,):
        raise ValueError(
            f"paged decode length must be per-slot with shape ({b},), got "
            f"{tuple(length.shape)}")
    quantized = k_pages.dtype == torch.int8
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError(
            "int8 k_pages/v_pages need per-row k_scale/v_scale rows "
            "(P, Hkv, page_size) — decoding raw int8 codes as values would "
            "be silently wrong")
    if not quantized and (k_scale is not None or v_scale is not None):
        raise ValueError("k_scale/v_scale are only valid for int8 pools")
    if buffers not in (1, 2):
        raise ValueError(f"buffers must be 1 or 2, got {buffers}")
    # Stale host bookkeeping must not read past the table's coverage.
    length = torch.clamp(length, max=block_tables.shape[1] * page_size)
    block_tables = block_tables.to(device=q.device, dtype=torch.int32)
    if not _use_kernel(mode, q, k_pages, v_pages):
        return ref.ref_paged_decode_attention(
            q, k_pages, v_pages, block_tables, length=length, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    return flash_paged_decode(q, k_pages, v_pages, block_tables.contiguous(),
                              length=length.contiguous(), scale=scale,
                              k_scale=k_scale, v_scale=v_scale,
                              buffers=buffers)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, mode: str = "auto") -> torch.Tensor:
    """WKV6 recurrence from the zero state.  r/k/v/w: (B, H, T, N); u:
    (H, N) -> y (B, H, T, N) in r's dtype.  Differentiable on every path:
    ``auto`` and ``kernel`` go through :class:`~repro_torch.kernels.wkv.
    WKV6` (the forward and backward kernels for CUDA tensors, their plain
    versions for CPU tensors), ``ref`` through torch autograd of
    ``ref.ref_wkv``."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv needs r, k, v, w (B, H, T, N) of one shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    if u.shape != (r.shape[1], r.shape[3]):
        raise ValueError(f"wkv needs u (H, N) = {(r.shape[1], r.shape[3])}, "
                         f"got {tuple(u.shape)}")
    if mode != "ref":
        _use_kernel(mode, r, k, v, w, u)
        return WKV6.apply(*(t.contiguous() for t in (r, k, v, w, u)))
    return ref.ref_wkv(r, k, v, w, u)
