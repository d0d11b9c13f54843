"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They are what a kernel wrapper runs for CPU tensors, what ``mode="ref"``
selects, and what ``chip_smoke.py`` holds every kernel against on the
card.  They follow the kernels' semantics where those differ from the JAX
oracles: masked logits are ``-1e30``, not ``-inf``, so a fully masked
attention row (or a zero-length decode slot) is zeros, not NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
_INT_RANGE = {torch.int8: (-128, 127), torch.int16: (-32768, 32767)}


def requantize(acc: torch.Tensor, out_dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    """Accumulator -> output conversion: an integer accumulator headed for
    int8/int16 is scaled in f32, rounded half to even (``torch.round``)
    and saturated; everything else is a plain cast (float GEMMs ignore
    ``scale``)."""
    if not acc.is_floating_point() and out_dtype in _INT_RANGE:
        lo, hi = _INT_RANGE[out_dtype]
        return torch.clamp(torch.round(acc.float() * scale), lo,
                           hi).to(out_dtype)
    return acc.to(out_dtype)


def ref_gemm(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
             scale: float = 1.0) -> torch.Tensor:
    """Plain gama_gemm: int8 inputs accumulate exactly (through float64,
    exact for |sum| < 2**53, which every int8 GEMM with K < 2**38 keeps),
    floats in f32."""
    integer = not a.is_floating_point()
    if out_dtype is None:
        out_dtype = torch.int32 if integer else a.dtype
    if integer:
        acc = (a.double() @ b.double()).to(torch.int32)
    else:
        acc = a.float() @ b.float()
    return requantize(acc, out_dtype, scale)


def _softmax_av(s: torch.Tensor, valid: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Masked softmax(s) @ v with the kernels' guards: masked logits at
    -1e30 contribute 0, and a row with no valid key gives 0."""
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    return (p @ v) / torch.where(l > 0, l, 1.0)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain flash_attention.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).
    Query head h reads KV head h // (Hq // Hkv); ``q_offset`` is q[0]'s
    absolute position for the causal mask; keys at or past ``kv_len``
    (default Sk) are masked."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kv_len = sk if kv_len is None else kv_len
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    k_pos = torch.arange(sk, device=q.device)
    valid = (k_pos < kv_len)[None, :]
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    return _softmax_av(s, valid, vf).to(q.dtype)


def ref_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, length: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain flash_decode.  q: (B, Hq, D) one token; k/v: (B, Hkv, Sk, D);
    ``length`` (B,) masks each slot's valid KV prefix (default Sk)."""
    b, hq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kf)[:, :, None] * scale
    k_pos = torch.arange(sk, device=q.device)
    if length is None:
        valid = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=q.device)
    else:
        valid = (k_pos[None, :] < length.to(q.device)[:, None])[:, None, None]
    return _softmax_av(s, valid, vf)[:, :, 0].to(q.dtype)
