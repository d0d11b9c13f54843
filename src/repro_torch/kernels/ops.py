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
slice (ROADMAP Queue A item 12).  ``wkv`` takes no ``chunk``: the kernels
take one chunk length per shape (``kernels/wkv.py:wkv_chunk``).

``matmul`` and ``attention`` take the kernel's plan from the tuner's
dispatch (``repro_torch.tuning.dispatch``: memo, then the tuning cache,
then today's analytic plan) unless the caller passes ``plan``, as the
reference resolves its tiles (``repro/kernels/ops.py:57-63``,
``:150-155``).  The CPU route takes no plan.

``matmul``, ``decode``, ``decode_paged``, ``wkv_state``, ``selective_scan``
and ``attention`` tick the
reference's route counters ``ops.<op>.kernel`` or ``ops.<op>.ref`` (the
last three the port's own) on the process registry
(``repro_torch.obs``).  The reference ticks them once per compiled program
(at trace time); the port has no tracing, so it ticks them once per call:
on the card each ``.kernel`` count equals its kernel's launch count, and
every ``.ref`` count reads 0 on the main path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (flash_decode,
                                                  flash_paged_decode)
from repro_torch.kernels.dequant import dequantize as dequant_kernel
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 check_bwd_form,
                                                 flash_attention)
from repro_torch.kernels.gemm import gama_gemm
from repro_torch.kernels.rmsnorm import LayerNorm, RMSNorm
from repro_torch.kernels.rmsnorm import add_rmsnorm as add_rmsnorm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.selective_scan import SelectiveScan
from repro_torch.kernels.selective_scan import check_shapes as _scan_shapes
from repro_torch.kernels.selective_scan import \
    selective_scan as selective_scan_kernel
from repro_torch.kernels.wkv import WKV6, wkv6_state
from repro_torch.obs import get_obs
from repro_torch.tuning import dispatch

MODES = ("auto", "kernel", "ref")

# The route counters' handles, looked up once per registry: `count` runs on
# every op call (225 GEMMs a SmolLM-360M decode step), and an entry point
# may swap the registry (`obs.configure`) between runs.
_route_registry = None
_route_counters: dict = {}


def _count(name: str) -> None:
    global _route_registry
    registry = get_obs().registry
    if registry is not _route_registry:
        _route_registry = registry
        _route_counters.clear()
    counter = _route_counters.get(name)
    if counter is None:
        counter = _route_counters[name] = registry.counter(name)
    counter.inc()


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
           mode: str = "auto", plan=None) -> torch.Tensor:
    """GAMA GEMM.  a: (M, K); b: (K, N).  ``plan``: a ``gemm.Plan``, None
    for the tuner's."""
    if not _use_kernel(mode, a, b):
        _count("ops.matmul.ref")
        return ref.ref_gemm(a, b, out_dtype=out_dtype, scale=scale)
    _count("ops.matmul.kernel")
    if plan is None:
        (m, k), n = a.shape, b.shape[1]
        plan = dispatch.gemm_config(m, k, n, a.dtype, a.get_device()).plan
    return gama_gemm(a, b, out_dtype=out_dtype, scale=scale, plan=plan)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, kv_len: Optional[int] = None,
              mode: str = "auto", plan=None) -> torch.Tensor:
    """Flash attention.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).
    ``plan``: a ``flash_attention.Plan``, None for the tuner's.

    When grad is enabled and an input requires it (training), ``auto`` and
    ``kernel`` go through :class:`~repro_torch.kernels.flash_attention.
    FlashAttention`: the forward kernel with its log-sum-exp and the
    hand-written backward for CUDA tensors, both plain halves for CPU
    tensors; it takes causal self-attention at ``q_offset`` 0 (training's
    form) and raises on any other.  ``ref`` differentiates the plain
    version by torch autograd."""
    _check_gqa(q.shape[1], k.shape[1])
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    on_kernel = _use_kernel(mode, q, k, v)
    _count("ops.attention.kernel" if on_kernel else "ops.attention.ref")
    if on_kernel and plan is None:
        _, hq, sq, d = q.shape
        plan = dispatch.attention_blocks(sq, k.shape[2], d, q.dtype, hq=hq,
                                         hkv=k.shape[1],
                                         device=q.get_device())
    if train and mode != "ref":
        check_bwd_form(causal, q_offset, kv_len, q.shape[2], k.shape[2])
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), scale, plan)
    if not on_kernel:
        # Past 2048 keys the plain path takes the online-softmax form, so
        # it never holds the (Sq, Sk) logits (ops.py:145-147 of the
        # reference).
        plain = (ref.chunked_attention if k.shape[2] > 2048
                 else ref.ref_attention)
        return plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                     kv_len=kv_len)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           q_offset=q_offset, kv_len=kv_len, plan=plan)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            mode: str = "auto") -> torch.Tensor:
    """RMSNorm over the last dim in f32, output in x's dtype: the
    fixed-order kernel for CUDA tensors (a row's bits do not depend on the
    rows beside it), the plain version for CPU tensors.  Differentiable on
    both: the kernel through :class:`~repro_torch.kernels.rmsnorm.RMSNorm`
    when an input requires grad (its backward is the plain expression's)."""
    if not _use_kernel(mode, x, scale):
        return ref.rmsnorm(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return rmsnorm_kernel(x, scale, eps)


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6, mode: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A residual add and the RMSNorm after it: (s = x + r, rmsnorm(s)).
    For CUDA tensors one launch of the rmsnorm kernel with the add fused
    in (s has torch's bits, y the unfused kernel's); for CPU tensors and in
    mode ``ref`` the plain ``x + r`` and ``ref.rmsnorm``.  When grad is
    enabled and an input requires it (training), the eager add and
    :func:`rmsnorm`: the fused kernel has no backward.  x and r must be of
    one shape and dtype (no broadcast, no promotion) on every route."""
    if r.shape != x.shape or r.dtype != x.dtype:
        raise ValueError(f"add_rmsnorm needs x and r of one shape and dtype, "
                         f"got {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(r.shape)} {r.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, r, scale)):
        s = x + r
        return s, rmsnorm(s, scale, eps=eps, mode=mode)
    if not _use_kernel(mode, x, r, scale):
        return ref.add_rmsnorm(x, r, scale, eps)
    return add_rmsnorm_kernel(x, r, scale, eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = 1e-5, groups: int = 1,
              mode: str = "auto") -> torch.Tensor:
    """LayerNorm over the last dim (``groups`` > 1: GroupNorm over that
    many slices of it) in f32, output in x's dtype: the fixed-order kernel
    for CUDA tensors (a row's bits do not depend on the rows beside it),
    the plain version for CPU tensors.  Differentiable on both: the kernel
    through :class:`~repro_torch.kernels.rmsnorm.LayerNorm` (its backward
    is the plain expression's)."""
    if not _use_kernel(mode, x, scale, bias):
        return ref.layernorm(x, scale, bias, eps, groups)
    return LayerNorm.apply(x, scale, bias, eps, groups)


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype, *,
               mode: str = "auto") -> torch.Tensor:
    """int8 weight codes q (..., K, N) times their f32 scales (..., N),
    rounded to ``dtype``: the ``dequant`` kernel for CUDA tensors (one
    pass, int8 read and ``dtype`` written), the plain version for CPU
    tensors."""
    if not _use_kernel(mode, q, scale):
        return ref.dequantize(q, scale, dtype)
    return dequant_kernel(q, scale, dtype)


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
        _count("ops.decode.ref")
        return ref.ref_decode_attention(q, k, v, length=length, scale=scale)
    _count("ops.decode.kernel")
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
        _count("ops.decode_paged.ref")
        return ref.ref_paged_decode_attention(
            q, k_pages, v_pages, block_tables, length=length, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    _count("ops.decode_paged.kernel")
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


def wkv_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
              mode: str = "auto"):
    """WKV6 recurrence from the state ``s0`` (B, H, N, N) f32: r/k/v/w
    (B, H, T, N); u (H, N) -> (y (B, H, T, N) in r's dtype, the final state
    (B, H, N, N) f32).  Serving's cached RWKV branch (prefill and decode):
    the ``wkv6_state`` kernel for CUDA tensors, ``ref.ref_wkv_state`` for
    CPU tensors and in mode ``ref``.  Inference only.  Ticks
    ``ops.wkv_state.kernel`` or ``ops.wkv_state.ref``."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv_state needs r, k, v, w (B, H, T, N) of one "
                         f"shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, h, _, n = r.shape
    if u.shape != (h, n) or s0.shape != (b, h, n, n):
        raise ValueError(f"wkv_state needs u ({h}, {n}) and s0 ({b}, {h}, "
                         f"{n}, {n}), got {tuple(u.shape)}, "
                         f"{tuple(s0.shape)}")
    if not _use_kernel(mode, r, k, v, w, u, s0):
        _count("ops.wkv_state.ref")
        return ref.ref_wkv_state(r, k, v, w, u, s0)
    _count("ops.wkv_state.kernel")
    return wkv6_state(*(t.contiguous() for t in (r, k, v, w, u, s0)))


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor, *,
                   mode: str = "auto"):
    """Mamba's selective scan from the state ``h0``: dt, x (B, T, di) and
    bm, c (B, T, N) in the compute dtype; a (di, N) and h0 (B, di, N) f32
    -> (y (B, T, di) in x's dtype, the final state (B, di, N) f32).  The
    ``selective_scan`` kernel for CUDA tensors, ``ref.selective_scan`` for
    CPU tensors and in mode ``ref``.  Ticks ``ops.selective_scan.kernel``
    or ``ops.selective_scan.ref``.

    When grad is enabled and an input requires it (training), ``auto`` and
    ``kernel`` go through :class:`~repro_torch.kernels.selective_scan.
    SelectiveScan`: the forward kernel saving its tile states and the
    hand-written backward for CUDA tensors, the plain forward and
    ``ref.selective_scan_bwd`` for CPU tensors.  ``ref`` differentiates the
    plain loop by torch autograd."""
    _scan_shapes(dt, x, bm, c, a, h0)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dt, x, bm, c, a, h0))
    on_kernel = _use_kernel(mode, dt, x, bm, c, a, h0)
    _count("ops.selective_scan.kernel" if on_kernel
           else "ops.selective_scan.ref")
    if train and mode != "ref":
        return SelectiveScan.apply(*(t.contiguous()
                                     for t in (dt, x, bm, c, a, h0)))
    if not on_kernel:
        return ref.selective_scan(dt, x, bm, c, a, h0)
    return selective_scan_kernel(dt, x, bm, c, a, h0)


def op_cost_model(op: str, *, m: int = 0, k: int = 0, n: int = 0,
                  batch: int = 0, heads: int = 0, kv_heads: int = 0,
                  seq: int = 0, d_head: int = 0,
                  dtype_bytes: float = 2.0,
                  kv_bytes: float = 2.0,
                  weight_flops: float = 0.0,
                  weight_bytes: float = 0.0,
                  chunk_tokens: int = 0,
                  layers: int = 1) -> tuple[float, float]:
    """Analytic (flops, bytes_moved) for the hot ops' roofline placement
    (a copy of the reference's; the port's engine always takes it, having
    no compiled executable to ask), counting the dominant terms only:

    * ``matmul``: 2mkn FLOPs; A + B + C once each through the memory
      system;
    * ``flash_decode`` / ``flash_paged_decode``: one query token per
      lane — 4·B·H·T·d FLOPs (QK^T + PV), traffic dominated by the KV
      read (T rows per kv head) plus the per-step weight stream
      (``weight_flops``/``weight_bytes``, from
      ``efficiency.model_flops_per_token``-style accounting, since the
      engine's decode step runs the whole model);
    * ``prefill_chunk``: the chunk forward (``weight_flops``/
      ``weight_bytes``, caller-scaled to the chunk's tokens) plus the
      chunk's KV page scatter — read scratch + write pool, zero MACs.
    """
    if op == "matmul":
        flops = 2.0 * m * k * n
        nbytes = (m * k + k * n) * dtype_bytes + m * n * dtype_bytes
        return flops, nbytes
    if op in ("flash_decode", "flash_paged_decode"):
        kvh = kv_heads or heads
        flops = layers * 4.0 * batch * heads * seq * d_head + weight_flops
        kv_read = layers * 2.0 * batch * kvh * seq * d_head * kv_bytes
        io = layers * 2.0 * batch * heads * d_head * dtype_bytes  # q/o
        return flops, kv_read + io + weight_bytes
    if op == "prefill_chunk":
        kvh = kv_heads or heads
        moved = (layers * 2.0 * 2.0 * chunk_tokens
                 * kvh * d_head * kv_bytes)
        return weight_flops, weight_bytes + moved
    raise ValueError(f"op_cost_model: unknown op {op!r}")
