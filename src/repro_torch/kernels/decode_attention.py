"""Flash decode over a dense cache and over a page pool, hand-written for
Hopper (``csrc/decode_attention.cu``, ``csrc/paged_decode_attention.cu``).

:func:`flash_decode` replaces the Pallas kernel ``repro/kernels/
decode_attention.py:flash_decode``: one query token per slot against a
dense (B, Hkv, Sk, D) KV cache with a per-slot valid length (a ragged
continuous batch); keys at or past ``length[b]`` are never read and a zero
length gives zeros.

:func:`flash_paged_decode` replaces ``flash_paged_decode`` of the same
file (both buffering variants): the same decode over a (P, Hkv, ps, D)
page pool gathered through a (B, max_pages) block table, with int8 pools
dequantized by their per-row scales inside the kernel.

Bound on the card: decode reads each slot's valid KV prefix once, so
device-memory bytes bound it.  Both kernels split a slot's keys into
chunks of :func:`decode_chunk` keys counted from key 0 (flash-decoding):
one block for each (chunk, KV head, slot) runs the ``group`` query heads
that share that KV head, so every KV tile is read once per group, and a
long slot's keys spread over many blocks.  The last block of a (slot, KV
head) to finish merges the chunks' partial states in chunk order, inside
the same launch.  The chunk size depends on (D, KV dtype) only, so a
slot's bits do not depend on B, the lengths, ``max_pages`` or Sk, and a
float pool gives the bits of :func:`flash_decode` on the gathered cache.
Head dims: f32 16, 64 and 128; bf16 64 and 128.

Each wrapper runs its plain version (:data:`plain`, :data:`plain_paged`)
for CPU tensors only; for CUDA tensors it launches its kernel or raises.
:data:`launches` counts ``flash_decode`` launches, :data:`paged_launches`
``flash_paged_decode`` launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_DTYPES, check_cuda_operands,
                                                 check_head_dim)
from repro_torch.kernels.ref import ref_decode_attention as plain
from repro_torch.kernels.ref import ref_paged_decode_attention as plain_paged

launches = 0
paged_launches = 0

MAX_GROUP = 16   # query heads per KV head: 4 warps x 4 heads


_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# Keys per chunk by head dim, for every KV dtype: the fastest of 32-256 in
# tools/decode_table.py --sweep on one H100 (PERF.md).
CHUNKS = {16: 32, 64: 32, 128: 128}
# device -> int32 zeros, one per (slot, KV head): the merge's tickets.  Each
# launch leaves them zeroed, so launches on one stream (the serve path's,
# or a CUDA graph's) share them; concurrent launches on two streams would
# not.
_TICKETS = {}


def decode_chunk(d: int, kv_dtype: torch.dtype) -> int:
    """Keys per decode chunk: a slot's keys split into chunks of this many
    keys counted from key 0, each folded by its own block.  A function of
    (D, KV dtype) only -- never of B, the lengths, ``max_pages``, Sk or
    the card -- and a multiple of the kernels' 32-key tile; the kernels'
    entry points refuse any other value (``csrc/common.cuh``
    ``decode_chunk``)."""
    if d not in CHUNKS or kv_dtype not in _KV_DTYPES:
        raise ValueError(f"decode kernels take head dims {tuple(CHUNKS)} "
                         f"and KV dtypes {tuple(_KV_DTYPES)}, got {d}, "
                         f"{kv_dtype}")
    return CHUNKS[d]


def _scratch(q: torch.Tensor, hkv: int, n_chunks: int):
    """The f32 scratch of a launch (which the caller keeps until the launch
    is queued), pointers into it to the partial states (m, l) and acc of
    every (slot, query head, chunk), and a pointer to the per-(slot, KV
    head) tickets, which the kernel leaves zeroed; all None when every
    slot is one chunk."""
    if n_chunks == 1:
        return None, None, None, None
    b, hq, d = q.shape
    rows = b * hq * n_chunks
    part = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    need = b * hkv
    tickets = _TICKETS.get(q.device)
    if tickets is None or tickets.numel() < need:
        tickets = _TICKETS[q.device] = torch.zeros(
            max(need, 4096), dtype=torch.int32, device=q.device)
    return (part, part.data_ptr(), part.data_ptr() + 4 * 2 * rows,
            tickets.data_ptr())


_ARGTYPES = {
    "flash_decode_launch": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                            + [ctypes.c_float, ctypes.c_void_p]),
    "flash_paged_decode_launch": ([ctypes.c_void_p] * 11
                                  + [ctypes.c_int] * 10
                                  + [ctypes.c_float, ctypes.c_void_p]),
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of the launch functions ``lib`` has (a
    build of ``decode_attention.cu`` or ``paged_decode_attention.cu``)."""
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name, None)
        if fn is not None and fn.argtypes is None:
            fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind(_build.load("decode_attention"))


def _paged_lib() -> ctypes.CDLL:
    return bind(_build.load("paged_decode_attention"))


def launch(lib: ctypes.CDLL, chunk: int, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, length: torch.Tensor, out: torch.Tensor,
           scale: float) -> None:
    """Launch ``lib``'s flash_decode into ``out`` with ``chunk``-key chunks
    (no checks beyond the kernel's own, which refuses another chunk size
    than its table's)."""
    b, hq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scratch, ml, acc, tickets = _scratch(q, hkv, -(-sk // chunk))
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), ml, acc, tickets, b, hq, hkv, sk, d,
        _DTYPES[q.dtype], chunk, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_decode", err)
    del scratch      # freed in stream order, after the kernel


def launch_paged(lib: ctypes.CDLL, chunk: int, q: torch.Tensor,
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_tables: torch.Tensor, length: torch.Tensor,
                 out: torch.Tensor, scale: float,
                 k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor], buffers: int) -> None:
    """Launch ``lib``'s flash_paged_decode into ``out`` with ``chunk``-key
    chunks (no checks beyond the kernel's own)."""
    b, hq, d = q.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    max_pages = block_tables.shape[1]
    scratch, ml, acc, tickets = _scratch(q, hkv, -(-max_pages * ps // chunk))
    quantized = k_scale is not None
    err = lib.flash_paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        block_tables.data_ptr(), length.data_ptr(), out.data_ptr(), ml, acc,
        tickets, b, hq, hkv, ps, d, max_pages, _DTYPES[q.dtype],
        _KV_DTYPES[k_pages.dtype], buffers, chunk, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_paged_decode", err)
    del scratch


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
    _build.refuse_autograd("flash_decode", q, k, v)
    check_cuda_operands("flash_decode", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv <= 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_decode needs hq % hkv == 0 and a group of "
                         f"at most {MAX_GROUP}, got hq={hq}, hkv={hkv}")
    check_head_dim("flash_decode", d, q.dtype)
    if (length.device != q.device or length.dtype != torch.int32
            or length.shape != (b,) or not length.is_contiguous()):
        raise ValueError(f"flash_decode needs length as a contiguous ({b},) "
                         f"int32 tensor on {q.device}, got {length.dtype} "
                         f"{tuple(length.shape)} on {length.device}")
    # The kernel copies 16-byte chunks of K and V (a cp.async ring): a view
    # that starts off that boundary is copied (rows, D * elt bytes, are
    # multiples of 16 at every head dim it takes).
    k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (k, v))
    global launches
    out = torch.empty_like(q)
    launch(_lib(), decode_chunk(d, q.dtype), q, k, v, length, out, scale)
    launches += 1
    return out


def flash_paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor, *,
                       length: torch.Tensor, scale: Optional[float] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       buffers: int = 2) -> torch.Tensor:
    """q: (B, Hq, D); k_pages/v_pages: (P, Hkv, ps, D) pools (P includes
    the null sink page) in q's dtype, or int8 with f32 scale rows
    ``k_scale``/``v_scale`` (P, Hkv, ps); block_tables: (B, max_pages)
    int32; length: (B,) int32 -> (B, Hq, D).

    ``buffers`` picks the kernel's tile pipeline: 1 = synchronous loads,
    2 = a two-stage ``cp.async`` ring; both give bit-identical outputs.
    Keys at or past ``length[b]`` (clamped to max_pages * ps) and their
    table entries are never read."""
    if buffers not in (1, 2):
        raise ValueError(f"buffers must be 1 or 2, got {buffers}")
    quantized = k_pages.dtype == torch.int8
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("int8 k_pages/v_pages need k_scale and v_scale rows "
                         "(P, Hkv, page_size)")
    if not quantized and (k_scale is not None or v_scale is not None):
        raise ValueError("k_scale/v_scale are only valid for int8 pools")
    b, hq, d = q.shape
    n_pool, hkv, ps = k_pages.shape[:3]
    scale = d ** -0.5 if scale is None else float(scale)
    tensors = [q, k_pages, v_pages, block_tables, length]
    scales = [k_scale, v_scale] if quantized else []
    if all(t.device.type == "cpu" for t in tensors + scales):
        return plain_paged(q, k_pages, v_pages, block_tables, length=length,
                           scale=scale, k_scale=k_scale, v_scale=v_scale)
    _build.refuse_autograd("flash_paged_decode", *tensors, *scales)
    check_cuda_operands("flash_paged_decode", q)
    dev = q.device
    if not all(t.device == dev and t.is_contiguous()
               for t in tensors + scales):
        raise ValueError("flash_paged_decode needs contiguous operands on "
                         f"{dev}, got {[str(t.device) for t in tensors]}")
    if k_pages.dtype not in (q.dtype, torch.int8) or \
            v_pages.dtype != k_pages.dtype:
        raise ValueError(f"flash_paged_decode pools must be {q.dtype} or "
                         f"int8, got {k_pages.dtype}/{v_pages.dtype}")
    if (k_pages.shape != v_pages.shape or k_pages.dim() != 4
            or k_pages.shape[3] != d):
        raise ValueError(f"flash_paged_decode shapes: q {tuple(q.shape)}, "
                         f"k_pages {tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    if any(s.dtype != torch.float32 or s.shape != (n_pool, hkv, ps)
           for s in scales):
        raise ValueError(f"flash_paged_decode scale rows must be f32 "
                         f"({n_pool}, {hkv}, {ps})")
    if hkv <= 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_paged_decode needs hq % hkv == 0 and a group "
                         f"of at most {MAX_GROUP}, got hq={hq}, hkv={hkv}")
    check_head_dim("flash_paged_decode", d, q.dtype)
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b or block_tables.shape[1] < 1):
        raise ValueError(f"flash_paged_decode needs ({b}, max_pages) int32 "
                         f"block_tables, got {block_tables.dtype} "
                         f"{tuple(block_tables.shape)}")
    if length.dtype != torch.int32 or length.shape != (b,):
        raise ValueError(f"flash_paged_decode needs length as a ({b},) int32 "
                         f"tensor, got {length.dtype} {tuple(length.shape)}")
    if any(t.data_ptr() % 16 for t in (k_pages, v_pages)):
        raise ValueError("flash_paged_decode pools must be 16-byte aligned "
                         "(the kernel copies 16-byte chunks)")
    global paged_launches
    out = torch.empty_like(q)
    launch_paged(_paged_lib(), decode_chunk(d, k_pages.dtype), q, k_pages,
                 v_pages, block_tables, length, out, scale, k_scale, v_scale,
                 buffers)
    paged_launches += 1
    return out
