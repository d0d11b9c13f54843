"""Flash attention (forward), hand-written for Hopper
(``csrc/flash_attention.cu``).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:
flash_attention``: online-softmax attention with GQA (query head h reads
KV head h // group), causal masking at an absolute ``q_offset``, a
``kv_len`` mask, future KV tiles skipped, masked logits of -1e30 and a
zero-denominator guard.  ``q_offset`` and ``kv_len`` are runtime arguments.

bf16 runs on the tensor cores (``mma.sync`` for Q.K^T and P.V, K/V tiles
of :data:`KV_TILE` keys in a ``cp.async`` ring) at head dims 64 and 128;
f32 runs on a SIMT kernel (the tensor cores take f32 only as TF32) at 16,
64 and 128 (:data:`HEAD_DIMS`).  Prefill pads a prompt to a
power-of-two bucket from 16 tokens up to ``max_len`` (488 in the
8 x 448-token replay, against a 496-row scratch cache), so Sq runs from 16
to a few hundred: a few MFLOP per block, bound by latency rather than by
the MMA rate or the bytes of q, k and v.

:func:`plan` decides the launch: the route, the query rows of a block,
whether a block packs a GQA group's query heads (so their K/V tiles are
read once), and the ring's depth.  The KV tiles start at multiples of
:func:`kv_tile` from key 0, a width that depends on (D, dtype) only, and
each row passes through them in order, so a row's bits do not depend on
the plan, Sq, ``q_offset`` or B: a prompt prefilled whole or in chunks at
runtime offsets gives the same rows.

:func:`flash_attention` runs the plain version (``ref.ref_attention``,
:data:`plain`) for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  :data:`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_attention as plain

launches = 0

# Head dims each route takes: SmolLM (64) and Qwen3 (128) on both, the SMOKE
# configs' 16 on the f32 SIMT kernel only (they compute in f32).
HEAD_DIMS = {torch.float32: (16, 64, 128), torch.bfloat16: (64, 128)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"simt": 0, "tc": 1}

KV_TILE = 64             # keys per tile of the tensor-core kernel
SIMT_KV_TILE = 32        # ... and of the f32 SIMT kernel (common.cuh)
ROWS = (16, 32, 64)      # query rows per head in a tensor-core block
STAGES = (2, 4)          # KV tiles the ring may hold, least and most
MAX_WARPS = 8
SMEM_LIMIT = 232448      # shared memory one block may have on sm_90


class Plan(NamedTuple):
    route: str     # "tc": tensor cores (bf16); "simt": f32 FMA
    rows: int      # query rows of each head in a block (16 per warp)
    heads: int     # query heads in a block: 1, or the GQA group
    stages: int    # KV tiles in the shared-memory ring (1: SIMT)
    kv_tile: int   # keys per KV tile: kv_tile(D, dtype)


def check_head_dim(name: str, d: int, dtype: torch.dtype) -> None:
    """Raise unless the attention kernels take head dim ``d`` in
    ``dtype`` (:data:`HEAD_DIMS`)."""
    if dtype not in HEAD_DIMS:
        raise ValueError(f"{name} takes f32 or bf16, not {dtype}")
    if d not in HEAD_DIMS[dtype]:
        raise ValueError(f"{name} takes head dims {HEAD_DIMS[dtype]} in "
                         f"{dtype}, got {d}")


def kv_tile(d: int, dtype: torch.dtype) -> int:
    """Keys per KV tile: a function of (D, dtype) only, so the tiles a row
    passes through start at the same keys however the prompt is split."""
    check_head_dim("flash_attention", d, dtype)
    return SIMT_KV_TILE if dtype == torch.float32 else KV_TILE


def warps(p: Plan) -> int:
    return p.rows // 16 * p.heads


def smem_bytes(p: Plan, d: int) -> int:
    """Shared memory of a tensor-core block: each warp's 16 Q rows and
    ``stages`` K and V tiles, every row padded by 16 bytes."""
    pitch = 2 * d + 16
    return warps(p) * 16 * pitch + p.stages * 2 * p.kv_tile * pitch


def blocks(p: Plan, b: int, hq: int, sq: int) -> int:
    """Blocks one launch of ``p`` runs."""
    return b * (hq // p.heads) * -(-sq // p.rows)


@functools.lru_cache(maxsize=4096)
def plan(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
         dtype: torch.dtype) -> Plan:
    """The launch for q (b, hq, sq, d) against k/v (b, hkv, sk, d).

    f32 takes the SIMT kernel's one plan.  bf16 takes the tensor cores
    with 64-key tiles; the rest only decides which block computes a row
    (rules fitted to ``tools/attention_table.py --sweep`` on one H100):

    * 16 rows a head (one warp) up to sq = 16, 32 up to 32, else 64;
    * at sq <= 16 a block packs the GQA group's query heads, so K and V
      are read once per KV head (10-18% faster than a 16-row block per
      head at 16 x 48);
    * a ring of 3 tiles at D = 64 past two tiles of cache, else 2 (at
      D = 128 three stages leave one block an SM).

    Raises on shapes or dtypes the kernel does not take."""
    if min(b, hq, hkv, sq, sk) < 1:
        raise ValueError(f"flash_attention got an empty problem: b={b} "
                         f"hq={hq} hkv={hkv} sq={sq} sk={sk}")
    if hq % hkv:
        raise ValueError(f"GQA needs hq % hkv == 0, got hq={hq}, hkv={hkv}")
    tile = kv_tile(d, dtype)
    if dtype == torch.float32:
        return Plan("simt", 16, 1, 1, tile)
    group = hq // hkv
    rows = 16 if sq <= 16 else 32 if sq <= 32 else 64
    heads = group if sq <= 16 and group * rows // 16 <= MAX_WARPS else 1
    stages = 3 if d == 64 and sk > 2 * tile else 2
    return Plan("tc", rows, heads, stages, tile)


def check_plan(p: Plan, hq: int, hkv: int, d: int,
               dtype: torch.dtype) -> None:
    """Raise unless the kernel takes ``p``: the rule ``flash_attention_
    launch`` in ``csrc/flash_attention.cu`` checks again on the card."""
    tile = kv_tile(d, dtype)
    if dtype == torch.float32:
        ok = tuple(p) == ("simt", 16, 1, 1, tile)
    else:
        ok = (p.route == "tc" and p.kv_tile == tile and p.rows in ROWS
              and p.heads in (1, hq // hkv) and warps(p) <= MAX_WARPS
              and STAGES[0] <= p.stages <= STAGES[1]
              and smem_bytes(p, d) <= SMEM_LIMIT)
    if not ok:
        raise ValueError(f"flash_attention does not take {p} for hq={hq} "
                         f"hkv={hkv} d={d} {dtype}")


def candidates(hq: int, hkv: int, d: int, dtype: torch.dtype):
    """Every plan the kernel takes for these heads, head dim and dtype:
    the choices ``tools/attention_table.py --sweep`` times and checks for
    equal bits."""
    tile = kv_tile(d, dtype)
    if dtype == torch.float32:
        yield Plan("simt", 16, 1, 1, tile)
        return
    for heads in sorted({1, hq // hkv}):
        for rows in ROWS:
            for stages in range(STAGES[0], STAGES[1] + 1):
                p = Plan("tc", rows, heads, stages, tile)
                if (warps(p) <= MAX_WARPS
                        and smem_bytes(p, d) <= SMEM_LIMIT):
                    yield p


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
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


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, p: Plan, *, causal: bool, scale: float,
           q_offset: int, kv_len: int) -> None:
    """Launch the kernel with plan ``p`` into ``out`` (no checks beyond the
    kernel's own, which refuses a plan it does not take)."""
    global launches
    b, hq, sq, d = q.shape
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        k.shape[1], sq, k.shape[2], d, _DTYPES[q.dtype], int(causal),
        int(q_offset), int(kv_len), float(scale), _ROUTES[p.route], p.rows,
        p.heads, p.stages, p.kv_tile,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", err)
    launches += 1


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
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len must lie in [0, {sk}], got {kv_len}")
    p = plan(b, hq, hkv, sq, sk, d, q.dtype)
    if p.route == "tc":
        # 16-byte cp.async needs 16-byte aligned rows: a view that starts
        # off that boundary is copied (the rows themselves, D * 2 bytes,
        # are multiples of 16).
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    launch(q, k, v, out, p, causal=causal, scale=scale, q_offset=q_offset,
           kv_len=kv_len)
    return out
