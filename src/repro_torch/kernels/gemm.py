"""GAMA GEMM, hand-written for Hopper (``csrc/gemm.cu``).

Replaces the Pallas kernel ``repro/kernels/gemm.py:gama_gemm``.  C = A @ B
with f32 accumulation for f32/bf16 inputs and int32 accumulation for int8
inputs, whose int16/int8 outputs go through the requant epilogue (scale in
f32, round half to even, saturate) bit for bit as ``ref.requantize``.

bf16 and int8 run on the tensor cores (``mma.sync``), fed by a ring of
2-8 K chunks of :data:`CHUNK_BYTES` a row; f32 runs on a SIMT kernel (the
tensor cores take f32 only as TF32).  At decode sizes the weight's bytes
bound the kernel, so K is split into up to :data:`MAX_SPLITS` slices, each
summed by its own block; the blocks of one output tile form a thread-block
cluster and add their partial tiles in slice order inside the launch.  At
prefill sizes one block may walk the slices in order instead: the same
sums, added in the same order.

:func:`plan` decides the launch: the row tile, the column tile, the number
of K slices, whether they run as a cluster, and the ring's depth.  The
slices -- and so the order in which each output is summed -- depend on
``(K, N, dtype)`` only, never on M, so a row's result does not depend on
the batch it rides in (what the serving engine's ``--verify`` checks).
:func:`k_walk` spells the slices out; the kernel checks the plan it is
given and refuses one it does not take (:func:`check_plan` states the same
rule for the CPU).

:func:`gama_gemm` runs the plain version (``ref.ref_gemm``, imported here
as :data:`plain`) for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  :data:`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

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

SMS = 132            # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 8       # K slices of one output tile: a portable cluster
CHUNK_BYTES = 128    # one K chunk of a row: 64 bf16 or 128 int8 elements
STAGES = (2, 8)      # K chunks the shared-memory ring may hold, least and most
SMEM_LIMIT = 232448  # shared memory one block may have on sm_90
# Row tile -> the column tiles the tensor-core kernel takes with it.
TC_TILES = {16: (32, 64, 128), 64: (128,), 128: (128,)}
# The SIMT f32 kernel's one tile: (bm, bn, splits, cluster, stages).
SIMT_PLAN = (16, 64, 1, 0, 1)


class Plan(NamedTuple):
    bm: int        # rows of the output tile
    bn: int        # columns of the output tile
    splits: int    # K slices, summed from zero each and added in order
    cluster: int   # 1: one block per slice, a thread-block cluster adds
                   # them; 0: one block walks the slices in order
    stages: int    # K chunks in the shared-memory ring (1: the SIMT kernel)


def k_chunk(dtype: torch.dtype) -> int:
    """Elements of one K chunk: the unit in which K is walked and split."""
    if dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"the tensor-core GEMM takes bf16 and int8, not "
                         f"{dtype}")
    return CHUNK_BYTES // dtype.itemsize


def smem_bytes(p: Plan, dtype: torch.dtype) -> int:
    """Shared memory of one block: the ring of ``stages`` A and B chunks,
    each row padded by 16 bytes, and with several slices the f32/int32
    partial tile: after the ring if one block walks them, over it if a
    cluster adds them."""
    ring = p.stages * (p.bm * (CHUNK_BYTES + 16)
                       + k_chunk(dtype) * (p.bn * dtype.itemsize + 16))
    red = p.bm * (p.bn + 4) * 4
    if p.splits == 1:
        return ring
    return max(ring, red) if p.cluster else ring + red


def splits_for(k: int, n: int, dtype: torch.dtype) -> int:
    """K slices for a (K, N) weight: the fewest that give one block per SM
    to a decode launch of 16-row tiles 64 columns wide (32 where 8 slices
    of 64 columns leave SMs idle), at most :data:`MAX_SPLITS` and one
    chunk a slice.  A function of (K, N, dtype) only."""
    if dtype == torch.float32:
        return 1
    chunks = -(-k // k_chunk(dtype))
    bn = 64 if -(-n // 64) * MAX_SPLITS >= SMS else 32
    return max(1, min(MAX_SPLITS, chunks, -(-SMS // -(-n // bn))))


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, dtype: torch.dtype) -> Plan:
    """The launch for C[m, n] = A[m, k] @ B[k, n] with ``dtype`` inputs.

    The K walk is :func:`splits_for`'s (not a function of m).  The rest
    only decides which block sums what, and follows m (rules fitted to
    timings of every choice at the served shapes on one H100):

    * m <= 16 (decode), 16-row tiles: the widest column tile (128, 64,
      32) that still gives every SM a block; the slices run in parallel as
      a cluster; a ring of 6 chunks (3 with 128 columns, so that three
      blocks fit an SM and the lm head's 384 blocks the card at once);
    * small prefills (m <= 64 with few 64 x 128 tiles): the same with
      64-column tiles;
    * larger m: 128 x 128 tiles (from m = 65) or 64 x 128, one block
      walking all slices while the tiles alone fill the card, else the
      slices as a cluster; a ring of 3 chunks (two blocks an SM).

    Raises on sizes or dtypes the kernel does not take."""
    if min(m, k, n) < 1:
        raise ValueError(f"gama_gemm got an empty problem ({m}, {k}, {n})")
    if dtype == torch.float32:
        return Plan(*SIMT_PLAN)
    if dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"gama_gemm takes f32, bf16 and int8, not {dtype}")
    splits = splits_for(k, n, dtype)

    def tiles(bm: int, bn: int) -> int:
        return -(-m // bm) * -(-n // bn)

    if m <= 16:
        bn = next((bn for bn in (128, 64) if tiles(16, bn) * splits >= SMS),
                  32)
        # 6 stages of 128 columns would leave one block an SM.
        return Plan(16, bn, splits, int(splits > 1), 3 if bn == 128 else 6)
    if m <= 64 and tiles(64, 128) * splits < SMS // 2:
        return Plan(16, 64, splits, int(splits > 1), 6)
    t128 = tiles(128, 128) if m > 64 else 0
    if 2 * t128 >= SMS:
        return Plan(128, 128, splits, 0, 3)
    if tiles(64, 128) >= SMS:
        return Plan(64, 128, splits, 0, 3)
    bm = 128 if 4 * t128 * splits >= 3 * SMS else 64
    return Plan(bm, 128, splits, int(splits > 1), 3)


def check_plan(p: Plan, k: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel takes ``p`` for this K and dtype: the same
    rule as ``gama_gemm_launch`` in ``csrc/gemm.cu``, which checks it again
    on the card."""
    if dtype == torch.float32:
        ok = tuple(p) == SIMT_PLAN
    else:
        chunks = -(-k // k_chunk(dtype))
        ok = (p.bn in TC_TILES.get(p.bm, ()) and p.cluster in (0, 1)
              and STAGES[0] <= p.stages <= STAGES[1]
              and smem_bytes(p, dtype) <= SMEM_LIMIT
              and 1 <= p.splits <= min(MAX_SPLITS, chunks))
    if not ok:
        raise ValueError(f"gama_gemm does not take {p} for K={k} {dtype}")


def k_walk(p: Plan, k: int, dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """The K slices of a plan as element ranges [lo, hi), in the order they
    are added: slice s holds chunks [s * C // S, (s + 1) * C // S) of the
    C chunks (the kernel's ``slice_start``), whichever block sums it."""
    if dtype == torch.float32:
        return ((0, k),)
    step = k_chunk(dtype)
    chunks = -(-k // step)
    bounds = [s * chunks // p.splits for s in range(p.splits + 1)]
    return tuple((lo * step, min(hi * step, k))
                 for lo, hi in zip(bounds, bounds[1:]))


def blocks(p: Plan, m: int, n: int) -> int:
    """Blocks one launch of ``p`` runs."""
    return (-(-m // p.bm) * -(-n // p.bn)
            * (p.splits if p.cluster else 1))


def _lib() -> ctypes.CDLL:
    lib = _build.load("gemm")
    fn = lib.gama_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, p: Plan,
           scale: float = 1.0) -> None:
    """Launch the kernel with plan ``p`` into ``out`` (no checks beyond the
    kernel's own, which refuses a plan it does not take)."""
    global launches
    m, k = a.shape
    code = _CODES[(a.dtype, out.dtype)]
    lib = _lib()
    err = lib.gama_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, b.shape[1], code,
        float(scale), p.bm, p.bn, p.splits, p.cluster, p.stages,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, "gama_gemm", err)
    launches += 1


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
    if (a.dtype, out_dtype) not in _CODES:
        raise ValueError(f"gama_gemm does not take {a.dtype} -> {out_dtype} "
                         f"(have {sorted(str(k) for k in _CODES)})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gama_gemm needs contiguous row-major operands")
    m, k = a.shape
    n = b.shape[1]
    p = plan(m, k, n, a.dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    launch(a, b, out, p, scale)
    return out
