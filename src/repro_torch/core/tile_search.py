"""Kernel-size (tile) search — paper Section IV-A, plus the TPU analogue.

AIE2 path: exhaustive search over (M, K, N) that satisfies the corrected
Eq. 6 memory constraint, ranked by (gamma, memory utilization, K).  The
paper's published sizes emerge for all four precisions under the documented
alignment constraints (M, N multiples of 16; K multiples of 8).  Known
discrepancy: for int8-int16 our search returns K=192 (100% memory, gamma
0.96) where the paper reports K=184 (97%, gamma 0.96) — identical gamma,
strictly higher utilization; we surface both.

TPU path: the same structural search adapted to Pallas BlockSpec tiles.
The AIE's 64 KB local memory becomes the VMEM budget; ping-pong double
buffering becomes the Pallas pipeline's automatic input double buffering
plus an f32 accumulator scratch that persists across the K grid (the
in-kernel "cascade"); PLIO bandwidth becomes HBM bandwidth.  gamma becomes
the tile's compute-time / HBM-stream-time ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

from repro_torch.core import hw
from repro_torch.core.gemm_model import (GemmShape, comm_cycles_abc, compute_cycles,
                                   gamma, memory_bytes, memory_utilization)

# ---------------------------------------------------------------------------
# AIE2 exhaustive search (paper)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AieTileChoice:
    shape: GemmShape
    precision: hw.Precision
    gamma: float
    mem_bytes: int
    mem_utilization: float
    theoretical_kcc: float


def search_aie_tiles(
    p: hw.Precision,
    dev: hw.AIE2Device = hw.VE2802,
    mn_step: int = 16,
    k_step: int = 8,
    mn_max: int = 64,
    k_max: int = 1024,
    top: int = 8,
) -> List[AieTileChoice]:
    """Exhaustive (M, K, N) search ranked by (gamma, mem util, K).

    The MMUL API granularity (4x8x8 / 8x8x4 etc.) requires M, N, K to be
    multiples of the element-block dims; vectorized 256-bit loads make
    multiples of 16 for M/N and 8 for K the practical grid (Section IV-A).

    ``mn_max`` defaults to 64: the paper's kernels cap the per-dimension
    output-tile extent (accumulator register pressure in the MMUL kernel);
    all four published sizes reproduce under this cap.  Lifting it is a
    *beyond-paper* observation: e.g. int8-int8 (96, 104, 112) reaches
    gamma = 1.44 vs the paper's 0.96.
    """
    out: List[AieTileChoice] = []
    for m in range(mn_step, mn_max + 1, mn_step):
        for n in range(mn_step, mn_max + 1, mn_step):
            # Largest K that fits; then scan a few K values downward so ties
            # on gamma are visible.
            for k in range(k_step, k_max + 1, k_step):
                shp = GemmShape(m, k, n)
                mem = memory_bytes(shp, p)
                if mem > dev.mem_bytes:
                    break
                out.append(AieTileChoice(
                    shape=shp, precision=p, gamma=gamma(shp, p, dev),
                    mem_bytes=mem,
                    mem_utilization=memory_utilization(shp, p, dev),
                    theoretical_kcc=compute_cycles(shp, p, dev)))
    out.sort(key=lambda c: (round(c.gamma, 4), c.mem_utilization,
                            c.shape.k), reverse=True)
    return out[:top]


def best_aie_tile(p: hw.Precision,
                  dev: hw.AIE2Device = hw.VE2802) -> AieTileChoice:
    return search_aie_tiles(p, dev, top=1)[0]


# The sizes the paper publishes (Table II); used by the table-reproduction
# benchmarks so downstream numbers match the paper even where our search
# finds an equal-gamma, higher-utilization tile.
PAPER_TILES = {
    "int8-int32": GemmShape(48, 240, 48),
    "int8-int16": GemmShape(64, 184, 64),
    "int8-int8": GemmShape(64, 224, 64),
    "bf16-bf16": GemmShape(64, 96, 64),
}


# ---------------------------------------------------------------------------
# TPU Pallas BlockSpec tile search
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpuTilePlan:
    """A Pallas GEMM tiling: C[M,N] = A[M,K] @ B[K,N] on one core.

    Grid is (M/tm, N/tn, K/tk) with the K axis innermost ("arbitrary"
    dimension semantics): partial sums accumulate in an f32 VMEM scratch and
    never round-trip HBM — the TPU analogue of the cascade stream.
    """

    tm: int
    tk: int
    tn: int
    in_bytes: int
    out_bytes: int
    vmem_bytes: int          # working set claimed
    arithmetic_intensity: float   # flops / HBM byte for the whole GEMM
    gamma: float             # tile compute time / tile HBM stream time
    notes: str = ""

    @property
    def block_a(self) -> Tuple[int, int]:
        return (self.tm, self.tk)

    @property
    def block_b(self) -> Tuple[int, int]:
        return (self.tk, self.tn)

    @property
    def block_c(self) -> Tuple[int, int]:
        return (self.tm, self.tn)


def tile_vmem_bytes(tm: int, tk: int, tn: int, in_bytes: int,
                    out_bytes: int) -> int:
    """VMEM claimed by one grid step under Pallas pipelining.

    Inputs are double-buffered by the pipeline (the ping-pong analogue);
    the f32 accumulator persists across the K loop; the output block is
    written once on the last K step.
    """
    a = tm * tk * in_bytes
    b = tk * tn * in_bytes
    acc = tm * tn * 4
    c = tm * tn * out_bytes
    return 2 * (a + b) + acc + c


def tile_gamma(tm: int, tk: int, tn: int, k_total: int, in_bytes: int,
               out_bytes: int, chip: hw.TpuChip,
               precision: hw.Precision) -> float:
    """Compute/communication ratio for one (tm, tn) output tile.

    Per output tile the kernel streams A (tm x K) and B (K x tn) from HBM
    and writes C (tm x tn); compute is 2*tm*tn*K flops.  Mirrors Eq. 5 with
    PLIO -> HBM.
    """
    flops = 2.0 * tm * tn * k_total
    t_compute = flops / chip.peak_ops(precision)
    hbm_bytes = (tm * k_total + k_total * tn) * in_bytes + tm * tn * out_bytes
    t_hbm = hbm_bytes / chip.hbm_bw
    return t_compute / t_hbm


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def search_tpu_tiles(
    m: int,
    k: int,
    n: int,
    precision: hw.Precision,
    chip: hw.TpuChip = hw.TPU_V5E,
    vmem_budget: Optional[int] = None,
    candidates: Iterable[int] = (128, 256, 512, 1024, 2048),
    k_candidates: Iterable[int] = (128, 256, 512, 1024, 2048),
) -> TpuTilePlan:
    """Pick (tm, tk, tn) for a local GEMM, GAMA-style.

    Policy (mirrors the paper's): among tiles that fit the VMEM budget and
    are MXU-aligned, maximize gamma; tie-break on VMEM utilization (larger
    working set = more reuse), then on tk (deeper in-kernel cascade =
    fewer output-block revisits).
    """
    budget = chip.vmem_budget if vmem_budget is None else vmem_budget
    sub, lane = chip.min_tile(precision.in_bytes)
    best: Optional[TpuTilePlan] = None
    best_key: Tuple = ()
    for tm in candidates:
        if tm > _round_up(m, sub):
            continue
        for tn in candidates:
            if tn > _round_up(n, lane):
                continue
            for tk in k_candidates:
                if tk > _round_up(k, lane):
                    continue
                if tm % sub or tk % lane or tn % lane:
                    continue
                vm = tile_vmem_bytes(tm, tk, tn, precision.in_bytes,
                                     precision.out_bytes)
                if vm > budget:
                    continue
                g = tile_gamma(tm, tk, tn, k, precision.in_bytes,
                               precision.out_bytes, chip, precision)
                ai = (2.0 * m * n * k) / (
                    (m * k + k * n) * precision.in_bytes
                    * (n // tn if tn < n else 1)  # A re-read per N tile row
                    + m * n * precision.out_bytes)
                key = (round(min(g, 4.0), 3), vm, tk)
                if best is None or key > best_key:
                    best_key = key
                    best = TpuTilePlan(
                        tm=tm, tk=tk, tn=tn,
                        in_bytes=precision.in_bytes,
                        out_bytes=precision.out_bytes,
                        vmem_bytes=vm, arithmetic_intensity=ai, gamma=g)
    if best is None:
        # Degenerate small problem: fall back to minimum aligned tile.
        tm, tk, tn = sub, lane, lane
        best = TpuTilePlan(
            tm=tm, tk=tk, tn=tn, in_bytes=precision.in_bytes,
            out_bytes=precision.out_bytes,
            vmem_bytes=tile_vmem_bytes(tm, tk, tn, precision.in_bytes,
                                       precision.out_bytes),
            arithmetic_intensity=0.0,
            gamma=tile_gamma(tm, tk, tn, k, precision.in_bytes,
                             precision.out_bytes, chip, precision),
            notes="fallback-min-tile")
    return best
