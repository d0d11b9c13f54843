"""Analytical GEMM performance model — the paper's Eq. 1-6, corrected.

The paper defines, for a single-AIE kernel of size (M, K, N):

  Eq. 1  Compute_cycles = M*K*N / peak_MACs
  Eq. 2-4  Comm_X       = bytes(X) / (PLIO_width/8)
  Eq. 5  gamma          = Compute_cycles / max(Comm_A, Comm_B, Comm_C)
  Eq. 6  memory         = M*K*b_in + K*N*b_in + 2*M*N*b_out  <= 64 KB

Two corrections are required to reproduce Table II exactly:

* Comm cycles must be expressed in AIE cycles: each 128-bit PLIO beat takes
  one *PL* cycle (300 MHz), i.e. ``freq_ratio = f_AIE/f_PL`` AIE cycles.
* All three matrices are ping-pong buffered (Algorithm 1 places six
  buffers), so the constraint is ``2*(A + B + C) <= 64 KB``.

The same structural model is reused for the TPU target, with PLIO->HBM and
the AIE local memory -> VMEM tile budget (see :mod:`repro_torch.core.tile_search`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core import hw


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """A (possibly tiled) GEMM problem C[M,N] += A[M,K] @ B[K,N]."""

    m: int
    k: int
    n: int

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def bytes_a(self, p: hw.Precision) -> int:
        return self.m * self.k * p.in_bytes

    def bytes_b(self, p: hw.Precision) -> int:
        return self.k * self.n * p.in_bytes

    def bytes_c(self, p: hw.Precision) -> int:
        return self.m * self.n * p.out_bytes


# ---------------------------------------------------------------------------
# Single-AIE model (paper Eq. 1-6)
# ---------------------------------------------------------------------------


def compute_cycles(shape: GemmShape, p: hw.Precision,
                   dev: hw.AIE2Device = hw.VE2802) -> float:
    """Eq. 1 — theoretical kernel compute cycles (KCC) on one engine."""
    return shape.macs / dev.macs_per_cycle(p)


def comm_cycles(nbytes: int, dev: hw.AIE2Device = hw.VE2802) -> float:
    """Eq. 2-4 — PLIO transfer cycles, expressed in AIE cycles.

    One PLIO moves ``plio_bits/8`` bytes per *PL* cycle; the paper counts
    kernel time in AIE cycles, hence the ``freq_ratio`` factor.
    """
    return nbytes / dev.plio_bytes_per_pl_cycle * dev.freq_ratio


def comm_cycles_abc(shape: GemmShape, p: hw.Precision,
                    dev: hw.AIE2Device = hw.VE2802) -> Tuple[float, float, float]:
    return (
        comm_cycles(shape.bytes_a(p), dev),
        comm_cycles(shape.bytes_b(p), dev),
        comm_cycles(shape.bytes_c(p), dev),
    )


def gamma(shape: GemmShape, p: hw.Precision,
          dev: hw.AIE2Device = hw.VE2802) -> float:
    """Eq. 5 — compute-to-communication ratio.

    gamma < 1: PLIO-bandwidth bound; gamma > 1: compute bound.  Each AIE has
    two input PLIOs (A and B stream concurrently) and one output PLIO, and
    read/compute/write are pipelined, so the binding term is the *max* of
    the three streams.
    """
    ca, cb, cc = comm_cycles_abc(shape, p, dev)
    return compute_cycles(shape, p, dev) / max(ca, cb, cc)


def memory_bytes(shape: GemmShape, p: hw.Precision) -> int:
    """Corrected Eq. 6 — ping-pong buffering doubles all three matrices."""
    return 2 * (shape.bytes_a(p) + shape.bytes_b(p) + shape.bytes_c(p))


def fits_memory(shape: GemmShape, p: hw.Precision,
                dev: hw.AIE2Device = hw.VE2802) -> bool:
    return memory_bytes(shape, p) <= dev.mem_bytes


def memory_utilization(shape: GemmShape, p: hw.Precision,
                       dev: hw.AIE2Device = hw.VE2802) -> float:
    return memory_bytes(shape, p) / dev.mem_bytes


# ---------------------------------------------------------------------------
# Efficiency metrics used throughout the paper
# ---------------------------------------------------------------------------


def kce(theoretical_kcc: float, measured_kcc: float) -> float:
    """Kernel Compute Efficiency = theoretical / measured cycles."""
    return theoretical_kcc / measured_kcc


def throughput_ops(shape: GemmShape, cycles: float, engines: int,
                   dev: hw.AIE2Device = hw.VE2802) -> float:
    """Achieved ops/s when `engines` engines each run `shape` in `cycles`."""
    return shape.flops * engines / (cycles / dev.aie_hz)


def throughput_efficiency(achieved_ops: float, p: hw.Precision,
                          dev: hw.AIE2Device = hw.VE2802) -> float:
    """TE — achieved throughput / chip peak (Section V-E)."""
    return achieved_ops / dev.peak_ops(p)


# ---------------------------------------------------------------------------
# Steady-state iteration model (used by the array-level simulator)
# ---------------------------------------------------------------------------


def steady_state_cycles(kernel_cycles: float, shape: GemmShape,
                        p: hw.Precision,
                        dev: hw.AIE2Device = hw.VE2802) -> float:
    """Per-iteration latency with pipelined read/compute/write.

    With ping-pong buffering the engine overlaps the PLIO streams of the
    next tile with the compute of the current one, so the steady-state
    iteration time is ``max(compute-ish kernel cycles, slowest stream)``.
    When gamma < 1 this is what throttles the array (Table V's int8-int32
    row: 2160/3000 * 94.7% = 68% TE).
    """
    ca, cb, cc = comm_cycles_abc(shape, p, dev)
    return max(kernel_cycles, ca, cb, cc)
