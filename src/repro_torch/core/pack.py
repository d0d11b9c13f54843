"""Pack-level model — chaining AIEs with the cascade (paper Section IV-B).

A *pack* is G engines in a row, each computing the same (M, K, N) tile over
a different K-slice; partial sums stream AIE->AIE over the 512-bit cascade,
so the pack computes a (M, G*K, N) GEMM and only the last engine writes C.

Three things are modelled here:

* **PLIO accounting + scalability window** (Eq. 7-8): each engine needs two
  input PLIOs; one output PLIO per pack.  Replicating packs across the
  8x38 array must respect 112 input / 84 output PLIOs.  With a (Y, X)
  search and a >=2/3 array-utilization criterion this reproduces the
  paper's scalable window G in [3, 10] (Fig. 6's unhatched region).
* **Cascade stalls**: the producer's accumulator traffic can exceed the
  512-bit/cycle cascade width; stalls accumulate per chained engine.  We
  model KCE_pack(G) = KCE_single * (1 - s)^(G-1) with the per-link stall
  rate s derived from the cascade width vs accumulator bandwidth, scaled by
  a single calibration constant shared across precisions (fit once so that
  the average G=4 loss matches Table IV's ~7pp; the per-precision numbers
  are then predictions, asserted within tolerance in tests).
* **Buffer placement within the pack**: Figure 4 — the last engine's output
  buffers are placed in its neighbour (the 3rd AIE of 4), so one engine has
  all six buffers and needs Algorithm 1; the rest hold four input buffers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core import hw
from repro_torch.core.gemm_model import GemmShape

# ---------------------------------------------------------------------------
# PLIO accounting and the scalability window (Eq. 7-8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """A (Y, G, X) replication of the pack across the array (Fig. 5)."""

    y: int   # vertical replication (splits M)
    g: int   # pack size (splits K, cascade)
    x: int   # horizontal replication (splits N)

    @property
    def engines(self) -> int:
        return self.y * self.g * self.x

    @property
    def plio_in(self) -> int:
        # PLIO broadcast (Fig. 5): matrix A rows are shared along X (Y*G
        # unique A streams) and matrix B columns along Y (G*X unique B
        # streams) — Eq. 8's Y*G + G*X term.
        return self.y * self.g + self.g * self.x

    @property
    def plio_out(self) -> int:
        return self.y * self.x


def fits_device(cfg: ArrayConfig, dev: hw.AIE2Device = hw.VE2802) -> bool:
    """Eq. 7 + Eq. 8."""
    return (cfg.y <= dev.rows
            and cfg.g * cfg.x <= dev.cols
            and cfg.engines <= dev.n_engines
            and cfg.plio_in <= dev.plio_in
            and cfg.plio_out <= dev.plio_out)


def best_array_for_pack(g: int, dev: hw.AIE2Device = hw.VE2802
                        ) -> Optional[ArrayConfig]:
    """Max-utilization (Y, X) for a given pack size G."""
    best: Optional[ArrayConfig] = None
    for y in range(dev.rows, 0, -1):
        for x in range(dev.cols // g, 0, -1):
            cfg = ArrayConfig(y, g, x)
            if fits_device(cfg, dev):
                if best is None or cfg.engines > best.engines:
                    best = cfg
    return best


def pack_is_scalable(g: int, dev: hw.AIE2Device = hw.VE2802,
                     min_utilization: float = 0.78) -> bool:
    """Does pack size G scale "to the complete array" (Fig. 6 unhatched)?

    Small packs run out of output PLIOs (every pack writes C), large packs
    out of input PLIOs (2 per engine before broadcast).  The paper calls a
    pack scalable when (nearly) the complete array is usable; the 78%
    utilization floor is calibrated to the published window: G=10 reaches
    240/304 = 78.9% (scalable per Fig. 6) while G=11 tops out at
    231/304 = 76% (hatched).  [3, 10] reproduces exactly.
    """
    cfg = best_array_for_pack(g, dev)
    return cfg is not None and cfg.engines >= min_utilization * dev.n_engines


def scalable_window(dev: hw.AIE2Device = hw.VE2802) -> Tuple[int, int]:
    ok = [g for g in range(2, dev.cols + 1) if pack_is_scalable(g, dev)]
    return (min(ok), max(ok))


# ---------------------------------------------------------------------------
# Cascade stall model (Fig. 6 / Table IV)
# ---------------------------------------------------------------------------

# Calibration: Table IV reports ~7pp average KCE loss at G=4 vs the single
# AIE (cascade stalls of 6-9%).  The physical driver: per kernel iteration
# each engine pushes M*N accumulator values (acc_bytes wide) through the
# 512-bit cascade while also computing; the stall rate per link is the
# excess of cascade beats over compute cycles.  A single dimensionless
# constant maps modelled excess to observed stall rate.
_CASCADE_CAL = 0.55


def cascade_stall_rate(shape: GemmShape, p: hw.Precision,
                       dev: hw.AIE2Device = hw.VE2802) -> float:
    """Per-link fractional KCE loss from cascade back-pressure."""
    kcc = shape.macs / dev.macs_per_cycle(p)
    acc_bytes = shape.m * shape.n * p.acc_bytes
    cascade_beats = acc_bytes / (dev.cascade_bits / 8)
    return _CASCADE_CAL * cascade_beats / kcc


def pack_kce(single_kce: float, g: int, shape: GemmShape, p: hw.Precision,
             dev: hw.AIE2Device = hw.VE2802) -> float:
    """KCE of a pack of G engines (Fig. 6 curve)."""
    s = cascade_stall_rate(shape, p, dev)
    return single_kce * (1.0 - s) ** (g - 1)


def pack_shape(shape: GemmShape, g: int) -> GemmShape:
    """Pack computes (M, G*K, N) — Fig. 3."""
    return GemmShape(shape.m, g * shape.k, shape.n)


def sweep_pack_sizes(single_kce: float, shape: GemmShape, p: hw.Precision,
                     dev: hw.AIE2Device = hw.VE2802
                     ) -> List[dict]:
    """Fig. 6: KCE and scalability for G in [2, #cols]."""
    rows = []
    for g in range(2, dev.cols + 1):
        rows.append({
            "g": g,
            "kce": pack_kce(single_kce, g, shape, p, dev),
            "scalable": pack_is_scalable(g, dev),
        })
    return rows


def best_pack_size(single_kce: float, shape: GemmShape, p: hw.Precision,
                   dev: hw.AIE2Device = hw.VE2802) -> int:
    """Highest-KCE scalable pack size — the paper picks G=4."""
    rows = [r for r in sweep_pack_sizes(single_kce, shape, p, dev)
            if r["scalable"]]
    return max(rows, key=lambda r: r["kce"])["g"]


# ---------------------------------------------------------------------------
# Pack buffer placement (Fig. 4)
# ---------------------------------------------------------------------------


def pack_buffer_homes(g: int) -> List[dict]:
    """Which engine hosts which buffers in a pack of G (Fig. 4).

    Engines 0..G-1; the last engine computes the final C but its output
    ping/pong live in engine G-2's memory (neighbour access), so engine
    G-2 holds six buffers (needs Algorithm 1) and everyone else four.
    """
    homes = []
    for i in range(g):
        bufs = ["ping_A", "pong_A", "ping_B", "pong_B"]
        if i == max(0, g - 2):
            bufs += ["ping_C", "pong_C"]
        homes.append({"engine": i, "buffers": bufs,
                      "needs_algorithm1": len(bufs) == 6})
    return homes
