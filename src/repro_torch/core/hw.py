"""Hardware models (counterpart of ``repro/core/hw.py``, which the port
copies whole, plus the card it runs on).

Three targets live side by side:

* :class:`AIE2Device` — the paper's AMD Versal VE2802 (AIE-ML) device, the
  peaks the paper's Tables II-VI are stated against.
* :class:`TpuChip` — the JAX package's deployment target: 197 TFLOP/s bf16
  per chip, 819 GB/s HBM, ~50 GB/s/link ICI.
* :class:`GpuCard` — the port's: :data:`H100_SXM`, NVIDIA's published
  dense peaks for the SXM part at its 700 W limit.

Each exposes the peak throughput per precision and the memory bandwidth
the roofline (``repro_torch.obs.efficiency``/``profile``) divides by.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Precision descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Precision:
    """An (input precision, output precision) pair, as in the paper."""

    name: str
    in_bytes: int
    out_bytes: int
    # Accumulator width used *inside* the engine (cascade payload on AIE2,
    # VMEM scratch dtype on TPU).
    acc_bytes: int

    @property
    def key(self) -> str:
        return self.name


# The four precisions evaluated by GAMA (Table II).
INT8_INT32 = Precision("int8-int32", in_bytes=1, out_bytes=4, acc_bytes=4)
INT8_INT16 = Precision("int8-int16", in_bytes=1, out_bytes=2, acc_bytes=4)
INT8_INT8 = Precision("int8-int8", in_bytes=1, out_bytes=1, acc_bytes=4)
BF16_BF16 = Precision("bf16-bf16", in_bytes=2, out_bytes=2, acc_bytes=4)

PRECISIONS: Dict[str, Precision] = {
    p.name: p for p in (INT8_INT32, INT8_INT16, INT8_INT8, BF16_BF16)
}

# f32 in and out: not one of the paper's four.  Only the card's model rates
# it apart from bf16 (its f32 runs on the SIMT cores, not the tensor cores).
F32_F32 = Precision("f32-f32", in_bytes=4, out_bytes=4, acc_bytes=4)


# ---------------------------------------------------------------------------
# AMD Versal AIE-ML (AIE2) — the paper's device
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AIE2Device:
    """VE2802 on the VEK280 board, as used in the paper (Section V-A)."""

    name: str = "VE2802"
    rows: int = 8
    cols: int = 38
    # Local data memory per engine: 64 KB in 4 banks of 16 KB.
    mem_bytes: int = 65536
    mem_banks: int = 4
    # PL <-> AIE interface.
    plio_in: int = 112
    plio_out: int = 84
    plio_bits: int = 128
    # Clocks: AIEs run at 1.25 GHz, the PL at 300 MHz.  The paper's Eq. 2-4
    # count PLIO transfer cycles in *AIE* cycles, so every PL-side beat costs
    # freq_ratio AIE cycles.  (This ratio is implicit in the paper; Table II's
    # gamma values only reproduce once it is applied.)
    aie_hz: float = 1.25e9
    pl_hz: float = 300e6
    # Cascade stream between neighbouring engines.
    cascade_bits: int = 512
    # Peak MAC throughput per engine per cycle (AM020): 256 int8, 128 bf16.
    macs_int8: int = 256
    macs_bf16: int = 128

    @property
    def n_engines(self) -> int:
        return self.rows * self.cols

    @property
    def freq_ratio(self) -> float:
        return self.aie_hz / self.pl_hz

    @property
    def plio_bytes_per_pl_cycle(self) -> float:
        return self.plio_bits / 8

    @property
    def bank_bytes(self) -> int:
        return self.mem_bytes // self.mem_banks

    def macs_per_cycle(self, precision: Precision) -> int:
        """Peak multiply-accumulates per cycle for a precision (per engine)."""
        if precision.in_bytes == 1:
            return self.macs_int8
        return self.macs_bf16

    def peak_ops(self, precision: Precision, engines: int | None = None) -> float:
        """Peak ops/s (1 MAC = 2 ops) for `engines` engines (default: chip)."""
        n = self.n_engines if engines is None else engines
        return n * self.macs_per_cycle(precision) * 2 * self.aie_hz


VE2802 = AIE2Device()


# ---------------------------------------------------------------------------
# TPU v5e-class chip — the deployment target
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpuChip:
    """TPU chip model (v5e-class constants per the assignment brief)."""

    name: str = "tpu-v5e"
    # Peak compute.
    peak_bf16_flops: float = 197e12
    peak_int8_ops: float = 394e12  # 2x bf16, standard for the generation
    # Memory system.
    hbm_bytes: int = 16 * 2**30
    hbm_bw: float = 819e9
    # VMEM: capacity is generous on the ML-optimized generations; we budget
    # conservatively and keep it configurable (tile search treats this as the
    # analogue of the AIE's 64 KB local memory).
    vmem_bytes: int = 64 * 2**20
    vmem_budget: int = 48 * 2**20
    # ICI per-link bandwidth (assignment: ~50 GB/s/link).
    ici_bw: float = 50e9
    # MXU geometry: 128x128 systolic, (sublane, lane) native tile (8, 128).
    mxu_dim: int = 128
    sublanes: int = 8
    lanes: int = 128

    def peak_ops(self, precision: Precision) -> float:
        if precision.in_bytes == 1:
            return self.peak_int8_ops
        return self.peak_bf16_flops

    def min_tile(self, dtype_bytes: int) -> Tuple[int, int]:
        """Native (second-minor, minor) tile for a dtype, per TPU tiling rules.

        fp32: (8, 128); bf16: (16, 128); int8/fp8: (32, 128).
        """
        packing = max(1, 4 // dtype_bytes)
        return (self.sublanes * packing, self.lanes)


TPU_V5E = TpuChip()


# ---------------------------------------------------------------------------
# NVIDIA H100 SXM — the port's card
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GpuCard:
    """One NVIDIA card: published dense peaks (no sparsity) by input type,
    device memory and its bandwidth, and the L2 a working set must exceed
    to be read from device memory."""

    name: str = "h100-sxm"
    peak_bf16_flops: float = 989e12
    peak_f32_flops: float = 67e12      # SIMT, outside the tensor cores
    peak_int8_ops: float = 1979e12
    hbm_bytes: int = 80 * 10**9
    hbm_bw: float = 3.35e12            # HBM3
    l2_bytes: int = 50 * 2**20

    def peak_ops(self, precision: Precision) -> float:
        """Peak ops/s for a precision, by its input width: int8, f32, else
        the bf16 tensor-core rate."""
        if precision.in_bytes == 1:
            return self.peak_int8_ops
        if precision.in_bytes == 4:
            return self.peak_f32_flops
        return self.peak_bf16_flops


H100_SXM = GpuCard()


# ---------------------------------------------------------------------------
# Pod / mesh level constants (roofline uses these)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """A pod of TPU chips joined by ICI; pods join over DCN."""

    chip: TpuChip = TPU_V5E
    chips_per_pod: int = 256
    # 2D torus per pod for v5e-class parts.
    torus: Tuple[int, int] = (16, 16)
    dcn_bw: float = 25e9  # per-host cross-pod bandwidth (model constant)


POD_V5E_256 = PodSpec()
