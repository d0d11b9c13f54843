"""Step-time attribution: device/host bubble accounting + per-kernel
roofline stall classification (counterpart of ``repro/obs/profile.py``).

The paper's optimisation loop is *attribution first*: find where cycles
go (compute vs PLIO data movement vs routing congestion), then remove
the dominant stall.  :mod:`repro_torch.obs.efficiency` already reports
%-of-peak for whole runs; this module answers the per-step and
per-kernel "why was it slow" questions for the serving stack:

* **Bubble accounting** — each engine step's wall time is split into a
  *device estimate* (the sum of the step's section probes: admission,
  prefill chunks, the decode; on a card each is the span between two CUDA
  events on the stream, on the CPU a host clock) and the residual
  host/dispatch **bubble** (scheduling, Python, callbacks, transfer
  glue).  The bubble is host time outside the probed sections, not the
  device's idle share: an eager section that the host cannot feed fast
  enough has a device span about as long as its host span, idle gaps
  between its kernels included.  Exported as the ``step.bubble_ms`` /
  ``step.device_ms`` histograms and the cumulative
  ``serve.bubble_fraction`` gauge.  By
  construction ``device + bubble == wall`` per step (bubble is clamped
  at zero if probes over-cover the step).

* **Stall classification** — each hot kernel (matmul, flash_decode,
  flash_paged_decode, prefill chunk scatter) is classified
  compute-bound vs memory-bound from its FLOPs and bytes (the analytic
  ``repro_torch.kernels.ops.op_cost_model``; there is no compiled
  executable to ask, so the reference's ``extract_costs`` has no
  counterpart) against the :mod:`repro_torch.core.hw` roofline:
  arithmetic intensity above the ridge point → compute-bound, below →
  memory-bound.  The roofline time bound
  ``max(flops/peak, bytes/bw)`` over the measured time gives the
  achieved-vs-bound ratio (1.0 = at the roofline).

Everything is host-side and cheap; the profiler only does arithmetic on
timings the engine already takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

from repro_torch.core import hw
from repro_torch.obs.efficiency import peak_flops
from repro_torch.obs.metrics import Registry

COMPUTE_BOUND = "compute"
MEMORY_BOUND = "memory"

#: Hot ops the engine places on the roofline.
HOT_OPS = ("matmul", "flash_decode", "flash_paged_decode", "prefill_chunk")


def peak_bandwidth(backend: str) -> float:
    """Analytic memory-system bandwidth (bytes/s) for the roofline's
    slanted roof: HBM on the H100 (``"cuda"``) and on the TPU chip model,
    the aggregate input PLIO bandwidth on the paper's VE2802 (its kernels
    stream operands over PLIO, so that is the memory-movement bound Eq.
    2-4 model)."""
    if backend == "cuda":
        return hw.H100_SXM.hbm_bw
    if backend == "tpu":
        return hw.TPU_V5E.hbm_bw
    dev = hw.VE2802
    return dev.plio_in * dev.plio_bytes_per_pl_cycle * dev.pl_hz


def ridge_intensity(dtype_name: str, backend: str) -> float:
    """The roofline ridge point (FLOPs/byte) where the compute roof
    meets the bandwidth roof for this dtype + backend."""
    return peak_flops(dtype_name, backend) / peak_bandwidth(backend)


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """One hot op's roofline placement."""

    name: str
    flops: float
    bytes: float
    measured_us: float
    intensity: float        # flops / bytes
    ridge: float            # ridge point for its dtype + backend
    stall_class: str        # COMPUTE_BOUND | MEMORY_BOUND
    bound_us: float         # roofline lower bound on time
    bound_ratio: float      # bound_us / measured_us  (1.0 = at roofline)

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def classify_kernel(name: str, flops: float, nbytes: float,
                    measured_us: float, dtype_name: str = "bfloat16",
                    backend: str = "cpu") -> KernelProfile:
    """Place one timed kernel on the roofline.

    >>> p = classify_kernel("gemm", flops=2 * 4096**3,
    ...                     nbytes=3 * 4096 * 4096 * 2,
    ...                     measured_us=100.0, backend="cpu")
    >>> p.stall_class
    'compute'
    >>> p = classify_kernel("scatter", flops=1e3, nbytes=1e9,
    ...                     measured_us=100.0, backend="cpu")
    >>> p.stall_class
    'memory'
    """
    if flops < 0 or nbytes < 0:
        raise ValueError(f"kernel {name}: negative flops/bytes")
    if measured_us <= 0:
        raise ValueError(f"kernel {name}: measured_us must be > 0")
    peak = peak_flops(dtype_name, backend)
    bw = peak_bandwidth(backend)
    intensity = flops / nbytes if nbytes > 0 else float("inf")
    ridge = peak / bw
    stall = COMPUTE_BOUND if intensity >= ridge else MEMORY_BOUND
    bound_s = max(flops / peak, nbytes / bw)
    bound_us = bound_s * 1e6
    return KernelProfile(
        name=name, flops=flops, bytes=nbytes, measured_us=measured_us,
        intensity=intensity, ridge=ridge, stall_class=stall,
        bound_us=bound_us,
        bound_ratio=min(1.0, bound_us / measured_us),
    )


class StepProfiler:
    """Per-step wall-time decomposition + kernel roofline table.

    The engine calls :meth:`record_step` once per ``step()`` with the
    step's wall time and its section probes; it calls
    :meth:`record_kernel` once per hot op once costs and a steady-state
    timing are known (re-recording a kernel overwrites its row —
    last-wins, so the table reflects warm timings).

    >>> prof = StepProfiler(Registry(), backend="cpu")
    >>> rec = prof.record_step(10.0, {"decode": 6.0, "prefill": 2.0})
    >>> rec["bubble_ms"]
    2.0
    >>> round(prof.bubble_fraction(), 2)
    0.2
    """

    def __init__(self, registry: Registry, backend: str,
                 dtype_name: str = "bfloat16"):
        self.registry = registry
        self.backend = backend
        self.dtype_name = dtype_name
        self._wall_ms_total = 0.0
        self._bubble_ms_total = 0.0
        self._kernels: Dict[str, KernelProfile] = {}
        self._h_bubble = registry.histogram(
            "step.bubble_ms", "host/dispatch bubble per engine step")
        self._h_device = registry.histogram(
            "step.device_ms", "device-attributed time per engine step")
        self._g_fraction = registry.gauge(
            "serve.bubble_fraction",
            "cumulative bubble / wall over the run")

    # -- per-step decomposition --------------------------------------------

    def record_step(self, wall_ms: float,
                    sections: Mapping[str, float]) -> Dict[str, float]:
        """Attribute one step: ``sections`` maps probe name → ms of
        probed work; the residual is the bubble.  Returns the
        decomposition record (also what the flight recorder stores)."""
        wall_ms = float(wall_ms)
        device_ms = sum(max(0.0, float(v)) for v in sections.values())
        # Probes can marginally over-cover wall (clock granularity);
        # clamp so the decomposition identity device + bubble == wall
        # holds exactly.
        device_ms = min(device_ms, wall_ms)
        bubble_ms = wall_ms - device_ms
        self._h_bubble.observe(bubble_ms)
        self._h_device.observe(device_ms)
        self._wall_ms_total += wall_ms
        self._bubble_ms_total += bubble_ms
        self._g_fraction.set(self.bubble_fraction())
        return {"wall_ms": wall_ms, "device_ms": device_ms,
                "bubble_ms": bubble_ms,
                "bubble_fraction": (bubble_ms / wall_ms) if wall_ms else 0.0}

    def bubble_fraction(self) -> float:
        """Cumulative bubble share of wall time (0 when nothing ran)."""
        if self._wall_ms_total <= 0:
            return 0.0
        return self._bubble_ms_total / self._wall_ms_total

    @property
    def wall_ms_total(self) -> float:
        return self._wall_ms_total

    @property
    def bubble_ms_total(self) -> float:
        return self._bubble_ms_total

    def reset_totals(self) -> None:
        """Zero the cumulative decomposition (the warmup seam, next to
        ``Registry.reset_values``).  The kernel table survives — warm
        steady-state timings are exactly what it should hold."""
        self._wall_ms_total = 0.0
        self._bubble_ms_total = 0.0

    # -- per-kernel roofline ------------------------------------------------

    def record_kernel(self, name: str, flops: float, nbytes: float,
                      measured_us: float,
                      dtype_name: Optional[str] = None) -> KernelProfile:
        prof = classify_kernel(
            name, flops, nbytes, measured_us,
            dtype_name=dtype_name or self.dtype_name,
            backend=self.backend)
        self._kernels[name] = prof
        self.registry.gauge(
            f"profile.{name}.bound_ratio",
            "roofline bound / measured time").set(prof.bound_ratio)
        self.registry.gauge(
            f"profile.{name}.memory_bound",
            "1 if memory-bound, 0 if compute-bound").set(
                1.0 if prof.stall_class == MEMORY_BOUND else 0.0)
        return prof

    def kernel_table(self) -> List[KernelProfile]:
        """Stall table, worst (lowest bound_ratio) first."""
        return sorted(self._kernels.values(), key=lambda p: p.bound_ratio)

    def summary(self) -> Dict[str, object]:
        return {
            "wall_ms_total": self._wall_ms_total,
            "bubble_ms_total": self._bubble_ms_total,
            "bubble_fraction": self.bubble_fraction(),
            "kernels": [p.as_dict() for p in self.kernel_table()],
        }
