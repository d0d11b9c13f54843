"""repro_torch.obs — tracing, metrics & roofline-efficiency telemetry
(counterpart of ``repro/obs``: the same series, span names and snapshot
schema, so the port's files read like the reference's).

One process-wide :class:`Obs` bundle pairs a :class:`~repro_torch.obs.
metrics.Registry` (always on — instruments are allocation-light) with a
:class:`~repro_torch.obs.trace.Tracer` (off by default — spans cost a
clock read each, so tracing is opt-in via ``configure`` or
``--trace-out``).

Call sites grab handles through :func:`get_obs` or the :func:`count`
convenience; entry points that own a run (``launch/serve.py``) swap in
fresh instances with :func:`configure` so one process can produce
multiple independent snapshots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import NULL_TRACER, Tracer, validate_chrome_trace
from repro_torch.obs.export import (SNAPSHOT_SCHEMA, flatten_snapshot,
                                    validate_snapshot, write_metrics,
                                    write_prometheus)
from repro_torch.obs import efficiency
from repro_torch.obs.profile import (KernelProfile, StepProfiler,
                                     classify_kernel, peak_bandwidth,
                                     ridge_intensity)
from repro_torch.obs.slo import SLOMonitor, window_percentile
from repro_torch.obs.flight import FlightRecorder

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Tracer", "NULL_TRACER",
    "SNAPSHOT_SCHEMA", "flatten_snapshot", "validate_snapshot",
    "validate_chrome_trace", "write_metrics", "write_prometheus",
    "efficiency", "Obs", "get_obs", "configure", "reset", "count",
    "KernelProfile", "StepProfiler", "classify_kernel", "peak_bandwidth",
    "ridge_intensity", "SLOMonitor", "window_percentile", "FlightRecorder",
]


@dataclass
class Obs:
    """The (registry, tracer) pair instrumentation points consume."""

    registry: Registry
    tracer: Tracer


_GLOBAL = Obs(registry=Registry(), tracer=Tracer(enabled=False))


def get_obs() -> Obs:
    """The process-wide observability bundle."""
    return _GLOBAL


def configure(registry: Optional[Registry] = None,
              tracer: Optional[Tracer] = None) -> Obs:
    """Swap in a new registry and/or tracer; returns the bundle."""
    if registry is not None:
        _GLOBAL.registry = registry
    if tracer is not None:
        _GLOBAL.tracer = tracer
    return _GLOBAL


def reset() -> Obs:
    """Fresh always-on registry, tracing back to off (test isolation)."""
    return configure(registry=Registry(), tracer=Tracer(enabled=False))


def count(name: str, n: float = 1.0) -> None:
    """One-liner for fire-and-forget counters in hot-ish call sites
    (kernel route picks)."""
    _GLOBAL.registry.counter(name).inc(n)
