"""SLO breach monitor: rolling-window latency percentiles vs targets
(counterpart of ``repro/obs/slo.py``).

Serving SLOs are tail-latency contracts — "p99 TTFT under X ms, p99 ITL
under Y ms".  The always-on histograms in :mod:`repro_torch.obs.metrics`
aggregate over the whole run, which hides *when* the tail blew up; this
monitor keeps a bounded rolling window per series, re-evaluates the
tail quantile on every observation, and on a breach:

* increments ``slo.<series>.breaches``;
* emits a trace instant (``slo.breach``, cat ``slo``) so the blow-up is
  visible in Perfetto next to whatever the engine was doing;
* flips the ``breached`` flag the scheduler's ``LatencyPolicy`` reads
  through the engine's admission signals (deferring admissions is the
  built-in reaction);
* invokes registered callbacks (the flight recorder dumps on these).

Breach semantics are strict-greater: a window whose p99 equals the
target is *meeting* the SLO; the first observation pushing it over
fires.  Targets of ``None`` disable checking for that series (the
window percentile gauges still export).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import NULL_TRACER, Tracer

DEFAULT_WINDOW = 256
DEFAULT_QUANTILE = 99.0


def window_percentile(xs, q: float) -> float:
    """Linear-interpolated percentile (numpy default) of a sequence."""
    if not 0 <= q <= 100:
        raise ValueError(f"percentile {q} outside [0, 100]")
    ordered = sorted(xs)
    if not ordered:
        return float("nan")
    pos = (len(ordered) - 1) * q / 100.0
    lo = int(pos)
    frac = pos - lo
    if lo + 1 >= len(ordered):
        return ordered[-1]
    return ordered[lo] * (1 - frac) + ordered[lo + 1] * frac


class _Series:
    """One monitored latency series: bounded window + breach state."""

    __slots__ = ("name", "target_ms", "window", "breaches", "last_q")

    def __init__(self, name: str, target_ms: Optional[float],
                 window_size: int):
        self.name = name
        self.target_ms = target_ms
        self.window: Deque[float] = deque(maxlen=window_size)
        self.breaches = 0
        self.last_q = float("nan")


class SLOMonitor:
    """Rolling-window p99 TTFT/ITL vs configurable targets.

    >>> mon = SLOMonitor(Registry(), itl_target_ms=10.0, window=4)
    >>> for v in (1.0, 2.0, 3.0): _ = mon.observe_itl(v)
    >>> mon.breaches("itl")
    0
    >>> _ = mon.observe_itl(500.0)   # window p99 now > 10 ms
    >>> mon.breaches("itl")
    1
    """

    def __init__(self, registry: Registry, tracer: Optional[Tracer] = None,
                 ttft_target_ms: Optional[float] = None,
                 itl_target_ms: Optional[float] = None,
                 window: int = DEFAULT_WINDOW,
                 quantile: float = DEFAULT_QUANTILE):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.registry = registry
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.quantile = quantile
        self._series: Dict[str, _Series] = {
            "ttft": _Series("ttft", ttft_target_ms, window),
            "itl": _Series("itl", itl_target_ms, window),
        }
        self._counters = {
            name: registry.counter(f"slo.{name}.breaches",
                                   f"rolling-window p{quantile:g} "
                                   f"{name} exceeded its target")
            for name in self._series
        }
        self._gauges = {
            name: registry.gauge(f"slo.{name}.window_p{quantile:g}_ms",
                                 f"rolling-window {name} percentile")
            for name in self._series
        }
        self._on_breach: List[Callable[[str, float, float], None]] = []

    _KEEP = object()

    def set_targets(self, ttft_ms: object = _KEEP,
                    itl_ms: object = _KEEP) -> None:
        """Retarget live series (``None`` disables a series; omitted
        arguments keep their current target) — the launcher seam for
        ``--slo-ttft-ms`` / ``--slo-itl-ms``."""
        if ttft_ms is not SLOMonitor._KEEP:
            self._series["ttft"].target_ms = \
                None if ttft_ms is None else float(ttft_ms)  # type: ignore[arg-type]
        if itl_ms is not SLOMonitor._KEEP:
            self._series["itl"].target_ms = \
                None if itl_ms is None else float(itl_ms)  # type: ignore[arg-type]

    def on_breach(self, fn: Callable[[str, float, float], None]) -> None:
        """Register ``fn(series, window_pq_ms, target_ms)`` to run on
        every breach (flight-recorder trip point)."""
        self._on_breach.append(fn)

    # -- observation --------------------------------------------------------

    def observe_ttft(self, ms: float) -> bool:
        return self._observe("ttft", ms)

    def observe_itl(self, ms: float) -> bool:
        return self._observe("itl", ms)

    def _observe(self, name: str, ms: float) -> bool:
        s = self._series[name]
        s.window.append(float(ms))
        q = window_percentile(s.window, self.quantile)
        s.last_q = q
        self._gauges[name].set(q)
        if s.target_ms is None or not q > s.target_ms:
            return False
        s.breaches += 1
        self._counters[name].inc()
        self.tracer.instant("slo.breach", cat="slo", series=name,
                            window_pq_ms=q, target_ms=s.target_ms)
        for fn in self._on_breach:
            fn(name, q, s.target_ms)
        return True

    # -- introspection ------------------------------------------------------

    def breaches(self, name: Optional[str] = None) -> int:
        if name is not None:
            return self._series[name].breaches
        return sum(s.breaches for s in self._series.values())

    def window_quantile(self, name: str) -> float:
        return self._series[name].last_q

    def signals(self) -> Dict[str, object]:
        """Admission-signal fragment for the scheduler's policies."""
        out: Dict[str, object] = {"slo_breached": False}
        for name, s in self._series.items():
            out[f"slo_{name}_p{self.quantile:g}_ms"] = s.last_q
            if (s.target_ms is not None and s.last_q == s.last_q
                    and s.last_q > s.target_ms):
                out["slo_breached"] = True
        return out

    def summary(self) -> Dict[str, object]:
        return {
            name: {"target_ms": s.target_ms, "breaches": s.breaches,
                   f"window_p{self.quantile:g}_ms": s.last_q,
                   "window_len": len(s.window)}
            for name, s in self._series.items()
        }
