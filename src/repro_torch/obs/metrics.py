"""Metrics core: counters, gauges, histograms behind one registry
(counterpart of ``repro/obs/metrics.py``; the port keeps its own copy).

The paper's headline numbers are *efficiency* figures (85% of int8
peak, 86% of bf16 peak) obtained by systematically measuring per-level
throughput and stalls; this module is the port's shared instrumentation
layer so those figures come from one place instead of ad-hoc inline
percentiles.

Three instrument kinds, all host-side and allocation-light:

* :class:`Counter` — monotonically increasing float (events, tokens,
  cache hits);
* :class:`Gauge` — last-set value plus a high-water mark (pages in use,
  queue depth);
* :class:`Histogram` — either **exact** mode (stores every observation;
  true percentiles — the default, right for the thousands-of-samples
  scale of a serve trace) or **fixed-bucket** mode (bounded memory,
  interpolated percentiles — right for unbounded streams).

A :class:`Registry` hands out instruments memoized by name and renders
them as a stable JSON snapshot (see :mod:`repro_torch.obs.export`) or
Prometheus text.  ``Registry(enabled=False)`` hands out shared no-op
instruments so an uninstrumented run pays one ``if`` per lookup and
nothing per observation.

>>> reg = Registry()
>>> reg.counter("demo.hits").inc()
>>> reg.gauge("demo.depth").set(3)
>>> h = reg.histogram("demo.lat_ms")
>>> for v in (1.0, 2.0, 3.0, 4.0): h.observe(v)
>>> h.percentile(50)
2.5
>>> sorted(reg.snapshot()["counters"])
['demo.hits']
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        self.value += n

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-set value; tracks its own high-water mark."""

    __slots__ = ("name", "help", "value", "high_water")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0
        self.high_water = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if self.value > self.high_water:
            self.high_water = self.value

    def add(self, delta: float) -> None:
        self.set(self.value + delta)

    def reset(self) -> None:
        self.value = 0.0
        self.high_water = 0.0


class Histogram:
    """Distribution of observations.

    ``buckets=None`` (default) keeps every sample — exact percentiles.
    With ``buckets`` (ascending upper bounds; +inf is implicit) only
    per-bucket counts are kept and percentiles are linearly interpolated
    inside the winning bucket, Prometheus-style.

    Exact mode is capped at ``max_samples`` retained observations
    (default ``DEFAULT_MAX_SAMPLES``): when the buffer would exceed the
    cap it is *deterministically decimated* — sorted, then every other
    order statistic kept (min and max always survive).  Each decimation
    halves memory and perturbs any percentile by at most one
    inter-sample gap, so long replays stay bounded while short runs
    (fewer than ``max_samples`` observations) remain bit-exact.
    ``count``/``sum``/``min``/``max`` are tracked separately and stay
    exact regardless.  ``max_samples=None`` disables the cap.

    >>> h = Histogram("x", buckets=[1.0, 10.0, 100.0])
    >>> for v in (0.5, 5.0, 5.0, 50.0): h.observe(v)
    >>> h.count, round(h.sum, 1)
    (4, 60.5)
    >>> 1.0 <= h.percentile(50) <= 10.0
    True
    """

    __slots__ = ("name", "help", "buckets", "counts", "count", "sum",
                 "min", "max", "max_samples", "_values")

    DEFAULT_MAX_SAMPLES = 65536

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 max_samples: Optional[int] = DEFAULT_MAX_SAMPLES):
        self.name, self.help = name, help
        if max_samples is not None and max_samples < 2:
            raise ValueError(f"histogram {name}: max_samples must be "
                             f">= 2, got {max_samples}")
        self.max_samples = max_samples
        if buckets is not None:
            b = [float(x) for x in buckets]
            if b != sorted(b) or len(set(b)) != len(b):
                raise ValueError(f"histogram {name}: buckets must be "
                                 f"strictly ascending, got {buckets}")
            self.buckets: Optional[List[float]] = b
            self.counts = [0] * (len(b) + 1)   # last = +inf overflow
        else:
            self.buckets = None
            self.counts = []
        self._values: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def exact(self) -> bool:
        return self.buckets is None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if self.buckets is None:
            self._values.append(v)
            if (self.max_samples is not None
                    and len(self._values) > self.max_samples):
                self._decimate()
        else:
            self.counts[bisect.bisect_left(self.buckets, v)] += 1

    def _decimate(self) -> None:
        """Halve the retained-sample buffer, keeping every other order
        statistic (plus the true max).  Deterministic — no RNG — so
        replays of the same trace produce the same percentiles."""
        xs = sorted(self._values)
        kept = xs[::2]
        if kept[-1] != xs[-1]:
            kept.append(xs[-1])
        self._values = kept

    def percentile(self, q: float) -> float:
        """q in [0, 100].  NaN when empty (callers report, not crash)."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile {q} outside [0, 100]")
        if self.count == 0:
            return math.nan
        if self.buckets is None:
            xs = sorted(self._values)
            # Linear interpolation between closest ranks (numpy default).
            pos = (len(xs) - 1) * q / 100.0
            lo = int(pos)
            frac = pos - lo
            if lo + 1 >= len(xs):
                return xs[-1]
            return xs[lo] * (1 - frac) + xs[lo + 1] * frac
        # Bucketed: find the bucket holding the target rank, interpolate
        # linearly inside it (lower bound = previous bucket's upper).
        rank = q / 100.0 * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.max)
                lo = self.buckets[i - 1] if i > 0 else min(self.min, hi)
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.max

    def reset(self) -> None:
        if self.buckets is not None:
            self.counts = [0] * (len(self.buckets) + 1)
        self._values = []
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": self.percentile(50) if self.count else None,
            "p90": self.percentile(90) if self.count else None,
            "p99": self.percentile(99) if self.count else None,
        }
        if self.buckets is not None:
            labels = [f"le_{b:g}" for b in self.buckets] + ["inf"]
            out["buckets"] = dict(zip(labels, self.counts))
        return out


class _NullCounter(Counter):
    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge(Gauge):
    def set(self, v: float) -> None:
        pass


class _NullHistogram(Histogram):
    def observe(self, v: float) -> None:
        pass


_NULL_COUNTER = _NullCounter("null")
_NULL_GAUGE = _NullGauge("null")
_NULL_HISTOGRAM = _NullHistogram("null")


def _prom_name(name: str) -> str:
    out = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
    return out if not out[:1].isdigit() else f"_{out}"


class Registry:
    """Name-keyed instrument factory + exporter.

    ``counter``/``gauge``/``histogram`` memoize by name, so call sites
    can re-request a handle instead of threading objects around.  A name
    registered as one kind cannot be re-registered as another.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def _claim(self, name: str, kind: str) -> None:
        for other, table in (("counter", self.counters),
                             ("gauge", self.gauges),
                             ("histogram", self.histograms)):
            if other != kind and name in table:
                raise ValueError(f"{name!r} already registered as "
                                 f"a {other}, requested as {kind}")

    def counter(self, name: str, help: str = "") -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self.counters.get(name)
        if c is None:
            self._claim(name, "counter")
            c = self.counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self.gauges.get(name)
        if g is None:
            self._claim(name, "gauge")
            g = self.gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  max_samples: Optional[int] = Histogram.DEFAULT_MAX_SAMPLES,
                  ) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        h = self.histograms.get(name)
        if h is None:
            self._claim(name, "histogram")
            h = self.histograms[name] = Histogram(name, help,
                                                  buckets=buckets,
                                                  max_samples=max_samples)
        return h

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()

    def reset_values(self) -> None:
        """Zero every instrument *in place*, keeping registrations (and
        any handles call sites already hold) alive.  This is the warmup
        seam: replay a trace once to compile everything, reset, then
        measure — without rebinding the engine's instrument handles."""
        for table in (self.counters, self.gauges, self.histograms):
            for inst in table.values():
                inst.reset()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """The stable JSON snapshot (schema in
        :mod:`repro_torch.obs.export`)."""
        from repro_torch.obs.export import SNAPSHOT_SCHEMA
        return {
            "schema": SNAPSHOT_SCHEMA,
            "counters": {n: c.value for n, c in self.counters.items()},
            "gauges": {n: {"value": g.value, "high_water": g.high_water}
                       for n, g in self.gauges.items()},
            "histograms": {n: h.summary()
                           for n, h in self.histograms.items()},
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition (histograms as summaries)."""
        lines: List[str] = []
        for n, c in sorted(self.counters.items()):
            pn = _prom_name(n)
            if c.help:
                lines.append(f"# HELP {pn} {c.help}")
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {c.value:g}")
        for n, g in sorted(self.gauges.items()):
            pn = _prom_name(n)
            if g.help:
                lines.append(f"# HELP {pn} {g.help}")
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {g.value:g}")
            lines.append(f"{pn}_high_water {g.high_water:g}")
        for n, h in sorted(self.histograms.items()):
            pn = _prom_name(n)
            if h.help:
                lines.append(f"# HELP {pn} {h.help}")
            lines.append(f"# TYPE {pn} summary")
            for q in (50, 90, 99):
                v = h.percentile(q) if h.count else math.nan
                lines.append(f'{pn}{{quantile="{q / 100:g}"}} {v:g}')
            lines.append(f"{pn}_sum {h.sum:g}")
            lines.append(f"{pn}_count {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")
