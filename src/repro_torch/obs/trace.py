"""Span tracer with a Chrome-trace-event (Perfetto-loadable) exporter
(counterpart of ``repro/obs/trace.py``).

Three event families, matching the Trace Event Format that
``chrome://tracing`` and https://ui.perfetto.dev consume directly:

* **sync spans** (``ph: "X"`` complete events) — nested host-side
  phases inside one engine step (``engine.step`` > ``admit`` >
  ``prefill`` > ``decode``).  Opened with :meth:`Tracer.span`, which
  enforces LIFO nesting by construction (it is a context manager).
* **async spans** (``ph: "b"``/``"e"`` pairs keyed by ``(cat, id)``) —
  per-request lifecycle phases (``queued`` → ``prefill`` → ``decode``)
  that overlap arbitrarily across requests and engine steps.
* **instants and counters** (``ph: "i"`` / ``"C"``) — point events
  (preemption, EOS) and time series (pages in use over the trace).

``Tracer(enabled=False)`` — the process default — is a zero-cost no-op:
``span()`` returns one shared null context manager and every other
method returns immediately, so uninstrumented serving pays a single
attribute check per call site.

>>> tr = Tracer()
>>> with tr.span("step", step=0):
...     with tr.span("decode"):
...         pass
>>> tr.async_begin("request", 7, phase="queued")
>>> tr.async_end("request", 7)
>>> evs = tr.chrome_trace()["traceEvents"]
>>> sorted({e["ph"] for e in evs})
['X', 'b', 'e']
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Reusable no-op context manager (the disabled-tracer span)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    """One open sync span; records an ``X`` event when it closes."""

    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self.tracer, self.name, self.cat, self.args = tracer, name, cat, args
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        self.tracer._stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        now = time.perf_counter()
        top = self.tracer._stack.pop()
        assert top is self, (
            f"span {self.name!r} closed while {top.name!r} is open — "
            f"sync spans must nest LIFO")
        ev: Dict[str, Any] = {
            "name": self.name, "ph": "X", "pid": 0, "tid": 0,
            "ts": self.tracer._us(self.t0),
            "dur": max(0.0, (now - self.t0) * 1e6),
        }
        if self.cat:
            ev["cat"] = self.cat
        if self.args:
            ev["args"] = self.args
        self.tracer._events.append(ev)


class Tracer:
    """Event recorder; export with :meth:`chrome_trace` / :meth:`write`."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._epoch = time.perf_counter()
        self._events: List[Dict[str, Any]] = []
        self._stack: List[_Span] = []
        self._open_async: Dict[tuple, int] = {}   # (cat, id) -> open count

    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _now_us(self) -> float:
        return self._us(time.perf_counter())

    # -- recording ----------------------------------------------------------

    def span(self, name: str, cat: str = "", **args):
        """Context manager timing one nested host-side phase."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        if not self.enabled:
            return
        ev: Dict[str, Any] = {"name": name, "ph": "i", "s": "p",
                              "pid": 0, "tid": 0, "ts": self._now_us()}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, **values: float) -> None:
        """A ``C`` time-series sample (one track per value key)."""
        if not self.enabled:
            return
        self._events.append({"name": name, "ph": "C", "pid": 0,
                             "ts": self._now_us(),
                             "args": {k: float(v)
                                      for k, v in values.items()}})

    def metadata(self, name: str, /, pid: int = 0, tid: int = 0,
                 **args: Any) -> None:
        """A ``M`` metadata event (``process_name`` / ``thread_name`` …)
        naming a pid/tid lane in the Perfetto UI.  Emitted with ``ts`` 0
        so it sorts ahead of the events it labels."""
        if not self.enabled:
            return
        self._events.append({"name": name, "ph": "M", "pid": pid,
                             "tid": tid, "ts": 0.0, "args": args})

    def process_name(self, label: str, pid: int = 0) -> None:
        self.metadata("process_name", pid=pid, name=label)

    def thread_name(self, label: str, tid: int = 0, pid: int = 0) -> None:
        self.metadata("thread_name", pid=pid, tid=tid, name=label)

    _FLOW_PH = {"start": "s", "step": "t", "end": "f"}

    def flow(self, name: str, id: Any, phase: str = "step",
             cat: str = "flow", **args: Any) -> None:
        """A flow-event arrow (``s``/``t``/``f``) on the ``(cat, id)``
        flow track.  Linking one request's per-step spans with
        ``start`` → ``step``… → ``end`` draws a per-request lane across
        engine steps in Perfetto."""
        if not self.enabled:
            return
        ph = self._FLOW_PH.get(phase)
        if ph is None:
            raise ValueError(f"flow phase {phase!r} not in "
                             f"{sorted(self._FLOW_PH)}")
        ev: Dict[str, Any] = {"name": name, "ph": ph, "cat": cat,
                              "id": str(id), "pid": 0, "tid": 0,
                              "ts": self._now_us()}
        if ph == "f":
            ev["bp"] = "e"   # bind to the enclosing slice's end
        if args:
            ev["args"] = args
        self._events.append(ev)

    def async_begin(self, name: str, id: Any, cat: str = "req",
                    **args) -> None:
        """Open one async span of ``name`` on the ``(cat, id)`` track."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {"name": name, "ph": "b", "cat": cat,
                              "id": str(id), "pid": 0, "tid": 0,
                              "ts": self._now_us()}
        if args:
            ev["args"] = args
        self._events.append(ev)
        self._open_async[(cat, str(id))] = \
            self._open_async.get((cat, str(id)), 0) + 1

    def async_end(self, name: str, id: Any, cat: str = "req",
                  **args) -> None:
        if not self.enabled:
            return
        key = (cat, str(id))
        open_n = self._open_async.get(key, 0)
        if open_n <= 0:
            raise ValueError(f"async_end({name!r}, id={id!r}, cat={cat!r}) "
                             f"with no open span on that track")
        self._open_async[key] = open_n - 1
        ev: Dict[str, Any] = {"name": name, "ph": "e", "cat": cat,
                              "id": str(id), "pid": 0, "tid": 0,
                              "ts": self._now_us()}
        if args:
            ev["args"] = args
        self._events.append(ev)

    # -- introspection ------------------------------------------------------

    def open_spans(self) -> List[str]:
        """Names of sync spans currently open (outermost first)."""
        return [s.name for s in self._stack]

    def open_async_tracks(self) -> Dict[tuple, int]:
        """(cat, id) tracks with unclosed async spans."""
        return {k: n for k, n in self._open_async.items() if n > 0}

    def clear(self) -> None:
        self._events.clear()
        self._open_async.clear()

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """The Trace Event Format document (JSON Object Format flavour,
        which both ``chrome://tracing`` and Perfetto load)."""
        events = sorted(self._events, key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


NULL_TRACER = Tracer(enabled=False)


def validate_chrome_trace(doc: Dict[str, Any]) -> None:
    """Structural check of an exported trace: required keys per phase,
    non-negative durations, and balanced async ``b``/``e`` pairs per
    ``(cat, id, name)`` track with ends never preceding begins.  Raises
    ``ValueError`` — used by tests and the CI artifact check."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a chrome trace: missing 'traceEvents'")
    opens: Dict[tuple, int] = {}
    for ev in doc["traceEvents"]:
        ph = ev.get("ph")
        if ph == "M":
            # Metadata events label lanes; ts is optional per the format.
            if "name" not in ev:
                raise ValueError(f"metadata event missing name: {ev}")
            continue
        if "name" not in ev or "ts" not in ev:
            raise ValueError(f"event missing name/ts: {ev}")
        if ph == "X":
            if ev.get("dur", -1) < 0:
                raise ValueError(f"negative duration: {ev}")
        elif ph in ("b", "e"):
            if "id" not in ev or "cat" not in ev:
                raise ValueError(f"async event missing id/cat: {ev}")
            key = (ev["cat"], ev["id"], ev["name"])
            n = opens.get(key, 0) + (1 if ph == "b" else -1)
            if n < 0:
                raise ValueError(f"async end before begin on {key}")
            opens[key] = n
        elif ph in ("s", "t", "f"):
            if "id" not in ev:
                raise ValueError(f"flow event missing id: {ev}")
        elif ph in ("i", "C"):
            pass
        else:
            raise ValueError(f"unknown phase {ph!r}: {ev}")
    dangling = {k for k, n in opens.items() if n != 0}
    if dangling:
        raise ValueError(f"unclosed async spans: {sorted(dangling)}")
