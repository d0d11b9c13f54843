"""Flight recorder: bounded ring of recent step events + per-request
timelines, dumped to JSON when something goes wrong (counterpart of
``repro/obs/flight.py``).

Post-hoc debugging of a serving incident needs the *last few seconds of
context*, not a full trace: which steps ran, what each decomposed into,
which requests were in flight and what happened to them.  The recorder
keeps that context in fixed-size rings (never more than ``capacity``
step records, ``max_requests`` request timelines of ``max_events``
events each — old entries fall off) and serialises it on demand:

* a tripwire fires — SLO breach (wired via
  :meth:`SLOMonitor.on_breach`), a preemption storm
  (:meth:`note_preemption` sees too many preemptions inside one window
  of steps), or an engine error;
* or explicitly, via ``launch/serve.py --flight-out`` at end of run.

Every trip writes the same ``path`` (latest wins) so a crash always
leaves the freshest snapshot behind; ``dump()`` returns a plain-JSON
dict and round-trips losslessly through ``json``.
"""

from __future__ import annotations

import json
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, Optional

DEFAULT_CAPACITY = 256
DEFAULT_MAX_REQUESTS = 64
DEFAULT_MAX_EVENTS = 128
DEFAULT_STORM_PREEMPTIONS = 4
DEFAULT_STORM_WINDOW_STEPS = 16


class FlightRecorder:
    """Bounded in-memory recorder with JSON dumps.

    >>> fr = FlightRecorder(capacity=2)
    >>> for i in range(5): fr.record_step(i, wall_ms=1.0)
    >>> [r["step"] for r in fr.dump()["steps"]]
    [3, 4]
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_requests: int = DEFAULT_MAX_REQUESTS,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 storm_preemptions: int = DEFAULT_STORM_PREEMPTIONS,
                 storm_window_steps: int = DEFAULT_STORM_WINDOW_STEPS,
                 path: Optional[str] = None):
        if min(capacity, max_requests, max_events) < 1:
            raise ValueError("flight recorder bounds must be >= 1")
        self.capacity = capacity
        self.max_requests = max_requests
        self.max_events = max_events
        self.storm_preemptions = storm_preemptions
        self.storm_window_steps = storm_window_steps
        self.path = path
        self._t0 = time.perf_counter()
        self._steps: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._requests: "OrderedDict[str, Deque[Dict[str, Any]]]" = \
            OrderedDict()
        self._preempt_steps: Deque[int] = deque(maxlen=storm_preemptions)
        self.trips: Deque[Dict[str, Any]] = deque(maxlen=32)

    def _now_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    # -- recording ----------------------------------------------------------

    def record_step(self, step: int, **fields: Any) -> None:
        """One engine-step record (decomposition, counts — JSON scalars)."""
        rec = {"step": int(step), "t_ms": self._now_ms()}
        rec.update(fields)
        self._steps.append(rec)

    def record_request_event(self, rid: Any, event: str,
                             **fields: Any) -> None:
        """Append to one request's timeline (submitted, admitted, first
        token, preempted, finished, cancelled …)."""
        key = str(rid)
        timeline = self._requests.get(key)
        if timeline is None:
            while len(self._requests) >= self.max_requests:
                self._requests.popitem(last=False)
            timeline = self._requests[key] = deque(maxlen=self.max_events)
        ev = {"event": event, "t_ms": self._now_ms()}
        ev.update(fields)
        timeline.append(ev)

    def note_preemption(self, step: int, rid: Any = None) -> bool:
        """Record a preemption; returns True (and trips) when
        ``storm_preemptions`` of them landed within
        ``storm_window_steps`` engine steps — a preemption storm."""
        if rid is not None:
            self.record_request_event(rid, "preempted", step=int(step))
        self._preempt_steps.append(int(step))
        if (len(self._preempt_steps) == self.storm_preemptions
                and self._preempt_steps[-1] - self._preempt_steps[0]
                < self.storm_window_steps):
            self.trip("preemption_storm", step=int(step),
                      preempt_steps=list(self._preempt_steps))
            return True
        return False

    # -- dumping ------------------------------------------------------------

    def dump(self, reason: str = "manual") -> Dict[str, Any]:
        """The JSON-serialisable snapshot of everything retained."""
        return {
            "reason": reason,
            "capacity": self.capacity,
            "steps": list(self._steps),
            "requests": {rid: list(tl)
                         for rid, tl in self._requests.items()},
            "trips": list(self.trips),
        }

    def write(self, path: str, reason: str = "manual") -> Dict[str, Any]:
        doc = self.dump(reason)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc

    def trip(self, reason: str, **fields: Any) -> None:
        """A tripwire fired: log it and, when a ``path`` is configured,
        write the snapshot immediately (latest trip wins the file)."""
        rec = {"reason": reason, "t_ms": self._now_ms()}
        rec.update(fields)
        self.trips.append(rec)
        if self.path:
            self.write(self.path, reason=reason)

    def __len__(self) -> int:
        return len(self._steps)
