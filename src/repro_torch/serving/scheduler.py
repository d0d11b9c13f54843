"""Continuous-batching scheduler: a request queue over a fixed slot pool.

A copy of ``repro/serving/scheduler.py`` (the port imports nothing of the
JAX package).

The engine owns one persistent KV-cache allocation with
``batch_slots`` rows ("slots"); the scheduler decides which request
occupies which slot at every engine step.  This is the serving-side
analogue of the paper's staggered placement (Fig. 7): instead of
starting a whole batch together and idling finished rows until the
slowest one drains, requests are admitted the moment a slot frees up,
so every cache row stays busy.

Slot lifecycle::

    FREE ──admit()──► PREFILL ──(same step)──► DECODE ──release()──► FREE
      ▲       │                                   ▲                    │
      │       └─admit(state=PREFILLING)─► PREFILLING                   │
      │                  │   ▲        │  (chunked: prefill_pos         │
      │                  └───┘        │   advances one chunk/step)     │
      │              chunk scattered  └──────── last chunk ────────────┤
      └────────────────────── slot reused ◄────────────────────────────┘

``PREFILL`` is transient: the engine prefills an admission and joins it
to the very next decode step, so a newly admitted request *shares* that
step with every older in-flight request.  ``PREFILLING`` is the chunked
variant and *persists across steps*: the slot carries a prompt cursor
(``prefill_pos``) and joins decode only once the cursor reaches the
prompt end.  The scheduler is pure host bookkeeping — it never touches
a tensor — which keeps admission decisions off the device.

Admission is delegated to a :class:`Policy`.  ``fifo`` reproduces the
historical hardcoded scan bit-for-bit; ``latency`` defers admission
while the decode token budget is saturated (or the measured inter-token
p99 is above target), trading TTFT for in-flight stream latency.

>>> s = Scheduler(2)
>>> s.submit(Request(rid=0, prompt_len=4, max_new=2))
0
>>> s.submit(Request(rid=1, prompt_len=3, max_new=2, arrival=5))
1
>>> [r.rid for r in s.admissible(step=0)]   # rid 1 hasn't arrived yet
[0]
>>> slot = s.admit(s.pop_admissible(step=0)[0])
>>> (slot.index, slot.state, s.free_slots())
(0, 'decode', 1)
>>> s.release(slot); (slot.state, s.free_slots(), s.done())
('free', 2, False)
>>> s.pop_admissible(step=5)[0].rid and s.done()
True
>>> Scheduler(2, policy="latency").policy.name
'latency'
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

FREE = "free"
PREFILL = "prefill"
PREFILLING = "prefilling"   # chunked prefill in flight; prefill_pos < prompt
DECODE = "decode"


@dataclasses.dataclass
class Request:
    """One generation request.

    ``arrival`` is the earliest engine step at which the request may be
    admitted (trace replay measures arrival in decode steps so runs are
    deterministic; live serving would use wall clock).
    """

    rid: int
    prompt_len: int
    max_new: int
    arrival: int = 0
    prompt: Any = None          # (prompt_len,) int32, owned by the engine
    enc_embeds: Any = None      # (1, S_enc, d_model) for enc-dec archs


@dataclasses.dataclass
class Slot:
    """Per-slot state surviving across engine steps: which request the
    slot holds, how many KV rows of the persistent cache are valid
    (``length``), how many tokens it has produced, and — while chunked
    prefill is in flight — how far the prompt cursor has advanced."""

    index: int
    state: str = FREE
    rid: Optional[int] = None
    length: int = 0             # valid KV prefix in this slot's cache row
    generated: int = 0
    max_new: int = 0
    admit_seq: int = -1         # global admission order (preemption picks
                                # the youngest — the largest admit_seq)
    prefill_pos: int = 0        # prompt tokens already prefilled (chunked)


# -- admission policies ------------------------------------------------------


@dataclasses.dataclass
class AdmissionView:
    """Read-only picture a :class:`Policy` decides from: the arrived
    queue, the step counter, free-slot headroom, the engine's capacity
    gate, and engine-published load signals (token budget, in-flight
    decode tokens, measured inter-token p99, ...)."""

    queue: List[Request]
    step: int
    free_slots: int
    fits: Optional[Callable[[Request], bool]] = None
    signals: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Policy:
    """Admission policy protocol.  ``select`` returns the FIFO-ordered
    sublist of ``view.queue`` to admit this step; it must never reorder
    or invent requests — the scheduler pops exactly what it returns."""

    name = "base"

    def select(self, view: AdmissionView) -> List[Request]:
        raise NotImplementedError


class FifoPolicy(Policy):
    """The historical hardcoded scan, preserved bit-for-bit: arrived
    requests in submission order, capped by free slots, stopping at the
    first capacity rejection (strictly FIFO — a small later request can
    never starve a large earlier one)."""

    name = "fifo"

    def select(self, view: AdmissionView) -> List[Request]:
        out: List[Request] = []
        for r in view.queue:
            if r.arrival > view.step:
                continue
            if len(out) >= view.free_slots:
                break
            if view.fits is not None and not view.fits(r):
                break
            out.append(r)
        return out


class LatencyPolicy(FifoPolicy):
    """Defer admission while decode is saturated.  Three signals gate the
    FIFO scan wholesale (admitting nothing this step):

    - the step's token budget is already consumed by in-flight decode
      plus pending prefill chunks (``decode_tokens + prefill_backlog >=
      token_budget``), so a new prompt's chunks could only displace
      in-flight tokens; or
    - the measured ``serve.inter_token_ms`` p99 (``itl_p99_ms``) is
      above ``target_p99_ms`` (when set), i.e. streams are already
      missing their SLO; or
    - the engine's :class:`repro_torch.obs.slo.SLOMonitor` reports an
      active rolling-window breach (``slo_breached`` in the signals —
      armed by the launcher's ``--slo-ttft-ms`` / ``--slo-itl-ms``).

    Deferral trades time-to-first-token for inter-token latency of the
    streams already running; FIFO order among deferred requests is kept.
    """

    name = "latency"

    def __init__(self, target_p99_ms: Optional[float] = None):
        self.target_p99_ms = target_p99_ms

    def select(self, view: AdmissionView) -> List[Request]:
        sig = view.signals
        budget = int(sig.get("token_budget") or 0)
        if budget > 0:
            load = int(sig.get("decode_tokens") or 0) \
                + int(sig.get("prefill_backlog") or 0)
            if load >= budget:
                return []
        p99 = sig.get("itl_p99_ms")
        if (self.target_p99_ms is not None and p99 is not None
                and p99 > self.target_p99_ms):
            return []
        # The SLO monitor's rolling-window verdict: while the recent tail
        # is over target, new prompts' prefills would push the breached
        # streams further past their SLO.
        if sig.get("slo_breached"):
            return []
        return super().select(view)


def make_policy(policy: Union[str, Policy, None]) -> Policy:
    if policy is None or policy == "fifo":
        return FifoPolicy()
    if policy == "latency":
        return LatencyPolicy()
    if isinstance(policy, Policy):
        return policy
    raise ValueError(f"unknown scheduler policy {policy!r} "
                     "(have: 'fifo', 'latency')")


class Scheduler:
    """Policy-driven admission of queued requests into free slots.

    Requests become admissible once ``arrival <= step``; which arrived
    requests are admitted each step is the :class:`Policy`'s call (the
    default ``fifo`` admits in submission order — no starvation).
    """

    def __init__(self, n_slots: int,
                 policy: Union[str, Policy, None] = "fifo",
                 registry=None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.slots: List[Slot] = [Slot(index=i) for i in range(n_slots)]
        self.queue: List[Request] = []
        self.policy = make_policy(policy)
        # Engine-published load signals the policy reads (token budget,
        # decode tokens in flight, measured p99, ...).
        self.signals: Callable[[], Dict[str, Any]] = dict
        self._admit_seq = 0
        # Optional obs registry (repro_torch.obs.metrics.Registry); the
        # engine passes the process bundle's, direct constructions stay
        # silent.
        self._c_submitted = self._c_requeued = self._g_depth = None
        if registry is not None:
            self._c_submitted = registry.counter(
                "sched.submitted", "requests queued")
            self._c_requeued = registry.counter(
                "sched.requeued", "preempted requests returned to queue")
            self._g_depth = registry.gauge(
                "sched.queue_depth", "requests waiting for a slot")

    def _sample_depth(self) -> None:
        if self._g_depth is not None:
            self._g_depth.set(len(self.queue))

    # -- queue --------------------------------------------------------------

    def submit(self, req: Request) -> int:
        self.queue.append(req)
        if self._c_submitted is not None:
            self._c_submitted.inc()
        self._sample_depth()
        return req.rid

    def requeue(self, req: Request) -> None:
        """Return a *preempted* request to the head of the queue: it was
        admitted first among everything still waiting, and admitting it
        first again keeps preemption FIFO-fair (no later request can
        leapfrog a victim)."""
        self.queue.insert(0, req)
        if self._c_requeued is not None:
            self._c_requeued.inc()
        self._sample_depth()

    def cancel(self, rid: int) -> Optional[Request]:
        """Drop a still-queued request; returns it, or None if ``rid``
        is not waiting (already admitted, finished, or unknown)."""
        for r in self.queue:
            if r.rid == rid:
                self.queue.remove(r)
                self._sample_depth()
                return r
        return None

    def admissible(self, step: int,
                   fits: Optional[Callable[[Request], bool]] = None
                   ) -> List[Request]:
        """Requests the policy selects for admission this step (does
        not pop).  ``fits`` adds a capacity gate beyond slots (the
        paged engine passes a free-page check that reserves
        cumulatively)."""
        view = AdmissionView(queue=self.queue, step=step,
                             free_slots=self.free_slots(), fits=fits,
                             signals=self.signals())
        return self.policy.select(view)

    def pop_admissible(self, step: int,
                       fits: Optional[Callable[[Request], bool]] = None
                       ) -> List[Request]:
        """Remove and return the requests :meth:`admissible` selects."""
        picked = self.admissible(step, fits=fits)
        for r in picked:
            self.queue.remove(r)
        if picked:
            self._sample_depth()
        return picked

    # -- slots --------------------------------------------------------------

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s.state == FREE)

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.state == DECODE]

    def prefilling_slots(self) -> List[Slot]:
        """Slots mid chunked-prefill, oldest admission first."""
        return sorted((s for s in self.slots if s.state == PREFILLING),
                      key=lambda s: s.admit_seq)

    def admit(self, req: Request, state: str = DECODE) -> Slot:
        """Bind ``req`` to the lowest-index free slot.  By default the
        engine prefills it immediately, so the slot lands in DECODE
        state; chunked admission passes ``state=PREFILLING`` and the
        slot's prompt cursor starts at zero."""
        for slot in self.slots:
            if slot.state == FREE:
                slot.state = state
                slot.rid = req.rid
                slot.length = req.prompt_len if state == DECODE else 0
                slot.generated = 0
                slot.max_new = req.max_new
                slot.admit_seq = self._admit_seq
                slot.prefill_pos = 0
                self._admit_seq += 1
                return slot
        raise RuntimeError("admit() with no free slot — call "
                           "admissible() first")

    def release(self, slot: Slot) -> None:
        """Evict a finished (or cancelled/preempted) request; the slot's
        stale KV is left in place — re-admission overwrites the whole
        cache row and length masking hides anything beyond the new
        prefix."""
        slot.state = FREE
        slot.rid = None
        slot.generated = 0
        slot.max_new = 0
        slot.admit_seq = -1
        slot.prefill_pos = 0

    def done(self) -> bool:
        """True when nothing is queued and nothing is in flight."""
        return not self.queue and not self.active_slots() \
            and not any(s.state == PREFILLING for s in self.slots)
