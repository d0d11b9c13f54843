"""Continuous-batching serving engine: slot-based dense KV cache + scheduler
(the dense subset of ``repro/serving/engine.py``).

One persistent KV-cache allocation (``batch_slots`` rows of ``max_len``)
lives for the engine's lifetime.  A :class:`~repro_torch.serving.scheduler.
Scheduler` admits queued requests into free slots *mid-decode*: an
admission is prefilled into its slot (one request at a time, its prompt
padded to a power-of-two bucket, against a fresh single-slot cache that is
then copied into the slot's row in place) and joins the very next batched
decode step alongside every older in-flight request.

API: :meth:`ServeEngine.submit` queues a request (optionally with a
streaming per-token callback), :meth:`step` runs one engine step
(admissions + one batched decode), :meth:`cancel` drops a request,
:meth:`drain` steps until idle and returns finished outputs, and the
one-shot :meth:`generate` admits a uniform batch at step 0.

The engine runs on the device its parameters live on.  The reference's
paged KV, int8 pages, chunked prefill, prefix cache, weight-only
quantization, pack mesh and tuner-resolved sizes raise
``NotImplementedError`` naming the ROADMAP item that brings them; none of
them falls back to the dense path.  The ``obs`` hooks (tracer spans, step
profiler, SLO monitor, flight recorder) wait for ROADMAP Queue A item 8.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import decode_step, forward, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.serving.scheduler import DECODE, Request, Scheduler, Slot


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8      # KV-cache slots (0 = tuner: not ported yet)
    max_len: int = 1024
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0             # torch.Generator seed for sampled decoding
    eos_id: Optional[int] = None  # sampled EOS ends the request early
    # Options of the reference that later slices bring; each non-default
    # value raises NotImplementedError (see _UNSUPPORTED).
    quantize: bool = False
    kv: str = "dense"
    page_size: Optional[int] = None   # paged only; 0 asks the tuner
    kv_dtype: Optional[str] = None
    prefix_cache: bool = False
    prefill_chunk: Optional[int] = 0  # None asks the tuner
    token_budget: int = 0     # read by the latency policy's signals
    policy: Any = "fifo"      # a scheduler Policy name or instance
    pack_mesh: Any = None


# (field, predicate on the value that the port cannot serve yet, the
# ROADMAP item that brings it).
_UNSUPPORTED = (
    ("kv", lambda v: v != "dense",
     "paged KV + flash_paged_decode (ROADMAP Queue A item 6.2, Queue B 4)"),
    ("page_size", lambda v: v is not None,
     "paged KV and its tuner-resolved page size (ROADMAP Queue A items "
     "6.2 and 9)"),
    ("kv_dtype", lambda v: v is not None,
     "int8 KV pages (ROADMAP Queue A item 6.3)"),
    ("prefix_cache", bool, "prefix caching (ROADMAP Queue A item 6.5)"),
    ("prefill_chunk", lambda v: v != 0,
     "chunked prefill and its tuner-resolved chunk (ROADMAP Queue A items "
     "6.4 and 9)"),
    ("quantize", bool,
     "int8 weight-only quantization (ROADMAP Queue A item 3)"),
    ("pack_mesh", lambda v: v is not None,
     "the multi-device pack GEMM (ROADMAP Queue A item 12)"),
    ("batch_slots", lambda v: v == 0,
     "the tuner-resolved slot count (ROADMAP Queue A item 9)"),
)


def prefill_buckets(max_len: int, lo: int = 8) -> List[int]:
    """Power-of-two prompt buckets up to ``max_len``.  Per-slot prefill
    pads each prompt to its bucket, so prefill sees O(log max_len)
    distinct shapes, not one per prompt length.

    >>> prefill_buckets(64)
    [8, 16, 32, 64]
    >>> prefill_buckets(100)
    [8, 16, 32, 64, 100]
    """
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def _bucket_for(plen: int, max_len: int) -> int:
    for b in prefill_buckets(max_len):
        if plen <= b:
            return b
    raise ValueError(f"prompt of {plen} tokens exceeds max_len={max_len}")


class ServeEngine:
    """Continuous-batching engine over the port's kernels.

    ``ServeEngine(cfg, params, ServeConfig(...))`` serves on the device of
    ``params``.  :meth:`close` is idempotent; any serving call after it
    raises ``RuntimeError``, as in the reference.
    """

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig):
        for name, unsupported, item in _UNSUPPORTED:
            value = getattr(scfg, name)
            if unsupported(value):
                raise NotImplementedError(
                    f"ServeConfig.{name}={value!r} is not ported yet: it "
                    f"comes with {item}")
        if any(spec.mixer != "attn" for spec in cfg.pattern):
            raise NotImplementedError(
                f"arch {cfg.name!r}: recurrent mixers are served by a later "
                f"slice (ROADMAP Queue A item 10)")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.device = params["embed"]["table"].device
        self._closed = False
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)
        self.sched = Scheduler(scfg.batch_slots, policy=scfg.policy)
        self.sched.signals = self._admission_signals
        self.caches = None            # allocated at first step
        self.step_count = 0
        self._next_rid = 0
        self._tok = np.zeros((scfg.batch_slots,), np.int64)
        self._out: Dict[int, List[int]] = {}
        self._finished: Dict[int, np.ndarray] = {}
        self._runnable_at: Dict[int, float] = {}  # rid -> perf_counter stamp
        self._last_emit: Dict[int, float] = {}    # rid -> last token stamp
        self._on_token: Dict[int, Callable] = {}  # rid -> stream callback
        self._cancel_log: List[int] = []          # cancels since last step
        self.stats = {"admitted": 0, "finished": 0, "prefills": 0,
                      "decode_steps": 0, "shared_steps": 0,
                      "eos_exits": 0, "cancelled": 0}

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Mark the engine closed (idempotent)."""
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self, what: str) -> None:
        if self._closed:
            raise RuntimeError(
                f"ServeEngine.{what}() on a closed engine; create a new "
                f"engine instead")

    # -- helpers ------------------------------------------------------------

    def new_cache(self, batch: Optional[int] = None) -> List:
        return init_cache(self.cfg, batch or self.scfg.batch_slots,
                          self.scfg.max_len, self.device)

    def _insert_slot(self, one: List, slot: int) -> None:
        """Overwrite slot ``slot`` of the persistent cache with a freshly
        prefilled single-slot cache, in place.  Replacing the whole row is
        what makes slot reuse leak-free: nothing from the previous
        occupant survives."""
        for full, fresh in zip(self.caches, one):
            for key in ("k", "v"):
                full["attn"][key][slot].copy_(fresh["attn"][key][0])

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy: argmax, first index on ties (torch.argmax's rule, as
        jnp.argmax's).  Sampled: one categorical draw per row from the
        engine's generator — not the reference's ``jax.random`` stream, so
        only greedy output is held token for token against it."""
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def _admission_signals(self) -> Dict[str, Any]:
        """Load picture the scheduler policy decides from.  Without
        chunked prefill no slot holds pending prompt chunks, so the
        backlog is 0."""
        return {"token_budget": self.scfg.token_budget,
                "decode_tokens": len(self.sched.active_slots()),
                "prefill_backlog": 0}

    # -- continuous-batching API --------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int, *,
               arrival: Optional[int] = None,
               on_token: Optional[Callable[[int, int, bool], None]]
               = None) -> int:
        """Queue one request; returns its request id.  ``arrival`` (in
        engine steps) defaults to "now".  ``on_token(rid, token, done)``
        streams every emitted token the moment the step produces it and
        may call :meth:`cancel`."""
        self._check_open("submit")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.size + max_new > self.scfg.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds "
                f"max_len={self.scfg.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        arrival = self.step_count if arrival is None else int(arrival)
        self.sched.submit(Request(rid=rid, prompt_len=int(prompt.size),
                                  max_new=int(max_new), arrival=arrival,
                                  prompt=prompt))
        if on_token is not None:
            self._on_token[rid] = on_token
        if arrival <= self.step_count:
            # TTFT clock starts the moment the request is runnable.
            self._runnable_at[rid] = time.perf_counter()
        return rid

    def step(self) -> Dict[str, Any]:
        """One engine step: admit arrived requests into free slots (each
        prefilled and seeded with its first token), run one batched decode
        over every active slot at per-slot positions, then a second
        admission pass so slots freed this step (EOS, completion, cancel)
        are reused at once.  Returns the step's events: {admitted,
        decoded, finished, cancelled} request ids, per-request ``ttft_ms``
        for first tokens, per-stream ``itl_ms`` gaps, and ``timings``."""
        self._check_open("step")
        if self.caches is None:
            self.caches = self.new_cache()
        t_step = time.perf_counter()
        for r in self.sched.queue:
            # Trace-replayed arrivals become runnable this step.
            if r.arrival <= self.step_count and r.rid not in self._runnable_at:
                self._runnable_at[r.rid] = t_step
        holdover = [s.rid for s in self.sched.active_slots()]
        events: Dict[str, Any] = {"admitted": [], "decoded": [],
                                  "finished": [],
                                  "cancelled": list(self._cancel_log),
                                  "ttft_ms": {}, "itl_ms": {}}
        self._cancel_log.clear()
        self._admit(events)
        admit_ms = (time.perf_counter() - t_step) * 1e3
        active = self.sched.active_slots()
        decode_ms = 0.0
        if active:
            pos = np.zeros((self.scfg.batch_slots,), np.int32)
            for s in self.sched.slots:
                # Inactive slots decode garbage into their own dead rows
                # (replaced wholesale on re-admission); the clamp only
                # guards the bound.
                pos[s.index] = min(s.length, self.scfg.max_len - 1)
            t_dec = time.perf_counter()
            logits, self.caches = decode_step(
                self.params, torch.from_numpy(self._tok).to(self.device),
                torch.from_numpy(pos).to(self.device), self.cfg, self.caches)
            toks = self._sample(logits).cpu().numpy()
            decode_ms = (time.perf_counter() - t_dec) * 1e3
            self.stats["decode_steps"] += 1
            if events["admitted"] and holdover:
                # A mid-stream admission shared this decode step with
                # older in-flight requests.
                self.stats["shared_steps"] += 1
            for s in active:
                if s.state != DECODE:
                    continue    # cancelled mid-step by a callback
                s.length += 1
                self._tok[s.index] = toks[s.index]
                events["decoded"].append(s.rid)
                self._emit(s, int(toks[s.index]), events)
        if self._cancel_log:
            events["cancelled"].extend(self._cancel_log)
            self._cancel_log.clear()
        if events["finished"] or events["cancelled"]:
            self._admit(events)
        self.step_count += 1
        events["timings"] = {
            "admit_ms": admit_ms, "decode_ms": decode_ms,
            "step_ms": (time.perf_counter() - t_step) * 1e3,
        }
        return events

    def _admit(self, events: Dict[str, Any]) -> None:
        """Admission pass: prefill every admitted request into its slot
        without a host sync, then read the first tokens back."""
        inflight = []
        for req in self.sched.pop_admissible(self.step_count):
            slot = self.sched.admit(req)
            inflight.append((slot, self._prefill_slot(slot, req)))
            self.stats["admitted"] += 1
            events["admitted"].append(req.rid)
        for slot, tok0 in inflight:
            tok = int(tok0)
            self._tok[slot.index] = tok
            self._emit(slot, tok, events)

    def _prefill_slot(self, slot: Slot, req: Request) -> torch.Tensor:
        """Prefill one admission into its slot: pad the prompt to its
        bucket, run it against a *fresh* single-slot cache (zero KV — no
        leakage from the previous occupant), copy that cache into the
        slot's row, and return the first generated token (greedy from the
        prompt's last-position logits) as an unsynced device tensor."""
        plen = req.prompt_len
        bucket = _bucket_for(plen, self.scfg.max_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = req.prompt
        fresh = self.new_cache(1)
        logits, fresh = forward(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            self.cfg, caches=fresh, cache_pos=0)
        self._insert_slot(fresh, slot.index)
        self.stats["prefills"] += 1
        slot.length = plen
        return torch.argmax(logits[0, plen - 1])

    def cancel(self, rid: int) -> bool:
        """Drop a request wherever it is — queued or mid-decode — freeing
        its slot the same step.  Partial output is discarded.  Safe from
        an ``on_token`` callback.  False when ``rid`` is unknown or
        already finished."""
        self._check_open("cancel")
        req = self.sched.cancel(rid)
        if req is not None:                      # still queued
            self._runnable_at.pop(rid, None)
            self._on_token.pop(rid, None)
            self.stats["cancelled"] += 1
            self._cancel_log.append(rid)
            return True
        for slot in self.sched.slots:
            if slot.rid == rid and slot.state == DECODE:
                self._out.pop(rid, None)
                self.sched.release(slot)
                self._runnable_at.pop(rid, None)
                self._last_emit.pop(rid, None)
                self._on_token.pop(rid, None)
                self.stats["cancelled"] += 1
                self._cancel_log.append(rid)
                return True
        return False

    def drain(self) -> Dict[int, np.ndarray]:
        """Step until the queue and all slots are empty; returns (and
        clears) every finished request's tokens, keyed by request id."""
        self._check_open("drain")
        while not self.sched.done():
            self.step()
        out, self._finished = self._finished, {}
        return out

    def result(self, rid: int) -> Optional[np.ndarray]:
        """Finished tokens for ``rid`` (None while still in flight)."""
        return self._finished.get(rid)

    def _emit(self, slot: Slot, tok: int, events: Dict[str, Any]) -> None:
        rid = slot.rid
        self._out.setdefault(rid, []).append(int(tok))
        slot.generated += 1
        now = time.perf_counter()
        t0 = self._runnable_at.pop(rid, None)
        if t0 is not None:
            # First token since the request became runnable: TTFT.
            events["ttft_ms"][rid] = (now - t0) * 1e3
        else:
            prev = self._last_emit.get(rid)
            if prev is not None:
                # Inter-token latency as the stream sees it: the wall gap
                # since this request's previous token.
                events["itl_ms"][rid] = (now - prev) * 1e3
        self._last_emit[rid] = now
        eos = (self.scfg.eos_id is not None
               and int(tok) == int(self.scfg.eos_id))
        if eos:
            self.stats["eos_exits"] += 1
        done = slot.generated >= slot.max_new or eos
        if done:
            self._finished[rid] = np.asarray(self._out.pop(rid), np.int32)
            self.stats["finished"] += 1
            events["finished"].append(rid)
            self._last_emit.pop(rid, None)
            self.sched.release(slot)
        cb = (self._on_token.pop(rid, None) if done
              else self._on_token.get(rid))
        if cb is not None:
            cb(rid, int(tok), done)

    # -- one-shot API (on the continuous loop) --------------------------------

    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """prompts: (B, S) with B == batch_slots; returns (B, max_new).

        All B requests are admitted at the same step and decode in
        lockstep.  With ``eos_id`` set, a row that exits early is
        right-padded with the eos token to ``max_new``."""
        self._check_open("generate")
        b = prompts.shape[0]
        if b != self.scfg.batch_slots:
            raise ValueError(f"generate() takes batch_slots="
                             f"{self.scfg.batch_slots} prompts, got {b}")
        if not self.sched.done():
            raise RuntimeError(
                "generate() needs an idle engine; drain() in-flight "
                "requests first (or use submit()/step() throughout)")
        rids = [self.submit(prompts[i], max_new) for i in range(b)]
        res = self.drain()
        rows = []
        for r in rids:
            row = res[r]
            if row.size < max_new:          # EOS early exit
                row = np.concatenate(
                    [row, np.full((max_new - row.size,), self.scfg.eos_id,
                                  np.int32)])
            rows.append(row)
        return np.stack(rows)
