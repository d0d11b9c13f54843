"""Continuous-batching serving engine: a dense or paged KV cache + scheduler
(the dense and paged subset of ``repro/serving/engine.py``).

One persistent KV-cache allocation lives for the engine's lifetime.  A
:class:`~repro_torch.serving.scheduler.Scheduler` admits queued requests
into free slots *mid-decode*: an admission is prefilled into its slot (one
request at a time, its prompt padded to a power-of-two bucket, against a
fresh single-slot dense cache that is then copied into the persistent
cache in place) and joins the very next batched decode step alongside
every older in-flight request.

``ServeConfig(kv="dense")`` reserves ``batch_slots`` rows of ``max_len``.
``kv="paged"`` swaps that for the ``repro_torch.serving.kvpool`` page pool:
prefill scatters the prompt's pages into the pool along the slot's block
table, decode appends rows (allocating pages on demand and preempting the
youngest admission when the pool is exhausted; the victim is requeued at
the head and regenerated), and completion, EOS and cancellation return a
request's pages the same step.  ``kv_dtype="int8"`` stores quantized pages
with per-row scales (``serving.quant``).

API: :meth:`ServeEngine.submit` queues a request (optionally with a
streaming per-token callback), :meth:`step` runs one engine step
(admissions + one batched decode), :meth:`cancel` drops a request,
:meth:`drain` steps until idle and returns finished outputs, and the
one-shot :meth:`generate` admits a uniform batch at step 0.

The engine runs on the device its parameters live on.  The reference's
chunked prefill, prefix cache, weight-only quantization, pack mesh and
tuner-resolved sizes raise ``NotImplementedError`` naming the ROADMAP item
that brings them; none of them falls back to another path.  The ``obs``
hooks (tracer spans, step profiler, SLO monitor, flight recorder) wait
for ROADMAP Queue A item 8.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import (decode_step, forward, init_cache,
                                init_paged_cache)
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.serving.kvpool import BlockTables, PagePool, pages_for
from repro_torch.serving.quant import KV_PAGE_DTYPES, quantize_kv_row
from repro_torch.serving.scheduler import DECODE, Request, Scheduler, Slot


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8      # KV-cache slots (0 = tuner: not ported yet)
    max_len: int = 1024
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0             # torch.Generator seed for sampled decoding
    eos_id: Optional[int] = None  # sampled EOS ends the request early
    # KV layout: "dense" per-slot max_len rows, or "paged" (kvpool).
    kv: str = "dense"
    # Paged only: tokens per page (None or 0 asks the tuner, which is not
    # ported: both raise), pool capacity in pages (0 = the dense-equivalent
    # slots * ceil(max_len / page_size)), and the page dtype (None keeps
    # cfg.cache_dtype; "int8" adds per-row scales).
    page_size: Optional[int] = None
    pool_pages: int = 0
    kv_dtype: Optional[str] = None
    # Options of the reference that later slices bring; each non-default
    # value raises NotImplementedError (see _UNSUPPORTED).
    quantize: bool = False
    prefix_cache: bool = False
    prefill_chunk: Optional[int] = 0  # None asks the tuner
    token_budget: int = 0     # read by the latency policy's signals
    policy: Any = "fifo"      # a scheduler Policy name or instance
    pack_mesh: Any = None


# (field, predicate on the value that the port cannot serve yet, the
# ROADMAP item that brings it).
_UNSUPPORTED = (
    ("page_size", lambda v: v == 0,
     "the tuner-resolved page size of paged KV (ROADMAP Queue A items 6.2 "
     "and 9)"),
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
        if scfg.kv not in ("dense", "paged"):
            raise ValueError(f"ServeConfig.kv must be 'dense' or 'paged', "
                             f"got {scfg.kv!r}")
        if scfg.kv_dtype is not None:
            if scfg.kv_dtype not in KV_PAGE_DTYPES:
                raise ValueError(f"ServeConfig.kv_dtype must be one of "
                                 f"{KV_PAGE_DTYPES}, got {scfg.kv_dtype!r}")
            if scfg.kv != "paged":
                raise ValueError(
                    f"ServeConfig.kv_dtype={scfg.kv_dtype!r} requires "
                    f"kv='paged' — the dense layout has no page pool to "
                    f"retype (got kv={scfg.kv!r})")
        if scfg.kv == "paged" and scfg.page_size is None:
            raise NotImplementedError(
                "ServeConfig.page_size=None with kv='paged' asks the tuner "
                "for a page size, which is not ported yet: it comes with "
                "ROADMAP Queue A item 9 (pass a page size)")
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
        self.paged = scfg.kv == "paged"
        if self.paged:
            ps = scfg.page_size
            self._max_pages = pages_for(scfg.max_len, ps)
            self.pool = PagePool(
                scfg.pool_pages or scfg.batch_slots * self._max_pages, ps)
            self.blocks = BlockTables(self.pool, scfg.batch_slots,
                                      self._max_pages)
            # The dense scratch each prefill runs against is page-aligned,
            # so whole pages scatter into the pool.
            self._fresh_len = self._max_pages * ps
        else:
            self.pool = self.blocks = None
            self._fresh_len = scfg.max_len
        self._slot_req: Dict[int, Request] = {}  # slot -> its request
        self._streamed: Dict[int, int] = {}       # rid -> tokens streamed
        self._kv_tokens_hwm = 0
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
                      "eos_exits": 0, "cancelled": 0, "preemptions": 0}

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

    def new_cache(self) -> List:
        """The persistent cache: page pools (paged) or ``batch_slots`` rows
        of ``max_len`` (dense)."""
        if self.paged:
            return init_paged_cache(self.cfg, self.pool.num_pages,
                                    self.pool.page_size,
                                    kv_dtype=self.scfg.kv_dtype,
                                    device=self.device)
        return init_cache(self.cfg, self.scfg.batch_slots,
                          self.scfg.max_len, self.device)

    # -- KV memory accounting ------------------------------------------------

    def token_kv_bytes(self) -> int:
        """Bytes of attention KV one token occupies across the stack (k and
        v, every layer), at the page dtype; an int8 row also carries its
        f32 scale, so it costs D + 4 bytes per KV head."""
        cfg = self.cfg
        kv_dtype = self.scfg.kv_dtype if self.paged else None
        row = cfg.d_head * (1 if kv_dtype == "int8" else torch_dtype(
            kv_dtype or cfg.cache_dtype).itemsize)
        if kv_dtype == "int8":
            row += 4
        return 2 * cfg.n_layers * cfg.n_kv_heads * row

    def kv_bytes_reserved(self) -> int:
        """Attention-KV bytes held for the engine's lifetime: the page pool
        (paged) or slots x max_len rows (dense)."""
        if self.paged:
            rows = self.pool.num_pages * self.pool.page_size
        else:
            rows = self.scfg.batch_slots * self.scfg.max_len
        return rows * self.token_kv_bytes()

    def kv_bytes_high_water(self) -> int:
        """Peak attention-KV bytes bound to live requests: the pool's
        ``pages_in_use`` high-water x page bytes (paged), or the live-token
        high-water x token bytes (dense)."""
        if self.paged:
            rows = self.pool.high_water * self.pool.page_size
        else:
            rows = self._kv_tokens_hwm
        return rows * self.token_kv_bytes()

    def _note_kv_tokens(self, live: int) -> None:
        self._kv_tokens_hwm = max(self._kv_tokens_hwm, live)

    def _insert_slot(self, one: List, slot: int) -> None:
        """Overwrite slot ``slot`` of the persistent cache with a freshly
        prefilled single-slot cache, in place.  Replacing the whole row is
        what makes slot reuse leak-free: nothing from the previous
        occupant survives."""
        for full, fresh in zip(self.caches, one):
            for key in ("k", "v"):
                full["attn"][key][slot].copy_(fresh["attn"][key][0])

    def _insert_slot_pages(self, one: List, slot: int) -> None:
        """Scatter a freshly prefilled single-slot dense cache into the page
        pools along the slot's block table, in place: the scratch's first
        pages go to the slot's pages, one page per pool row.  int8 pools
        quantize each token row on the way in and write its scale."""
        pages = self.blocks.slot_pages(slot)
        ids = torch.tensor(pages, dtype=torch.long, device=self.device)
        ps = self.pool.page_size
        for full, fresh in zip(self.caches, one):
            for key in ("k", "v"):
                dense = fresh["attn"][key][0, :, :len(pages) * ps]
                hkv, _, d = dense.shape
                rows = dense.reshape(hkv, len(pages), ps, d).transpose(0, 1)
                pool = full["attn"][f"{key}_pages"]
                if pool.dtype == torch.int8:
                    q, scale = quantize_kv_row(rows)
                    pool[ids] = q
                    full["attn"][f"{key}_scale"][ids] = scale
                else:
                    pool[ids] = rows.to(pool.dtype)

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
        if self.paged:
            need = pages_for(prompt.size + max_new, self.pool.page_size)
            if need > self.pool.num_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool has "
                    f"{self.pool.num_pages} — it could never run, even "
                    f"alone (raise ServeConfig.pool_pages)")
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
        prefilled and seeded with its first token); (paged) grow every
        active slot's block table for the row its next token writes,
        preempting the youngest admission while the pool is exhausted; run
        one batched decode over every active slot at per-slot positions;
        then a second admission pass so slots and pages freed this step
        (EOS, completion, cancel, preemption) are reused at once.  Returns
        the step's events: {admitted, decoded, finished, preempted,
        cancelled} request ids, per-request ``ttft_ms`` for first tokens,
        per-stream ``itl_ms`` gaps, and ``timings``."""
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
                                  "finished": [], "preempted": [],
                                  "cancelled": list(self._cancel_log),
                                  "ttft_ms": {}, "itl_ms": {}}
        self._cancel_log.clear()
        self._admit(events)
        admit_ms = (time.perf_counter() - t_step) * 1e3
        if self.paged:
            self._grow_pages(events)
        active = self.sched.active_slots()
        decode_ms = 0.0
        if active:
            pos = np.zeros((self.scfg.batch_slots,), np.int32)
            for s in self.sched.slots:
                # Inactive slots decode garbage into their own dead rows
                # (dense: replaced wholesale on re-admission; paged: the
                # null sink page); the clamp only guards the bound.
                pos[s.index] = min(s.length, self._fresh_len - 1)
            tables = (torch.from_numpy(self.blocks.table).to(self.device)
                      if self.paged else None)
            t_dec = time.perf_counter()
            logits, self.caches = decode_step(
                self.params, torch.from_numpy(self._tok).to(self.device),
                torch.from_numpy(pos).to(self.device), self.cfg, self.caches,
                block_tables=tables)
            toks = self._sample(logits).cpu().numpy()
            decode_ms = (time.perf_counter() - t_dec) * 1e3
            self.stats["decode_steps"] += 1
            if events["admitted"] and holdover:
                # A mid-stream admission shared this decode step with
                # older in-flight requests.
                self.stats["shared_steps"] += 1
            # Every active slot just wrote a row at position `length`.
            self._note_kv_tokens(sum(s.length + 1 for s in active))
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
        if events["finished"] or events["preempted"] or events["cancelled"]:
            self._admit(events)
        self.step_count += 1
        events["timings"] = {
            "admit_ms": admit_ms, "decode_ms": decode_ms,
            "step_ms": (time.perf_counter() - t_step) * 1e3,
        }
        return events

    def _admit(self, events: Dict[str, Any]) -> None:
        """Admission pass: prefill every admitted request into its slot
        without a host sync, then read the first tokens back.  Paged, a
        strict-FIFO gate admits a request only while the free pages cover
        its prompt and its first decode row, reserving cumulatively."""
        fits = None
        if self.paged:
            budget, ps = self.pool.free_pages, self.pool.page_size
            reserved = 0

            def fits(req: Request) -> bool:
                # +1: the first decode token writes KV at position
                # prompt_len, a fresh page for a page-aligned prompt;
                # admitting without it would prefill only to preempt
                # itself in _grow_pages the same step.
                nonlocal reserved
                need = pages_for(req.prompt_len + 1, ps)
                if reserved + need > budget:
                    return False
                reserved += need
                return True
        inflight = []
        for req in self.sched.pop_admissible(self.step_count, fits=fits):
            slot = self.sched.admit(req)
            if self.paged:
                pages = self.blocks.assign(slot.index, req.prompt_len)
                assert pages is not None, "admission fits() reserved these"
            self._slot_req[slot.index] = req
            inflight.append((slot, self._prefill_slot(slot, req)))
            self.stats["admitted"] += 1
            events["admitted"].append(req.rid)
        for slot, tok0 in inflight:
            tok = int(tok0)
            self._tok[slot.index] = tok
            self._emit(slot, tok, events)
        self._note_kv_tokens(sum(s.length for s in self.sched.active_slots()))

    def _prefill_slot(self, slot: Slot, req: Request) -> torch.Tensor:
        """Prefill one admission into its slot: pad the prompt to its
        bucket, run it against a *fresh* single-slot dense cache (zero KV —
        no leakage from the previous occupant), copy that cache into the
        slot's row (dense) or scatter its pages into the pool (paged), and
        return the first generated token (greedy from the prompt's
        last-position logits) as an unsynced device tensor."""
        plen = req.prompt_len
        bucket = _bucket_for(plen, self.scfg.max_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = req.prompt
        fresh = init_cache(self.cfg, 1, self._fresh_len, self.device)
        logits, fresh = forward(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            self.cfg, caches=fresh, cache_pos=0)
        if self.paged:
            self._insert_slot_pages(fresh, slot.index)
        else:
            self._insert_slot(fresh, slot.index)
        self.stats["prefills"] += 1
        slot.length = plen
        return torch.argmax(logits[0, plen - 1])

    def cancel(self, rid: int) -> bool:
        """Drop a request wherever it is — queued or mid-decode — freeing
        its slot (and, paged, its pages) the same step.  Partial output is
        discarded.  Safe from an ``on_token`` callback.  False when ``rid``
        is unknown or already finished."""
        self._check_open("cancel")
        req = self.sched.cancel(rid)
        self._streamed.pop(rid, None)
        if req is not None:                      # still queued
            self._runnable_at.pop(rid, None)
            self._on_token.pop(rid, None)
            self.stats["cancelled"] += 1
            self._cancel_log.append(rid)
            return True
        for slot in self.sched.slots:
            if slot.rid == rid and slot.state == DECODE:
                self._out.pop(rid, None)
                self._slot_req.pop(slot.index, None)
                if self.paged:
                    self.blocks.release(slot.index)
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
        n_out = slot.generated      # release() below resets the slot
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
            self._slot_req.pop(slot.index, None)
            if self.paged:
                # Pages return to the pool the step the request ends.
                self.blocks.release(slot.index)
            self.sched.release(slot)
        cb = (self._on_token.pop(rid, None) if done
              else self._on_token.get(rid))
        # A request regenerating after a preemption emits again the tokens
        # its stream already received (greedy: the same ones); the stream
        # gets each position once.
        if cb is not None and n_out > self._streamed.get(rid, 0):
            self._streamed[rid] = n_out
            cb(rid, int(tok), done)
        if done:
            self._streamed.pop(rid, None)

    # -- paged KV: growth and preemption ------------------------------------

    def _grow_pages(self, events: Dict[str, Any]) -> None:
        """Before a paged decode every active slot needs a table entry for
        the row its incoming token writes (position ``length``).  While the
        pool is exhausted the *youngest* admission (largest admit_seq) is
        preempted; oldest slots grow first, so the policy is deterministic
        and FIFO-fair (a victim is never older than the slot it yields
        to)."""
        for s in sorted(self.sched.active_slots(), key=lambda s: s.admit_seq):
            if s.state != DECODE:
                continue            # preempted by an earlier iteration
            while not self.blocks.extend_to(s.index, s.length + 1):
                victim = max(self.sched.active_slots(),
                             key=lambda v: v.admit_seq)
                self._preempt(victim, events)
                if victim is s:
                    break           # s yielded its own pages

    def _preempt(self, slot: Slot, events: Dict[str, Any]) -> None:
        """Evict a mid-decode request to reclaim its pages: its partial
        output is discarded and the request returns to the head of the
        queue (greedy decoding regenerates the identical stream)."""
        rid = slot.rid
        self._out.pop(rid, None)
        self._last_emit.pop(rid, None)
        self.blocks.release(slot.index)
        req = self._slot_req.pop(slot.index)
        self.sched.release(slot)
        self.sched.requeue(req)
        self.stats["preemptions"] += 1
        events["preempted"].append(rid)
        # The regenerated stream measures TTFT again from the eviction.
        self._runnable_at[rid] = time.perf_counter()

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
