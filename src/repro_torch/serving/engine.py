"""Continuous-batching serving engine: a dense or paged KV cache, a
scheduler, chunked prefill under a per-step token budget and a prefix
cache (counterpart of ``repro/serving/engine.py``).

One persistent KV-cache allocation lives for the engine's lifetime.  A
:class:`~repro_torch.serving.scheduler.Scheduler` admits queued requests
into free slots *mid-decode*, and every admission joins a batched decode
step beside the older in-flight requests.

* **Monolithic prefill** (``prefill_chunk=0``, the default): an admission
  is prefilled whole, its prompt padded to a power-of-two bucket, against
  a fresh single-slot dense cache that is then copied into the slot's row
  (dense) or scattered into its pages (paged); it joins the very next
  decode.
* **Chunked prefill** (``prefill_chunk=N``): the prompt is cut into
  N-token chunks (paged: rounded up to a page multiple), and the slot sits
  in ``PREFILLING`` with a prompt cursor, its chunks running against its
  own dense scratch at the cursor's offset, in the same steps as every
  in-flight request's decode.  ``token_budget`` caps the tokens a step
  spends: decode takes one a slot first, chunks the rest (at least one
  chunk a step).  Greedy outputs are bit-identical to monolithic prefill:
  every op on the path computes a row independently of the rows beside it
  (the GEMM, attention and rmsnorm kernels by construction).
* **Recurrent archs** (RWKV-6) keep a fixed-size state per slot, so they
  bypass what only attention KV supports, as the reference does:
  ``kv="paged"`` serves the dense layout (``kv_mode`` says so), a page
  dtype is refused, prefill runs at the exact prompt length (a padded
  prompt would advance the state past it) and whole (no chunks, so no
  prefix cache either).
* ``kv="paged"`` swaps the dense ``slots x max_len`` reservation for the
  ``repro_torch.serving.kvpool`` page pool: pages are allocated on demand,
  the youngest admission is preempted when the pool is exhausted (and
  regenerated from the head of the queue), and completion, EOS and
  cancellation return pages the same step.  ``kv_dtype="int8"`` stores
  quantized pages with per-row scales (``serving.quant``).
* ``prefix_cache=True`` (paged only) maps each prompt's page-aligned
  prefix to resident pages through a radix tree behind per-page
  refcounts: admission charges only the unshared suffix, the chunk cursor
  starts at the first uncached page, and a write into a shared page
  copies it first.  Cached pages keep a sidecar of their scratch rows at
  full precision, so cached and uncached runs give the same tokens for
  every page dtype.

API: :meth:`ServeEngine.submit` queues a request (optionally with a
streaming per-token callback), :meth:`step` runs one engine step,
:meth:`cancel` drops a request wherever it is, :meth:`drain` steps until
idle and returns finished outputs, and the one-shot :meth:`generate`
admits a uniform batch at step 0.

The engine runs on the device its parameters live on.  ``batch_slots=0``,
``page_size=0`` (or None) with paged KV and ``prefill_chunk=None`` ask the
tuner (``repro_torch.tuning.dispatch.serve_*``: a measured entry of the
tuning cache, else the analytic 8 slots, pages of 32 and monolithic
prefill), as the reference does.  ``pretune`` resolves the kernel plan of
every GEMM shape the engine can issue before the first step (a cache hit
or the analytic plan; ``tuned_gemm_hits`` counts the hits), so a step's
lookups are memo hits.  ``quantize=True`` serves int8 weights
(``serving.quant``; ``quant_stats`` as the reference's).  An enc-dec
model (``enc_len`` > 0) takes each request's encoder input as
``submit(..., enc_embeds=)`` / ``generate(..., enc_embeds=)`` and keeps a
dense cross cache of ``enc_len`` rows a slot, so it bypasses the page
pool, chunked prefill and the prefix cache to dense and monolithic, as
the reference does.  The pack mesh raises ``NotImplementedError`` naming
the ROADMAP item that brings it; nothing falls back to another path.

Observability (``repro_torch.obs``) follows the reference series for
series and span for span: the engine instruments the process bundle's
registry (always on) and tracer (on when the entry point enables it),
splits each step's wall into the section probes and the host bubble
(:class:`~repro_torch.obs.profile.StepProfiler`), places the decode and
the prefill chunks on the card's roofline, watches rolling-window
TTFT/ITL against SLO targets and keeps a flight recorder that a breach or
a preemption storm trips.  On a card the section probes are CUDA event
pairs on the stream, read once a step after its last readback, so a
prefill chunk whose kernels are still queued when the host moves on is
charged to its own section.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import op_cost_model
from repro_torch.models import (decode_step, forward, init_cache,
                                init_paged_cache, paged_eligible,
                                prepare_params)
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.obs import FlightRecorder, SLOMonitor, StepProfiler, get_obs
from repro_torch.obs.efficiency import model_flops_per_token
from repro_torch.serving.kvpool import (BlockTables, PagePool, PrefixCache,
                                        pages_for)
from repro_torch.serving import quant
from repro_torch.serving.quant import KV_PAGE_DTYPES, quantize_kv_row
from repro_torch.serving.scheduler import (DECODE, PREFILLING, Request,
                                           Scheduler, Slot)
from repro_torch.tuning import dispatch


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8      # KV-cache slots; 0 = resolve from the tuner
    max_len: int = 1024
    enc_len: int = 0          # encoder length of enc-dec models
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0             # torch.Generator seed for sampled decoding
    quantize: bool = False    # int8 weight-only
    pretune: bool = True      # resolve every GEMM shape's plan at init
    eos_id: Optional[int] = None  # sampled EOS ends the request early
    # KV layout: "dense" per-slot max_len rows, or "paged" (kvpool).
    kv: str = "dense"
    # Paged only: tokens per page (None or 0 = resolve from the tuner),
    # pool capacity in pages (0 = the dense-equivalent slots *
    # ceil(max_len / page_size)), and the page dtype (None keeps
    # cfg.cache_dtype; "int8" adds per-row scales).
    page_size: Optional[int] = None
    pool_pages: int = 0
    kv_dtype: Optional[str] = None
    # Paged only: share page-aligned prompt prefixes through a radix tree
    # behind per-page refcounts, copy-on-write on shared writes.  Forces
    # the chunked path (prefill_chunk=0 then means one chunk over the
    # whole uncached suffix).
    prefix_cache: bool = False
    # 0 = monolithic prefill; N > 0 = N-token chunks (paged: rounded up to
    # a page multiple) interleaved with decode; None asks the tuner.
    prefill_chunk: Optional[int] = 0
    # Tokens a step may spend: decode takes one a slot first, prefill
    # chunks the rest, oldest admission first.  0 = unbudgeted: every
    # prefilling slot advances one chunk a step.
    token_budget: int = 0
    policy: Any = "fifo"      # a scheduler Policy name or instance
    # The multi-device pack GEMM and its options.
    pack_mesh: Any = None
    pack_data_axis: Optional[str] = None
    pack_min_flops: float = 2.0 * 1024 ** 3


# (field, predicate on the value that the port cannot serve yet, the
# ROADMAP item that brings it).
_UNSUPPORTED = (
    ("pack_mesh", lambda v: v is not None,
     "the multi-device pack GEMM (ROADMAP Queue A item 12)"),
    ("pack_data_axis", lambda v: v is not None,
     "the multi-device pack GEMM's data axis (ROADMAP Queue A item 12)"),
)


def model_gemm_shapes(cfg: ModelConfig, batch: int, seq: int,
                      include_decode: bool = True) -> List[tuple]:
    """The (M, K, N, dtype) GEMMs a forward pass issues, for warming the
    plan lookups (the reference's ``model_gemm_shapes`` over the port's
    projections, ``ModelConfig.gemm_shapes``, each in its site's
    ``ModelConfig.gemm_dtype``): prefill sees M = batch*seq tokens,
    decode M = batch (``include_decode=False`` keeps only the prefill
    block, used when warming per-slot prompt buckets).  GEMM sites of one
    pattern period of layers and the head, not unique shapes: k and v,
    and gate and up, are listed apart."""
    sites = [(k, n, cfg.gemm_dtype(name))
             for name, (k, n, c) in cfg.gemm_shapes().items()
             for _ in range(c if name == "lm_head" else c // cfg.n_groups)]
    return [(m, k, n, dt)
            for m in ((batch * seq, batch) if include_decode
                      else (batch * seq,))
            for k, n, dt in sites]


def _weights(tree: Any):
    """Every ``w`` and ``table`` tensor of a parameter tree."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            if key in ("w", "table") and isinstance(v, torch.Tensor):
                yield v
            else:
                yield from _weights(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _weights(v)


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


class _Sections:
    """One step's section probes: named spans whose sum is the step's
    device estimate.  On a CUDA device a span is two events recorded on
    the current stream and read only after the stream has passed them
    (:meth:`read`), so no probe stalls the host; on the CPU the work is
    synchronous and a span is a host-clock interval."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._spans: List[tuple] = []     # (name, start, end, payload)

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span(self, name: str, start, payload=None) -> None:
        """Close the span ``name`` opened by the mark ``start``."""
        self._spans.append((name, start, self.mark(), payload))

    def read(self, synced: bool) -> List[tuple]:
        """Every span as (name, ms, payload), in the order closed.  On a
        card the last event is waited for unless the caller has already
        synchronised the stream past it (``synced``)."""
        if self.cuda and self._spans and not synced:
            self._spans[-1][2].synchronize()
        out = []
        for name, start, end, payload in self._spans:
            ms = (start.elapsed_time(end) if self.cuda
                  else (end - start) * 1e3)
            out.append((name, ms, payload))
        self._spans.clear()
        return out


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
        if scfg.prefix_cache and scfg.kv != "paged":
            raise ValueError(
                f"ServeConfig.prefix_cache requires kv='paged' — the dense "
                f"layout has no page pool to share prefixes through (got "
                f"kv={scfg.kv!r})")
        if scfg.kv_dtype is not None and not paged_eligible(cfg):
            raise ValueError(
                f"arch {cfg.name!r} cannot honor kv_dtype="
                f"{scfg.kv_dtype!r}: its recurrent state / enc-dec cross "
                f"cache bypasses the page pool to the dense layout, which "
                f"would silently store full-precision KV.  Drop kv_dtype "
                f"(the bypass is only transparent for the default page "
                f"precision) or serve an attention-only arch")
        table = params["embed"]["table"]
        self.device = (table["q"] if quant.is_quantized(table)
                       else table).device
        device = self.device.index if self.device.type == "cuda" else -1
        self.quant_stats = None
        if scfg.quantize:
            params = self._quantized(cfg, params)
        # Paged KV needs every position in an attention page; a recurrent
        # state is fixed-size per slot and an enc-dec cross cache is
        # length-fixed, so such an arch keeps the dense layout (the
        # reference's engine.py:258-264): kv_mode is the live path.
        self.kv_mode = scfg.kv
        if scfg.kv == "paged" and not paged_eligible(cfg):
            self.kv_mode = "dense"
        # The tuner-resolved sizes (the reference's engine.py:249-300): a
        # measured entry of the tuning cache for this arch and max_len,
        # else the analytic 8 slots, pages of 32 and monolithic prefill.
        if scfg.batch_slots == 0:
            scfg = dataclasses.replace(scfg, batch_slots=dispatch.serve_slots(
                cfg, scfg.max_len, cfg.cdtype, device))
        if self.kv_mode == "paged" and not scfg.page_size:
            scfg = dataclasses.replace(scfg, page_size=dispatch.serve_page_size(
                cfg, scfg.max_len, cfg.cdtype, device))
        if scfg.prefill_chunk is None:
            scfg = dataclasses.replace(
                scfg, prefill_chunk=dispatch.serve_prefill_chunk(
                    cfg, scfg.max_len, cfg.cdtype, device))
        self.cfg, self.params, self.scfg = cfg, params, scfg
        # A recurrent mixer (and RWKV's channel mix) threads its state
        # through every token, pad or not: such archs prefill at the exact
        # prompt length, attention-only ones in power-of-two buckets.
        self._exact_prefill = any(spec.mixer != "attn" or spec.ffn ==
                                  "rwkv_cm" for spec in cfg.pattern)
        self._closed = False
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)
        self.caches = None            # allocated at first step
        self.paged = self.kv_mode == "paged"
        self.prefix = None
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
            if scfg.prefix_cache:
                self.prefix = PrefixCache(self.pool)
                # A pool shortfall evicts LRU cache-only pages before alloc
                # fails: cache eviction always precedes preemption.
                self.pool.reclaimer = self.prefix.evict
        else:
            self.pool = self.blocks = None
            self._fresh_len = scfg.max_len
        chunk = int(scfg.prefill_chunk)
        if chunk < 0:
            raise ValueError(f"ServeConfig.prefill_chunk must be >= 0 (or "
                             f"None = tuner), got {chunk}")
        if chunk and not paged_eligible(cfg):
            # A recurrent state cannot stop mid-prompt and resume, and a
            # cross cache is written once at full length: whole.
            chunk = 0
        if self.prefix is not None and chunk == 0:
            # A prefix hit moves the chunk cursor: with no chunk size, one
            # chunk covers the whole uncached suffix.
            chunk = self._fresh_len
        if chunk and self.paged:
            # Page-aligned chunks: each chunk's scatter writes whole pages.
            chunk = pages_for(chunk, scfg.page_size) * scfg.page_size
        self.prefill_chunk = min(chunk, self._fresh_len)
        self.tuned_gemm_hits = 0
        if scfg.pretune:
            # Resolve every GEMM shape's plan up front (a cache hit or the
            # analytic plan), so a step's lookups are memo hits.
            self.tuned_gemm_hits = dispatch.warm_gemm_shapes(
                self._all_gemm_shapes(), cfg.cdtype, device)
        self._init_obs()
        self.sched = Scheduler(scfg.batch_slots, policy=scfg.policy,
                               registry=self._obs.registry)
        # The policy reads the engine's live load picture (token budget,
        # decode tokens in flight, measured inter-token p99, SLO state).
        self.sched.signals = self._admission_signals
        self._slot_req: Dict[int, Request] = {}  # slot -> its request
        self._scratch: Dict[int, List] = {}       # slot -> chunk scratch
        self._streamed: Dict[int, int] = {}       # rid -> tokens streamed
        self._kv_tokens_hwm = 0
        self._prefix_hit_tokens = 0
        self._prefix_prompt_tokens = 0
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
                      "prefill_chunks": 0, "decode_steps": 0,
                      "shared_steps": 0, "preemptions": 0,
                      "eos_exits": 0, "cancelled": 0,
                      "starved_steps": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "prefix_prompt_tokens": 0,
                      "cow_copies": 0}

    def _init_obs(self) -> None:
        """Instrument against the process bundle (the reference's series,
        names and help texts): metrics always on, spans live only when the
        entry point enabled the tracer (``--trace-out``)."""
        obs = get_obs()
        self._obs = obs
        reg = obs.registry
        self._h_ttft = reg.histogram(
            "serve.ttft_ms", "runnable -> first token, per request")
        self._h_itl = reg.histogram(
            "serve.inter_token_ms",
            "per-stream gap between consecutive decode tokens "
            "(first tokens are TTFT, not ITL)")
        self._c_tokens = reg.counter("serve.tokens_out", "tokens emitted")
        self._c_chunks = reg.counter(
            "serve.prefill_chunks", "prompt chunks prefilled")
        self._c_starved = reg.counter(
            "serve.decode_starved_steps",
            "steps where in-flight streams stalled behind prefill work "
            "longer than the batched decode itself")
        self._c_rejects = reg.counter(
            "serve.admission_rejections",
            "arrived requests deferred by the paged fits() gate")
        self._g_active = reg.gauge("serve.active_slots", "slots mid-decode")
        self._g_kv_tokens = reg.gauge(
            "serve.kv_tokens", "KV rows bound to live requests")
        # Registered in both layouts so one snapshot schema covers dense
        # and paged runs (dense holds no pages: stays 0), as are the
        # prefix-cache series (stay 0 when the cache is off).
        reg.gauge("kvpool.pages_in_use", "KV pages currently allocated")
        self._c_plookup = reg.counter(
            "prefix.lookup", "prefix-cache lookups at admission")
        self._c_phit = reg.counter(
            "prefix.hit_tokens",
            "prompt tokens served from cached pages (never re-forwarded)")
        self._g_phit_rate = reg.gauge(
            "prefix.hit_rate",
            "cumulative hit_tokens / prompt tokens across admissions")
        if self.pool is not None:
            self.pool.bind_metrics(reg)
        # Step-time decomposition and the kernel roofline table, against
        # the model of the device the engine serves on.
        dtype_name = self.cfg.compute_dtype
        self._dtype_bytes = float(torch_dtype(dtype_name).itemsize)
        self.profiler = StepProfiler(reg, backend=self.device.type,
                                     dtype_name=dtype_name)
        # Rolling-window tail-latency monitor (targets off until the
        # launcher arms them), and the incident recorder its breaches and
        # preemption storms trip.
        self.slo = SLOMonitor(reg, tracer=obs.tracer)
        self.flight = FlightRecorder()
        self.slo.on_breach(
            lambda series, q, target: self.flight.trip(
                "slo_breach", series=series, window_ms=q,
                target_ms=target))
        self._kernel_costs: Dict[str, tuple] = {}  # op -> (flops, bytes)
        self._sections = _Sections(self.device)   # the step's probes
        if obs.tracer.enabled:
            obs.tracer.process_name("repro-serve")
            obs.tracer.thread_name("engine")

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

    def _quantized(self, cfg: ModelConfig, params: Any) -> Any:
        """``quantize=True``: the parameters with int8 weights, and
        ``quant_stats`` as the reference's ``quantize_params`` gives them
        for its f32 tree.  Parameters built with ``quantize=True``
        (``init_params``, ``bridge.params_from_numpy``) are served as
        they are.  Otherwise every weight to quantize must still be f32
        (an f32-compute config, or training's parameters): codes and
        scales taken from bf16 copies would differ from the reference's."""
        if not quant.is_quantized(params["embed"]["table"]):
            if any(w.dtype != torch.float32 for w in _weights(params)):
                raise ValueError(
                    "ServeConfig.quantize needs f32 weights to quantize "
                    "(as the reference quantizes its f32 parameters); "
                    "build them with init_params(..., quantize=True) or "
                    "bridge.params_from_numpy(..., quantize=True)")
            params = prepare_params(params, cfg, quantize=True)
        self.quant_stats = quant.weight_stats(params, len(cfg.pattern),
                                              cfg.pdtype.itemsize)
        return params

    def _all_gemm_shapes(self) -> List[tuple]:
        """(M, K, N, dtype) GEMMs the engine can issue: the uniform-batch
        shapes, every per-slot prefill bucket (M = bucket; not for
        exact-length prefill), chunked, M = chunk and, for an enc-dec
        model, the encoder's and the cross K/V projections' at M =
        ``enc_len`` (a full-length encoder input)."""
        shapes = model_gemm_shapes(self.cfg, self.scfg.batch_slots,
                                   self.scfg.max_len)
        if self.cfg.encoder_decoder and self.scfg.enc_len:
            decode = self.cfg.gemm_shapes()
            shapes += [(self.scfg.enc_len, k, n, self.cfg.gemm_dtype(name))
                       for name, (k, n, _) in
                       self.cfg.gemm_shapes("prefill").items()
                       if name not in decode]
        for bucket in (() if self._exact_prefill
                       else prefill_buckets(self.scfg.max_len)):
            shapes += model_gemm_shapes(self.cfg, 1, bucket,
                                        include_decode=False)
        if self.prefill_chunk:
            shapes += model_gemm_shapes(self.cfg, 1, self.prefill_chunk,
                                        include_decode=False)
        return shapes

    def new_cache(self) -> List:
        """The persistent cache: page pools (paged) or ``batch_slots`` rows
        of ``max_len`` (dense)."""
        if self.paged:
            return init_paged_cache(self.cfg, self.pool.num_pages,
                                    self.pool.page_size,
                                    kv_dtype=self.scfg.kv_dtype,
                                    device=self.device)
        return init_cache(self.cfg, self.scfg.batch_slots,
                          self.scfg.max_len, self.device,
                          enc_len=self.scfg.enc_len)

    # -- KV memory accounting ------------------------------------------------

    def token_kv_bytes(self) -> int:
        """Bytes of attention KV one token occupies across the stack (k and
        v, every attention layer: none for a Mamba or RWKV layer, whose
        state does not grow with the tokens), at the page dtype; an int8
        row also carries its f32 scale, so it costs D + 4 bytes per KV
        head."""
        cfg = self.cfg
        n_attn = sum(spec.mixer == "attn" for spec in cfg.pattern)
        kv_dtype = self.scfg.kv_dtype if self.paged else None
        row = cfg.d_head * (1 if kv_dtype == "int8" else torch_dtype(
            kv_dtype or cfg.cache_dtype).itemsize)
        if kv_dtype == "int8":
            row += 4
        return 2 * n_attn * cfg.n_groups * cfg.n_kv_heads * row

    def kv_bytes_reserved(self) -> int:
        """Attention-KV bytes held for the engine's lifetime: the page pool
        (paged) or slots x max_len rows (dense)."""
        if self.paged:
            rows = self.pool.num_pages * self.pool.page_size
        else:
            rows = self.scfg.batch_slots * self.scfg.max_len
        return rows * self.token_kv_bytes()

    def kv_bytes_high_water(self) -> int:
        """Peak attention-KV bytes bound to live requests: the pool's live
        high-water (pages a slot references; cache-only pages are idle) x
        page bytes (paged), or the live-token high-water x token bytes
        (dense)."""
        if self.paged:
            rows = self.pool.high_water * self.pool.page_size
        else:
            rows = self._kv_tokens_hwm
        return rows * self.token_kv_bytes()

    def _note_kv_tokens(self, live: int) -> None:
        """Record the live-token count (KV rows bound to active requests)
        into the gauge and the engine's own high-water."""
        self._kv_tokens_hwm = max(self._kv_tokens_hwm, live)
        self._g_kv_tokens.set(live)

    def _insert_slot(self, one: List, slot: int) -> None:
        """Overwrite slot ``slot`` of the persistent cache with a freshly
        prefilled single-slot cache, in place, layer by layer: KV, a
        Mamba layer's conv window and SSM state, or an RWKV layer's shifts
        and WKV state.  Replacing the whole row is what makes slot
        reuse leak-free: nothing from the previous occupant survives."""
        for full, fresh in zip(self.caches, one):
            for kind, leaves in fresh.items():
                for key, t in leaves.items():
                    full[kind][key][slot].copy_(t[0])

    def _insert_pages(self, one: List, pages: List[int], first: int) -> None:
        """Scatter pages ``first, first + 1, ...`` of a single-slot dense
        scratch into the pool pages ``pages``, every layer, in place.  int8
        pools quantize each token row on the way in and write its scale
        (per row, so a page's bits do not depend on the call that wrote
        it)."""
        ids = torch.tensor(pages, dtype=torch.long, device=self.device)
        ps = self.pool.page_size
        lo, hi = first * ps, (first + len(pages)) * ps
        for full, fresh in zip(self.caches, one):
            for key in ("k", "v"):
                dense = fresh["attn"][key][0, :, lo:hi]
                hkv, _, d = dense.shape
                rows = dense.reshape(hkv, len(pages), ps, d).transpose(0, 1)
                pool = full["attn"][f"{key}_pages"]
                if pool.dtype == torch.int8:
                    q, scale = quantize_kv_row(rows)
                    pool[ids] = q
                    full["attn"][f"{key}_scale"][ids] = scale
                else:
                    pool[ids] = rows.to(pool.dtype)

    def _insert_slot_pages(self, one: List, slot: int) -> None:
        """Scatter a freshly prefilled single-slot dense cache into the page
        pools along the slot's block table: the scratch's first pages go to
        the slot's pages."""
        self._insert_pages(one, self.blocks.slot_pages(slot), 0)

    def _insert_chunk_pages(self, one: List, slot: int, c0: int,
                            rows: int) -> None:
        """Scatter one prefill chunk's pages, scratch rows [c0, c0 + rows)
        (page-aligned), into the slot's pages that hold them: O(chunk)
        pages a call, not O(max_len)."""
        ps = self.pool.page_size
        p_lo = c0 // ps
        pages = self.blocks.slot_pages(slot)[p_lo:p_lo + rows // ps]
        self._insert_pages(one, pages, p_lo)

    # -- prefix cache (kvpool.PrefixCache) ----------------------------------

    def prefix_hit_rate(self) -> float:
        """Cumulative prefix-cache hit rate: cached prompt tokens over all
        prompt tokens admitted (0.0 when the cache is off)."""
        return self._prefix_hit_tokens / max(1, self._prefix_prompt_tokens)

    def _note_prefix(self, req: Request, hit_pages: int) -> None:
        """Account one admission's lookup, once per admission (not per
        fits() probe, so deferred requests do not skew the rate)."""
        hit = hit_pages * self.pool.page_size
        self._c_plookup.inc()
        self._prefix_prompt_tokens += req.prompt_len
        self.stats["prefix_prompt_tokens"] = self._prefix_prompt_tokens
        if hit:
            self._c_phit.inc(hit)
            self._prefix_hit_tokens += hit
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] = self._prefix_hit_tokens
        self._g_phit_rate.set(self.prefix_hit_rate())

    def _slice_prefix_page(self, scratch: List, page_idx: int) -> List:
        """One full page of a slot's dense-scratch KV rows, every layer: the
        radix node's sidecar, copied out at the scratch's dtype (whatever
        the page dtype), so a later hit restores exactly the rows this
        prefill computed and the scratch itself can be freed."""
        lo = page_idx * self.pool.page_size
        hi = lo + self.pool.page_size
        return [{k: lc["attn"][k][:, :, lo:hi].clone() for k in ("k", "v")}
                for lc in scratch]

    def _restore_prefix(self, scratch: List, payloads: List) -> None:
        """Write a hit's sidecar pages into a fresh scratch's leading rows,
        in place."""
        ps = self.pool.page_size
        for i, page in enumerate(payloads):
            for lc, rows in zip(scratch, page):
                for k in ("k", "v"):
                    lc["attn"][k][:, :, i * ps:(i + 1) * ps] = rows[k]

    def _cache_prefix(self, slot: Slot, req: Request) -> None:
        """At prefill completion, insert the prompt's full pages (and their
        scratch-row sidecars) into the radix tree, which takes its own
        reference on each newly cached page.  Decode appends land after
        the full-page prefix, so cached pages are never written again
        (the copy-on-write guard holds the invariant anyway)."""
        ps = self.pool.page_size
        full = req.prompt_len // ps
        if full == 0:
            return
        scratch = self._scratch[slot.index]
        payloads = [self._slice_prefix_page(scratch, i) for i in range(full)]
        self.prefix.insert(req.prompt[:full * ps],
                           self.blocks.slot_pages(slot.index)[:full],
                           payloads)

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
        """Load picture the scheduler policy decides from: the token
        budget, the decode tokens in flight, the prompt tokens the
        prefilling slots' next chunks hold, the measured inter-token p99
        and the SLO monitor's rolling-window state."""
        backlog = 0
        if self.prefill_chunk:
            for s in self.sched.slots:
                req = self._slot_req.get(s.index)
                if s.state == PREFILLING and req is not None:
                    backlog += min(self.prefill_chunk,
                                   req.prompt_len - s.prefill_pos)
        sig = {"token_budget": self.scfg.token_budget,
               "decode_tokens": len(self.sched.active_slots()),
               "prefill_backlog": backlog,
               "itl_p99_ms": (self._h_itl.percentile(99)
                              if self._h_itl.count else None)}
        sig.update(self.slo.signals())
        return sig

    # -- kernel roofline capture ---------------------------------------------

    def _profile_decode(self, decode_ms: float) -> None:
        """Roofline-place the step's batched decode on the analytic costs
        (:func:`~repro_torch.kernels.ops.op_cost_model`) and this step's
        decode probe, so the table tracks warm timings (last wins)."""
        op = "flash_paged_decode" if self.paged else "flash_decode"
        costs = self._kernel_costs.get(op)
        if costs is None:
            cfg = self.cfg
            mfpt = model_flops_per_token(cfg)
            costs = self._kernel_costs[op] = op_cost_model(
                op, batch=self.scfg.batch_slots, heads=cfg.n_heads,
                kv_heads=cfg.n_kv_heads, seq=self.scfg.max_len,
                d_head=cfg.d_head, dtype_bytes=self._dtype_bytes,
                kv_bytes=self._dtype_bytes, layers=cfg.n_layers,
                weight_flops=mfpt * self.scfg.batch_slots,
                weight_bytes=mfpt / 2.0 * self._dtype_bytes)
        if decode_ms > 0:
            self.profiler.record_kernel(op, costs[0], costs[1],
                                        measured_us=decode_ms * 1e3)

    def _profile_prefill_chunk(self, take: int, chunk_ms: float) -> None:
        """Roofline-place one prompt chunk (forward + page scatter)."""
        if chunk_ms <= 0 or take <= 0:
            return
        cfg = self.cfg
        mfpt = model_flops_per_token(cfg)
        flops, nbytes = op_cost_model(
            "prefill_chunk", chunk_tokens=take, heads=cfg.n_heads,
            kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            kv_bytes=self._dtype_bytes, layers=cfg.n_layers,
            weight_flops=mfpt * take,
            weight_bytes=mfpt / 2.0 * self._dtype_bytes)
        self.profiler.record_kernel("prefill_chunk", flops, nbytes,
                                    measured_us=chunk_ms * 1e3)

    # -- continuous-batching API --------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int, *,
               arrival: Optional[int] = None,
               enc_embeds: Optional[np.ndarray] = None,
               on_token: Optional[Callable[[int, int, bool], None]]
               = None) -> int:
        """Queue one request; returns its request id.  ``arrival`` (in
        engine steps) defaults to "now".  ``enc_embeds`` (1, S_enc,
        d_model), S_enc <= ``enc_len``, is an enc-dec model's encoder
        input (its prefill raises ``KeyError`` without one, as the
        reference's).  ``on_token(rid, token, done)`` streams every emitted
        token the moment the step produces it and may call
        :meth:`cancel`."""
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
                                  prompt=prompt, enc_embeds=enc_embeds))
        if on_token is not None:
            self._on_token[rid] = on_token
        tr = self._obs.tracer
        tr.async_begin("request", rid, prompt_len=int(prompt.size),
                       max_new=int(max_new))
        tr.async_begin("queued", rid)
        self.flight.record_request_event(
            rid, "submitted", prompt_len=int(prompt.size),
            max_new=int(max_new), arrival=arrival)
        if arrival <= self.step_count:
            # TTFT clock starts the moment the request is runnable.
            self._runnable_at[rid] = time.perf_counter()
        return rid

    def step(self, token_budget: Optional[int] = None) -> Dict[str, Any]:
        """One engine step under a token budget, in the reference's order:

        1. admit arrived requests into free slots (the policy's call):
           monolithic admissions prefill whole and emit their first token,
           chunked ones enter ``PREFILLING`` with the cursor at 0 (or past
           their cached prefix);
        2. advance chunked prefills (budget permitting): a slot whose
           cursor reaches the prompt's end emits its first token and joins
           this step's decode;
        3. (paged) grow every decoding slot's block table for the row its
           next token writes, copying a shared page first and preempting
           the youngest admission while the pool is exhausted; then one
           batched decode over every decoding slot at per-slot positions;
        4. a second admission pass, so slots and pages freed this step
           (EOS, completion, cancel, preemption) are reused at once.

        ``token_budget`` overrides ``ServeConfig.token_budget`` for this
        step.  Returns the step's events: {admitted, decoded, finished,
        preempted, cancelled} request ids, per-request ``ttft_ms`` for
        first tokens, per-stream ``itl_ms`` gaps, and ``timings``."""
        self._check_open("step")
        if self.caches is None:
            self.caches = self.new_cache()
        tr = self._obs.tracer
        t_step = time.perf_counter()
        for r in self.sched.queue:
            # Trace-replayed arrivals become runnable this step.
            if r.arrival <= self.step_count and r.rid not in self._runnable_at:
                self._runnable_at[r.rid] = t_step
        holdover = [s.rid for s in self.sched.active_slots()]
        budget = (self.scfg.token_budget if token_budget is None
                  else int(token_budget))
        events: Dict[str, Any] = {"admitted": [], "decoded": [],
                                  "finished": [], "preempted": [],
                                  "cancelled": list(self._cancel_log),
                                  "ttft_ms": {}, "itl_ms": {}}
        self._cancel_log.clear()
        clock = self._sections
        with tr.span("engine.step", cat="engine", step=self.step_count):
            mark = clock.mark()
            self._admission_pass(events, "arrival")
            clock.span("admit", mark)
            if any(s.state == PREFILLING for s in self.sched.slots):
                mark = clock.mark()
                self._advance_prefills(events, budget)
                clock.span("prefill", mark)
            if self.paged:
                self._grow_pages(events)
            active = self.sched.active_slots()
            if active:
                pos = np.zeros((self.scfg.batch_slots,), np.int32)
                for s in self.sched.slots:
                    # Inactive slots decode garbage into their own dead
                    # rows (dense: replaced wholesale on re-admission;
                    # paged: the null sink page); the clamp only guards
                    # the bound.
                    pos[s.index] = min(s.length, self._fresh_len - 1)
                tables = (torch.from_numpy(self._decode_table()).to(
                    self.device) if self.paged else None)
                with tr.span("decode", cat="engine", batch=len(active)):
                    mark = clock.mark()
                    logits, self.caches = decode_step(
                        self.params,
                        torch.from_numpy(self._tok).to(self.device),
                        torch.from_numpy(pos).to(self.device), self.cfg,
                        self.caches, block_tables=tables)
                    toks = self._sample(logits)
                    clock.span("decode", mark)
                    toks = toks.cpu().numpy()
                # The readback above synchronised the stream past every
                # probe of the step so far.
                probes = self._read_probes(synced=True)
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
            else:
                probes = self._read_probes(synced=False)
            if self._cancel_log:
                events["cancelled"].extend(self._cancel_log)
                self._cancel_log.clear()
            if (holdover and active
                    and probes["admit"] + probes["prefill"]
                    > probes["decode"]):
                # In-flight streams waited longer on prefill work than on
                # their own batched decode: what chunking exists to bound.
                self._c_starved.inc()
                self.stats["starved_steps"] += 1
            if events["finished"] or events["preempted"] \
                    or events["cancelled"]:
                self._admission_pass(events, "reclaim")
        self._note_kv_tokens(sum(s.length for s in self.sched.active_slots()))
        self._g_active.set(len(self.sched.active_slots()))
        self.step_count += 1
        step_ms = (time.perf_counter() - t_step) * 1e3
        events["timings"] = {
            "admit_ms": probes["admit"], "prefill_ms": probes["prefill"],
            "decode_ms": probes["decode"], "step_ms": step_ms,
        }
        # Attribution: the three section probes are the device estimate;
        # the wall time they do not cover is the host bubble.
        prof = self.profiler.record_step(
            step_ms, {"admit": probes["admit"],
                      "prefill": probes["prefill"],
                      "decode": probes["decode"]})
        events["profile"] = prof
        tr.counter("step.attribution", bubble_ms=prof["bubble_ms"],
                   device_ms=prof["device_ms"])
        self.flight.record_step(
            self.step_count - 1, wall_ms=round(step_ms, 3),
            device_ms=round(prof["device_ms"], 3),
            bubble_ms=round(prof["bubble_ms"], 3),
            admitted=len(events["admitted"]),
            decoded=len(events["decoded"]),
            finished=len(events["finished"]),
            preempted=len(events["preempted"]))
        return events

    def _read_probes(self, synced: bool) -> Dict[str, float]:
        """Read the step's section probes (once a step, after its last
        readback), feed the chunk and decode spans to the kernel roofline
        table, and return the section times: ``admit``, ``prefill`` (the
        whole chunk phase) and ``decode``, in ms (0 for a section that did
        not run)."""
        out = {"admit": 0.0, "prefill": 0.0, "decode": 0.0}
        for name, ms, payload in self._sections.read(synced):
            if name == "prefill_chunk":
                self._profile_prefill_chunk(payload, ms)
            else:
                out[name] = ms
                if name == "decode":
                    self._profile_decode(ms)
        return out

    def _decode_table(self) -> np.ndarray:
        """Block tables as the decode step sees them: a slot in the middle
        of its chunked prefill gets an all-sink row, so the garbage token
        its inactive lane writes cannot land on a page its chunks were
        already scattered into."""
        pre = [s.index for s in self.sched.slots if s.state == PREFILLING]
        if not pre:
            return self.blocks.table
        table = self.blocks.table.copy()
        table[pre] = self.pool.null_page
        return table

    def _admission_pass(self, events: Dict[str, Any], phase: str) -> None:
        """The single admission entry point: the arrival pass at the top
        of :meth:`step` and the reclaim pass after decode (``phase`` tags
        the trace span)."""
        with self._obs.tracer.span("admit", cat="engine", phase=phase):
            self._admit(events)

    def _admit(self, events: Dict[str, Any]) -> None:
        """Admission pass: free slots and (paged) enough free pages for each
        prompt, reserved cumulatively in FIFO order.  With the prefix cache,
        each candidate's cached prefix is pinned by a pool reference and
        only its unshared suffix is charged, against free pages plus the
        evictable cache-only ones.  Monolithic admissions prefill without a
        host sync; their first tokens are read back after the pass."""
        fits = None
        pins: Dict[int, tuple] = {}     # rid -> pinned (pages, payloads)
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
                headroom = budget
                if self.prefix is not None:
                    if req.rid not in pins:
                        # Only full pages strictly before the last prompt
                        # token can come from the cache: that token is
                        # always forwarded, its logits seed decode.
                        hit = self.prefix.lookup(
                            req.prompt, max_pages=(req.prompt_len - 1) // ps)
                        if hit[0]:
                            # Pinned: out of evictable() and the evictor.
                            self.pool.share(hit[0])
                        pins[req.rid] = hit
                    need -= len(pins[req.rid][0])
                    headroom = self.pool.free_pages + self.prefix.evictable()
                if reserved + need > headroom:
                    self._c_rejects.inc()
                    return False
                reserved += need
                return True
        tr = self._obs.tracer
        inflight = []
        for req in self.sched.pop_admissible(self.step_count, fits=fits):
            slot = self.sched.admit(
                req, state=PREFILLING if self.prefill_chunk else DECODE)
            tr.async_end("queued", req.rid)
            tr.async_begin("decode", req.rid, slot=slot.index)
            hit_pages, hit_payloads = pins.pop(req.rid, ([], []))
            if self.paged:
                # The slot takes over the pinned prefix's references and
                # allocates only the unshared suffix.
                pages = self.blocks.assign(slot.index, req.prompt_len,
                                           shared=hit_pages)
                assert pages is not None, "admission fits() reserved these"
                if self.prefix is not None:
                    self._note_prefix(req, len(hit_pages))
            self._slot_req[slot.index] = req
            if self.prefill_chunk:
                scratch = init_cache(self.cfg, 1, self._fresh_len,
                                     self.device, enc_len=self.scfg.enc_len)
                if hit_pages:
                    # Cached tokens are never forwarded again: their rows
                    # come back from the sidecar at full precision and the
                    # cursor starts at the first uncached page.
                    self._restore_prefix(scratch, hit_payloads)
                    slot.prefill_pos = len(hit_pages) * self.pool.page_size
                self._scratch[slot.index] = scratch
            else:
                inflight.append((slot, self._prefill_slot(slot, req)))
            self.stats["admitted"] += 1
            events["admitted"].append(req.rid)
            self.flight.record_request_event(
                req.rid, "admitted", slot=slot.index, step=self.step_count)
        # Unpin what fits() approved but the policy did not take (it stays
        # queued; the next pass pins again).
        for hit_pages, _ in pins.values():
            if hit_pages:
                self.pool.release(hit_pages)
        for slot, tok0 in inflight:
            tok = int(tok0)
            self._tok[slot.index] = tok
            self._emit(slot, tok, events)
        self._note_kv_tokens(sum(s.length for s in self.sched.active_slots()))

    def _prefill_slot(self, slot: Slot, req: Request) -> torch.Tensor:
        """Prefill one admission into its slot: pad the prompt to its
        bucket (a recurrent arch: the exact length), run it against a
        *fresh* single-slot dense cache (zero KV and zero state — no
        leakage from the previous occupant), copy that cache into the
        slot's row (dense) or scatter its pages into the pool (paged), and
        return the first generated token (greedy from the prompt's
        last-position logits) as an unsynced device tensor."""
        plen = req.prompt_len
        bucket = (plen if self._exact_prefill
                  else _bucket_for(plen, self.scfg.max_len))
        with self._obs.tracer.span("prefill", cat="engine", rid=req.rid,
                                   plen=plen, bucket=bucket):
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :plen] = req.prompt
            fresh = init_cache(self.cfg, 1, self._fresh_len, self.device,
                               enc_len=self.scfg.enc_len)
            logits, fresh, _ = forward(self.params, self._batch(toks, req),
                                       self.cfg, caches=fresh, cache_pos=0)
            if self.paged:
                self._insert_slot_pages(fresh, slot.index)
            else:
                self._insert_slot(fresh, slot.index)
            self.stats["prefills"] += 1
            slot.length = plen
            return torch.argmax(logits[0, plen - 1])

    def _batch(self, toks: np.ndarray, req: Request) -> Dict[str, Any]:
        """A prefill's batch: the (padded) prompt tokens on the device and,
        for an enc-dec request, its encoder input."""
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if req.enc_embeds is not None:
            batch["enc_embeds"] = torch.as_tensor(req.enc_embeds).to(
                self.device)
        return batch

    def _advance_prefills(self, events: Dict[str, Any], budget: int) -> None:
        """Spend the step's prefill tokens on prompt chunks, oldest
        admission first.  Decode claims one budget token per active slot up
        front; what is left buys chunks.  Unbudgeted (``budget <= 0``)
        every prefilling slot advances exactly one chunk.  The first chunk
        always runs, so prefill cannot starve behind a saturated decode."""
        chunk = self.prefill_chunk
        avail = (budget - len(self.sched.active_slots()) if budget > 0
                 else None)
        advanced = 0
        for slot in self.sched.prefilling_slots():
            while slot.state == PREFILLING:
                if advanced and avail is not None and avail < chunk:
                    return
                self._prefill_chunk_step(slot, events)
                advanced += 1
                if avail is None:
                    break       # unbudgeted: one chunk a slot a step
                avail -= chunk

    def _prefill_chunk_step(self, slot: Slot, events: Dict[str, Any]) -> None:
        """Advance one slot's prefill by one chunk: prompt tokens [c0, c0 +
        take) run against the slot's dense scratch at offset c0 (the KV
        write offset and RoPE base; attention is causal over the scratch's
        prefix), then (paged) exactly that chunk's pages scatter into the
        pool.  The last chunk seeds the first token from its last row's
        logits, as monolithic prefill does, and flips the slot to DECODE so
        it joins this step's decode."""
        req = self._slot_req[slot.index]
        chunk, plen = self.prefill_chunk, req.prompt_len
        c0 = slot.prefill_pos
        take = min(chunk, plen - c0)
        # The buffer is sized to the page-aligned take, never the full
        # chunk: a full-chunk buffer on a tail chunk (or a cursor moved
        # past cached pages) would run past the scratch's end.  Aligned,
        # c0 + buf <= ceil(plen / ps) * ps <= the scratch's rows.
        if self.paged:
            ps = self.pool.page_size
            buf = pages_for(take, ps) * ps
        else:
            buf = min(chunk, self._fresh_len - c0)
        mark = self._sections.mark()
        with self._obs.tracer.span("prefill_chunk", cat="engine",
                                   rid=req.rid, lo=c0, take=take):
            toks = np.zeros((1, buf), np.int64)
            toks[0, :take] = req.prompt[c0:c0 + take]
            scratch = self._scratch[slot.index]
            logits, _, _ = forward(self.params, self._batch(toks, req),
                                   self.cfg, caches=scratch, cache_pos=c0)
            if self.paged:
                self._insert_chunk_pages(scratch, slot.index, c0, buf)
            self.stats["prefill_chunks"] += 1
            self._c_chunks.inc()
        # The chunk's roofline row is placed when the step reads its probes.
        self._sections.span("prefill_chunk", mark, take)
        slot.prefill_pos = c0 + take
        if slot.prefill_pos < plen:
            return
        # Last chunk: dense copies the whole scratch into the slot's row
        # (leak-free, as monolithic); paged scattered every page already.
        if not self.paged:
            self._insert_slot(scratch, slot.index)
        if self.prefix is not None:
            # Cache the prompt's full pages while the scratch still holds
            # their full-precision rows.
            self._cache_prefix(slot, req)
        self._scratch.pop(slot.index, None)
        tok0 = int(torch.argmax(logits[0, take - 1]))
        slot.state = DECODE
        slot.length = plen
        self.stats["prefills"] += 1
        self._tok[slot.index] = tok0
        self._emit(slot, tok0, events)

    def cancel(self, rid: int) -> bool:
        """Drop a request wherever it is — queued, in the middle of its
        chunked prefill, or mid-decode — freeing its slot, its scratch and
        (paged) its pages the same step.  Partial output is discarded.
        Safe from an ``on_token`` callback.  False when ``rid`` is unknown
        or already finished."""
        self._check_open("cancel")
        tr = self._obs.tracer
        req = self.sched.cancel(rid)
        self._streamed.pop(rid, None)
        if req is not None:                      # still queued
            self._runnable_at.pop(rid, None)
            self._on_token.pop(rid, None)
            self.stats["cancelled"] += 1
            self._cancel_log.append(rid)
            tr.async_end("queued", rid)
            tr.async_end("request", rid, cancelled=True)
            self.flight.record_request_event(rid, "cancelled", queued=True)
            return True
        for slot in self.sched.slots:
            if slot.rid == rid and slot.state in (DECODE, PREFILLING):
                self._out.pop(rid, None)
                self._scratch.pop(slot.index, None)
                self._slot_req.pop(slot.index, None)
                if self.paged:
                    self.blocks.release(slot.index)
                self.sched.release(slot)
                self._runnable_at.pop(rid, None)
                self._last_emit.pop(rid, None)
                self._on_token.pop(rid, None)
                self.stats["cancelled"] += 1
                self._cancel_log.append(rid)
                tr.instant("cancel", cat="engine", rid=rid)
                tr.async_end("decode", rid)
                tr.async_end("request", rid, cancelled=True)
                self.flight.record_request_event(rid, "cancelled",
                                                 queued=False)
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
        self._c_tokens.inc()
        now = time.perf_counter()
        tr = self._obs.tracer
        t0 = self._runnable_at.pop(rid, None)
        if t0 is not None:
            # First token since the request became runnable (or since its
            # last preemption): TTFT.
            ttft_ms = (now - t0) * 1e3
            self._h_ttft.observe(ttft_ms)
            self.slo.observe_ttft(ttft_ms)
            events["ttft_ms"][rid] = ttft_ms
            self.flight.record_request_event(
                rid, "first_token", ttft_ms=round(ttft_ms, 3))
            tr.flow(f"req{rid}", rid, "start", cat="reqflow")
        else:
            prev = self._last_emit.get(rid)
            if prev is not None:
                # Inter-token latency as the stream sees it: the wall gap
                # since this request's previous token.
                gap_ms = (now - prev) * 1e3
                self._h_itl.observe(gap_ms)
                self.slo.observe_itl(gap_ms)
                events["itl_ms"][rid] = gap_ms
                tr.flow(f"req{rid}", rid, "step", cat="reqflow")
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
            tr.flow(f"req{rid}", rid, "end", cat="reqflow")
            tr.async_end("decode", rid)
            tr.async_end("request", rid, tokens=n_out, eos=eos)
            self.flight.record_request_event(
                rid, "finished", tokens=int(n_out), eos=bool(eos))
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
            if self.prefix is not None and not self._cow_guard(s, events):
                continue            # s preempted itself paying for a copy
            while not self.blocks.extend_to(s.index, s.length + 1):
                victim = max(self.sched.active_slots(),
                             key=lambda v: v.admit_seq)
                self._preempt(victim, events)
                if victim is s:
                    break           # s yielded its own pages

    def _cow_guard(self, s: Slot, events: Dict[str, Any]) -> bool:
        """Copy-on-write before a decode write lands in a shared page: if
        the page holding position ``length`` has other referents, copy it
        into a fresh page of the slot's own first (every layer's k and v
        pools, and an int8 pool's scales), so the sharers keep the original
        bits.  Cached pages sit strictly before the first decode position,
        so this guards an invariant rather than a hot path.  False when
        the slot preempted itself paying for the copy."""
        idx = s.length // self.pool.page_size
        spages = self.blocks.slot_pages(s.index)
        if idx >= len(spages) or self.pool.refcount(spages[idx]) <= 1:
            return True
        res = self.blocks.cow(s.index, idx)
        while res is None:          # pool exhausted even after eviction
            victim = max(self.sched.active_slots(),
                         key=lambda v: v.admit_seq)
            self._preempt(victim, events)
            if victim is s:
                return False
            res = self.blocks.cow(s.index, idx)
        src, dst = res
        if src != dst:
            for layer in self.caches:
                for pool in layer["attn"].values():
                    pool[dst] = pool[src]
            self.stats["cow_copies"] += 1
        return True

    def _preempt(self, slot: Slot, events: Dict[str, Any]) -> None:
        """Evict a mid-decode request to reclaim its pages: its partial
        output is discarded and the request returns to the head of the
        queue (greedy decoding regenerates the identical stream).  Only the
        slot's own page references go; pages it shares survive for the
        other referents."""
        rid = slot.rid
        self._out.pop(rid, None)
        self._last_emit.pop(rid, None)
        self._scratch.pop(slot.index, None)
        self.blocks.release(slot.index)
        req = self._slot_req.pop(slot.index)
        self.sched.release(slot)
        self.sched.requeue(req)
        self.stats["preemptions"] += 1
        events["preempted"].append(rid)
        tr = self._obs.tracer
        tr.instant("preempt", cat="engine", rid=rid)
        tr.async_end("decode", rid)
        tr.async_begin("queued", rid)
        # Enough preemptions inside one window of steps trip the flight
        # recorder (a preemption storm).
        self.flight.note_preemption(self.step_count, rid)
        # The regenerated stream measures TTFT again from the eviction.
        self._runnable_at[rid] = time.perf_counter()

    # -- one-shot API (on the continuous loop) --------------------------------

    def generate(self, prompts: np.ndarray, max_new: int,
                 enc_embeds: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts: (B, S) with B == batch_slots; returns (B, max_new).
        ``enc_embeds`` (B, S_enc, d_model): an enc-dec model's encoder
        inputs, row i for request i.

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
        rids = [self.submit(prompts[i], max_new,
                            enc_embeds=None if enc_embeds is None
                            else np.asarray(enc_embeds[i:i + 1]))
                for i in range(b)]
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
