"""Serving launcher: continuous batching over a request-trace workload
(counterpart of ``repro/launch/serve.py``).

Replays a trace through the port's ``ServeEngine``.  Two replay modes:

* **step-indexed** (default): arrivals are measured in engine steps
  (``arrival``), every request is submitted up front and the scheduler
  releases each as the step counter passes its arrival — deterministic.
* **wall-clock**: arrivals are seconds (``arrival_s``); the launcher
  submits each request the moment the clock reaches it, as a serving
  frontend would.  Selected when the trace carries ``arrival_s``, or by
  synthesizing arrivals with ``--arrivals {uniform,poisson,pareto}``
  (seedable; ``--rate`` sets the mean request rate, ``--speed`` replays
  faster).  Greedy tokens per request do not depend on the schedule;
  the steps that admit each request do.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \\
        --full --trace smoke6 --batch_slots 3 --verify

    # bursty wall-clock replay, chunked prefill, every output file
    PYTHONPATH=src python -m repro_torch.launch.serve --trace bursty24 \\
        --kv paged --page_size 16 --prefill-chunk 16 --verify \\
        --metrics-out m.json --trace-out t.json --flight-out f.json

Trace file (``--trace``, JSON lines; a bare name resolves to
``benchmarks/traces/<name>.jsonl``)::

    {"id": 0, "arrival": 0, "prompt_len": 12, "max_new": 16}
    {"id": 1, "arrival": 3, "prompt": [17, 3, 99], "max_new": 8}
    {"id": 2, "arrival": 4, "prompt_len": 60, "max_new": 8,
     "group": 1, "prefix_len": 48}
    {"id": 3, "arrival_s": 0.25, "prompt_len": 40, "max_new": 8,
     "cancel_after": 3}

A record with ``group`` and ``prefix_len`` shares its first
``prefix_len`` tokens with its group (a system prompt, seeded per group).
``cancel_after: N`` cancels the request after its Nth streamed token
(``engine.cancel`` frees its slot and pages the same step).

``--kv paged --page_size N`` serves from the page pool (``--pool_pages``
caps it; ``--kv-dtype int8`` stores quantized pages; ``--prefix-cache``
shares page-aligned prompt prefixes; ``--arrivals shared`` synthesizes
the matching shared-system-prompt trace).  ``--prefill-chunk N`` prefills
in N-token chunks interleaved with decode, ``--token-budget B`` caps the
tokens a step spends, ``--policy`` picks the admission policy.
``--batch_slots 0``, ``--page_size 0`` and ``--prefill-chunk -1`` ask the
tuner (``repro_torch.tuning``: a measured entry of the tuning cache, else
8 slots, pages of 32 and monolithic prefill) and print what it resolved.
``--trace-out``, ``--metrics-out``, ``--prom-out`` and ``--flight-out``
write the Chrome trace, the schema-1 metrics snapshot, its Prometheus
text and the flight record (``tools/obs_report.py`` renders them);
``--slo-ttft-ms``/``--slo-itl-ms`` arm the SLO monitor.
``--arch`` defaults to ``qwen3_8b``, as the reference's; ``--full``
serves the FULL config, SMOKE otherwise (``--smoke``, the reference's
flag, is accepted and changes nothing).  ``--quantize`` serves int8
weights, quantized from the f32 draws (``serving.quant``).  A recurrent
arch (RWKV-6, the Jamba hybrid's Mamba layers) serves its state on the
dense layout whatever ``--kv`` asks, as does an enc-dec model (no
``paged kv:`` line; the reference's ``paged kv bypassed:`` line instead).
``--arch qwen2_vl_72b`` serves the trace's text tokens at
M-RoPE positions (t, t, t).  Like the reference's, the launcher builds no
encoder inputs: ``--arch seamless_m4t_large_v2`` fails at its first
prefill with ``KeyError: 'enc_embeds'``; an enc-dec model is served
through the engine API (``ServeConfig.enc_len``, ``submit(...,
enc_embeds=)``).
``--verify`` re-runs every completed request through a one-slot one-shot
engine that prefills monolithically and shares no pages, and checks the
continuous outputs are bit-identical: a dense one for full-precision runs
(so it is also the paged-vs-dense, chunked-vs-whole and
shared-vs-private check), a paged one of the same ``kv_dtype`` for int8
pages.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

# The reference's default for --pack_min_flops (ServeConfig.pack_min_flops).
PACK_MIN_FLOPS = 2.0 * 1024 ** 3


def shared_prefix_tokens(group: int, prefix_len: int, vocab_size: int,
                         seed: int = 0) -> np.ndarray:
    """The system-prompt tokens of one share group, seeded per group
    (offset by 1000 so they never collide with the per-id rngs); the same
    tokens as the reference's ``shared_prefix_tokens``."""
    return np.random.default_rng(seed + 1000 + int(group)).integers(
        0, vocab_size, size=(int(prefix_len),)).astype(np.int32)


def load_trace(path: str, vocab_size: int, seed: int = 0) -> List[dict]:
    """Parse a JSONL trace; synthesize prompt tokens where only
    ``prompt_len`` is given (deterministically, per request id — the same
    tokens as the reference's ``load_trace``).  A record with ``group``
    and ``prefix_len`` takes its first ``prefix_len`` tokens from the
    group's rng and the rest from its own."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rec = json.loads(line)
            if "prompt" in rec:
                prompt = np.asarray(rec["prompt"], np.int32)
            else:
                rng = np.random.default_rng(seed + int(rec["id"]))
                plen = int(rec["prompt_len"])
                pfx = np.zeros((0,), np.int32)
                if "group" in rec:
                    pfx = shared_prefix_tokens(rec["group"],
                                               rec.get("prefix_len", 0),
                                               vocab_size, seed)
                prompt = np.concatenate([pfx, rng.integers(
                    0, vocab_size, size=(plen - len(pfx),)).astype(np.int32)])
            item = {"id": int(rec["id"]),
                    "arrival": int(rec.get("arrival", 0)),
                    "prompt": prompt,
                    "max_new": int(rec["max_new"])}
            if "group" in rec:
                item["group"] = int(rec["group"])
                item["prefix_len"] = int(rec.get("prefix_len", 0))
            if "arrival_s" in rec:
                item["arrival_s"] = float(rec["arrival_s"])
            if "cancel_after" in rec:
                item["cancel_after"] = int(rec["cancel_after"])
            out.append(item)
    return sorted(out, key=lambda r: (r.get("arrival_s", 0.0),
                                      r["arrival"], r["id"]))


def resolve_trace_path(name: str) -> str:
    """``--trace`` accepts a filesystem path or a bare trace name; bare
    names resolve to the repo's ``benchmarks/traces/<name>.jsonl``."""
    if os.path.exists(name):
        return name
    if os.sep not in name and not name.endswith(".jsonl"):
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        cand = os.path.join(repo, "benchmarks", "traces", f"{name}.jsonl")
        if os.path.exists(cand):
            return cand
    return name


def synth_trace(requests: int, prompt_len: int, max_new: int,
                stagger: int, vocab_size: int, seed: int = 0
                ) -> List[dict]:
    """Staggered-arrival synthetic trace: request i arrives at step
    ``i * stagger`` (the reference's tokens for the same seed)."""
    rng = np.random.default_rng(seed)
    return [{"id": i, "arrival": i * stagger,
             "prompt": rng.integers(0, vocab_size, size=(prompt_len,)
                                    ).astype(np.int32),
             "max_new": max_new}
            for i in range(requests)]


def gen_arrivals(kind: str, n: int, rate: float, seed: int = 0
                 ) -> np.ndarray:
    """Seedable arrival times (seconds, first at 0) for ``n`` requests
    at a mean rate of ``rate`` req/s (the reference's times for the same
    seed):

    * ``uniform`` — evenly spaced, gap 1/rate;
    * ``poisson`` — exponential inter-arrivals (memoryless load);
    * ``pareto``  — Lomax(alpha=1.5) inter-arrivals scaled to mean
      1/rate: heavy-tailed, so requests cluster into bursts separated
      by long quiet gaps (the adversarial case for monolithic prefill).

    >>> a = gen_arrivals("uniform", 4, 2.0)
    >>> [round(float(x), 2) for x in a]
    [0.0, 0.5, 1.0, 1.5]
    >>> b = gen_arrivals("pareto", 100, 8.0, seed=1)
    >>> (bool(b[0] == 0.0), bool(np.all(np.diff(b) >= 0)))
    (True, True)
    """
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        gaps = np.full(n, 1.0 / rate)
    elif kind == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n)
    elif kind == "pareto":
        alpha = 1.5
        gaps = rng.pareto(alpha, size=n) * (alpha - 1.0) / rate
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    return np.cumsum(gaps) - gaps[0]


def bursty_trace(requests: int, prompt_len: int, max_new: int,
                 kind: str, rate: float, vocab_size: int, seed: int = 0
                 ) -> List[dict]:
    """Wall-clock trace with ``kind`` arrivals and heterogeneous sizes:
    prompt lengths drawn from [prompt_len/2, 2*prompt_len], max_new from
    [max_new/2, max_new].  Prompts use the per-id rng of
    :func:`load_trace`, so a trace dumped with ``--dump-trace`` (which
    stores only ``prompt_len``) reloads to identical prompts."""
    rng = np.random.default_rng(seed)
    arrivals = gen_arrivals(kind, requests, rate, seed)
    out = []
    for i in range(requests):
        plen = int(rng.integers(max(1, prompt_len // 2),
                                2 * prompt_len + 1))
        mnew = int(rng.integers(max(1, max_new // 2), max_new + 1))
        prompt = np.random.default_rng(seed + i).integers(
            0, vocab_size, size=(plen,)).astype(np.int32)
        out.append({"id": i, "arrival": 0,
                    "arrival_s": round(float(arrivals[i]), 3),
                    "prompt": prompt, "max_new": mnew})
    return out


def shared_trace(requests: int, prompt_len: int, max_new: int,
                 groups: int, stagger: int, vocab_size: int,
                 seed: int = 0) -> List[dict]:
    """Shared-system-prompt trace (the prefix cache's workload):
    ``requests`` requests over ``groups`` share groups, each reusing one
    seeded system prompt of ``3 * prompt_len // 4`` tokens followed by a
    per-request suffix of ``prompt_len//8 .. prompt_len//4`` tokens.
    Arrivals are group-blocked and staggered one request per ``stagger``
    steps, consecutive groups an extra ``max_new`` steps apart, so a
    group's first request populates the radix tree before its siblings
    are admitted.  Prompts use the group/per-id rngs of
    :func:`load_trace`."""
    rng = np.random.default_rng(seed)
    prefix_len = max(1, (3 * prompt_len) // 4)
    out = []
    for i in range(requests):
        g = i * groups // max(1, requests)     # group-blocked order
        pfx = shared_prefix_tokens(g, prefix_len, vocab_size, seed)
        slen = int(rng.integers(max(1, prompt_len // 8),
                                max(2, prompt_len // 4) + 1))
        sfx = np.random.default_rng(seed + i).integers(
            0, vocab_size, size=(slen,)).astype(np.int32)
        out.append({"id": i, "arrival": i * stagger + g * max_new,
                    "group": g, "prefix_len": prefix_len,
                    "prompt": np.concatenate([pfx, sfx]),
                    "max_new": max_new})
    return out


def dump_trace(path: str, trace: List[dict]) -> None:
    """Write ``trace`` as JSONL, storing ``prompt_len`` instead of the
    tokens (``load_trace`` re-synthesizes them per id; shared-prefix
    records keep ``group``/``prefix_len`` so the group rng rebuilds the
    common system prompt)."""
    with open(path, "w") as f:
        for t in trace:
            rec: Dict[str, object] = {"id": t["id"]}
            if "arrival_s" in t:
                rec["arrival_s"] = t["arrival_s"]
            elif t.get("arrival"):
                rec["arrival"] = t["arrival"]
            if "group" in t:
                rec["group"] = t["group"]
                rec["prefix_len"] = t["prefix_len"]
            rec["prompt_len"] = int(len(t["prompt"]))
            rec["max_new"] = t["max_new"]
            if "cancel_after" in t:
                rec["cancel_after"] = t["cancel_after"]
            f.write(json.dumps(rec) + "\n")


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(xs, q)) if xs else float("nan")


def run_trace(engine, trace: List[dict],
              log: Optional[Callable[[str], None]] = print, *,
              wallclock: Optional[bool] = None, speed: float = 1.0,
              stream: Optional[Callable[[int, int, bool], None]] = None
              ) -> dict:
    """Replay ``trace``.  Returns {results: {trace_id: tokens},
    cancelled_ids, wall_s, tokens, tok_s, p50_ms, p99_ms, ttft_p50_ms,
    ttft_p99_ms, shared_steps, decode_steps, prefill_chunks,
    starved_steps, prefill_ms, decode_ms, kv_bytes_hwm, kv_bytes_reserved,
    bubble_ms_total, bubble_fraction, slo_breaches}, for a paged engine
    pages_hwm, pages_reclaimed and preemptions, and with the prefix cache
    prefix_hit_tokens, prefix_hit_rate and cow_copies (all but the
    high-waters counted over this replay; ``prefill_ms``/``decode_ms``
    sum the steps' section probes, ``bubble_*`` the profiler's host time
    outside them).

    Replay mode: ``wallclock=None`` auto-selects — wall-clock when any
    record carries ``arrival_s`` (each request is submitted when the
    clock, scaled by ``speed``, reaches it), step-indexed otherwise (all
    submitted up front with their step arrivals, relative to the engine's
    current step, so a warm engine replays the same schedule).

    ``p50/p99_ms`` are per-stream inter-token gaps (the engine's
    ``itl_ms`` events); ``ttft_*`` cover runnable -> first token.
    ``stream(trace_id, token, done)`` is invoked per emitted token; trace
    records with ``cancel_after: N`` are cancelled from the stream
    callback after their Nth token (mid-step, same-step page reclaim)."""
    log = log or (lambda s: None)
    rid_to_tid: Dict[int, int] = {}
    counts: Dict[int, int] = {}
    cancelled_tids: List[int] = []
    if wallclock is None:
        wallclock = any("arrival_s" in t for t in trace)

    def _cb(t):
        limit = t.get("cancel_after")
        tid = t["id"]

        def cb(rid, tok, done):
            if stream is not None:
                stream(tid, tok, done)
            counts[rid] = counts.get(rid, 0) + 1
            if limit is not None and counts[rid] >= limit and not done:
                if engine.cancel(rid):
                    cancelled_tids.append(tid)
        return cb

    def _submit(t, arrival=None):
        need_cb = stream is not None or "cancel_after" in t
        rid = engine.submit(t["prompt"], t["max_new"], arrival=arrival,
                            on_token=_cb(t) if need_cb else None)
        rid_to_tid[rid] = t["id"]

    base = engine.step_count
    pending: List[dict] = []
    if wallclock:
        pending = sorted(trace, key=lambda t: t.get("arrival_s", 0.0))
    else:
        for t in trace:
            _submit(t, base + t["arrival"])
    stats0 = dict(engine.stats)
    pool = engine.pool
    reclaimed0 = pool.total_reclaimed if pool is not None else 0
    bubble0 = engine.profiler.bubble_ms_total
    pwall0 = engine.profiler.wall_ms_total
    slo0 = engine.slo.breaches()
    itl: List[float] = []
    ttft: List[float] = []
    phase_ms = {"prefill_ms": 0.0, "decode_ms": 0.0}
    t0 = time.monotonic()
    while pending or not engine.sched.done():
        if pending:
            now_s = (time.monotonic() - t0) * speed
            while pending and pending[0].get("arrival_s", 0.0) <= now_s:
                _submit(pending.pop(0))
            if engine.sched.done():
                # Idle until the next arrival: nothing to decode yet.
                wait = (pending[0].get("arrival_s", 0.0) / speed
                        - (time.monotonic() - t0))
                if wait > 0:
                    time.sleep(min(wait, 0.02))
                continue
        ev = engine.step()
        itl += list(ev["itl_ms"].values())
        ttft += list(ev["ttft_ms"].values())
        phase_ms["prefill_ms"] += ev["timings"]["prefill_ms"]
        phase_ms["decode_ms"] += ev["timings"]["decode_ms"]
        older = sorted(set(ev["decoded"]) - set(ev["admitted"]))
        if ev["admitted"] and older:
            log(f"[serve] step={engine.step_count - 1} "
                f"admitted={[rid_to_tid[r] for r in ev['admitted']]} "
                f"sharing decode with {[rid_to_tid[r] for r in older]}")
        for rid in ev["preempted"]:
            log(f"[serve] preempted id={rid_to_tid[rid]} (pool exhausted) "
                f"— requeued at the head")
        for rid in ev["cancelled"]:
            log(f"[serve] cancelled id={rid_to_tid[rid]} — slot"
                f"{' and pages' if pool is not None else ''} freed this "
                f"step")
        for rid in ev["finished"]:
            log(f"[serve] done id={rid_to_tid[rid]} "
                f"tokens={len(engine.result(rid))}")
    wall = time.monotonic() - t0
    results = {rid_to_tid[rid]: toks for rid, toks in engine.drain().items()}
    tokens = sum(len(v) for v in results.values())

    def delta(key):
        return engine.stats[key] - stats0[key]
    pwall = engine.profiler.wall_ms_total - pwall0
    pbubble = engine.profiler.bubble_ms_total - bubble0
    rep = {
        "results": results,
        "cancelled_ids": sorted(cancelled_tids),
        "wall_s": wall,
        "tokens": tokens,
        "tok_s": tokens / wall if wall > 0 else float("inf"),
        "p50_ms": _pct(itl, 50), "p99_ms": _pct(itl, 99),
        "ttft_p50_ms": _pct(ttft, 50), "ttft_p99_ms": _pct(ttft, 99),
        "shared_steps": delta("shared_steps"),
        "decode_steps": delta("decode_steps"),
        "prefill_chunks": delta("prefill_chunks"),
        "starved_steps": delta("starved_steps"),
        **phase_ms,
        "kv_bytes_hwm": engine.kv_bytes_high_water(),
        "kv_bytes_reserved": engine.kv_bytes_reserved(),
        "bubble_ms_total": pbubble,
        "bubble_fraction": pbubble / pwall if pwall > 0 else 0.0,
        "slo_breaches": engine.slo.breaches() - slo0,
    }
    if pool is not None:
        rep["pages_hwm"] = pool.high_water
        rep["pages_reclaimed"] = pool.total_reclaimed - reclaimed0
        rep["preemptions"] = delta("preemptions")
    if engine.prefix is not None:
        rep["prefix_hit_tokens"] = delta("prefix_hit_tokens")
        rep["prefix_hit_rate"] = rep["prefix_hit_tokens"] / max(
            1, delta("prefix_prompt_tokens"))
        rep["cow_copies"] = delta("cow_copies")
    return rep


def _verify(cfg, params, trace, results, scfg) -> None:
    """Re-run every request one-shot (a one-slot engine on the same
    kernels) and require the continuous-batching outputs to be
    bit-identical.  The one-shot engine prefills monolithically and shares
    no pages, so with ``prefill_chunk`` or ``prefix_cache`` set this is
    also the chunked-vs-whole and shared-vs-private check.  For a
    full-precision run the one-shot engine is *dense*, so for a paged run
    this is also the paged-vs-dense check.  With ``kv_dtype`` set it keeps
    the same paged layout and page dtype (the dense layout has no page
    pool to retype, and quantization would differ from it by more than
    the batching machinery under test)."""
    from repro_torch.serving.engine import ServeEngine
    one_scfg = dataclasses.replace(scfg, batch_slots=1, prefill_chunk=0,
                                   prefix_cache=False, token_budget=0)
    if scfg.kv_dtype is None:
        one_scfg = dataclasses.replace(one_scfg, kv="dense")
        ref_name = "one-shot dense generate()"
    else:
        ref_name = f"one-shot paged/{scfg.kv_dtype} generate()"
    one = ServeEngine(cfg, params, one_scfg)
    try:
        bad = []
        for t in trace:
            want = one.generate(t["prompt"][None, :], t["max_new"])[0]
            if not np.array_equal(want, results[t["id"]]):
                bad.append(t["id"])
        if bad:
            raise SystemExit(f"[serve] VERIFY FAILED for ids {bad}")
        print(f"[serve] verify OK: {len(trace)} requests bit-identical to "
              f"{ref_name}")
    finally:
        one.close()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--full", action="store_true",
                    help="serve the FULL config (default: SMOKE)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the SMOKE config (the default; accepted as "
                         "the reference's flag)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch_slots", type=int, default=4,
                    help="KV-cache slots (0 = resolve from the tuner)")
    ap.add_argument("--prompt_len", type=int, default=16)
    ap.add_argument("--max_new", type=int, default=24)
    ap.add_argument("--stagger", type=int, default=3,
                    help="arrival gap between requests, in engine steps "
                         "(step-indexed replay)")
    ap.add_argument("--arrivals", default="steps",
                    choices=("steps", "shared", "uniform", "poisson",
                             "pareto"),
                    help="synthetic arrival process: 'steps' keeps the "
                         "deterministic --stagger replay; 'shared' is a "
                         "step-indexed shared-system-prompt trace "
                         "(--groups share groups); the rest generate "
                         "wall-clock arrival_s at --rate req/s (seedable "
                         "via --seed) and replay in real time")
    ap.add_argument("--groups", type=int, default=4,
                    help="share groups (distinct system prompts) for "
                         "--arrivals shared")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean request rate (req/s) for --arrivals")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="wall-clock replay speedup factor (2 = replay "
                         "arrival_s twice as fast)")
    ap.add_argument("--trace", default=None,
                    help="JSONL trace file or bare name under "
                         "benchmarks/traces/ (overrides --requests/"
                         "--prompt_len/--stagger/--arrivals)")
    ap.add_argument("--dump-trace", dest="dump_trace", default=None,
                    help="write the (synthesized) trace as JSONL and "
                         "continue")
    ap.add_argument("--trace-out", dest="trace_out", default=None,
                    help="write a Chrome-trace-event JSON of the run "
                         "(chrome://tracing or ui.perfetto.dev); enables "
                         "span recording for this run")
    ap.add_argument("--metrics-out", dest="metrics_out", default=None,
                    help="write the schema-1 metrics snapshot JSON")
    ap.add_argument("--prom-out", dest="prom_out", default=None,
                    help="write the metrics as Prometheus text exposition")
    ap.add_argument("--flight-out", dest="flight_out", default=None,
                    help="write the flight recorder's JSON at the end of "
                         "the run; mid-run tripwires (SLO breach, "
                         "preemption storm) write the same path at once")
    ap.add_argument("--slo-ttft-ms", dest="slo_ttft_ms", type=float,
                    default=None,
                    help="arm the SLO monitor: rolling-window p99 TTFT "
                         "target in ms")
    ap.add_argument("--slo-itl-ms", dest="slo_itl_ms", type=float,
                    default=None,
                    help="arm the SLO monitor: rolling-window p99 "
                         "inter-token target in ms")
    ap.add_argument("--warmup", action="store_true",
                    help="replay the trace once first, reset the metrics, "
                         "then measure")
    ap.add_argument("--verify", action="store_true",
                    help="check each completed request against a one-shot "
                         "single-slot generate() (greedy only)")
    ap.add_argument("--kv", choices=("dense", "paged"), default="dense",
                    help="KV layout: dense per-slot max_len rows, or the "
                         "kvpool page pool + block tables")
    ap.add_argument("--page_size", type=int, default=0,
                    help="paged: tokens per page (0 = resolve from the "
                         "tuner)")
    ap.add_argument("--pool_pages", type=int, default=0,
                    help="paged: pool capacity in pages (0 = the "
                         "dense-equivalent slots * ceil(max_len/page))")
    ap.add_argument("--kv-dtype", dest="kv_dtype", default=None,
                    choices=("bfloat16", "float32", "int8"),
                    help="paged: page dtype (default: the model's cache "
                         "dtype; int8 stores quantized pages with per-row "
                         "scales, dequantized inside the decode kernel)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true",
                    help="paged: share page-aligned prompt prefixes across "
                         "requests through a refcounted radix tree "
                         "(copy-on-write; bit-identical to uncached runs)")
    ap.add_argument("--prefill-chunk", dest="prefill_chunk", type=int,
                    default=0,
                    help="prefill prompts in N-token chunks interleaved "
                         "with decode (0 = monolithic; -1 = resolve from "
                         "the tuner; paged runs round N up to a page "
                         "multiple)")
    ap.add_argument("--token-budget", dest="token_budget", type=int,
                    default=0,
                    help="tokens a step may spend, decode first (0 = "
                         "unbudgeted: one chunk a prefilling slot a step)")
    ap.add_argument("--policy", default="fifo", choices=("fifo", "latency"),
                    help="admission policy: fifo admits whenever a slot "
                         "fits; latency defers admission while the token "
                         "budget is saturated or an SLO is breached")
    ap.add_argument("--stream", action="store_true",
                    help="print every token as the engine emits it")
    ap.add_argument("--eos_id", type=int, default=None,
                    help="token id that ends a request early (frees its "
                         "slot and, when paged, its pages that step)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weight-only quantization (per output "
                         "channel; dequantized on every weight fetch)")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="a (data, model) pack mesh (not ported yet: "
                         "ROADMAP Queue A item 12)")
    ap.add_argument("--pack_min_flops", type=float, default=PACK_MIN_FLOPS,
                    help="the pack mesh's GEMM size threshold (not ported "
                         "yet: ROADMAP Queue A item 12)")
    ap.add_argument("--gemm-mode", dest="gemm_mode", default="auto",
                    choices=("auto", "kernel", "ref"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.verify and args.temperature > 0.0:
        raise SystemExit(
            "--verify requires greedy decoding (temperature=0): sampled "
            "streams depend on the slot's place in the batch")
    if args.mesh is not None:
        raise NotImplementedError(
            "--mesh (the multi-device pack GEMM) is not ported yet: it "
            "comes with ROADMAP Queue A item 12")
    if args.pack_min_flops != PACK_MIN_FLOPS:
        raise NotImplementedError(
            "--pack_min_flops (the multi-device pack GEMM) is not ported "
            "yet: it comes with ROADMAP Queue A item 12")
    if args.full and args.smoke:
        raise SystemExit("--full and --smoke name different configs")

    from repro_torch import configs as C, obs
    from repro_torch.models import init_params
    from repro_torch.models.layers import set_gemm_mode
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    # Fresh metrics for this run; span recording only when a trace is
    # written (spans cost a clock read each).
    bundle = obs.configure(
        registry=obs.Registry(),
        tracer=obs.Tracer(enabled=args.trace_out is not None))
    set_gemm_mode(args.gemm_mode)
    cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
    if args.trace:
        trace = load_trace(resolve_trace_path(args.trace), cfg.vocab_size,
                           seed=args.seed)
    elif args.arrivals == "shared":
        trace = shared_trace(args.requests, args.prompt_len, args.max_new,
                             args.groups, args.stagger, cfg.vocab_size,
                             seed=args.seed)
    elif args.arrivals != "steps":
        trace = bursty_trace(args.requests, args.prompt_len, args.max_new,
                             args.arrivals, args.rate, cfg.vocab_size,
                             seed=args.seed)
    else:
        trace = synth_trace(args.requests, args.prompt_len, args.max_new,
                            args.stagger, cfg.vocab_size, seed=args.seed)
    if args.dump_trace:
        dump_trace(args.dump_trace, trace)
        print(f"[serve] wrote {len(trace)} requests -> {args.dump_trace}")
    max_len = max(len(t["prompt"]) + t["max_new"] for t in trace) + 8
    scfg = ServeConfig(
        batch_slots=args.batch_slots, max_len=max_len,
        temperature=args.temperature, seed=args.seed,
        quantize=args.quantize, eos_id=args.eos_id, kv=args.kv,
        page_size=args.page_size, pool_pages=args.pool_pages,
        kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
        prefill_chunk=None if args.prefill_chunk < 0 else args.prefill_chunk,
        token_budget=args.token_budget, policy=args.policy)
    params = init_params(cfg, seed=1, device=args.device,
                         quantize=args.quantize)
    engine = ServeEngine(cfg, params, scfg)
    if engine.quant_stats is not None:
        qs = engine.quant_stats
        print(f"[serve] int8 weights: quantized={qs['quantized']} "
              f"kept={qs['kept']} bytes {qs['bytes_before']} -> "
              f"{qs['bytes_after']}")
    if (args.batch_slots == 0 or args.prefill_chunk < 0
            or (args.kv == "paged" and args.page_size == 0)):
        from repro_torch.tuning import dispatch
        print(f"[serve] tuner-resolved: batch_slots="
              f"{engine.scfg.batch_slots} page_size={engine.scfg.page_size} "
              f"prefill_chunk={engine.scfg.prefill_chunk} (tuning cache "
              f"{dispatch.get_cache().path})")
    if args.slo_ttft_ms is not None:
        engine.slo.set_targets(ttft_ms=args.slo_ttft_ms)
    if args.slo_itl_ms is not None:
        engine.slo.set_targets(itl_ms=args.slo_itl_ms)
    if args.flight_out:
        # Armed path: mid-run tripwires write the snapshot at once.
        engine.flight.path = args.flight_out
    stream_cb = None
    if args.stream:
        def stream_cb(tid, tok, done):
            print(f"[stream] id={tid} token={tok}"
                  f"{' (done)' if done else ''}")
    try:
        if args.warmup:
            run_trace(engine, trace, log=None, speed=args.speed)
            bundle.registry.reset_values()
            engine.profiler.reset_totals()
        rep = run_trace(engine, trace, stream=stream_cb, speed=args.speed)
        expected = len(trace) - len(rep["cancelled_ids"])
        if len(rep["results"]) != expected:
            raise SystemExit(f"only {len(rep['results'])}/{expected} "
                             f"requests completed")
        print(f"[serve] {rep['tokens']} tokens in {rep['wall_s']:.3f}s "
              f"({rep['tok_s']:.1f} tok/s) p50={rep['p50_ms']:.2f}ms "
              f"p99={rep['p99_ms']:.2f}ms ttft_p50={rep['ttft_p50_ms']:.2f}ms "
              f"ttft_p99={rep['ttft_p99_ms']:.2f}ms "
              f"shared_steps={rep['shared_steps']} "
              f"decode_steps={rep['decode_steps']} arch={cfg.name} "
              f"slots={engine.scfg.batch_slots} device={engine.device}")
        if engine.prefill_chunk:
            print(f"[serve] chunked prefill: chunk={engine.prefill_chunk} "
                  f"chunks={rep['prefill_chunks']} "
                  f"budget={engine.scfg.token_budget} "
                  f"policy={engine.sched.policy.name} "
                  f"starved_steps={rep['starved_steps']}")
        if rep["cancelled_ids"]:
            print(f"[serve] cancelled ids={rep['cancelled_ids']} "
                  f"(slots/pages reclaimed the same step)")
        # The paper's %-of-peak analogue: decode throughput over the
        # analytic peak of the device the engine serves on.
        backend = engine.device.type
        eff = obs.efficiency.serve_efficiency(cfg, rep["tok_s"], backend)
        bundle.registry.gauge(
            "serve.efficiency",
            "achieved decode throughput / analytic peak").set(eff)
        print(f"[serve] efficiency={eff:.3e} of analytic peak "
              f"(backend={backend})")
        stall = " ".join(
            f"{k.name}:{k.stall_class}({k.bound_ratio:.1e})"
            for k in engine.profiler.kernel_table()) or "n/a"
        print(f"[serve] attribution: bubble={rep['bubble_fraction']:.3f} "
              f"(bubble_ms={rep['bubble_ms_total']:.1f}) stall={stall}")
        if (args.slo_ttft_ms is not None or args.slo_itl_ms is not None
                or rep["slo_breaches"]):
            slo = engine.slo.summary()
            print(f"[serve] slo: breaches={rep['slo_breaches']} "
                  f"ttft_target={args.slo_ttft_ms} "
                  f"itl_target={args.slo_itl_ms} "
                  f"ttft_breaches={slo['ttft']['breaches']} "
                  f"itl_breaches={slo['itl']['breaches']}")
        if engine.paged:
            dense_mib = (engine.scfg.batch_slots * engine.scfg.max_len
                         * engine.token_kv_bytes() / 2 ** 20)
            print(f"[serve] paged kv: page_size={engine.pool.page_size} "
                  f"kv_dtype={engine.scfg.kv_dtype or 'cache'} "
                  f"pool={engine.pool.num_pages} pages "
                  f"pages_hwm={rep['pages_hwm']} "
                  f"pages_reclaimed={rep['pages_reclaimed']} "
                  f"preemptions={rep['preemptions']} "
                  f"kv_hwm={rep['kv_bytes_hwm'] / 2 ** 20:.2f}MiB "
                  f"(dense would reserve {dense_mib:.2f}MiB)")
        elif args.kv == "paged":
            print(f"[serve] paged kv bypassed: arch {cfg.name} has "
                  f"non-attention state — dense layout in effect")
        if engine.prefix is not None:
            print(f"[serve] prefix cache: "
                  f"hit_rate={rep['prefix_hit_rate']:.3f} "
                  f"hit_tokens={rep['prefix_hit_tokens']} "
                  f"cow_copies={rep['cow_copies']} "
                  f"resident={engine.pool.pages_resident}"
                  f"/{engine.pool.num_pages} pages")
        if args.verify:
            done = [t for t in trace if t["id"] in rep["results"]]
            _verify(cfg, params, done, rep["results"], engine.scfg)
        if args.trace_out:
            n = bundle.tracer.write(args.trace_out)
            obs.validate_chrome_trace(bundle.tracer.chrome_trace())
            print(f"[serve] wrote {n} trace events -> {args.trace_out} "
                  f"(open in chrome://tracing or ui.perfetto.dev)")
        if args.metrics_out:
            run_section = {k: v for k, v in rep.items() if k != "results"}
            run_section["arch"] = cfg.name
            run_section["kv_mode"] = engine.kv_mode
            run_section["prefill_chunk"] = engine.prefill_chunk
            run_section["device"] = str(engine.device)
            obs.write_metrics(
                args.metrics_out, bundle.registry,
                extra={"run": run_section},
                required_histograms=("serve.ttft_ms",
                                     "serve.inter_token_ms"),
                required_gauges=("kvpool.pages_in_use",
                                 "serve.efficiency", "serve.kv_tokens",
                                 "serve.bubble_fraction"))
            print(f"[serve] wrote metrics snapshot -> {args.metrics_out}")
        if args.prom_out:
            obs.write_prometheus(args.prom_out, bundle.registry)
            print(f"[serve] wrote prometheus text -> {args.prom_out}")
        if args.flight_out:
            doc = engine.flight.write(args.flight_out, reason="end_of_run")
            print(f"[serve] wrote flight record -> {args.flight_out} "
                  f"(steps={len(doc['steps'])} "
                  f"requests={len(doc['requests'])} "
                  f"trips={len(doc['trips'])})")
    finally:
        engine.close()


if __name__ == "__main__":
    main()
