"""Serving launcher: continuous batching over a request-trace workload
(counterpart of ``repro/launch/serve.py``, step-indexed replay).

Replays a trace through the port's ``ServeEngine``: arrivals are measured
in engine steps, every request is submitted up front and the scheduler
releases each as the step counter passes its arrival — deterministic.
Wall-clock replay (``arrival_s``) is not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \\
        --full --trace smoke6 --batch_slots 3 --verify

Trace file (``--trace``, JSON lines; a bare name resolves to
``benchmarks/traces/<name>.jsonl``)::

    {"id": 0, "arrival": 0, "prompt_len": 12, "max_new": 16}
    {"id": 1, "arrival": 3, "prompt": [17, 3, 99], "max_new": 8}

``--kv paged --page_size N`` serves from the page pool (``--pool_pages``
caps it; ``--kv-dtype int8`` stores quantized pages).  ``--verify`` re-runs
every completed request through a one-slot one-shot engine and checks the
continuous outputs are bit-identical: a dense one for full-precision runs
(for a paged run, the paged-vs-dense check), a paged one of the same
``kv_dtype`` for int8 pages.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np


def load_trace(path: str, vocab_size: int, seed: int = 0) -> List[dict]:
    """Parse a JSONL trace; synthesize prompt tokens where only
    ``prompt_len`` is given (deterministically, per request id — the same
    tokens as the reference's ``load_trace``)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rec = json.loads(line)
            later = {"arrival_s", "group", "cancel_after"} & set(rec)
            if later:
                raise NotImplementedError(
                    f"trace fields {sorted(later)} (wall-clock replay, shared "
                    f"prefixes, cancellation) come with the launcher's later "
                    f"slices (ROADMAP Queue A items 7 and 6.5)")
            if "prompt" in rec:
                prompt = np.asarray(rec["prompt"], np.int32)
            else:
                rng = np.random.default_rng(seed + int(rec["id"]))
                prompt = rng.integers(0, vocab_size,
                                      size=(int(rec["prompt_len"]),)
                                      ).astype(np.int32)
            out.append({"id": int(rec["id"]),
                        "arrival": int(rec.get("arrival", 0)),
                        "prompt": prompt,
                        "max_new": int(rec["max_new"])})
    return sorted(out, key=lambda r: (r["arrival"], r["id"]))


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


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(xs, q)) if xs else float("nan")


def run_trace(engine, trace: List[dict],
              log: Optional[Callable[[str], None]] = print) -> dict:
    """Replay ``trace`` (step-indexed).  Returns {results: {trace_id:
    tokens}, wall_s, tokens, tok_s, p50_ms, p99_ms, ttft_p50_ms,
    ttft_p99_ms, shared_steps, decode_steps, kv_bytes_hwm,
    kv_bytes_reserved}, and for a paged engine pages_hwm, pages_reclaimed
    and preemptions (the last two counted over this replay).

    ``p50/p99_ms`` are per-stream inter-token gaps (the engine's
    ``itl_ms`` events); ``ttft_*`` cover runnable -> first token.  Arrivals
    are relative to the engine's current step, so a warm engine replays
    the same schedule."""
    log = log or (lambda s: None)
    rid_to_tid: Dict[int, int] = {}
    base = engine.step_count
    for t in trace:
        rid = engine.submit(t["prompt"], t["max_new"],
                            arrival=base + t["arrival"])
        rid_to_tid[rid] = t["id"]
    stats0 = dict(engine.stats)
    pool = engine.pool
    reclaimed0 = pool.total_reclaimed if pool is not None else 0
    itl: List[float] = []
    ttft: List[float] = []
    t0 = time.perf_counter()
    while not engine.sched.done():
        ev = engine.step()
        itl += list(ev["itl_ms"].values())
        ttft += list(ev["ttft_ms"].values())
        older = sorted(set(ev["decoded"]) - set(ev["admitted"]))
        if ev["admitted"] and older:
            log(f"[serve] step={engine.step_count - 1} "
                f"admitted={[rid_to_tid[r] for r in ev['admitted']]} "
                f"sharing decode with {[rid_to_tid[r] for r in older]}")
        for rid in ev["preempted"]:
            log(f"[serve] preempted id={rid_to_tid[rid]} (pool exhausted) "
                f"— requeued at the head")
        for rid in ev["finished"]:
            log(f"[serve] done id={rid_to_tid[rid]} "
                f"tokens={len(engine.result(rid))}")
    wall = time.perf_counter() - t0
    results = {rid_to_tid[rid]: toks for rid, toks in engine.drain().items()}
    tokens = sum(len(v) for v in results.values())
    rep = {
        "results": results,
        "wall_s": wall,
        "tokens": tokens,
        "tok_s": tokens / wall if wall > 0 else float("inf"),
        "p50_ms": _pct(itl, 50), "p99_ms": _pct(itl, 99),
        "ttft_p50_ms": _pct(ttft, 50), "ttft_p99_ms": _pct(ttft, 99),
        "shared_steps": engine.stats["shared_steps"] - stats0["shared_steps"],
        "decode_steps": engine.stats["decode_steps"] - stats0["decode_steps"],
        "kv_bytes_hwm": engine.kv_bytes_high_water(),
        "kv_bytes_reserved": engine.kv_bytes_reserved(),
    }
    if pool is not None:
        rep["pages_hwm"] = pool.high_water
        rep["pages_reclaimed"] = pool.total_reclaimed - reclaimed0
        rep["preemptions"] = (engine.stats["preemptions"]
                              - stats0["preemptions"])
    return rep


def _verify(cfg, params, trace, results, scfg) -> None:
    """Re-run every request one-shot (a one-slot engine on the same
    kernels) and require the continuous-batching outputs to be
    bit-identical.  For a full-precision run the one-shot engine is
    *dense*, so for a paged run this is also the paged-vs-dense check.
    With ``kv_dtype`` set it keeps the same paged layout and page dtype
    (the dense layout has no page pool to retype, and quantization would
    differ from it by more than the batching machinery under test)."""
    from repro_torch.serving.engine import ServeEngine
    if scfg.kv_dtype is None:
        one_scfg = dataclasses.replace(scfg, batch_slots=1, kv="dense")
        ref_name = "one-shot dense generate()"
    else:
        one_scfg = dataclasses.replace(scfg, batch_slots=1)
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
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--full", action="store_true",
                    help="serve the FULL config (default: SMOKE)")
    ap.add_argument("--trace", default=None,
                    help="JSONL trace file or bare name under "
                         "benchmarks/traces/ (default: a synthetic trace)")
    ap.add_argument("--batch_slots", type=int, default=4)
    ap.add_argument("--max_new", type=int, default=24,
                    help="tokens per request of the synthetic trace (8 "
                         "requests of 16 prompt tokens, 3 steps apart)")
    ap.add_argument("--verify", action="store_true",
                    help="check each completed request against a one-shot "
                         "single-slot generate()")
    ap.add_argument("--kv", choices=("dense", "paged"), default="dense",
                    help="KV layout: dense per-slot max_len rows, or the "
                         "kvpool page pool + block tables")
    ap.add_argument("--page_size", type=int, default=None,
                    help="paged: tokens per page (required: the tuner that "
                         "would pick it is not ported)")
    ap.add_argument("--pool_pages", type=int, default=0,
                    help="paged: pool capacity in pages (0 = the "
                         "dense-equivalent slots * ceil(max_len/page))")
    ap.add_argument("--kv-dtype", dest="kv_dtype", default=None,
                    choices=("bfloat16", "float32", "int8"),
                    help="paged: page dtype (default: the model's cache "
                         "dtype; int8 stores quantized pages with per-row "
                         "scales, dequantized inside the decode kernel)")
    ap.add_argument("--gemm-mode", dest="gemm_mode", default="auto",
                    choices=("auto", "kernel", "ref"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import configs as C
    from repro_torch.models import init_params
    from repro_torch.models.layers import set_gemm_mode
    from repro_torch.serving.engine import ServeConfig, ServeEngine

    set_gemm_mode(args.gemm_mode)
    cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
    params = init_params(cfg, seed=1, device=args.device)
    if args.trace:
        trace = load_trace(resolve_trace_path(args.trace), cfg.vocab_size)
    else:
        trace = synth_trace(8, 16, args.max_new, 3, cfg.vocab_size)
    max_len = max(len(t["prompt"]) + t["max_new"] for t in trace) + 8
    engine = ServeEngine(cfg, params, ServeConfig(
        batch_slots=args.batch_slots, max_len=max_len, kv=args.kv,
        page_size=args.page_size, pool_pages=args.pool_pages,
        kv_dtype=args.kv_dtype))
    try:
        rep = run_trace(engine, trace)
        if len(rep["results"]) != len(trace):
            raise SystemExit(f"only {len(rep['results'])}/{len(trace)} "
                             f"requests completed")
        print(f"[serve] {rep['tokens']} tokens in {rep['wall_s']:.3f}s "
              f"({rep['tok_s']:.1f} tok/s) p50={rep['p50_ms']:.2f}ms "
              f"p99={rep['p99_ms']:.2f}ms ttft_p50={rep['ttft_p50_ms']:.2f}ms "
              f"ttft_p99={rep['ttft_p99_ms']:.2f}ms "
              f"shared_steps={rep['shared_steps']} "
              f"decode_steps={rep['decode_steps']} arch={cfg.name} "
              f"slots={engine.scfg.batch_slots} device={engine.device}")
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
        if args.verify:
            _verify(cfg, params, trace, rep["results"], engine.scfg)
    finally:
        engine.close()


if __name__ == "__main__":
    main()
