"""Hot-path dispatch: cached-best plans with an analytic fallback
(counterpart of ``repro/tuning/dispatch.py``).

Lookup order per ``(op, shape, dtype, backend, device_kind)``:

1. the in-process memo;
2. the persistent tuning cache (loaded once per process);
3. the analytic prior: exactly the plan an untuned port launches.

The reference looks plans up only while jit traces.  The port looks them
up on every eager call (``ops.matmul`` runs 225 times a SmolLM-360M
decode step), so a memo hit is one dict lookup on a tuple key such as
``(m, k, n, dtype, device index)``; the string key and the backend
fingerprint are built only on a miss.  A cached plan that the kernel
refuses raises, naming the key and the file: it never quietly gives way
to the analytic plan.

``tune_gemm``, ``tune_attention``, ``tune_decode``, ``tune_wkv``,
``tune_serve`` and ``tune_pack`` run the pipeline (enumerate the design
space, prune with the prior, measure the survivors, persist the winner);
the CLI drives them.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import decode_attention, flash_attention, gemm, wkv
from repro_torch.tuning import prior
from repro_torch.tuning.cache import TuningCache, cache_key
from repro_torch.tuning.space import (AttentionCandidate, DecodeCandidate,
                                      DesignSpace, GemmCandidate,
                                      PackCandidate, ServeCandidate,
                                      WkvCandidate, canonical_dtype,
                                      torch_dtype)


def _device_index(device) -> int:
    """A device as torch's index: -1 for the CPU.  None is the default
    device: the current CUDA device when there is one, else the CPU."""
    if device is None:
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else -1
    if isinstance(device, int):
        return device
    dev = torch.device(device)
    if dev.type == "cpu":
        return -1
    if not torch.cuda.is_available():
        raise ValueError(f"device {device!r} asked for, but torch sees no "
                         f"CUDA card (only serve and pack tune on the CPU)")
    return torch.cuda.current_device() if dev.index is None else dev.index


def backend_fingerprint(device=None) -> Tuple[str, str]:
    """(backend, device_kind), the hardware half of the cache key:
    ``("cuda", the card's name with spaces as _)`` or ``("cpu", "cpu")``."""
    index = _device_index(device)
    if index < 0:
        return "cpu", "cpu"
    return "cuda", torch.cuda.get_device_name(index).replace(" ", "_")


# ---------------------------------------------------------------------------
# Process-level state (memo + cache singleton)
# ---------------------------------------------------------------------------

_MEMO: Dict[tuple, object] = {}
_CACHE: Optional[TuningCache] = None
_CACHE_PATH: Optional[Path] = None


def set_cache_path(path) -> None:
    """Point dispatch at a specific cache file (tests, CLI --cache)."""
    global _CACHE, _CACHE_PATH
    _CACHE_PATH = Path(path) if path is not None else None
    _CACHE = None
    _MEMO.clear()


def reset() -> None:
    """Drop all in-process state; the next lookup reloads from disk."""
    set_cache_path(None)


def get_cache() -> TuningCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = TuningCache(_CACHE_PATH).load()
    return _CACHE


def _cached_config(key: str, cls, check):
    """The cached candidate under ``key``, or None.  ``check(candidate)``
    raises ValueError for one the kernel does not take, which becomes an
    error naming the key and the file."""
    tc = get_cache()
    entry = tc.get(key)
    if entry is None or "config" not in entry:
        return None
    cand = cls.from_json(entry["config"])
    try:
        check(cand)
    except ValueError as e:
        raise ValueError(f"tuning cache entry {key!r} in {tc.path} holds a "
                         f"plan the kernel does not take: {e}") from None
    return cand


# ---------------------------------------------------------------------------
# Hot-path lookups
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    plan: gemm.Plan
    source: str   # "cache" | "analytic"


def gemm_config(m: int, k: int, n: int, dtype, device=None) -> GemmConfig:
    """Best-known ``gama_gemm`` plan for this shape on this device
    (``device``: a CUDA index, -1 for the CPU, None the default)."""
    hit = _MEMO.get((m, k, n, dtype, device))
    if hit is not None:
        return hit  # type: ignore[return-value]
    tdt = torch_dtype(dtype)
    backend, kind = backend_fingerprint(device)
    key = cache_key("gemm", m, n, k, canonical_dtype(tdt), backend, kind)
    c = _cached_config(key, GemmCandidate,
                       lambda c: gemm.check_plan(c.plan, k, tdt))
    cfg = (GemmConfig(c.plan, "cache") if c is not None
           else GemmConfig(gemm.plan(m, k, n, tdt), "analytic"))
    _MEMO[(m, k, n, dtype, device)] = cfg
    return cfg


def _attention_key(hq, hkv, sq, sk, d, dt, backend, kind) -> str:
    """The reference's attention slots, plus the GQA heads the port's plan
    depends on."""
    return cache_key("attention", sq, sk, d, dt, backend, kind,
                     extra=f"h{hq}x{hkv}")


def attention_blocks(sq: int, sk: int, d: int, dtype, *, hq: int, hkv: int,
                     device=None) -> flash_attention.Plan:
    """Best-known ``flash_attention`` plan for this shape and GQA group."""
    hit = _MEMO.get((hq, hkv, sq, sk, d, dtype, device))
    if hit is not None:
        return hit  # type: ignore[return-value]
    tdt = torch_dtype(dtype)
    backend, kind = backend_fingerprint(device)
    key = _attention_key(hq, hkv, sq, sk, d, canonical_dtype(tdt), backend,
                         kind)
    c = _cached_config(
        key, AttentionCandidate,
        lambda c: flash_attention.check_plan(c.plan, hq, hkv, d, tdt))
    plan = (c.plan if c is not None
            else flash_attention.plan(1, hq, hkv, sq, sk, d, tdt))
    _MEMO[(hq, hkv, sq, sk, d, dtype, device)] = plan
    return plan


def _one_point(name: str, got: int, want: int) -> None:
    if got != want:
        raise ValueError(f"the {name} kernels take {want}, not {got}")


def decode_block(sk: int, d: int, dtype, device=None) -> int:
    """Keys per chunk of the decode kernels for a (Sk, D) cache of
    ``dtype`` (the KV dtype): ``decode_chunk``'s, the one value the
    kernels take."""
    tdt = torch_dtype(dtype)
    memo = ("decode", sk, d, tdt, device)
    hit = _MEMO.get(memo)
    if hit is not None:
        return hit  # type: ignore[return-value]
    backend, kind = backend_fingerprint(device)
    key = cache_key("decode", sk, d, 1, canonical_dtype(tdt), backend, kind)
    want = decode_attention.decode_chunk(d, tdt)
    c = _cached_config(key, DecodeCandidate,
                       lambda c: _one_point("decode", c.bk, want))
    _MEMO[memo] = bk = c.bk if c is not None else want
    return bk


def wkv_chunk(t: int, n: int, dtype, device=None) -> int:
    """Steps per chunk of the WKV6 kernels for a (T, N) recurrence:
    ``wkv_chunk``'s, the one value the kernels take."""
    tdt = torch_dtype(dtype)
    memo = ("wkv", t, n, tdt, device)
    hit = _MEMO.get(memo)
    if hit is not None:
        return hit  # type: ignore[return-value]
    backend, kind = backend_fingerprint(device)
    key = cache_key("wkv", t, n, 1, canonical_dtype(tdt), backend, kind)
    want = wkv.wkv_chunk(t, n, tdt)
    c = _cached_config(key, WkvCandidate,
                       lambda c: _one_point("wkv", c.chunk, want))
    _MEMO[memo] = chunk = c.chunk if c is not None else want
    return chunk


def _pack_key(m, k, n, dt, backend, kind, data_axis, model_axis) -> str:
    return cache_key("pack", m, n, k, dt, backend, kind,
                     extra=f"mesh{data_axis}x{model_axis}")


def pack_config(m: int, k: int, n: int, dtype, *, data_axis: int = 1,
                model_axis: int = 1, device=None) -> PackCandidate:
    """Best-known (P, Q, stagger, reduce, overlap) pack grid for this
    shape on a (data_axis, model_axis) mesh; a miss takes the analytic
    prior (the planner's KCE sweep under the overlap-aware step model)."""
    dt = canonical_dtype(dtype)
    backend, kind = backend_fingerprint(device)
    key = _pack_key(m, k, n, dt, backend, kind, data_axis, model_axis)
    hit = _MEMO.get(key)
    if hit is not None:
        return hit  # type: ignore[return-value]
    cand = _cached_config(key, PackCandidate, lambda c: None)
    if cand is None:
        cand = prior.analytic_pack(m, k, n, data_axis, model_axis)
    _MEMO[key] = cand
    return cand


def _serve_key(cfg, max_len: int, dt: str, backend: str, kind: str) -> str:
    """Cache key of the engine tunables: the arch (name, width and vocab)
    and the cache length are the workload."""
    return cache_key("serve", cfg.d_model, cfg.vocab_size, max_len, dt,
                     backend, kind, extra=f"arch{cfg.name}")


def serve_config(cfg, max_len: int, dtype, device=None) -> ServeCandidate:
    """Best-known engine tunables for this arch and workload, else the
    analytic prior (8 slots, pages of 32, the cache dtype, monolithic,
    uncached)."""
    dt = canonical_dtype(dtype)
    backend, kind = backend_fingerprint(device)
    key = _serve_key(cfg, max_len, dt, backend, kind)
    hit = _MEMO.get(key)
    if hit is not None:
        return hit  # type: ignore[return-value]
    cand = _cached_config(key, ServeCandidate, lambda c: None)
    if cand is None:
        cand = prior.analytic_serve(max_len)
    _MEMO[key] = cand
    return cand


def serve_slots(cfg, max_len: int, dtype, device=None) -> int:
    """The engine's ``batch_slots=0`` hook: the tuned slot count, else 8."""
    return serve_config(cfg, max_len, dtype, device).slots


def serve_page_size(cfg, max_len: int, dtype, device=None) -> int:
    """The paged engine's ``page_size=0`` hook.  A tuned *dense* winner
    (page_size 0) gives the analytic 32: the caller chose the paged
    layout and asks only for the granularity."""
    tuned = serve_config(cfg, max_len, dtype, device).page_size
    return tuned if tuned > 0 else prior.analytic_serve(max_len).page_size


def serve_kv_dtype(cfg, max_len: int, dtype, device=None) -> Optional[str]:
    """The tuned page dtype, or None (the cache dtype) unless a measured
    entry chose quantized pages: a miss never changes numerics."""
    from repro_torch.models import paged_eligible
    if not paged_eligible(cfg):
        return None
    return serve_config(cfg, max_len, dtype, device).kv_dtype or None


def serve_prefill_chunk(cfg, max_len: int, dtype, device=None) -> int:
    """The engine's ``prefill_chunk=None`` hook: 0 (monolithic) unless a
    measured entry chose a chunk; always 0 for archs the chunked path
    cannot cover."""
    from repro_torch.models import paged_eligible
    if not paged_eligible(cfg):
        return 0
    return serve_config(cfg, max_len, dtype, device).prefill_chunk


def serve_prefix_cache(cfg, max_len: int, dtype, device=None) -> bool:
    """False (no sharing) unless a measured entry chose the prefix cache;
    always False for archs the page pool cannot cover."""
    from repro_torch.models import paged_eligible
    if not paged_eligible(cfg):
        return False
    return serve_config(cfg, max_len, dtype, device).prefix_cache


def warm_gemm_shapes(shapes: Sequence[tuple], dtype,
                     device=None) -> int:
    """Resolve the plans of a model's GEMM shapes at engine start, so the
    first forward never reads the cache file.  A shape is (M, K, N) in
    ``dtype``, or (M, K, N, its own dtype).  Returns how many came from
    the persistent cache."""
    return sum(gemm_config(m, k, n, own[0] if own else dtype,
                           device).source == "cache"
               for (m, k, n, *own) in shapes)


# ---------------------------------------------------------------------------
# Tuning pipeline (space -> prior prune -> measure -> persist)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TuneResult:
    key: str
    best: Optional[dict]           # winning candidate config (JSON form)
    best_us: Optional[float]
    cache_hit: bool                # True = nothing measured, entry existed
    trials: List[dict]             # per-candidate {config, us, max_err, ok}
    space_size: int = 0

    def summary(self) -> str:
        if self.cache_hit:
            return f"cache hit: {self.key} -> {self.best}"
        if self.best is None:
            return f"tuning failed: no candidate passed numerics ({self.key})"
        if self.best_us is None:
            return f"tuned {self.key} -> {self.best} (analytic, unmeasured)"
        return (f"tuned {self.key} -> {self.best} "
                f"({self.best_us:.1f} us, {len(self.trials)} measured)")


def _now() -> float:
    return time.time()


def _store(key: str, tc: TuningCache, entry: dict) -> None:
    tc.put(key, entry)
    tc.save()
    _MEMO.clear()   # the memo is keyed by tuples: drop every answer


def _measure_and_store(key: str, tc: TuningCache, survivors, measure,
                       space_size: int) -> TuneResult:
    """Measure each surviving candidate (one that raises is a failed
    trial, not an aborted tune), persist the fastest that passed its gate
    and drop the in-process memo."""
    from repro_torch.tuning import runner
    trials: List[dict] = []
    results = []
    try:
        for c in survivors:
            try:
                meas = measure(c)
            except Exception as e:  # noqa: BLE001 - candidate, not harness
                meas = runner.Measurement(us=float("inf"), samples_us=[],
                                          max_err=float("inf"), ok=False)
                trials.append({"config": c.to_json(), **meas.to_json(),
                               "error": repr(e)})
                results.append(meas)
                continue
            results.append(meas)
            trials.append({"config": c.to_json(), **meas.to_json()})
    finally:
        runner.release()
    best_i = runner.pick_best(survivors, results)
    if best_i is None:
        return TuneResult(key=key, best=None, best_us=None, cache_hit=False,
                          trials=trials, space_size=space_size)
    best = survivors[best_i]
    entry = {
        "config": best.to_json(),
        "us": results[best_i].us,
        "max_err": results[best_i].max_err,
        "space_size": space_size,
        "measured": len(survivors),
        "tuned_at": _now(),
    }
    _store(key, tc, entry)
    return TuneResult(key=key, best=entry["config"], best_us=entry["us"],
                      cache_hit=False, trials=trials, space_size=space_size)


def _cached_result(key: str, tc: TuningCache,
                   force: bool) -> Optional[TuneResult]:
    entry = tc.get(key)
    if entry is None or force:
        return None
    return TuneResult(key=key, best=entry.get("config"),
                      best_us=entry.get("us"), cache_hit=True, trials=[],
                      space_size=entry.get("space_size", 0))


def _kernel_device(device, op: str):
    """The CUDA device a kernel tune runs on; the CPU raises ValueError
    (see ``runner``)."""
    index = _device_index(device)
    if index < 0:
        raise ValueError(
            f"tune {op}: the kernels are CUDA C++ with no CPU build, and the "
            f"plain versions take no plan, so a CPU timing would measure "
            f"nothing a plan decides (tune on a card; only --op serve runs "
            f"on the CPU)")
    return torch.device("cuda", index)


def tune_gemm(m: int, k: int, n: int, dtype, *, keep: int = 8,
              warmup: int = 1, reps: int = 3, force: bool = False,
              cache: Optional[TuningCache] = None,
              device=None) -> TuneResult:
    """Measure the pruned ``gama_gemm`` plans of one shape on the card."""
    from repro_torch.tuning import runner
    dev = _kernel_device(device, "gemm")
    tdt = torch_dtype(dtype)
    dt = canonical_dtype(tdt)
    backend, kind = backend_fingerprint(dev)
    key = cache_key("gemm", m, n, k, dt, backend, kind)
    tc = cache if cache is not None else get_cache()
    hit = _cached_result(key, tc, force)
    if hit is not None:
        return hit
    space = DesignSpace.gemm(m, k, n, tdt)
    survivors = prior.prune_gemm(space, m, k, n, tdt, keep=keep)
    return _measure_and_store(
        key, tc, survivors,
        lambda c: runner.time_gemm(c, m, k, n, dt, device=dev,
                                   warmup=warmup, reps=reps),
        space_size=len(space))


def tune_attention(sq: int, sk: int, d: int, dtype="bfloat16", *,
                   hq: int = 4, hkv: int = 2, keep: int = 6,
                   warmup: int = 1, reps: int = 3, force: bool = False,
                   cache: Optional[TuningCache] = None,
                   device=None) -> TuneResult:
    """Measure the pruned ``flash_attention`` plans of one prefill shape
    and GQA group on the card."""
    from repro_torch.tuning import runner
    dev = _kernel_device(device, "attention")
    tdt = torch_dtype(dtype)
    dt = canonical_dtype(tdt)
    backend, kind = backend_fingerprint(dev)
    key = _attention_key(hq, hkv, sq, sk, d, dt, backend, kind)
    tc = cache if cache is not None else get_cache()
    hit = _cached_result(key, tc, force)
    if hit is not None:
        return hit
    space = DesignSpace.attention(hq, hkv, d, tdt)
    survivors = prior.prune_attention(space, hq, hkv, sq, sk, d, tdt,
                                      keep=keep)
    return _measure_and_store(
        key, tc, survivors,
        lambda c: runner.time_attention(c, sq, sk, d, dt, hq=hq, hkv=hkv,
                                        device=dev, warmup=warmup,
                                        reps=reps),
        space_size=len(space))


def tune_decode(sk: int, d: int, dtype="bfloat16", *, b: int = 1,
                hq: int = 4, hkv: int = 2, keep: int = 4, warmup: int = 1,
                reps: int = 3, force: bool = False,
                cache: Optional[TuningCache] = None,
                device=None) -> TuneResult:
    """Measure the decode kernels' one chunk for a (Sk, D) cache."""
    from repro_torch.tuning import runner
    dev = _kernel_device(device, "decode")
    tdt = torch_dtype(dtype)
    dt = canonical_dtype(tdt)
    backend, kind = backend_fingerprint(dev)
    key = cache_key("decode", sk, d, 1, dt, backend, kind)
    tc = cache if cache is not None else get_cache()
    hit = _cached_result(key, tc, force)
    if hit is not None:
        return hit
    space = DesignSpace.decode(sk, d, tdt)
    survivors = prior.prune_decode(space, sk, d, keep=keep)
    return _measure_and_store(
        key, tc, survivors,
        lambda c: runner.time_decode(c, sk, d, dt, b=b, hq=hq, hkv=hkv,
                                     device=dev, warmup=warmup, reps=reps),
        space_size=len(space))


def tune_wkv(t: int, n: int, dtype="bfloat16", *, b: int = 1, h: int = 2,
             keep: int = 4, warmup: int = 1, reps: int = 3,
             force: bool = False, cache: Optional[TuningCache] = None,
             device=None) -> TuneResult:
    """Measure the WKV6 kernels' one chunk for a (T, N) recurrence."""
    from repro_torch.tuning import runner
    dev = _kernel_device(device, "wkv")
    tdt = torch_dtype(dtype)
    dt = canonical_dtype(tdt)
    backend, kind = backend_fingerprint(dev)
    key = cache_key("wkv", t, n, 1, dt, backend, kind)
    tc = cache if cache is not None else get_cache()
    hit = _cached_result(key, tc, force)
    if hit is not None:
        return hit
    space = DesignSpace.wkv(t, n, tdt)
    survivors = prior.prune_wkv(space, t, n, keep=keep)
    return _measure_and_store(
        key, tc, survivors,
        lambda c: runner.time_wkv(c, t, n, dt, b=b, h=h, device=dev,
                                  warmup=warmup, reps=reps),
        space_size=len(space))


def tune_pack(m: int, k: int, n: int, dtype, *, data_axis: int = 1,
              model_axis: int = 1, keep: int = 6, warmup: int = 1,
              reps: int = 3, force: bool = False,
              cache: Optional[TuningCache] = None,
              device=None) -> TuneResult:
    """Store the analytic pack grid (the planner's KCE sweep), flagged
    ``analytic``.  The reference measures it through ``pack_gemm`` where
    the host has the devices; the port's pack GEMM over NCCL comes with
    ROADMAP Queue A item 12, so on a host with the cards for a
    multi-device mesh this raises rather than time something else."""
    devices = data_axis * model_axis
    if devices > 1 and torch.cuda.device_count() >= devices:
        raise NotImplementedError(
            f"tune --op pack on a {data_axis}x{model_axis} mesh of cards "
            f"needs the multi-device pack GEMM, which comes with ROADMAP "
            f"Queue A item 12")
    dt = canonical_dtype(dtype)
    backend, kind = backend_fingerprint(device)
    key = _pack_key(m, k, n, dt, backend, kind, data_axis, model_axis)
    tc = cache if cache is not None else get_cache()
    hit = _cached_result(key, tc, force)
    if hit is not None:
        return hit
    space = DesignSpace.pack(m, k, n, model_axis)
    best = prior.analytic_pack(m, k, n, data_axis, model_axis)
    entry = {"config": best.to_json(), "analytic": True,
             "space_size": len(space), "measured": 0, "tuned_at": _now()}
    _store(key, tc, entry)
    return TuneResult(key=key, best=entry["config"], best_us=None,
                      cache_hit=False,
                      trials=[{"config": entry["config"], "analytic": True}],
                      space_size=len(space))


def tune_serve(cfg, *, max_len: int = 64, prompt_len: int = 8,
               max_new: int = 8, requests: Optional[int] = None,
               stagger: int = 2, keep: int = 3, warmup: int = 0,
               reps: int = 1, force: bool = False,
               cache: Optional[TuningCache] = None,
               device=None) -> TuneResult:
    """Tune the engine (slots x page size x page dtype x prefill chunk x
    prefix cache) for one model config: each surviving candidate serves
    the staggered, shared-prefix trace through the port's ``ServeEngine``
    on ``device`` (the card by default; the CPU when asked) and is scored
    on measured us per token, completeness as its gate."""
    from repro_torch.models import paged_eligible
    from repro_torch.tuning import runner
    index = _device_index(device)
    dev = torch.device("cpu") if index < 0 else torch.device("cuda", index)
    dt = canonical_dtype(cfg.cdtype)
    backend, kind = backend_fingerprint(index)
    key = _serve_key(cfg, max_len, dt, backend, kind)
    tc = cache if cache is not None else get_cache()
    hit = _cached_result(key, tc, force)
    if hit is not None:
        return hit
    space = DesignSpace.serve(max_len=max_len)
    if not paged_eligible(cfg):
        space = [c for c in space if not c.kv_dtype
                 and not c.prefill_chunk and not c.prefix_cache]
    survivors = prior.prune_serve(space, max_len, keep=keep)
    return _measure_and_store(
        key, tc, survivors,
        lambda c: runner.time_serve(c, cfg, max_len=max_len,
                                    prompt_len=prompt_len, max_new=max_new,
                                    requests=requests, stagger=stagger,
                                    warmup=warmup, reps=reps, device=dev),
        space_size=len(space))
