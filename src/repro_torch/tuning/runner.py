"""Empirical measurement of pruned candidates (counterpart of
``repro/tuning/runner.py``).

``time_gemm``, ``time_attention``, ``time_decode`` and ``time_wkv`` time
the CUDA kernel launched with one candidate's plan on the card: device
time from CUDA events around a CUDA graph of repeated calls whose inputs
rotate over copies covering twice the card's L2, so operands come from
device memory as on the serve path.  Their numerics gate: the candidate's
output must be ``torch.equal`` to the analytic plan's output on the same
inputs (the port's plans differ only in which block sums what, never in
the order of a sum) and within the JAX suite's tolerance of the plain
version.  A candidate with other bits is a failed trial, never a winner.
For CPU tensors they raise ``ValueError``: the kernels have no CPU build
and the plain versions take no plan, so a CPU timing would measure
nothing that a plan decides.

``time_serve`` runs the port's ``ServeEngine`` end to end over the
reference's staggered, shared-prefix tuning trace, on the card or, when
the caller asks, on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import statistics
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import hw
from repro_torch.kernels import decode_attention, flash_attention, gemm, ref
from repro_torch.kernels import wkv as wkv_mod
from repro_torch.tuning.space import (AttentionCandidate, DecodeCandidate,
                                      GemmCandidate, ServeCandidate,
                                      WkvCandidate, torch_dtype)


@dataclasses.dataclass
class Measurement:
    us: float                  # robust per-call estimate
    samples_us: List[float]    # raw per-rep timings
    max_err: float             # |kernel - plain| on the probe inputs
    ok: bool                   # numerics gate passed
    bits_equal: Optional[bool] = None   # == the analytic plan's output

    def to_json(self) -> dict:
        out = {"us": self.us, "samples_us": self.samples_us,
               "max_err": self.max_err, "ok": self.ok}
        if self.bits_equal is not None:
            out["bits_equal"] = self.bits_equal
        return out


def robust_us(samples: List[float], trim: float = 0.25) -> float:
    """Median of the fastest (1 - trim) fraction — one-sided rejection.

    Timing noise on a shared host is strictly additive (preemption, GC),
    so slow outliers are discarded and fast samples trusted.
    """
    if not samples:
        return float("nan")
    keep = sorted(samples)[:max(1, int(len(samples) * (1.0 - trim)) or 1)]
    return statistics.median(keep)


def measure_fn(fn: Callable[[], object], warmup: int = 1,
               reps: int = 5) -> List[float]:
    """Per-rep wall times in microseconds, after ``warmup`` calls.

    ``fn`` must finish its work before it returns (read its result back)
    so asynchronous launches cannot hide the work.
    """
    from repro_torch.obs import get_obs
    obs = get_obs()
    obs.registry.counter("tuning.measurements",
                         "candidate timing runs").inc()
    with obs.tracer.span("tune.measure", cat="tuning",
                         warmup=warmup, reps=reps):
        for _ in range(max(0, warmup)):
            fn()
        out: List[float] = []
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e6)
    return out


def device_us(calls: List[Callable[[], object]], warmup: int = 1,
              reps: int = 3, per_graph: int = 24) -> List[float]:
    """Device microseconds of one call, one sample per rep: ``calls``
    (closures over the copies of the inputs) captured round robin in a
    CUDA graph of at least ``per_graph`` calls, replayed ``warmup`` times
    untimed, then ``reps`` times between CUDA events."""
    from repro_torch.obs import get_obs
    get_obs().registry.counter("tuning.measurements",
                               "candidate timing runs").inc()
    n = max(per_graph, len(calls))
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            calls[i % len(calls)]()
    for _ in range(max(0, warmup)):
        graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(max(1, reps)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / n)
    del graph
    return out


def copies_past_l2(nbytes: int) -> int:
    """Copies of ``nbytes`` of inputs that cover twice the card's L2 (at
    most 256)."""
    return max(1, min(256, math.ceil(2 * hw.H100_SXM.l2_bytes
                                     / max(1, nbytes))))


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"the kernels are CUDA C++ for sm_90a with no CPU build, and the "
            f"plain versions take no plan: a timing on {dev} would measure "
            f"nothing a plan decides (use a CUDA device)")
    return dev


def _gate(got: torch.Tensor, analytic: torch.Tensor, want: torch.Tensor,
          tol: float):
    """(max |got - plain|, bits equal to the analytic plan's, ok)."""
    err = float((got.double() - want.double()).abs().max())
    same = torch.equal(got, analytic)
    return err, same, same and math.isfinite(err) and err <= tol


def _measure(calls, got, analytic, want, tol, warmup, reps):
    samples = device_us(calls, warmup=warmup, reps=reps)
    err, same, ok = _gate(got, analytic, want, tol)
    return Measurement(us=robust_us(samples), samples_us=samples,
                       max_err=err, ok=ok, bits_equal=same)


# ---------------------------------------------------------------------------
# Kernel probes.  One probe per shape is kept (the tune loop times every
# candidate of one shape in a row): the inputs and their copies, the
# analytic plan's output and the plain version's.
# ---------------------------------------------------------------------------


def release() -> None:
    """Drop the kept probe inputs (device memory) after a tune."""
    _gemm_probe.cache_clear()
    _attention_probe.cache_clear()


def _rand(gen, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(dtype)


@functools.lru_cache(maxsize=1)
def _gemm_probe(m, k, n, dtype_name, device):
    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device=device).manual_seed(0)
    if dtype == torch.int8:
        def mk(shape):
            return torch.randint(-128, 128, shape, generator=gen,
                                 device=device, dtype=torch.int8)
    else:
        def mk(shape):
            return _rand(gen, shape, dtype)
    a = mk((m, k))
    bs = [mk((k, n)) for _ in range(copies_past_l2(
        (m * k + k * n) * dtype.itemsize))]
    analytic = gemm.gama_gemm(a, bs[0], plan=gemm.plan(m, k, n, dtype))
    want = ref.ref_gemm(a, bs[0])
    return a, bs, analytic, want


def time_gemm(cand: GemmCandidate, m: int, k: int, n: int, dtype_name: str,
              *, device="cuda", warmup: int = 1, reps: int = 3,
              rtol: float = 2e-2) -> Measurement:
    """Time ``gama_gemm`` with the candidate's plan; its output must equal
    the analytic plan's bit for bit and lie within ``rtol`` * max |plain|
    of the plain version."""
    dev = _cuda_device(device)
    a, bs, analytic, want = _gemm_probe(m, k, n, dtype_name, dev)
    plan = cand.plan
    calls = [functools.partial(gemm.gama_gemm, a, b, plan=plan) for b in bs]
    got = gemm.gama_gemm(a, bs[0], plan=plan)
    scale = float(want.double().abs().max()) or 1.0
    return _measure(calls, got, analytic, want, rtol * scale, warmup,
                    reps)


@functools.lru_cache(maxsize=1)
def _attention_probe(hq, hkv, sq, sk, d, dtype_name, device):
    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device=device).manual_seed(0)
    per = d * (hq * sq + 2 * hkv * sk) * dtype.itemsize
    sets = [tuple(_rand(gen, (1, h, s, d), dtype)
                  for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
            for _ in range(copies_past_l2(per))]
    q, k, v = sets[0]
    analytic = flash_attention.flash_attention(
        q, k, v, plan=flash_attention.plan(1, hq, hkv, sq, sk, d, dtype))
    want = ref.ref_attention(q, k, v)
    return sets, analytic, want


def time_attention(cand: AttentionCandidate, sq: int, sk: int, d: int,
                   dtype_name: str = "bfloat16", hq: int = 4, hkv: int = 2,
                   *, device="cuda", warmup: int = 1, reps: int = 3,
                   atol: float = 5e-2) -> Measurement:
    """Time causal ``flash_attention`` (one sequence, q_offset 0) with the
    candidate's plan; equal bits to the analytic plan, within ``atol`` of
    the plain version."""
    dev = _cuda_device(device)
    sets, analytic, want = _attention_probe(hq, hkv, sq, sk, d, dtype_name,
                                            dev)
    plan = cand.plan
    calls = [functools.partial(flash_attention.flash_attention, *qkv,
                               plan=plan) for qkv in sets]
    got = flash_attention.flash_attention(*sets[0], plan=plan)
    return _measure(calls, got, analytic, want, atol, warmup, reps)


def _decode_call(chunk, q, k, v, length):
    out = torch.empty_like(q)
    decode_attention.launch(decode_attention._lib(), chunk, q, k, v, length,
                            out, q.shape[-1] ** -0.5)
    return out


def time_decode(cand: DecodeCandidate, sk: int, d: int,
                dtype_name: str = "bfloat16", b: int = 1, hq: int = 4,
                hkv: int = 2, *, device="cuda", warmup: int = 1,
                reps: int = 3, atol: float = 5e-2) -> Measurement:
    """Time the dense decode kernel with the candidate's chunk (the kernel
    refuses any other than ``decode_chunk``'s), every slot at ``sk``
    keys."""
    dev = _cuda_device(device)
    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device=dev).manual_seed(0)
    length = torch.full((b,), sk, dtype=torch.int32, device=dev)
    per = d * b * (hq + 2 * hkv * sk) * dtype.itemsize
    sets = [tuple(_rand(gen, shape, dtype)
                  for shape in ((b, hq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
            for _ in range(copies_past_l2(per))]
    calls = [functools.partial(_decode_call, cand.bk, *qkv, length)
             for qkv in sets]
    got = _decode_call(cand.bk, *sets[0], length)
    analytic = decode_attention.flash_decode(*sets[0], length=length)
    want = ref.ref_decode_attention(*sets[0], length=length)
    return _measure(calls, got, analytic, want, atol, warmup, reps)


def _wkv_call(chunk, r, k, v, w, u):
    y = torch.empty_like(r)
    wkv_mod.launch_fwd(wkv_mod._lib(), chunk, r, k, v, w, u, y)
    return y


def time_wkv(cand: WkvCandidate, t: int, n: int,
             dtype_name: str = "bfloat16", b: int = 1, h: int = 2, *,
             device="cuda", warmup: int = 1, reps: int = 3,
             atol: float = 5e-2) -> Measurement:
    """Time the WKV6 forward with the candidate's chunk (the kernel
    refuses any other than ``wkv_chunk``'s); r/k/v in ``dtype_name``, w
    and u in f32 at the training path's scale."""
    dev = _cuda_device(device)
    dtype = torch_dtype(dtype_name)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (b, h, t, n)
    per = b * h * t * n * (3 * dtype.itemsize + 4)

    def inputs():
        r, k, v = (_rand(gen, shape, dtype, 0.5) for _ in range(3))
        w = torch.exp(-torch.exp(
            torch.rand(shape, generator=gen, device=dev) * 10 - 8))
        u = torch.randn((h, n), generator=gen, device=dev) * 0.1
        return r, k, v, w, u

    sets = [inputs() for _ in range(copies_past_l2(per))]
    calls = [functools.partial(_wkv_call, cand.chunk, *x) for x in sets]
    got = _wkv_call(cand.chunk, *sets[0])
    analytic = wkv_mod.wkv6(*sets[0])
    want = ref.ref_wkv(*sets[0])
    return _measure(calls, got, analytic, want, atol, warmup, reps)


def time_serve(cand: ServeCandidate, cfg, max_len: Optional[int] = None,
               prompt_len: int = 8, max_new: int = 8,
               requests: Optional[int] = None, stagger: int = 2,
               warmup: int = 0, reps: int = 1,
               device="cuda") -> Measurement:
    """Time one engine configuration end to end through the port's
    ``ServeEngine`` on the reference's staggered-arrival trace (a request
    every ``stagger`` steps, the first half of every prompt shared, so
    the prefix-cache axis is exercised).  ``max_len`` is the engine's KV
    length, the value the cache entry is keyed under.  ``us`` is wall
    time per generated token; the gate is completeness (every request
    finished with exactly ``max_new`` tokens).  Runs on ``device``: the
    card, or the CPU (SMOKE sizes) when the caller asks."""
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServeConfig, ServeEngine
    if max_len is None:
        max_len = prompt_len + max_new + 8
    if prompt_len + max_new > max_len:
        raise ValueError(f"prompt_len + max_new exceeds max_len={max_len}")
    n_req = requests if requests is not None else max(4, 2 * cand.slots)
    params = init_params(cfg, seed=0, device=device)
    engine = ServeEngine(cfg, params, ServeConfig(
        batch_slots=cand.slots, max_len=max_len, pretune=False,
        kv="paged" if cand.page_size > 0 else "dense",
        page_size=cand.page_size,
        kv_dtype=cand.kv_dtype or None,
        prefill_chunk=cand.prefill_chunk,
        prefix_cache=cand.prefix_cache))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(n_req, prompt_len)).astype(np.int32)
    prompts[:, :prompt_len // 2] = prompts[0, :prompt_len // 2]
    last: dict = {}

    def run():
        base = engine.step_count
        for i in range(n_req):
            engine.submit(prompts[i], max_new, arrival=base + i * stagger)
        last.clear()
        last.update(engine.drain())
        return last

    try:
        samples = measure_fn(run, warmup=warmup, reps=reps)
    finally:
        engine.close()
    per_tok = [s / (n_req * max_new) for s in samples]
    ok = (len(last) == n_req
          and all(len(v) == max_new for v in last.values()))
    return Measurement(us=robust_us(per_tok), samples_us=per_tok,
                       max_err=0.0, ok=ok)


def pick_best(cands: List, results: List[Measurement]
              ) -> Optional[int]:
    """Index of the fastest candidate that passed its gate, or None."""
    best_i: Optional[int] = None
    for i, meas in enumerate(results):
        if not meas.ok:
            continue
        if best_i is None or meas.us < results[best_i].us:
            best_i = i
    return best_i
