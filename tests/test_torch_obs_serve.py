"""The port's instrumented serving path against the JAX package's, at SMOKE
size on the CPU: the engine's metrics, trace, step attribution, SLO
monitor and flight recorder, and the serve launcher's wall-clock replay,
cancellation, trace synthesis and output files.

Both engines serve smollm SMOKE (f32 compute) with the same parameters,
carried across with ``bridge.params_from_numpy``, each against a fresh
registry.  Step-indexed replays are deterministic, so their counters,
gauge high-waters, histogram counts, flight event sequences and span
multisets must be equal.  Wall-clock replays are deterministic in their
tokens only (which step admits a request depends on the clock), so they
are compared token for token.  Excluded from the equalities, with the
reason:

* the ``ops.*`` route counters: the reference ticks them once per
  compiled program, the port once per call;
* timing-derived series (``serve.decode_starved_steps``, which compares
  section times, ``serve.bubble_fraction``, the SLO window percentiles,
  ``profile.*.bound_ratio``);
* the ``tokens`` of a ``finished`` flight event and of the ``request``
  track's end: the reference reads ``slot.generated`` after
  ``Scheduler.release`` has zeroed it, so it always records 0; the port
  records the count.
"""

import collections
import functools
import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import obs as jobs
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch import obs as tobs
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import ServeConfig, ServeEngine

pytestmark = pytest.mark.serving

ARCH = "smollm_360m"
REPO = pathlib.Path(__file__).resolve().parents[1]
TIMED_GAUGES = ("serve.bubble_fraction", "slo.ttft.window_p99_ms",
                "slo.itl.window_p99_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's default pool of one thread per
    core only oversubscribes the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_bundles():
    yield
    tobs.reset()
    jobs.reset()


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jparams = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _trace(name):
    vocab = TC.get_smoke(ARCH).vocab_size
    return tserve.load_trace(tserve.resolve_trace_path(name), vocab)


def _run_both(trace, tracing=False, **scfg):
    """Replay ``trace`` through a fresh engine of each package, each on a
    fresh registry (and tracer); returns the two (report, engine,
    bundle) triples, JAX first."""
    jcfg, tcfg, jparams, tparams = _setup()
    out = []
    for mod, serve, Engine, Config, cfg, params in (
            (jobs, jserve, JServeEngine, JServeConfig, jcfg, jparams),
            (tobs, tserve, ServeEngine, ServeConfig, tcfg, tparams)):
        bundle = mod.configure(registry=mod.Registry(),
                               tracer=mod.Tracer(enabled=tracing))
        eng = Engine(cfg, params, Config(**scfg))
        try:
            rep = serve.run_trace(eng, trace, log=None)
        finally:
            eng.close()
        out.append((rep, eng, bundle))
    return out


def _deterministic(snap):
    counters = {k: v for k, v in snap["counters"].items()
                if not k.startswith(("ops.", "tuning."))
                and k != "serve.decode_starved_steps"}
    gauges = {k: (g["value"], g["high_water"])
              for k, g in snap["gauges"].items()
              if k not in TIMED_GAUGES and not k.endswith(".bound_ratio")}
    hists = {k: h["count"] for k, h in snap["histograms"].items()}
    return counters, gauges, hists


def _flight_requests(dump):
    drop = ("t_ms", "ttft_ms", "tokens")
    return {rid: [{k: v for k, v in e.items() if k not in drop}
                  for e in evs]
            for rid, evs in dump["requests"].items()}


def _flight_steps(dump):
    keep = ("step", "admitted", "decoded", "finished", "preempted")
    return [{k: r[k] for k in keep} for r in dump["steps"]]


CASES = {
    "smoke6-dense": ("smoke6", dict(batch_slots=3, max_len=36)),
    "shared16-prefix": ("shared16", dict(batch_slots=4, max_len=128,
                                         kv="paged", page_size=16,
                                         prefix_cache=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_indexed_replay_metrics_flight_and_trace_equal(case):
    name, scfg = CASES[case]
    trace = _trace(name)
    (jrep, jeng, jb), (trep, teng, tb) = _run_both(trace, tracing=True,
                                                   **scfg)
    for tid, toks in jrep["results"].items():
        np.testing.assert_array_equal(trep["results"][tid], toks,
                                      err_msg=f"trace id {tid}")
    jsnap, tsnap = jb.registry.snapshot(), tb.registry.snapshot()
    jcnt, jgauge, jhist = _deterministic(jsnap)
    tcnt, tgauge, thist = _deterministic(tsnap)
    assert tcnt == jcnt and tcnt["serve.tokens_out"] > 0
    assert tgauge == jgauge
    assert thist == jhist and thist["serve.inter_token_ms"] > 0
    # The port's route counters tick once per call: never the plain path
    # on the card, every call on the CPU.
    assert tsnap["counters"]["ops.matmul.ref"] > 0
    assert "ops.matmul.kernel" not in tsnap["counters"]
    tobs.validate_snapshot(jsnap)
    jobs.validate_snapshot(tsnap, required_histograms=(
        "serve.ttft_ms", "serve.inter_token_ms", "step.device_ms"))
    assert _flight_requests(teng.flight.dump()) == \
        _flight_requests(jeng.flight.dump())
    assert _flight_steps(teng.flight.dump()) == \
        _flight_steps(jeng.flight.dump())
    for fin in (e for evs in teng.flight.dump()["requests"].values()
                for e in evs if e["event"] == "finished"):
        assert fin["tokens"] >= 1
    tdoc, jdoc = tb.tracer.chrome_trace(), jb.tracer.chrome_trace()
    for validate in (tobs.validate_chrome_trace, jobs.validate_chrome_trace):
        validate(tdoc)
        validate(jdoc)
    assert tb.tracer.open_spans() == [] and \
        tb.tracer.open_async_tracks() == {}

    def kinds(doc):
        return collections.Counter(
            (e["ph"], e["name"], e.get("cat", ""))
            for e in doc["traceEvents"])
    assert kinds(tdoc) == kinds(jdoc)
    spans = {n for (ph, n, _) in kinds(tdoc) if ph == "X"}
    assert {"engine.step", "admit", "decode"} <= spans
    assert trep["slo_breaches"] == jrep["slo_breaches"] == 0
    assert 0.0 <= trep["bubble_fraction"] < 1.0


def test_step_attribution_identity_on_every_step():
    _, tcfg, _, tparams = _setup()
    eng = ServeEngine(tcfg, tparams, ServeConfig(
        batch_slots=3, max_len=64, kv="paged", page_size=16,
        prefill_chunk=16, token_budget=19))
    rng = np.random.default_rng(2)
    try:
        for i in range(5):
            eng.submit(rng.integers(0, 512, size=(9 + 7 * i,)), 6,
                       arrival=2 * i)
        n = 0
        while not eng.sched.done():
            ev = eng.step()
            prof, tim = ev["profile"], ev["timings"]
            assert prof["wall_ms"] == tim["step_ms"]
            assert prof["device_ms"] + prof["bubble_ms"] == \
                pytest.approx(prof["wall_ms"], abs=1e-9)
            assert prof["device_ms"] == pytest.approx(min(
                tim["step_ms"],
                tim["admit_ms"] + tim["prefill_ms"] + tim["decode_ms"]))
            n += 1
        assert eng.profiler.bubble_fraction() == pytest.approx(
            eng.profiler.bubble_ms_total / eng.profiler.wall_ms_total)
        names = {k.name for k in eng.profiler.kernel_table()}
        assert names == {"flash_paged_decode", "prefill_chunk"}
        assert all(k.stall_class in ("compute", "memory")
                   for k in eng.profiler.kernel_table())
    finally:
        eng.close()
    snap = tobs.get_obs().registry.snapshot()
    assert snap["histograms"]["step.device_ms"]["count"] == n


def test_engine_attribution_slo_and_flight(tmp_path):
    """The reference's end-to-end scenario on the port: per-step
    decomposition sums to wall time, unarmed targets see no breach on the
    smoke trace, an impossible ITL target fires and trips the flight
    recorder into writing its file."""
    bundle = tobs.configure(registry=tobs.Registry(),
                            tracer=tobs.Tracer(enabled=True))
    _, cfg, _, params = _setup()
    engine = ServeEngine(cfg, params, ServeConfig(batch_slots=2,
                                                  max_len=64))
    trace = tserve.synth_trace(3, 8, 5, 2, cfg.vocab_size, seed=1)
    try:
        rep = tserve.run_trace(engine, trace, log=None)
        assert engine.slo.breaches() == 0
        assert rep["slo_breaches"] == 0
        assert 0.0 <= rep["bubble_fraction"] < 1.0
        dump = engine.flight.dump("test")
        assert dump["steps"]
        for s in dump["steps"]:
            assert s["device_ms"] + s["bubble_ms"] == \
                pytest.approx(s["wall_ms"], abs=2e-3)
        assert any(k.name in ("flash_decode", "flash_paged_decode")
                   for k in engine.profiler.kernel_table())
        for t in trace:
            evs = [e["event"] for e in dump["requests"][str(t["id"])]]
            for expect in ("submitted", "admitted", "first_token",
                           "finished"):
                assert expect in evs, (t["id"], evs)
        engine.slo.set_targets(itl_ms=1e-6)
        engine.flight.path = str(tmp_path / "flight.json")
        rep2 = tserve.run_trace(engine, trace, log=None)
        assert engine.slo.breaches("itl") > 0
        assert rep2["slo_breaches"] > 0
        on_disk = json.loads((tmp_path / "flight.json").read_text())
        assert on_disk["reason"] == "slo_breach"
        assert any(t["reason"] == "slo_breach" for t in on_disk["trips"])
        doc = bundle.tracer.chrome_trace()
        tobs.validate_chrome_trace(doc)
        assert any(e["ph"] == "i" and e["name"] == "slo.breach"
                   for e in doc["traceEvents"])
        assert {"s", "t", "f"} <= {e["ph"] for e in doc["traceEvents"]}
        # The breach reaches admission: the latency policy's SLO gate.
        assert engine._admission_signals()["slo_breached"] is True
    finally:
        engine.close()


@pytest.mark.parametrize("seed", [0, 3])
def test_trace_synthesis_and_dump_equal_reference(seed, tmp_path):
    vocab = TC.get_smoke(ARCH).vocab_size
    for kind in ("uniform", "poisson", "pareto"):
        np.testing.assert_array_equal(
            tserve.gen_arrivals(kind, 40, 12.0, seed),
            jserve.gen_arrivals(kind, 40, 12.0, seed))
    with pytest.raises(ValueError, match="rate"):
        tserve.gen_arrivals("pareto", 4, 0.0)
    with pytest.raises(ValueError, match="unknown arrival"):
        tserve.gen_arrivals("gamma", 4, 1.0)
    traces = {
        "bursty": (tserve.bursty_trace(24, 80, 12, "pareto", 12.0, vocab,
                                       seed=seed),
                   jserve.bursty_trace(24, 80, 12, "pareto", 12.0, vocab,
                                       seed=seed)),
        "shared": (tserve.shared_trace(16, 64, 8, 4, 2, vocab, seed=seed),
                   jserve.shared_trace(16, 64, 8, 4, 2, vocab, seed=seed)),
        "steps": (tserve.synth_trace(5, 9, 7, 2, vocab, seed=seed),
                  jserve.synth_trace(5, 9, 7, 2, vocab, seed=seed)),
    }
    for name, (t, j) in traces.items():
        assert len(t) == len(j)
        for a, b in zip(t, j):
            assert {k: v for k, v in a.items() if k != "prompt"} == \
                {k: v for k, v in b.items() if k != "prompt"}
            np.testing.assert_array_equal(a["prompt"], b["prompt"])
        if name == "bursty":
            t[3]["cancel_after"] = j[3]["cancel_after"] = 2
        tserve.dump_trace(str(tmp_path / f"t_{name}.jsonl"), t)
        jserve.dump_trace(str(tmp_path / f"j_{name}.jsonl"), j)
        assert (tmp_path / f"t_{name}.jsonl").read_bytes() == \
            (tmp_path / f"j_{name}.jsonl").read_bytes()
        back = tserve.load_trace(str(tmp_path / f"t_{name}.jsonl"), vocab,
                                 seed=seed)
        want = jserve.load_trace(str(tmp_path / f"j_{name}.jsonl"), vocab,
                                 seed=seed)
        assert [r["id"] for r in back] == [r["id"] for r in want]
        for a, b in zip(back, want):
            assert {k: v for k, v in a.items() if k != "prompt"} == \
                {k: v for k, v in b.items() if k != "prompt"}
            np.testing.assert_array_equal(a["prompt"], b["prompt"])
        if name != "steps":
            # Bursty and shared prompts come from the per-id (and group)
            # rngs, so their dumps reload to the same tokens.
            by_id = {r["id"]: r for r in t}
            for r in back:
                np.testing.assert_array_equal(r["prompt"],
                                              by_id[r["id"]]["prompt"])


def test_cancel_after_step_indexed_equals_reference():
    vocab = TC.get_smoke(ARCH).vocab_size
    trace = tserve.synth_trace(6, 10, 8, 1, vocab, seed=4)
    trace[1]["cancel_after"] = 3
    trace[4]["cancel_after"] = 1
    trace[5]["cancel_after"] = 8        # its last token: never cancelled
    (jrep, _, jb), (trep, teng, tb) = _run_both(trace, batch_slots=3,
                                                max_len=36)
    assert trep["cancelled_ids"] == jrep["cancelled_ids"] == [1, 4]
    assert sorted(trep["results"]) == sorted(jrep["results"]) == \
        [0, 2, 3, 5]
    for tid, toks in jrep["results"].items():
        np.testing.assert_array_equal(trep["results"][tid], toks)
    assert teng.stats["cancelled"] == 2
    assert _deterministic(tb.registry.snapshot())[0] == \
        _deterministic(jb.registry.snapshot())[0]


def test_bursty24_chunked_wallclock_tokens_equal_jax_engine():
    """ROADMAP Queue A item 7's gate: bursty24, chunked, replayed on the
    wall clock (sped up), gives every request the JAX engine's greedy
    tokens, whatever steps the clock made it arrive in."""
    trace = _trace("bursty24")
    assert len(trace) == 24 and all("arrival_s" in t for t in trace)
    max_len = max(len(t["prompt"]) + t["max_new"] for t in trace) + 8
    jcfg, tcfg, jparams, tparams = _setup()
    scfg = dict(batch_slots=4, max_len=max_len, kv="paged", page_size=16,
                prefill_chunk=32, token_budget=4 + 2 * 32)
    jeng = JServeEngine(jcfg, jparams, JServeConfig(**scfg))
    teng = ServeEngine(tcfg, tparams, ServeConfig(**scfg))
    try:
        want = jserve.run_trace(jeng, trace, log=None, wallclock=False)
        got = tserve.run_trace(teng, trace, log=None, speed=8.0)
    finally:
        jeng.close()
        teng.close()
    assert sorted(got["results"]) == list(range(24))
    for tid, toks in want["results"].items():
        np.testing.assert_array_equal(got["results"][tid], toks,
                                      err_msg=f"trace id {tid}")
    assert got["prefill_chunks"] >= 24 and got["cancelled_ids"] == []


def test_launcher_output_flags_write_valid_files(tmp_path, capsys):
    out = {k: str(tmp_path / f"{k}.out") for k in ("metrics", "trace",
                                                   "prom", "flight")}
    tserve.main(["--trace", "smoke6", "--batch_slots", "3", "--kv", "paged",
                 "--page_size", "16", "--verify", "--device", "cpu",
                 "--metrics-out", out["metrics"], "--trace-out",
                 out["trace"], "--prom-out", out["prom"], "--flight-out",
                 out["flight"], "--slo-itl-ms", "1e6", "--warmup",
                 "--stream"])
    text = capsys.readouterr().out
    assert "verify OK: 6 requests" in text and "[serve] slo:" in text
    # --stream prints every token of the measured replay (after --warmup's
    # unprinted one): 96 tokens of smoke6.
    assert text.count("[stream] id=") == 96
    snap = json.loads(pathlib.Path(out["metrics"]).read_text())
    jobs.validate_snapshot(
        snap, required_histograms=("serve.ttft_ms", "serve.inter_token_ms"),
        required_gauges=("kvpool.pages_in_use", "serve.efficiency",
                         "serve.kv_tokens", "serve.bubble_fraction"))
    assert snap["run"]["kv_mode"] == "paged" and snap["run"]["tokens"] == 96
    assert snap["counters"]["slo.itl.breaches"] == 0
    jobs.validate_chrome_trace(json.loads(
        pathlib.Path(out["trace"]).read_text()))
    prom = pathlib.Path(out["prom"]).read_text()
    assert "# TYPE serve_ttft_ms summary" in prom
    flight = json.loads(pathlib.Path(out["flight"]).read_text())
    assert flight["reason"] == "end_of_run" and flight["steps"]
    report = subprocess.run(
        [sys.executable, str(REPO / "tools" / "obs_report.py"), "--metrics",
         out["metrics"], "--trace", out["trace"], "--flight",
         out["flight"]], capture_output=True, text=True, timeout=60)
    assert report.returncode == 0, report.stderr
    assert "Step-time attribution" in report.stdout
    assert "flash_paged_decode" in report.stdout
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        tserve.main(["--mesh", "1,8", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        tserve.main(["--pack_min_flops", "1e9", "--device", "cpu"])
    with pytest.raises(SystemExit, match="greedy"):
        tserve.main(["--verify", "--temperature", "0.7", "--device", "cpu"])
