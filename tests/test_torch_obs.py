"""The port's observability layer (``repro_torch.obs``, ``core.hw``,
``kernels.ops.op_cost_model``) against the JAX package's ``repro.obs``.

Every instrument is driven by one observation stream, drawn from a seed
with numpy, through both implementations; snapshots, Prometheus text,
trace events (without their clock fields), SLO breaches and flight dumps
(without their timestamps) must be equal.  The roofline models must give
the reference's numbers for the ``cpu`` and ``tpu`` backends, and the
card's entry (``H100_SXM``) must be the constants ``chip_smoke.py``
bounds its kernels with.
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import obs as jobs
from repro.core import hw as jhw
from repro.kernels.ops import op_cost_model as j_op_cost_model
from repro.obs import efficiency as jeff
from repro.obs import profile as jprof
from repro_torch import configs as TC
from repro_torch import obs as tobs
from repro_torch.core import hw as thw
from repro_torch.kernels import ops as tops
from repro_torch.obs import efficiency as teff
from repro_torch.obs import profile as tprof

REPO = pathlib.Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 2]


def _same(a, b):
    """Equal, with NaN equal to NaN (an empty window's percentile)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _stream(seed, n=400):
    """One seeded script of (kind, name, value) observations."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["counter", "gauge", "hist", "bucket", "capped"],
                       size=n)
    out = []
    for i, kind in enumerate(kinds):
        name = f"{kind}.{int(rng.integers(0, 3))}"
        value = float(rng.lognormal(1.0, 1.5))
        if kind == "gauge" and rng.random() < 0.3:
            value = -value
        out.append((str(kind), name, value))
    return out


def _feed(mod, stream):
    reg = mod.Registry()
    for kind, name, value in stream:
        if kind == "counter":
            reg.counter(name, "help text").inc(value)
        elif kind == "gauge":
            reg.gauge(name).set(value)
        elif kind == "hist":
            reg.histogram(name, "a histogram").observe(value)
        elif kind == "bucket":
            reg.histogram(name, buckets=[0.5, 2.0, 8.0, 64.0]).observe(value)
        else:
            reg.histogram(name, max_samples=8).observe(value)
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_metrics_snapshot_prometheus_and_capped_percentiles_equal(seed):
    stream = _stream(seed)
    j, t = _feed(jobs.metrics, stream), _feed(tobs.metrics, stream)
    assert t.snapshot() == j.snapshot()
    assert t.to_prometheus() == j.to_prometheus()
    assert tobs.flatten_snapshot(t.snapshot()) == \
        jobs.flatten_snapshot(j.snapshot())
    capped = [n for n in j.histograms if n.startswith("capped")]
    assert capped
    for name in capped:
        # Decimated well past the cap: the same retained samples.
        assert j.histograms[name].count > 8
        for q in (0, 10, 50, 90, 99, 100):
            assert t.histograms[name].percentile(q) == \
                j.histograms[name].percentile(q)
    t.reset_values()
    j.reset_values()
    assert t.snapshot() == j.snapshot()
    off = tobs.Registry(enabled=False)
    off.counter("x").inc(3)
    off.histogram("y").observe(1.0)
    assert off.snapshot() == jobs.Registry(enabled=False).snapshot()


def test_snapshot_validation_and_writers_agree(tmp_path):
    reg = _feed(tobs.metrics, _stream(5))
    snap = tobs.write_metrics(str(tmp_path / "m.json"), reg,
                              extra={"run": {"tokens": 3}},
                              required_counters=("counter.0",))
    jobs.validate_snapshot(json.loads((tmp_path / "m.json").read_text()),
                           required_counters=("counter.0",))
    text = tobs.write_prometheus(str(tmp_path / "m.prom"), reg)
    assert text == (tmp_path / "m.prom").read_text() == reg.to_prometheus()
    assert tobs.SNAPSHOT_SCHEMA == jobs.SNAPSHOT_SCHEMA == snap["schema"]
    for bad in ({"schema": 2}, {"schema": 1, "counters": {"a": "x"},
                                "gauges": {}, "histograms": {}}):
        with pytest.raises(ValueError):
            tobs.validate_snapshot(bad)
        with pytest.raises(ValueError):
            jobs.validate_snapshot(bad)
    with pytest.raises(ValueError, match="missing required"):
        tobs.validate_snapshot(snap, required_gauges=("absent",))


def _drive_tracer(mod, seed):
    """One seeded script over every event family of the tracer."""
    rng = np.random.default_rng(seed)
    tr = mod.Tracer()
    tr.process_name("repro-serve")
    tr.thread_name("engine")
    open_async = []
    for step in range(30):
        with tr.span("engine.step", cat="engine", step=step):
            with tr.span("admit", cat="engine", phase="arrival"):
                if rng.random() < 0.5:
                    rid = step
                    tr.async_begin("request", rid, prompt_len=int(step))
                    tr.async_begin("queued", rid)
                    open_async.append(rid)
            if open_async and rng.random() < 0.4:
                rid = open_async.pop(int(rng.integers(0, len(open_async))))
                tr.async_end("queued", rid)
                tr.flow(f"req{rid}", rid, "start", cat="reqflow")
                tr.flow(f"req{rid}", rid, "step", cat="reqflow")
                tr.flow(f"req{rid}", rid, "end", cat="reqflow")
                tr.async_end("request", rid, tokens=3)
            with tr.span("decode", cat="engine", batch=int(step % 4)):
                tr.instant("preempt", cat="engine", rid=step)
        tr.counter("step.attribution", bubble_ms=float(step),
                   device_ms=2.0 * step)
    for rid in open_async:
        tr.async_end("queued", rid)
        tr.async_end("request", rid)
    return tr


def _without_clock(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in doc["traceEvents"]]


@pytest.mark.parametrize("seed", SEEDS)
def test_tracer_events_equal_and_cross_validate(seed, tmp_path):
    t, j = _drive_tracer(tobs.trace, seed), _drive_tracer(jobs.trace, seed)
    # Sorted by ts, events recorded in one order keep it: compare them in
    # the order recorded (the clock fields differ run to run).
    assert [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in t._events] == \
        [{k: v for k, v in e.items() if k not in ("ts", "dur")}
         for e in j._events]
    tdoc, jdoc = t.chrome_trace(), j.chrome_trace()
    assert sorted(map(json.dumps, _without_clock(tdoc))) == \
        sorted(map(json.dumps, _without_clock(jdoc)))
    jobs.validate_chrome_trace(tdoc)
    tobs.validate_chrome_trace(jdoc)
    assert t.write(str(tmp_path / "t.json")) == len(tdoc["traceEvents"])
    jobs.validate_chrome_trace(json.loads((tmp_path / "t.json").read_text()))
    assert t.open_spans() == j.open_spans() == []
    assert t.open_async_tracks() == j.open_async_tracks() == {}
    dangling = {"traceEvents": [{"name": "q", "ph": "b", "cat": "req",
                                 "id": "1", "ts": 0.0}]}
    for validate in (tobs.validate_chrome_trace, jobs.validate_chrome_trace):
        with pytest.raises(ValueError, match="unclosed"):
            validate(dangling)
    off = tobs.Tracer(enabled=False)
    assert off.span("x") is tobs.trace._NULL_SPAN
    off.async_begin("request", 1)
    off.flow("f", 1, "start")
    assert off.chrome_trace()["traceEvents"] == []


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_breaches_signals_and_callback_order_equal(seed):
    rng = np.random.default_rng(seed)
    values = rng.lognormal(1.0, 1.0, size=300)
    series = rng.choice(["ttft", "itl"], size=300)
    calls = {"t": [], "j": []}
    mons = {}
    for tag, mod in (("t", tobs), ("j", jobs)):
        mon = mod.SLOMonitor(mod.Registry(), tracer=mod.Tracer(),
                             ttft_target_ms=9.0, window=16)
        mon.on_breach(lambda s, q, target, tag=tag:
                      calls[tag].append((s, q, target)))
        mons[tag] = mon
    for i, (s, v) in enumerate(zip(series, values)):
        if i == 150:
            for mon in mons.values():
                mon.set_targets(ttft_ms=None, itl_ms=4.0)
        got = [getattr(m, f"observe_{s}")(float(v)) for m in mons.values()]
        assert got[0] == got[1]
        assert _same(mons["t"].signals(), mons["j"].signals())
    assert calls["t"] == calls["j"] and calls["t"]
    assert _same(mons["t"].summary(), mons["j"].summary())
    assert mons["t"].breaches() == mons["j"].breaches() > 0
    assert mons["t"].registry.snapshot() == mons["j"].registry.snapshot()
    xs = list(values[:37])
    for q in (0, 25, 50, 99, 100):
        assert tobs.window_percentile(xs, q) == jobs.window_percentile(xs, q)
        assert tobs.window_percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))


def _drive_flight(mod, seed, path=None):
    rng = np.random.default_rng(seed)
    fr = mod.FlightRecorder(capacity=12, max_requests=5, max_events=4,
                            storm_preemptions=3, storm_window_steps=6,
                            path=path)
    storms = []
    for step in range(60):
        fr.record_step(step, wall_ms=float(step), decoded=int(step % 3))
        for _ in range(int(rng.integers(0, 3))):
            rid = int(rng.integers(0, 9))
            fr.record_request_event(rid, str(rng.choice(
                ["submitted", "admitted", "first_token", "finished"])),
                step=step)
        if rng.random() < 0.25:
            storms.append(fr.note_preemption(step, int(rng.integers(0, 9))))
    fr.trip("slo_breach", series="itl", window_ms=3.0, target_ms=1.0)
    return fr, storms


def _untimed(dump):
    def clean(rec):
        return {k: v for k, v in rec.items() if k != "t_ms"}
    return {"reason": dump["reason"], "capacity": dump["capacity"],
            "steps": [clean(r) for r in dump["steps"]],
            "requests": {k: [clean(e) for e in v]
                         for k, v in dump["requests"].items()},
            "trips": [clean(r) for r in dump["trips"]]}


@pytest.mark.parametrize("seed", SEEDS)
def test_flight_dumps_equal_without_timestamps(seed, tmp_path):
    t, tstorms = _drive_flight(tobs, seed, str(tmp_path / "f.json"))
    j, jstorms = _drive_flight(jobs, seed)
    assert tstorms == jstorms
    assert len(t) == len(j) == 12
    assert _untimed(t.dump("x")) == _untimed(j.dump("x"))
    on_disk = json.loads((tmp_path / "f.json").read_text())
    assert on_disk["reason"] == "slo_breach"
    assert _untimed(on_disk) == _untimed(j.dump("slo_breach"))


def _cfgs():
    out = []
    for name in ("smollm_360m", "qwen3_8b"):
        out += [(TC.get(name), JC.get(name)),
                (TC.get_smoke(name), JC.get_smoke(name))]
    return out


@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_cost_and_roofline_models_equal_reference(backend):
    for dtype in ("bfloat16", "float32", "int8", "bf16"):
        assert dataclasses.asdict(teff.precision_for_dtype(dtype, backend)) \
            == dataclasses.asdict(jeff.precision_for_dtype(dtype))
        assert teff.peak_flops(dtype, backend) == \
            jeff.peak_flops(dtype, backend)
        assert tprof.ridge_intensity(dtype, backend) == \
            jprof.ridge_intensity(dtype, backend)
        assert teff.gemm_efficiency(64, 96, 128, 3.5, dtype, backend) == \
            jeff.gemm_efficiency(64, 96, 128, 3.5, dtype, backend)
    assert tprof.peak_bandwidth(backend) == jprof.peak_bandwidth(backend)
    for tcfg, jcfg in _cfgs():
        assert teff.model_flops_per_token(tcfg) == \
            jeff.model_flops_per_token(jcfg)
        assert teff.serve_efficiency(tcfg, 123.0, backend) == \
            jeff.serve_efficiency(jcfg, 123.0, backend)
    rng = np.random.default_rng(7)
    for _ in range(40):
        m, k, n, b, h, s, d, chunk, layers = (
            int(x) for x in rng.integers(1, 512, size=9))
        kw = dict(m=m, k=k, n=n, batch=b, heads=h, kv_heads=max(1, h // 3),
                  seq=s, d_head=d, dtype_bytes=2.0, kv_bytes=1.0,
                  weight_flops=float(m * k), weight_bytes=float(k * n),
                  chunk_tokens=chunk, layers=layers)
        for op in ("matmul", "flash_decode", "flash_paged_decode",
                   "prefill_chunk"):
            flops, nbytes = tops.op_cost_model(op, **kw)
            assert (flops, nbytes) == j_op_cost_model(op, **kw)
            for dtype in ("bfloat16", "int8"):
                got = tobs.classify_kernel(op, flops, nbytes, 17.0, dtype,
                                           backend)
                want = jobs.classify_kernel(op, flops, nbytes, 17.0, dtype,
                                            backend)
                assert got.as_dict() == want.as_dict()
    with pytest.raises(ValueError, match="unknown op"):
        tops.op_cost_model("conv")


def test_step_profiler_equals_reference():
    rng = np.random.default_rng(11)
    profs = [tobs.StepProfiler(tobs.Registry(), backend="cpu",
                               dtype_name="float32"),
             jobs.StepProfiler(jobs.Registry(), backend="cpu",
                               dtype_name="float32")]
    for _ in range(50):
        wall = float(rng.uniform(1, 10))
        sec = {k: float(rng.uniform(0, 5)) for k in ("admit", "prefill",
                                                     "decode")}
        recs = [p.record_step(wall, sec) for p in profs]
        assert recs[0] == recs[1]
        assert recs[0]["device_ms"] + recs[0]["bubble_ms"] == wall
    for p in profs:
        p.record_kernel("flash_decode", 1e9, 4e8, 250.0)
        p.record_kernel("prefill_chunk", 4e9, 1e8, 900.0)
    assert profs[0].summary() == profs[1].summary()
    assert profs[0].registry.snapshot() == profs[1].registry.snapshot()
    profs[0].reset_totals()
    assert profs[0].bubble_fraction() == 0.0


def test_hw_copy_equals_reference_and_h100_is_chip_smokes():
    for name in ("VE2802", "TPU_V5E", "POD_V5E_256", "INT8_INT32",
                 "INT8_INT16", "INT8_INT8", "BF16_BF16"):
        assert dataclasses.asdict(getattr(thw, name)) == \
            dataclasses.asdict(getattr(jhw, name))
    assert {k: dataclasses.asdict(v) for k, v in thw.PRECISIONS.items()} \
        == {k: dataclasses.asdict(v) for k, v in jhw.PRECISIONS.items()}
    h = thw.H100_SXM
    assert (h.peak_bf16_flops, h.peak_f32_flops, h.peak_int8_ops,
            h.hbm_bw, h.l2_bytes) == (989e12, 67e12, 1979e12, 3.35e12,
                                      50 * 2 ** 20)
    # The card's f32 is its own SIMT peak, not the bf16 floor.
    assert teff.peak_flops("float32", "cuda") == 67e12
    assert teff.peak_flops("bfloat16", "cuda") == 989e12
    assert teff.peak_flops("int8", "cuda") == 1979e12
    assert tprof.peak_bandwidth("cuda") == 3.35e12
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.HBM_BYTES_S == h.hbm_bw
    assert chip_smoke.L2_BYTES == h.l2_bytes
    assert chip_smoke.PEAK_OPS_S == {torch.bfloat16: h.peak_bf16_flops,
                                     torch.float32: h.peak_f32_flops,
                                     torch.int8: h.peak_int8_ops}
    ms, by = chip_smoke.bound(3.35e9, 1.0, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = chip_smoke.bound(1.0, 67e9, torch.float32)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_route_counters_follow_the_registry_and_count_per_call():
    a = torch.ones(3, 4)
    b = torch.ones(4, 5)
    try:
        reg = tobs.configure(registry=tobs.Registry()).registry
        for _ in range(3):
            tops.matmul(a, b)
        assert reg.counters["ops.matmul.ref"].value == 3
        assert "ops.matmul.kernel" not in reg.counters
        fresh = tobs.configure(registry=tobs.Registry()).registry
        tops.matmul(a, b)
        q = torch.zeros(2, 4, 8)
        kv = torch.zeros(2, 2, 6, 8)
        tops.decode(q, kv, kv, length=torch.tensor([3, 6]))
        pages = torch.zeros(5, 2, 4, 8)
        tops.decode_paged(q, pages, pages,
                          block_tables=torch.tensor([[0, 1], [2, 3]]),
                          length=torch.tensor([5, 8]))
        assert fresh.snapshot()["counters"] == {
            "ops.matmul.ref": 1.0, "ops.decode.ref": 1.0,
            "ops.decode_paged.ref": 1.0}
        assert reg.counters["ops.matmul.ref"].value == 3
        off = tobs.configure(registry=tobs.Registry(enabled=False)).registry
        tops.matmul(a, b)
        assert off.snapshot()["counters"] == {}
        with pytest.raises(ValueError, match="CUDA tensors"):
            tops.matmul(a, b, mode="kernel")
    finally:
        tobs.reset()
