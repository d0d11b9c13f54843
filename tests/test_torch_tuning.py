"""The port's autotuner (``repro_torch.tuning``) on the CPU: its pure-Python
parts against the reference's (``repro.tuning``: cache keys, the pack and
serve spaces, priors and analytic answers), the Hopper spaces against the
kernels' own rules, the cache, the dispatch order, the measure-and-store
back half with injected measurements, the CLI, and the engine's
tuner-resolved slots, page size and prefill chunk against the JAX
engine's.  The kernel timings need the card (``cuda``-marked)."""

from __future__ import annotations

import functools
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import init_params as jinit_params
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro.tuning import cache as jcache
from repro.tuning import dispatch as jdispatch
from repro.tuning import prior as jprior
from repro.tuning import space as jspace
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import cli as tcli
from repro_torch.tuning import dispatch, prior, runner
from repro_torch.tuning.space import (AttentionCandidate, DecodeCandidate,
                                      DesignSpace, GemmCandidate,
                                      PackCandidate, ServeCandidate,
                                      WkvCandidate)

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "smollm_360m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def caches(tmp_path):
    """Fresh dispatch state in both packages, each bound to its own file."""
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    dispatch.set_cache_path(port)
    jdispatch.set_cache_path(ref)
    yield port, ref
    dispatch.reset()
    jdispatch.reset()


# ---------------------------------------------------------------------------
# Pure-Python parts held to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,extra", [
    (("gemm", 512, 256, 128, "bfloat16", "cpu", "cpu"), ""),
    (("attention", 488, 496, 64, "bfloat16", "cuda",
      "NVIDIA_H100_80GB_HBM3"), "h15x5"),
    (("pack", 8, 8, 8, "f32", "cpu", "cpu"), "mesh2x4"),
    (("decode", 496, 64, 1, "int8", "cpu", "cpu"), ""),
    (("serve", 96, 512, 64, "float32", "cpu", "cpu"), "archsmollm-smoke")])
def test_cache_key_equals_reference(args, extra):
    assert tcache.cache_key(*args, extra=extra) == \
        jcache.cache_key(*args, extra=extra)


def test_cache_file_env_and_schema_are_the_ports(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE", raising=False)
    assert tcache.default_cache_path() == pathlib.Path(
        "~/.cache/repro_torch/tuning_cache.json").expanduser()
    assert tcache.default_cache_path() != jcache.default_cache_path()
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "x.json"))
    assert tcache.default_cache_path() == tmp_path / "x.json"
    assert tcache.SCHEMA_VERSION == 1


@pytest.mark.parametrize("model_axis", [1, 2, 4, 6, 8, 16])
def test_pack_space_prior_and_analytic_equal_reference(model_axis):
    for m, k, n, da in ((512, 512, 512, 1), (4096, 960, 2560, 2),
                        (8, 4096, 4096, 4)):
        want = jspace.DesignSpace.pack(m, k, n, model_axis)
        got = DesignSpace.pack(m, k, n, model_axis)
        assert [c.to_json() for c in got] == [c.to_json() for c in want]
        for keep in (1, 3, 6, 100):
            assert [c.to_json() for c in prior.prune_pack(
                got, m, k, n, da, model_axis, keep=keep)] == \
                [c.to_json() for c in jprior.prune_pack(
                    want, m, k, n, da, model_axis, keep=keep)]
        assert prior.analytic_pack(m, k, n, da, model_axis).to_json() == \
            jprior.analytic_pack(m, k, n, da, model_axis).to_json()


@pytest.mark.parametrize("max_slots,max_len", [
    (32, 0), (4, 0), (32, 24), (32, 48), (16, 64), (1, 488)])
def test_serve_space_prior_and_analytic_equal_reference(max_slots, max_len):
    want = jspace.DesignSpace.serve(max_slots=max_slots, max_len=max_len)
    got = DesignSpace.serve(max_slots=max_slots, max_len=max_len)
    assert [c.to_json() for c in got] == [c.to_json() for c in want]
    for keep in (1, 3, 8):
        assert [c.to_json() for c in prior.prune_serve(
            got, max_len, keep=keep)] == [c.to_json() for c in
                                           jprior.prune_serve(
                                               want, max_len, keep=keep)]
    assert prior.analytic_serve(max_len).to_json() == \
        jprior.analytic_serve(max_len).to_json() == \
        ServeCandidate(slots=8, page_size=32).to_json()


@pytest.mark.parametrize("modname", ["repro_torch.tuning.space",
                                     "repro_torch.tuning.cache",
                                     "repro_torch.serving.engine"])
def test_port_doctests(modname):
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(modname), verbose=False)
    assert res.attempted > 0 and res.failed == 0, res


@pytest.mark.parametrize("cand", [
    GemmCandidate(16, 64, 4, 1, 6), AttentionCandidate("tc", 64, 1, 3, 64),
    DecodeCandidate(32), WkvCandidate(128), PackCandidate(2, 4, 1, "ring",
                                                          True),
    ServeCandidate(16, 32, "int8", 32, True)])
def test_candidate_json_round_trip(cand):
    back = type(cand).from_json(json.loads(json.dumps(cand.to_json())))
    assert back == cand


# ---------------------------------------------------------------------------
# The Hopper spaces: the plans the kernels take, today's plan first
# ---------------------------------------------------------------------------


def _served_gemms():
    out = []
    for arch in ("smollm_360m", "qwen3_8b"):
        for k, n, _ in TC.get(arch).gemm_shapes().values():
            out.append((k, n))
    return sorted(set(out))


def _gemm_table_candidates():
    path = REPO / "tools" / "gemm_table.py"
    spec = importlib.util.spec_from_file_location("_gemm_table", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.candidates


@pytest.mark.parametrize("m", [1, 3, 8, 16, 17, 64, 65, 128, 488, 512])
def test_gemm_space_is_the_kernels_and_analytic_is_todays_plan(m):
    sweep = _gemm_table_candidates()
    for k, n in _served_gemms() + [(129, 127), (96, 5000)]:
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            space = DesignSpace.gemm(m, k, n, dtype)
            for c in space:
                tgemm.check_plan(c.plan, k, dtype)
                assert c.splits == tgemm.splits_for(k, n, dtype)
            today = tgemm.plan(m, k, n, dtype)
            assert prior.analytic_gemm(m, k, n, dtype).plan == today
            assert GemmCandidate.from_plan(today) in space
            assert prior.prune_gemm(space, m, k, n, dtype)[0].plan == today
            if dtype == torch.float32:
                assert [c.plan for c in space] == [tgemm.Plan(
                    *tgemm.SIMT_PLAN)]
            else:
                assert [c.plan for c in space] == list(sweep(m, k, n,
                                                             dtype))


@pytest.mark.parametrize("hq,hkv,d,dtype", [
    (15, 5, 64, torch.bfloat16), (32, 8, 128, torch.bfloat16),
    (6, 2, 16, torch.float32), (15, 5, 64, torch.float32),
    (4, 2, 64, torch.bfloat16)])
def test_attention_space_is_the_kernels_and_analytic_is_todays_plan(
        hq, hkv, d, dtype):
    space = DesignSpace.attention(hq, hkv, d, dtype)
    assert [c.plan for c in space] == list(tfa.candidates(hq, hkv, d, dtype))
    for c in space:
        tfa.check_plan(c.plan, hq, hkv, d, dtype)
        assert c.kv_tile == tfa.kv_tile(d, dtype)
    for sq, sk in ((16, 36), (16, 48), (128, 496), (488, 496), (512, 512)):
        today = tfa.plan(1, hq, hkv, sq, sk, d, dtype)
        assert prior.analytic_attention(hq, hkv, sq, sk, d,
                                        dtype).plan == today
        assert AttentionCandidate.from_plan(today) in space
        ranked = prior.prune_attention(space, hq, hkv, sq, sk, d, dtype)
        assert ranked[0].plan == today and len(set(ranked)) == len(ranked)


def test_decode_and_wkv_spaces_are_one_point():
    from repro_torch.kernels.decode_attention import decode_chunk
    from repro_torch.kernels.wkv import wkv_chunk
    for d, kv in ((64, torch.bfloat16), (128, torch.int8),
                  (16, torch.float32)):
        assert DesignSpace.decode(496, d, kv) == [DecodeCandidate(
            decode_chunk(d, kv))] == [prior.analytic_decode(496, d, kv)]
    for t, n in ((64, 64), (4096, 64), (100, 16)):
        assert DesignSpace.wkv(t, n, torch.bfloat16) == [WkvCandidate(
            wkv_chunk(t, n, torch.bfloat16))] == \
            [prior.analytic_wkv(t, n, torch.bfloat16)]


# ---------------------------------------------------------------------------
# Cache and dispatch
# ---------------------------------------------------------------------------


def test_cache_round_trip_schema_discard_and_corrupt_file(tmp_path):
    path = tmp_path / "c.json"
    tc = tcache.TuningCache(path).load()
    assert len(tc) == 0
    tc.put("k", {"config": {"bk": 32}, "us": 1.5})
    tc.save()
    assert tcache.TuningCache(path).load().entries == {
        "k": {"config": {"bk": 32}, "us": 1.5}}
    raw = json.loads(path.read_text())
    assert raw["schema"] == tcache.SCHEMA_VERSION
    raw["schema"] = 8            # the JAX package's schema: discarded whole
    path.write_text(json.dumps(raw))
    assert len(tcache.TuningCache(path).load()) == 0
    path.write_text("{not json")
    assert len(tcache.TuningCache(path).load()) == 0
    tc = tcache.TuningCache(path).load()
    tc.put("a", {})
    tc.save()
    assert tc.clear() == 1 and not path.exists()


def _store(path, key, config):
    tc = tcache.TuningCache(path).load()
    tc.put(key, {"config": config, "us": 1.0})
    tc.save()


def test_dispatch_memo_then_cache_then_analytic(caches):
    port, _ = caches
    m, k, n, dt = 8, 960, 2560, torch.bfloat16
    cfg = dispatch.gemm_config(m, k, n, dt, -1)
    assert (cfg.plan, cfg.source) == (tgemm.plan(m, k, n, dt), "analytic")
    other = next(c for c in DesignSpace.gemm(m, k, n, dt)
                 if c.plan != cfg.plan)
    key = tcache.cache_key("gemm", m, n, k, "bfloat16", "cpu", "cpu")
    _store(port, key, other.to_json())
    # The memo answers until the cache is reloaded.
    assert dispatch.gemm_config(m, k, n, dt, -1) is cfg
    dispatch.set_cache_path(port)
    got = dispatch.gemm_config(m, k, n, dt, -1)
    assert (got.plan, got.source) == (other.plan, "cache")
    assert dispatch.gemm_config(m, k, n, dt, -1) is got
    assert dispatch.warm_gemm_shapes([(m, k, n), (3, 960, 960)], dt, -1) == 1
    # Attention: the GQA heads are part of the key.
    plan = dispatch.attention_blocks(488, 496, 64, dt, hq=15, hkv=5,
                                     device=-1)
    assert plan == tfa.plan(1, 15, 5, 488, 496, 64, dt)
    alt = next(p for p in tfa.candidates(15, 5, 64, dt) if p != plan)
    _store(port, tcache.cache_key("attention", 488, 496, 64, "bfloat16",
                                  "cpu", "cpu", extra="h15x5"),
           AttentionCandidate.from_plan(alt).to_json())
    dispatch.set_cache_path(port)
    assert dispatch.attention_blocks(488, 496, 64, dt, hq=15, hkv=5,
                                     device=-1) == alt
    assert dispatch.attention_blocks(488, 496, 64, dt, hq=32, hkv=8,
                                     device=-1) == \
        tfa.plan(1, 32, 8, 488, 496, 64, dt)
    assert dispatch.decode_block(496, 64, dt, -1) == 32
    assert dispatch.wkv_chunk(64, 64, dt, -1) == 128
    assert dispatch.backend_fingerprint(-1) == ("cpu", "cpu")


@pytest.mark.parametrize("op", ["gemm", "attention", "decode", "wkv"])
def test_dispatch_refuses_a_cached_plan_the_kernel_does_not_take(caches, op):
    port, _ = caches
    dt = torch.bfloat16
    if op == "gemm":
        key = tcache.cache_key("gemm", 8, 960, 960, "bfloat16", "cpu", "cpu")
        config = GemmCandidate(16, 64, 99, 1, 6).to_json()
        call = functools.partial(dispatch.gemm_config, 8, 960, 960, dt, -1)
    elif op == "attention":
        key = tcache.cache_key("attention", 64, 64, 64, "bfloat16", "cpu",
                               "cpu", extra="h15x5")
        config = AttentionCandidate("tc", 64, 3, 2, 64).to_json()
        call = functools.partial(dispatch.attention_blocks, 64, 64, 64, dt,
                                 hq=15, hkv=5, device=-1)
    elif op == "decode":
        key = tcache.cache_key("decode", 496, 64, 1, "bfloat16", "cpu", "cpu")
        config = DecodeCandidate(512).to_json()
        call = functools.partial(dispatch.decode_block, 496, 64, dt, -1)
    else:
        key = tcache.cache_key("wkv", 64, 64, 1, "bfloat16", "cpu", "cpu")
        config = WkvCandidate(16).to_json()
        call = functools.partial(dispatch.wkv_chunk, 64, 64, dt, -1)
    _store(port, key, config)
    dispatch.set_cache_path(port)
    with pytest.raises(ValueError) as err:
        call()
    assert key in str(err.value) and str(port) in str(err.value)


def test_measure_and_store_picks_the_fastest_that_passes(caches):
    port, _ = caches
    tc = dispatch.get_cache()
    space = DesignSpace.gemm(8, 960, 2560, torch.bfloat16)[:4]
    times = {space[0]: (5.0, True, True), space[1]: (2.0, False, False),
             space[2]: (3.0, True, True)}

    def measure(c):
        if c not in times:
            raise RuntimeError("compiler refused the plan")
        us, ok, same = times[c]
        return runner.Measurement(us=us, samples_us=[us], max_err=0.0,
                                  ok=ok, bits_equal=same)

    res = dispatch._measure_and_store("k", tc, space, measure, len(space))
    assert res.best == space[2].to_json() and res.best_us == 3.0
    assert not res.cache_hit and len(res.trials) == 4
    assert res.trials[1]["bits_equal"] is False and not res.trials[1]["ok"]
    assert "compiler refused" in res.trials[3]["error"]
    saved = json.loads(port.read_text())["entries"]["k"]
    assert saved["config"] == space[2].to_json() and saved["measured"] == 4
    failed = dispatch._measure_and_store(
        "k2", tc, space[1:2], measure, 1)
    assert failed.best is None and "k2" not in tc.entries


def test_kernel_timings_refuse_the_cpu(caches):
    cand = prior.analytic_gemm(8, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="no CPU build"):
        runner.time_gemm(cand, 8, 64, 64, "bfloat16", device="cpu")
    with pytest.raises(ValueError, match="no CPU build"):
        runner.time_attention(prior.analytic_attention(
            4, 2, 16, 16, 64, torch.bfloat16), 16, 16, 64, device="cpu")
    with pytest.raises(ValueError, match="no CPU build"):
        runner.time_decode(DecodeCandidate(32), 64, 64, device="cpu")
    with pytest.raises(ValueError, match="no CPU build"):
        runner.time_wkv(WkvCandidate(128), 64, 64, device="cpu")
    for tune in (lambda: dispatch.tune_gemm(8, 64, 64, "bf16", device="cpu"),
                 lambda: dispatch.tune_attention(16, 16, 64, device="cpu"),
                 lambda: dispatch.tune_decode(64, 64, device="cpu"),
                 lambda: dispatch.tune_wkv(64, 64, device="cpu")):
        with pytest.raises(ValueError, match="no CPU build"):
            tune()


def test_tune_pack_stores_the_analytic_grid(caches):
    port, ref = caches
    res = dispatch.tune_pack(128, 256, 128, "bf16", data_axis=1,
                             model_axis=8, device="cpu")
    want = jprior.analytic_pack(128, 256, 128, 1, 8).to_json()
    assert res.best == want and res.best_us is None
    entry = json.loads(port.read_text())["entries"][res.key]
    assert entry["analytic"] is True and entry["measured"] == 0
    again = dispatch.tune_pack(128, 256, 128, "bf16", data_axis=1,
                               model_axis=8, device="cpu")
    assert again.cache_hit
    assert dispatch.pack_config(128, 256, 128, "bf16", data_axis=1,
                                model_axis=8, device="cpu").to_json() == want


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_serve_on_the_cpu_show_and_clear(tmp_path, capsys):
    path = str(tmp_path / "cli.json")
    try:
        argv = ["--cache", path, "tune", "--op", "serve", "--shape", "8,8",
                "--keep", "1", "--reps", "1", "--warmup", "0", "--device",
                "cpu"]
        assert tcli.main(argv) == 0
        out = capsys.readouterr().out
        assert "tuned serve|" in out and "|cpu|cpu|archsmollm-smoke" in out
        assert tcli.main(argv) == 0
        assert "cache hit: serve|" in capsys.readouterr().out
        assert tcli.main(["--cache", path, "show"]) == 0
        assert "1 entries in" in capsys.readouterr().out
        assert tcli.main(["--cache", path, "show", "--json"]) == 0
        shown = json.loads(capsys.readouterr().out)
        (entry,) = shown.values()
        assert entry["config"] == jprior.prune_serve(
            jspace.DesignSpace.serve(max_len=24), 24, keep=1)[0].to_json()
        assert tcli.main(["--cache", path, "clear"]) == 0
        assert "cleared 1 entries" in capsys.readouterr().out
        assert not pathlib.Path(path).exists()
    finally:
        dispatch.reset()


@pytest.mark.parametrize("op,shape", [("gemm", "8,64,64"),
                                      ("attention", "16,16,64"),
                                      ("decode", "64,64"), ("wkv", "64,64")])
def test_cli_kernel_ops_raise_on_the_cpu(tmp_path, op, shape):
    try:
        with pytest.raises(ValueError, match="no CPU build"):
            tcli.main(["--cache", str(tmp_path / "c.json"), "tune", "--op",
                       op, "--shape", shape, "--device", "cpu"])
    finally:
        dispatch.reset()
    assert not (tmp_path / "c.json").exists()


# ---------------------------------------------------------------------------
# The engine's tuner-resolved sizes against the JAX engine's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jparams = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


TUNED = dict(batch_slots=0, kv="paged", page_size=0, prefill_chunk=None)
MAX_LEN = 36


def _resolved(engine):
    return (engine.scfg.batch_slots, engine.pool.page_size,
            engine.prefill_chunk)


def _smoke6_tokens(scfg):
    _, tcfg, _, tparams = _setup()
    trace = tserve.load_trace(tserve.resolve_trace_path("smoke6"),
                              tcfg.vocab_size)
    engine = ServeEngine(tcfg, tparams, scfg)
    try:
        rep = tserve.run_trace(engine, trace, log=None)
    finally:
        engine.close()
    return engine, rep["results"]


def test_engine_resolves_empty_cache_as_reference_and_serves_same_tokens(
        caches):
    jcfg, tcfg, jparams, _ = _setup()
    want = (jdispatch.serve_slots(jcfg, MAX_LEN, jcfg.cdtype),
            jdispatch.serve_page_size(jcfg, MAX_LEN, jcfg.cdtype),
            jdispatch.serve_prefill_chunk(jcfg, MAX_LEN, jcfg.cdtype))
    assert want == (8, 32, 0)
    jeng = JServeEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN, **TUNED))
    try:
        assert _resolved(jeng) == want
    finally:
        jeng.close()
    tuned, got = _smoke6_tokens(ServeConfig(max_len=MAX_LEN, **TUNED))
    assert _resolved(tuned) == want
    assert tuned.tuned_gemm_hits == 0
    _, ref = _smoke6_tokens(ServeConfig(
        batch_slots=8, max_len=MAX_LEN, kv="paged", page_size=32,
        prefill_chunk=0))
    assert sorted(got) == sorted(ref) == list(range(6))
    for tid, toks in ref.items():
        np.testing.assert_array_equal(got[tid], toks)


def test_stored_serve_entry_is_read_by_both_packages(caches):
    port, ref = caches
    jcfg, tcfg, _, _ = _setup()
    stored = {"slots": 4, "page_size": 16, "kv_dtype": "", "prefill_chunk":
              16, "prefix_cache": False}
    key = jdispatch._serve_key(jcfg, MAX_LEN, "float32", "cpu", "cpu")
    assert dispatch._serve_key(tcfg, MAX_LEN, "float32", "cpu", "cpu") == key
    for path, mod in ((port, tcache), (ref, jcache)):
        tc = mod.TuningCache(path).load()
        tc.put(key, {"config": stored, "us": 1.0})
        tc.save()
    dispatch.set_cache_path(port)
    jdispatch.set_cache_path(ref)
    assert dispatch.serve_config(tcfg, MAX_LEN, tcfg.cdtype,
                                 "cpu").to_json() == \
        jdispatch.serve_config(jcfg, MAX_LEN, jcfg.cdtype).to_json() == stored
    want = (jdispatch.serve_slots(jcfg, MAX_LEN, jcfg.cdtype),
            jdispatch.serve_page_size(jcfg, MAX_LEN, jcfg.cdtype),
            jdispatch.serve_prefill_chunk(jcfg, MAX_LEN, jcfg.cdtype))
    assert want == (4, 16, 16)
    tuned, got = _smoke6_tokens(ServeConfig(max_len=MAX_LEN, **TUNED))
    assert _resolved(tuned) == want
    _, explicit = _smoke6_tokens(ServeConfig(
        batch_slots=4, max_len=MAX_LEN, kv="paged", page_size=16,
        prefill_chunk=16))
    for tid, toks in explicit.items():
        np.testing.assert_array_equal(got[tid], toks)


# ---------------------------------------------------------------------------
# On the card: a gemm and an attention tune, every candidate's bits checked
# ---------------------------------------------------------------------------


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gemm", "attention"])
def test_cuda_tune_measures_candidates_with_the_analytic_bits(caches, op):
    _require_cuda()
    if op == "gemm":
        tune = functools.partial(dispatch.tune_gemm, 8, 960, 2560, "bf16")
        cls, want = GemmCandidate, tgemm.plan(8, 960, 2560, torch.bfloat16)
    else:
        tune = functools.partial(dispatch.tune_attention, 488, 496, 64,
                                 "bf16", hq=15, hkv=5)
        cls = AttentionCandidate
        want = tfa.plan(1, 15, 5, 488, 496, 64, torch.bfloat16)
    res = tune(keep=4, reps=2)
    assert res.best is not None and len(res.trials) == 4
    assert all(t["bits_equal"] and t["ok"] for t in res.trials), res.trials
    assert cls.from_json(res.trials[0]["config"]).plan == want
    assert tune().cache_hit
