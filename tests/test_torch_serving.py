"""The port's continuous-batching ServeEngine against the JAX package's,
plus the port's structural rule: nothing under src/repro_torch imports
JAX or the JAX package.

Both engines serve smollm SMOKE (f32 compute) with the same parameters,
carried across with ``bridge.params_from_numpy``; greedy tokens must be
identical.
"""

import ast
import dataclasses
import functools
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import (ServeConfig, ServeEngine,
                                        _bucket_for, prefill_buckets)
from repro_torch.serving.scheduler import (AdmissionView, LatencyPolicy,
                                           Request, make_policy)

pytestmark = pytest.mark.serving

ARCH = "smollm_360m"
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's default pool of one thread per
    core only oversubscribes the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jparams = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engine(slots, max_len=64, **kw):
    _, tcfg, _, tparams = _setup()
    return ServeEngine(tcfg, tparams, ServeConfig(batch_slots=slots,
                                                  max_len=max_len, **kw))


def _oneshot(prompt, max_new, max_len=64):
    eng = _engine(1, max_len)
    try:
        return eng.generate(prompt[None, :], max_new)[0]
    finally:
        eng.close()


# Long enough for smoke6 (12-token prompts + 16 new + 8) and for the
# synth trace; both prompt lengths fall in the 16-token prefill bucket.
REPLAY_MAX_LEN = 36


@functools.lru_cache(maxsize=None)
def _jax_engine():
    """One JAX engine for every replay: its jitted prefill and decode
    compile once (the replays share shapes), and run_trace offsets each
    replay's arrivals by the engine's step count."""
    jcfg, _, jparams, _ = _setup()
    return JServeEngine(jcfg, jparams, JServeConfig(batch_slots=3,
                                                    max_len=REPLAY_MAX_LEN))


def _replay_both(trace):
    _, tcfg, _, tparams = _setup()
    assert max(len(t["prompt"]) + t["max_new"] for t in trace) \
        + 8 <= REPLAY_MAX_LEN
    teng = ServeEngine(tcfg, tparams, ServeConfig(batch_slots=3,
                                                  max_len=REPLAY_MAX_LEN))
    try:
        want = jserve.run_trace(_jax_engine(), trace, log=None)
        got = tserve.run_trace(teng, trace, log=None)
    finally:
        teng.close()
    return want, got, teng


def test_smoke6_greedy_tokens_equal_jax_engine():
    path = tserve.resolve_trace_path("smoke6")
    assert path == jserve.resolve_trace_path("smoke6")
    vocab = TC.get_smoke(ARCH).vocab_size
    trace = tserve.load_trace(path, vocab)
    jtrace = jserve.load_trace(path, vocab)
    for t, j in zip(trace, jtrace):
        np.testing.assert_array_equal(t["prompt"], j["prompt"])
    want, got, teng = _replay_both(trace)
    assert sorted(got["results"]) == sorted(want["results"]) == list(range(6))
    for tid, toks in want["results"].items():
        np.testing.assert_array_equal(got["results"][tid], toks,
                                      err_msg=f"trace id {tid}")
    assert got["shared_steps"] == want["shared_steps"] > 0
    assert got["decode_steps"] == want["decode_steps"]
    assert teng.stats["finished"] == 6


def test_synth_trace_greedy_tokens_equal_jax_engine():
    vocab = TC.get_smoke(ARCH).vocab_size
    trace = tserve.synth_trace(5, 9, 7, 2, vocab, seed=3)
    jtrace = jserve.synth_trace(5, 9, 7, 2, vocab, seed=3)
    for t, j in zip(trace, jtrace):
        np.testing.assert_array_equal(t["prompt"], j["prompt"])
    want, got, _ = _replay_both(trace)
    for tid, toks in want["results"].items():
        np.testing.assert_array_equal(got["results"][tid], toks,
                                      err_msg=f"trace id {tid}")


def test_launcher_main_replays_and_verifies(capsys):
    tserve.main(["--trace", "smoke6", "--batch_slots", "3", "--verify",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "96 tokens" in out and "verify OK: 6 requests" in out
    with pytest.raises(NotImplementedError, match="arrival_s"):
        tserve.main(["--trace", "bursty24", "--device", "cpu"])


def test_uniform_generate_matches_oneshot_rows():
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, 512, size=(3, 8)).astype(np.int32)
    eng = _engine(3)
    try:
        out = eng.generate(prompts, max_new=6)
        again = eng.generate(prompts, max_new=6)
    finally:
        eng.close()
    np.testing.assert_array_equal(out, again)
    for i in range(3):
        np.testing.assert_array_equal(out[i], _oneshot(prompts[i], 6))


def test_eviction_readmission_no_stale_kv():
    """A slot that served a long request serves a later, shorter one with
    no leakage: the re-admitted request equals a fresh engine's."""
    rng = np.random.default_rng(5)
    long_p = rng.integers(0, 512, size=(20,)).astype(np.int32)
    short_p = rng.integers(0, 512, size=(4,)).astype(np.int32)
    eng = _engine(1)
    try:
        first = eng.submit(long_p, 10)
        assert len(eng.drain()[first]) == 10
        second = eng.submit(short_p, 6)       # reuses slot 0
        res = eng.drain()
    finally:
        eng.close()
    np.testing.assert_array_equal(res[second], _oneshot(short_p, 6))


def test_eos_and_cancel_free_the_slot():
    rng = np.random.default_rng(8)
    p = rng.integers(0, 512, size=(6,)).astype(np.int32)
    ref = _oneshot(p, 6)
    eng = _engine(1, eos_id=int(ref[2]))
    try:
        rid = eng.submit(p, 6)
        res = eng.drain()
        stop = int(np.argmax(ref == ref[2]))
        np.testing.assert_array_equal(res[rid], ref[:stop + 1])
        assert eng.stats["eos_exits"] == 1
    finally:
        eng.close()
    eng = _engine(1)
    try:
        seen = []
        victim = eng.submit(p, 6, on_token=lambda r, t, d: (
            seen.append(t), len(seen) == 2 and eng.cancel(r)))
        queued = eng.submit(p, 3, arrival=eng.step_count + 50)
        assert eng.cancel(queued) and not eng.cancel(12345)
        res = eng.drain()
        assert victim not in res and len(seen) == 2
        assert eng.stats["cancelled"] == 2 and eng.sched.free_slots() == 1
    finally:
        eng.close()


def test_sampled_decoding_is_seeded():
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 512, size=(2, 5)).astype(np.int32)
    outs = []
    for _ in range(2):
        eng = _engine(2, temperature=1.0, seed=11)
        try:
            outs.append(eng.generate(prompts, max_new=8))
        finally:
            eng.close()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_submit_validation_and_close_as_reference():
    eng = _engine(1, max_len=16)
    try:
        with pytest.raises(ValueError, match="empty"):
            eng.submit(np.zeros((0,), np.int32), 4)
        with pytest.raises(ValueError, match="max_new"):
            eng.submit(np.zeros((4,), np.int32), 0)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.zeros((10,), np.int32), 10)
    finally:
        eng.close()
    eng.close()                                   # idempotent
    assert eng.closed
    prompts = np.zeros((1, 4), np.int32)
    for call in (lambda: eng.generate(prompts, 2),
                 lambda: eng.submit(prompts[0], 2), eng.step, eng.drain,
                 lambda: eng.cancel(0)):
        with pytest.raises(RuntimeError, match="closed"):
            call()
    assert prefill_buckets(64) == [8, 16, 32, 64]
    assert _bucket_for(5, 64) == 8
    with pytest.raises(ValueError, match="exceeds"):
        _bucket_for(65, 64)


@pytest.mark.parametrize("option,value,item", [
    ("prefix_cache", True, "6.5"), ("prefill_chunk", 8, "6.4"),
    ("prefill_chunk", None, "6.4"), ("quantize", True, "item 3"),
    ("pack_mesh", object(), "item 12"), ("batch_slots", 0, "item 9"),
    ("page_size", 0, "6.2 and 9")])
def test_unported_options_raise(option, value, item):
    _, tcfg, _, tparams = _setup()
    scfg = dataclasses.replace(ServeConfig(batch_slots=2, max_len=32),
                               **{option: value})
    with pytest.raises(NotImplementedError, match=item):
        ServeEngine(tcfg, tparams, scfg)


@pytest.mark.parametrize("option,value,item", [
    ("page_size", 0, "items 6.2 and 9"), ("page_size", None, "item 9"),
    ("prefix_cache", True, "6.5"), ("prefill_chunk", 8, "6.4")])
def test_unported_paged_options_raise(option, value, item):
    """Paged KV and int8 pages are served; the tuner's page size, the
    prefix cache and chunked prefill on top of them still raise."""
    _, tcfg, _, tparams = _setup()
    scfg = dataclasses.replace(ServeConfig(batch_slots=2, max_len=32,
                                           kv="paged", page_size=16),
                               **{option: value})
    with pytest.raises(NotImplementedError, match=item):
        ServeEngine(tcfg, tparams, scfg)


def test_kv_options_validated_as_reference():
    """Unknown KV layouts and page dtypes, and a page dtype without the
    page pool, are ValueErrors in both engines."""
    jcfg, tcfg, jparams, tparams = _setup()
    for kw, match in ((dict(kv="ring"), "kv must be"),
                      (dict(kv="paged", page_size=16, kv_dtype="fp8"),
                       "kv_dtype must be"),
                      (dict(kv_dtype="int8"), "requires kv='paged'")):
        for engine, cfg, params, scfg_cls in (
                (JServeEngine, jcfg, jparams, JServeConfig),
                (ServeEngine, tcfg, tparams, ServeConfig)):
            with pytest.raises(ValueError, match=match):
                engine(cfg, params, scfg_cls(batch_slots=2, max_len=32,
                                             **kw))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tools" / "gemm_table.py",
              REPO / "tools" / "attention_table.py",
              REPO / "tools" / "decode_table.py",
              REPO / "tools" / "wkv_table.py"]
    assert len(files) > 20 and all(f.exists() for f in files)
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(REPO)} imports {mod}"
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.bridge, repro_torch.configs\n"
            "import repro_torch.kernels.ops, repro_torch.models\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "import repro_torch.serving.kvpool, repro_torch.serving.quant\n"
            "import repro_torch.launch.train, repro_torch.models.rwkv\n"
            "import repro_torch.checkpoint.manager, repro_torch.data.pipeline\n"
            "import repro_torch.kernels.wkv, repro_torch.training.trainer\n"
            "print('ok')")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_latency_policy_gates_on_the_token_budget_only():
    """The budget gate is ported; the measured-p99 gate needs the obs
    slice and raises instead of admitting quietly."""
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        LatencyPolicy(target_p99_ms=5.0)
    assert make_policy("latency").name == "latency"
    assert make_policy(None).name == make_policy("fifo").name == "fifo"
    with pytest.raises(ValueError, match="unknown scheduler policy"):
        make_policy("lifo")
    queue = [Request(rid=i, prompt_len=4, max_new=2) for i in range(3)]
    view = AdmissionView(queue=queue, step=0, free_slots=2,
                         signals={"token_budget": 4, "decode_tokens": 4,
                                  "prefill_backlog": 0})
    assert LatencyPolicy().select(view) == []
    view.signals["decode_tokens"] = 3
    assert [r.rid for r in LatencyPolicy().select(view)] == [0, 1]
    eng = _engine(2, policy="latency", token_budget=1)
    try:
        rids = [eng.submit(np.arange(4, dtype=np.int32), 3) for _ in range(2)]
        res = eng.drain()
        assert all(len(res[r]) == 3 for r in rids)
        # One decode token fills the budget: the second request waited.
        assert eng.stats["shared_steps"] == 0
    finally:
        eng.close()
