"""Chunked prefill under a token budget in the port's ServeEngine, held
against the JAX package's engine, plus the plain versions the chunked
path leans on: rmsnorm with rows independent of the call's row count, and
the online-softmax attention the plain path takes past 2048 keys.

Both engines serve smollm SMOKE (f32 compute) with the same parameters,
carried across with ``bridge.params_from_numpy``.  Every case asserts
equal greedy tokens and equal engine stats (the wall-clock
``starved_steps`` aside), and that chunking leaves the tokens of the
monolithic run unchanged.  The JAX engine runs each workload once (cached
in the module).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ref as jref
from repro.models import init_params as jinit_params
from repro.models.layers import rmsnorm as jrmsnorm
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serving.engine import ServeConfig, ServeEngine

pytestmark = pytest.mark.serving

ARCH = "smollm_360m"
# Stats both engines keep; starved_steps compares wall times and is left
# out.
STATS = ("admitted", "finished", "prefills", "prefill_chunks",
         "decode_steps", "shared_steps", "preemptions", "cancelled")


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


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    vocab = TC.get_smoke(ARCH).vocab_size
    return {n: rng.integers(0, vocab, size=(n,)).astype(np.int32)
            for n in lengths}


# The reference's workload (tests/test_serving.py): lengths that hit every
# chunk-boundary shape across the chunk sizes — chunk == page size (8), a
# 1-token tail (17 = 2 * 8 + 1, 33 = 2 * 16 + 1), a chunk longer than the
# prompt (64), a 1-token prompt — staggered one step apart on 4 slots.
LENGTHS = (5, 17, 33, 1, 24)
MAX_NEW = (6, 4, 8, 5, 3)
PROMPTS = _prompts(LENGTHS, seed=21)


def _run(engine_cls, cfg_cls, cfg, params, **kw):
    eng = engine_cls(cfg, params, cfg_cls(batch_slots=4, max_len=64,
                                          page_size=8, **kw))
    try:
        rids = [eng.submit(PROMPTS[n], mn, arrival=i)
                for i, (n, mn) in enumerate(zip(LENGTHS, MAX_NEW))]
        res = eng.drain()
        stats = {k: eng.stats[k] for k in STATS}
        chunk = eng.prefill_chunk
    finally:
        eng.close()
    return [np.asarray(res[r]) for r in rids], stats, chunk


@functools.lru_cache(maxsize=None)
def _jax_run(kw_items):
    jcfg, _, jparams, _ = _setup()
    return _run(JServeEngine, JServeConfig, jcfg, jparams,
                pretune=False, **dict(kw_items))


@functools.lru_cache(maxsize=None)
def _port_run(kw_items):
    _, tcfg, _, tparams = _setup()
    return _run(ServeEngine, ServeConfig, tcfg, tparams, **dict(kw_items))


def _both(**kw):
    """(JAX run, port run) of the workload; each run is (outputs, stats,
    the engine's resolved chunk)."""
    items = tuple(sorted(kw.items()))
    return _jax_run(items), _port_run(items)


def _assert_same(want, got, what):
    for n, w, g in zip(LENGTHS, want[0], got[0]):
        np.testing.assert_array_equal(
            g, w, err_msg=f"{what}: prompt_len={n} diverged")
    assert got[1] == want[1], what
    assert got[2] == want[2], what


@pytest.mark.parametrize("budget", [0, 12])
@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("chunk", [3, 8, 16, 64])
def test_chunked_prefill_equals_jax_engine_and_monolithic(chunk, kv, budget):
    """Chunk sizes that are the page size, odd (3: paged rounds it up to
    the 8-token page), and longer than every prompt; dense and paged KV;
    unbudgeted and a budget of 12 tokens a step.  Tokens and stats equal
    the JAX engine's, and the tokens equal the monolithic run's."""
    want, got = _both(kv=kv, prefill_chunk=chunk, token_budget=budget)
    _assert_same(want, got, f"chunk={chunk} kv={kv} budget={budget}")
    assert got[1]["prefill_chunks"] > 0        # the chunked path ran
    mono = _port_run((("kv", kv),))
    assert mono[1]["prefill_chunks"] == 0
    for n, m, g in zip(LENGTHS, mono[0], got[0]):
        np.testing.assert_array_equal(g, m, err_msg=f"prompt_len={n}: "
                                      f"chunked != monolithic")


def test_monolithic_runs_equal_jax_engine():
    for kv in ("dense", "paged"):
        want, got = _both(kv=kv)
        _assert_same(want, got, f"monolithic kv={kv}")


@pytest.mark.parametrize("chunk,budget", [(8, 0), (16, 10)])
def test_chunked_prefill_int8_pages(chunk, budget):
    """Through the quantized pool: int8 rows are quantized per row, so a
    chunk's pages hold the bits the whole prompt's would."""
    want, got = _both(kv="paged", kv_dtype="int8", prefill_chunk=chunk,
                      token_budget=budget)
    _assert_same(want, got, f"int8 chunk={chunk} budget={budget}")
    mono = _port_run((("kv", "paged"), ("kv_dtype", "int8")))
    for m, g in zip(mono[0], got[0]):
        np.testing.assert_array_equal(g, m)


@pytest.mark.parametrize("kw,want_chunk", [
    (dict(kv="paged", page_size=8, prefill_chunk=3), 8),
    (dict(kv="paged", page_size=8, prefill_chunk=20), 24),
    (dict(kv="paged", page_size=8, prefill_chunk=1000), 32),
    (dict(kv="paged", page_size=8, prefix_cache=True), 32),
    (dict(prefill_chunk=5), 5),
    (dict(prefill_chunk=1000), 32),
    (dict(), 0)])
def test_chunk_validation_and_rounding_as_reference(kw, want_chunk):
    """Paged chunks round up to a page multiple, the prefix cache with
    chunk 0 takes one chunk over the whole suffix, and no chunk exceeds
    the scratch; both engines resolve the same chunk."""
    jcfg, tcfg, jparams, tparams = _setup()
    for engine, cfg, params, scfg_cls in (
            (JServeEngine, jcfg, jparams, JServeConfig),
            (ServeEngine, tcfg, tparams, ServeConfig)):
        eng = engine(cfg, params, scfg_cls(batch_slots=1, max_len=32,
                                           pretune=False, **kw))
        try:
            assert eng.prefill_chunk == want_chunk, engine
        finally:
            eng.close()


def test_negative_chunk_raises_as_reference():
    jcfg, tcfg, jparams, tparams = _setup()
    for engine, cfg, params, scfg_cls in (
            (JServeEngine, jcfg, jparams, JServeConfig),
            (ServeEngine, tcfg, tparams, ServeConfig)):
        with pytest.raises(ValueError, match="prefill_chunk"):
            engine(cfg, params, scfg_cls(batch_slots=1, max_len=32,
                                         prefill_chunk=-2, pretune=False))


def _cancel_mid_prefill(engine_cls, cfg_cls, cfg, params):
    prompts = _prompts((33, 6), seed=35)
    eng = engine_cls(cfg, params, cfg_cls(batch_slots=1, max_len=64,
                                          kv="paged", page_size=8,
                                          prefill_chunk=8))
    try:
        ra = eng.submit(prompts[33], 4)
        rb = eng.submit(prompts[6], 4)
        ev = eng.step()                     # the first chunk only: 8 < 33
        assert ra not in ev["finished"] and not ev["decoded"]
        assert eng.pool.pages_in_use == 5
        assert eng.cancel(ra)
        assert not eng._scratch             # scratch dropped at once
        assert eng.pool.pages_in_use == 0   # and the pages
        res = eng.drain()
        assert set(res) == {rb}
        assert eng.pool.free_pages == eng.pool.num_pages
        eng.pool.check()
        return np.asarray(res[rb]), {k: eng.stats[k] for k in STATS}
    finally:
        eng.close()


def test_cancel_mid_chunked_prefill_releases_scratch_and_pages():
    jcfg, tcfg, jparams, tparams = _setup()
    want = _cancel_mid_prefill(JServeEngine, JServeConfig, jcfg, jparams)
    got = _cancel_mid_prefill(ServeEngine, ServeConfig, tcfg, tparams)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def _cancel_from_callback(engine_cls, cfg_cls, cfg, params):
    prompts = _prompts((9, 7, 6), seed=31)
    eng = engine_cls(cfg, params, cfg_cls(batch_slots=2, max_len=64,
                                          kv="paged", page_size=8,
                                          prefill_chunk=8, token_budget=10))
    try:
        seen = []

        def cb(rid, tok, done):
            seen.append(tok)
            if len(seen) == 3:
                assert eng.cancel(rid)

        ra = eng.submit(prompts[9], 12, on_token=cb)
        rb = eng.submit(prompts[7], 8)
        rc = eng.submit(prompts[6], 6)      # queued: both slots busy
        cancel_ev = None
        while not eng.sched.done():
            ev = eng.step()
            if ra in ev["cancelled"]:
                cancel_ev = ev
        # Same-step reuse: the queued request took the cancelled slot.
        assert rc in cancel_ev["admitted"]
        res = eng.drain()
        assert ra not in res
        assert eng.pool.free_pages == eng.pool.num_pages
        return ([np.asarray(res[rb]), np.asarray(res[rc])],
                {k: eng.stats[k] for k in STATS})
    finally:
        eng.close()


def test_cancel_from_a_stream_reclaims_the_same_step_while_chunking():
    """A stream cancelled from its own callback frees its slot and pages
    within the step, the queued request is admitted by that step's reclaim
    pass into the chunked path, and the other streams keep their tokens."""
    jcfg, tcfg, jparams, tparams = _setup()
    want = _cancel_from_callback(JServeEngine, JServeConfig, jcfg, jparams)
    got = _cancel_from_callback(ServeEngine, ServeConfig, tcfg, tparams)
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]


# ---------------------------------------------------------------------------
# The plain versions under the chunked path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [96, 128, 960])
def test_plain_rmsnorm_matches_jax_and_rows_do_not_depend_on_the_call(d):
    """``ref.rmsnorm`` within 1e-6 of the reference's jnp rmsnorm, and a
    row's bits the same at every row count (what chunked prefill and
    batched decode need of every op on the path)."""
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(512, d)) * 3).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    want = np.asarray(jrmsnorm({"scale": jnp.asarray(scale)},
                               jnp.asarray(x)))
    tx, ts = torch.from_numpy(x), torch.from_numpy(scale)
    whole = tref.rmsnorm(tx, ts)
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(tops.rmsnorm(tx, ts), whole)
    for m in (1, 3, 8, 488):
        assert torch.equal(tref.rmsnorm(tx[:m], ts), whole[:m]), m
    alone = torch.cat([tref.rmsnorm(tx[i:i + 1], ts) for i in range(16)])
    assert torch.equal(alone, whole[:16])


@pytest.mark.parametrize("sq,sk,q_offset,kv_len", [
    (16, 2100, 2084, None), (40, 2200, 1000, 2150), (3, 2049, 0, None)])
def test_chunked_attention_matches_jax_past_2048_keys(sq, sk, q_offset,
                                                      kv_len):
    """``ref.chunked_attention`` (1024-key blocks, online softmax) against
    the reference's ``chunked_attention`` and the port's plain
    ``ref_attention``; ``ops.attention``'s plain path takes it past 2048
    keys."""
    rng = np.random.default_rng(sq + sk)
    hq, hkv, d = 4, 2, 16
    q = rng.normal(size=(1, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(1, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(1, hkv, sk, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tref.chunked_attention(tq, tk, tv, q_offset=q_offset,
                                 kv_len=kv_len)
    full = tref.ref_attention(tq, tk, tv, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-5,
                               atol=2e-5)
    if kv_len is None:                      # the reference has no kv_len
        want = np.asarray(jref.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_offset=q_offset))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    routed = tops.attention(tq, tk, tv, q_offset=q_offset, kv_len=kv_len)
    assert torch.equal(routed, got)
