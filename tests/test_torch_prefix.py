"""The prefix cache of the port's ServeEngine (kvpool.PrefixCache, the
refcounted PagePool, BlockTables.cow and the engine's wiring), held
against the JAX package's.

The radix tree, the pool and the block tables run the same sequence of
operations in both implementations and must agree at every step.  The
engine cases serve smollm SMOKE (f32 compute) with the same parameters in
both engines, carried across with ``bridge.params_from_numpy``, and
assert equal greedy tokens and equal stats: hit tokens, copy-on-write
copies, preemptions and the pool's live high-water.  The JAX engine runs
each workload once (cached in the module).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro.serving import kvpool as jkv
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.serving import kvpool as tkv
from repro_torch.serving.engine import ServeConfig, ServeEngine

pytestmark = pytest.mark.serving

ARCH = "smollm_360m"
STATS = ("admitted", "finished", "prefills", "prefill_chunks",
         "decode_steps", "shared_steps", "preemptions", "prefix_hits",
         "prefix_hit_tokens", "prefix_prompt_tokens", "cow_copies")
# shared16 on 4 slots, max_len 128, pages of 16: the JAX engine's numbers
# (test_shared16_equals_jax_engine asserts them on both engines;
# chip_smoke.py holds the card's run to them).
SHARED16_HIT_RATE = 0.6          # 576 of 960 prompt tokens
SHARED16_HWM = {True: 11, False: 20}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's default pool of one thread per
    core only oversubscribes the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jparams = jax.jit(jinit_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TC.get_smoke(ARCH).vocab_size,
                        size=(n,)).astype(np.int32)


def _engines(seed=0):
    """(engine class, config class, cfg, params) of JAX and of the port."""
    jcfg, tcfg, jparams, tparams = _setup(seed)
    return ((JServeEngine, JServeConfig, jcfg, jparams),
            (ServeEngine, ServeConfig, tcfg, tparams))


# ---------------------------------------------------------------------------
# Radix tree, refcounted pool, copy-on-write: one script, both modules
# ---------------------------------------------------------------------------


def _tree_lru_script(kv):
    pool = kv.PagePool(num_pages=8, page_size=2)
    tree = kv.PrefixCache(pool)
    out = []
    a = pool.alloc(2)                       # prompt [1, 2, 3, 4]
    out.append(tree.insert([1, 2, 3, 4], a, [None, None]))
    # Identical prompt again: existing nodes win, no extra cache refs.
    out.append(tree.insert([1, 2, 3, 4], a, [None, None]))
    out.append(pool.refcount(a[0]))         # 1 live + 1 cache
    b = pool.alloc(1)                       # divergent tail [1, 2, 9, 9]
    out.append(tree.insert([1, 2, 9, 9], [a[0], b[0]], [None, None]))
    out.append(tree.lookup([1, 2, 3, 4], max_pages=1)[0])
    pool.release(a)
    pool.release([b[0]])
    out.append((pool.pages_in_use, pool.pages_resident, tree.evictable()))
    tree.lookup([1, 2, 3, 4])               # the [9, 9] leaf is now LRU
    out.append(tree.evict(1))
    out.append(tree.lookup([1, 2, 9, 9])[0])
    out.append(tree.lookup([1, 2, 3, 4])[0])
    pool.check()
    return out


def test_prefix_tree_lru_convergence_and_max_pages():
    got = _tree_lru_script(tkv)
    assert got == _tree_lru_script(jkv)
    assert got[:3] == [2, 0, 2]
    assert got[5] == (0, 3, 3) and got[6] == 1


def _tree_pinned_script(kv):
    pool = kv.PagePool(num_pages=4, page_size=2)
    tree = kv.PrefixCache(pool)
    a = pool.alloc(2)
    tree.insert([5, 6, 7, 8], a, [None, None])
    pool.release([a[1]])                    # leaf idle; parent still live
    out = [tree.evictable(), tree.evict(4), pool.refcount(a[0]),
           tree.lookup([5, 6, 7, 8])[0]]
    pool.release([a[0]])                    # slot done: parent now idle
    out += [tree.evict(4), pool.pages_resident, pool.pages_in_use]
    pool.check()
    return out


def test_prefix_tree_evict_skips_pinned_pages():
    got = _tree_pinned_script(tkv)
    assert got == _tree_pinned_script(jkv)
    assert got == [1, 1, 2, [0], 1, 0, 0]


def _cow_script(kv):
    pool = kv.PagePool(num_pages=4, page_size=8)
    bt = kv.BlockTables(pool, n_slots=2, max_pages=4)
    out = [bt.assign(0, tokens=16)]
    pool.share([0])                         # pin page 0 as a prefix hit
    out.append(bt.assign(1, tokens=9, shared=[0]))
    out.append(pool.refcount(0))
    out.append(bt.cow(1, 0))                # shared: a fresh copy
    out.append((pool.refcount(0), pool.refcount(3), bt.slot_pages(1),
                int(bt.table[1, 0])))
    out.append(bt.cow(0, 1))                # exclusive: no copy
    pool.share([1])
    out.append(bt.cow(0, 1))                # pool exhausted: None
    pool.release([1])
    bt.release(0)
    bt.release(1)
    pool.check()
    out.append((pool.pages_in_use, pool.high_water, pool.total_reclaimed))
    return out


def test_block_tables_cow_shared_and_exclusive():
    got = _cow_script(tkv)
    assert got == _cow_script(jkv)
    assert got[3] == (0, 3) and got[5] == (1, 1) and got[6] is None


def test_pool_refcounts_follow_the_reference():
    """A seeded run of alloc / share (live and cache) / release on both
    pools: the same ids, refcounts and live, resident and reclaimed
    counts at every step, and the pool's invariants hold."""
    rng = np.random.default_rng(3)
    pools = [jkv.PagePool(12, 4), tkv.PagePool(12, 4)]
    held = []                               # (page, is_cache) refs held
    for _ in range(300):
        op = rng.random()
        if op < 0.35 or not held:
            n = int(rng.integers(1, 4))
            got = [p.alloc(n) for p in pools]
            assert got[0] == got[1]
            held += [(pg, False) for pg in got[0] or []]
        elif op < 0.6:
            pg, _ = held[int(rng.integers(len(held)))]
            cache = bool(rng.random() < 0.5)
            for p in pools:
                p.share([pg], cache=cache)
            held.append((pg, cache))
        else:
            pg, cache = held.pop(int(rng.integers(len(held))))
            assert len({p.release([pg], cache=cache) for p in pools}) == 1
        for attr in ("free_pages", "pages_in_use", "pages_resident",
                     "high_water", "total_reclaimed"):
            assert getattr(pools[0], attr) == getattr(pools[1], attr), attr
        assert [pools[0].refcount(i) for i in range(12)] == \
            [pools[1].refcount(i) for i in range(12)]
        pools[1].check()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def test_prefix_cache_requires_paged_layout():
    for engine, scfg_cls, cfg, params in _engines():
        with pytest.raises(ValueError, match="prefix_cache"):
            engine(cfg, params, scfg_cls(batch_slots=2, max_len=64,
                                         kv="dense", prefix_cache=True,
                                         pretune=False))


def _warm_hit(engine, scfg_cls, cfg, params, **kw):
    ps, plen = 8, 20
    prompt = _prompt(plen, seed=7)
    eng = engine(cfg, params, scfg_cls(batch_slots=2, max_len=64,
                                       kv="paged", page_size=ps,
                                       prefix_cache=True, **kw))
    try:
        outs = []
        for _ in range(2):                  # cold, then warm
            rid = eng.submit(prompt, 8)
            outs.append(np.asarray(eng.drain()[rid]))
        assert eng.pool.pages_in_use == 0
        eng.pool.check()
        return (outs, {k: eng.stats[k] for k in STATS},
                eng.prefix_hit_rate(), eng.pool.high_water)
    finally:
        eng.close()


def test_prefix_hit_reuses_cached_pages_bit_identically():
    """The second identical prompt takes its full pages from the tree (16
    tokens: the hit stops one page short of the last prompt token, which
    is always forwarded) and decodes the same tokens as the first and as
    the JAX engine."""
    (jeng, jcls, jcfg, jparams), (teng, tcls, tcfg, tparams) = _engines()
    want = _warm_hit(jeng, jcls, jcfg, jparams)
    got = _warm_hit(teng, tcls, tcfg, tparams)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][1], got[0][0])
    assert got[1] == want[1]
    assert got[1]["prefix_hit_tokens"] == 16
    assert got[1]["prefix_hits"] == 1 and got[1]["cow_copies"] == 0
    assert got[2] == want[2] == pytest.approx(16 / 40)
    assert got[3] == want[3]


def test_prefix_hit_int8_sidecar_restores_full_precision():
    """int8 pages are quantized on write; the sidecar keeps the scratch's
    full-precision rows, so a warm int8 run equals the cold one (no second
    quantization) and the JAX engine's."""
    (jeng, jcls, jcfg, jparams), (teng, tcls, tcfg, tparams) = _engines(5)
    want = _warm_hit(jeng, jcls, jcfg, jparams, kv_dtype="int8")
    got = _warm_hit(teng, tcls, tcfg, tparams, kv_dtype="int8")
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][1], got[0][0])
    assert got[1] == want[1] and got[1]["prefix_hit_tokens"] == 16


@functools.lru_cache(maxsize=None)
def _shared16(port, kv_dtype, cached):
    engine, scfg_cls, cfg, params = _engines()[int(port)]
    load = (tserve if port else jserve).load_trace
    trace = load(tserve.resolve_trace_path("shared16"), cfg.vocab_size)
    kw = {"kv_dtype": kv_dtype} if kv_dtype else {}
    eng = engine(cfg, params, scfg_cls(batch_slots=4, max_len=128,
                                       kv="paged", page_size=16,
                                       prefix_cache=cached, **kw))
    try:
        rep = (tserve if port else jserve).run_trace(eng, trace, log=None)
        assert eng.pool.pages_in_use == 0
        eng.pool.check()
        return (rep["results"], {k: eng.stats[k] for k in STATS},
                rep.get("prefix_hit_rate"), eng.pool.high_water)
    finally:
        eng.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_shared16_equals_jax_engine(kv_dtype):
    """The committed shared-prompt trace (16 requests, 4 system-prompt
    groups): with the cache on, every stream equals the uncached run's
    and the JAX engine's, and the hit rate and the pool's live high-water
    equal the JAX engine's (shared pages counted once, cache-only pages
    not at all)."""
    for cached in (False, True):
        want = _shared16(False, kv_dtype, cached)
        got = _shared16(True, kv_dtype, cached)
        assert set(got[0]) == set(want[0]) == set(range(16))
        for tid, toks in want[0].items():
            np.testing.assert_array_equal(got[0][tid], toks,
                                          err_msg=f"id {tid}")
        assert got[1] == want[1]
        assert got[3] == want[3] == SHARED16_HWM[cached]
    off, on = _shared16(True, kv_dtype, False), _shared16(True, kv_dtype,
                                                          True)
    for tid, toks in off[0].items():
        np.testing.assert_array_equal(on[0][tid], toks,
                                      err_msg=f"id {tid} cached")
    assert on[2] == _shared16(False, kv_dtype, True)[2] == SHARED16_HIT_RATE
    assert on[1]["cow_copies"] == 0


def _preempt_sharing(engine, scfg_cls, cfg, params):
    prompt = _prompt(16, seed=17)
    eng = engine(cfg, params, scfg_cls(batch_slots=2, max_len=32,
                                       kv="paged", page_size=8,
                                       pool_pages=5, prefix_cache=True))
    try:
        ra = eng.submit(prompt, 12, arrival=0)
        rb = eng.submit(prompt, 12, arrival=2)
        res = eng.drain()
        assert eng.pool.pages_in_use == 0
        eng.pool.check()
        return ([np.asarray(res[ra]), np.asarray(res[rb])],
                {k: eng.stats[k] for k in STATS}, eng.pool.high_water)
    finally:
        eng.close()


def test_preemption_under_sharing_keeps_shared_pages():
    """A prefix page shared three ways (older slot, younger slot, tree)
    when the pool runs out: preempting the younger sharer drops only its
    own reference, and the requeued request regenerates its stream."""
    (jeng, jcls, jcfg, jparams), (teng, tcls, tcfg, tparams) = _engines()
    want = _preempt_sharing(jeng, jcls, jcfg, jparams)
    got = _preempt_sharing(teng, tcls, tcfg, tparams)
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][1], got[0][0])
    assert got[1] == want[1] and got[2] == want[2]
    assert got[1]["preemptions"] >= 1 and got[1]["prefix_hit_tokens"] > 0


def _odd_prompt(engine, scfg_cls, cfg, params):
    ps, plen = 8, 58
    prompt = _prompt(plen, seed=29)
    eng = engine(cfg, params, scfg_cls(batch_slots=2, max_len=80,
                                       kv="paged", page_size=ps,
                                       prefill_chunk=24, prefix_cache=True))
    try:
        outs, chunks = [], []
        for _ in range(2):                  # cold 24 + 24 + 10; warm 2
            rid = eng.submit(prompt, 8)
            outs.append(np.asarray(eng.drain()[rid]))
            chunks.append(eng.stats["prefill_chunks"])
        return outs, chunks, {k: eng.stats[k] for k in STATS}
    finally:
        eng.close()


def test_chunked_prefill_with_prefix_cache_odd_prompt():
    """A chunk that does not divide the uncached suffix (58 tokens, chunks
    of 24): the last chunk's buffer is clamped to its page-aligned take,
    cold and warm (2-token suffix after a 56-token hit); the regression
    case of the chunk that scattered past the prompt."""
    (jeng, jcls, jcfg, jparams), (teng, tcls, tcfg, tparams) = _engines()
    want = _odd_prompt(jeng, jcls, jcfg, jparams)
    got = _odd_prompt(teng, tcls, tcfg, tparams)
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][1], got[0][0])
    assert got[1] == want[1] == [3, 4]
    assert got[2] == want[2] and got[2]["prefix_hit_tokens"] == 56


def test_launcher_prefix_cache_and_chunked_replays_verify(capsys):
    tserve.main(["--trace", "shared16", "--kv", "paged", "--page_size", "16",
                 "--prefix-cache", "--verify", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefix cache: hit_rate=" in out
    assert "verify OK: 16 requests" in out
    tserve.main(["--trace", "smoke6", "--prefill-chunk", "16",
                 "--token-budget", "12", "--verify", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "chunked prefill: chunk=16 chunks=6 budget=12" in out
    assert "verify OK: 6 requests" in out


def _cow_in_engine(engine, scfg_cls, cfg, params, kv_dtype, share):
    eng = engine(cfg, params, scfg_cls(batch_slots=1, max_len=32,
                                       kv="paged", page_size=8,
                                       prefix_cache=True, kv_dtype=kv_dtype))
    try:
        rid = eng.submit(_prompt(12, seed=3), 6)
        eng.step()                          # prefill, first decode: row 12
        page = eng.blocks.slot_pages(0)[1]  # rows 8-15: the next write's
        if share:
            eng.pool.share([page])          # a second referent
        eng.step()                          # the write at row 13 copies
        moved = eng.blocks.slot_pages(0)[1]
        res = eng.drain()
        if share:
            assert moved != page
            eng.pool.release([page])
        assert eng.pool.pages_in_use == 0
        eng.pool.check()
        return np.asarray(res[rid]), eng.stats["cow_copies"]
    finally:
        eng.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_cow_guard_copies_a_shared_page_before_a_decode_write(kv_dtype):
    """A decode write into a page that another referent holds goes to a
    fresh copy of it (k, v and, int8, the scales, every layer): the stream
    keeps the tokens of the run without sharing, in both engines."""
    (jeng, jcls, jcfg, jparams), (teng, tcls, tcfg, tparams) = _engines()
    alone = _cow_in_engine(teng, tcls, tcfg, tparams, kv_dtype, False)
    want = _cow_in_engine(jeng, jcls, jcfg, jparams, kv_dtype, True)
    got = _cow_in_engine(teng, tcls, tcfg, tparams, kv_dtype, True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], alone[0])
    assert got[1] == want[1] == 1 and alone[1] == 0
