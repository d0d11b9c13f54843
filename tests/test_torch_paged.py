"""The port's paged KV serving (int8 pages, preemption) against the JAX
package's.

Inputs are made with numpy from fixed seeds and handed to both.  The JAX
``flash_paged_decode`` runs in interpret mode (``ops.decode_paged(mode=
"kernel")``, as tests/test_kernels.py runs it) and is held against the
port's plain version at rtol = atol = 2e-5, the JAX suite's tolerance.
Model logits are compared at f32 (the SMOKE configs compute in f32) at
rtol = atol = 1e-4, as in tests/test_torch_models.py.  The engines serve
smollm SMOKE with the same parameters, carried across with
``bridge.params_from_numpy``; greedy tokens must be identical.
"""

import doctest
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.serving import kvpool as jkv
from repro.serving import quant as jquant
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serving import kvpool as tkv
from repro_torch.serving import quant as tquant
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.scheduler import Request, Scheduler

pytestmark = pytest.mark.serving

ARCHS = ["smollm_360m", "qwen3_8b"]
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's default pool of one thread per
    core only oversubscribes the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(jax cfg, port cfg, jax params, port params), shared read-only."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# int8 KV rows
# ---------------------------------------------------------------------------


def test_quantize_kv_row_bit_equal_to_jax():
    """Zero rows (scale 0), exact .5 ties after the division (half to
    even), the +-127 clip and random rows all quantize to the same codes
    and scales."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 4, 64)).astype(np.float32)
    x[0, 0] = 0.0                                    # zero row
    x[0, 1, :] = np.arange(64) - 31.5                # max 32.5
    x[0, 1, 0] = 127.0                               # scale exactly 1
    x[0, 1, 1:6] = [0.5, 1.5, 2.5, -0.5, -3.5]       # ties to even
    x[0, 2, :] = -1e-3
    x[0, 2, 3] = 1e-3
    want_q, want_s = jquant.quantize_kv_row(jnp.asarray(x))
    got_q, got_s = tquant.quantize_kv_row(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[0, 0] == 0 and (got_q[0, 0] == 0).all()
    assert got_q[0, 1, 1:6].tolist() == [0, 2, 2, 0, -4]
    assert got_q.abs().max() <= 127
    np.testing.assert_array_equal(
        tquant.dequantize_kv(got_q, got_s).numpy(),
        np.asarray(jquant.dequantize_kv(want_q, want_s)))
    kq, ks = tquant.quantize_kv_pages(torch.from_numpy(x))
    assert torch.equal(kq, got_q) and torch.equal(ks, got_s)
    assert tquant.KV_PAGE_DTYPES == jquant.KV_PAGE_DTYPES


# ---------------------------------------------------------------------------
# Paged decode: plain version vs the JAX kernel in interpret mode
# ---------------------------------------------------------------------------


def _paged_case(seed, hq, hkv, ps, lengths, int8, d=64):
    """Numpy pools with disjoint, shuffled per-slot pages (null-sink
    tail), as tests/test_kernels.py builds them."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    slot_pages = [-(-n // ps) for n in lengths]
    n_pool, max_pages = sum(slot_pages) + 3, max(slot_pages) + 1
    perm = list(rng.permutation(n_pool))
    bt = np.full((b, max_pages), n_pool, np.int32)
    for i, n in enumerate(slot_pages):
        bt[i, :n], perm = perm[:n], perm[n:]
    case = {"q": rng.normal(size=(b, hq, d)).astype(np.float32),
            "bt": bt, "length": np.asarray(lengths, np.int32)}
    for key in ("k", "v"):
        pool = rng.normal(size=(n_pool + 1, hkv, ps, d)).astype(np.float32)
        if int8:
            q, s = jquant.quantize_kv_pages(jnp.asarray(pool))
            case[f"{key}_pages"] = np.array(q)
            case[f"{key}_scale"] = np.array(s)
        else:
            case[f"{key}_pages"] = pool
    return case


def _jax_paged(case, buffers):
    scales = {k: jnp.asarray(case[k]) for k in ("k_scale", "v_scale")
              if k in case}
    return np.asarray(jops.decode_paged(
        jnp.asarray(case["q"]), jnp.asarray(case["k_pages"]),
        jnp.asarray(case["v_pages"]), block_tables=jnp.asarray(case["bt"]),
        length=jnp.asarray(case["length"]), buffers=buffers, mode="kernel",
        **scales))


def _torch_paged(case, **kw):
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    scales = {k: t[k] for k in ("k_scale", "v_scale") if k in t}
    return tops.decode_paged(t["q"], t["k_pages"], t["v_pages"],
                             block_tables=t["bt"], length=t["length"],
                             **scales, **kw)


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("ps,hq,hkv,d", [(4, 6, 2, 64), (8, 8, 2, 64),
                                         (16, 4, 4, 64), (4, 6, 2, 16),
                                         (16, 4, 4, 16)],
                         ids=["ps4-group3", "ps8-group4", "ps16-group1",
                              "ps4-group3-d16", "ps16-group1-d16"])
def test_plain_paged_decode_matches_jax_kernel(ps, hq, hkv, d, pool):
    """Lengths 0, one row, a partial last page and whole pages; the JAX
    kernel's single-buffer and double-buffer variants both; the FULL head
    dim 64 and the SMOKE configs' 16."""
    case = _paged_case(ps * 7 + hq + (d != 64) * d, hq, hkv, ps,
                       [0, 1, 3 * ps + 1, 2 * ps], pool == "int8", d=d)
    got = _torch_paged(case).numpy()
    for buffers in (1, 2):
        np.testing.assert_allclose(got, _jax_paged(case, buffers),
                                   **KERNEL_TOL)
    assert (got[0] == 0).all()                       # zero length -> zeros


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_nan_null_sink_is_unreachable(pool):
    """Whatever the null sink page holds — NaN here — never reaches an
    output: unallocated table entries point at it and the lengths mask
    it, and the partial last page's tail rows are never read."""
    case = _paged_case(3, 8, 2, 8, [5, 17, 0], pool == "int8")
    want = _torch_paged(case)
    sink = case["k_pages"].shape[0] - 1
    bad = dict(case)
    for key in ("k", "v"):
        if pool == "int8":
            bad[f"{key}_scale"] = case[f"{key}_scale"].copy()
            bad[f"{key}_scale"][sink] = np.nan
        else:
            bad[f"{key}_pages"] = case[f"{key}_pages"].copy()
            bad[f"{key}_pages"][sink] = np.nan
    got = _torch_paged(bad)
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_plain_paged_decode_equals_dense_on_gathered_cache():
    case = _paged_case(4, 8, 2, 16, [2 * 16 + 7, 5], False)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    dense = tops.decode(t["q"], tref.gather_pages(t["k_pages"], t["bt"]),
                        tref.gather_pages(t["v_pages"], t["bt"]),
                        length=t["length"])
    assert torch.equal(_torch_paged(case), dense)


def test_decode_paged_raises_where_the_reference_raises():
    """Each call below raises ValueError in ``repro.kernels.ops`` and in
    the port, with the same message fragment."""
    case = _paged_case(5, 8, 2, 16, [16, 4], False)
    q, fpool, bt = case["q"], case["k_pages"], case["bt"]
    qpool, scale = jquant.quantize_kv_pages(jnp.asarray(fpool))
    qpool, scale = np.array(qpool), np.array(scale)
    ln = np.asarray([16, 4], np.int32)
    calls = [
        ("k_scale", dict(k=qpool, length=ln)),
        ("int8", dict(k=fpool, length=ln, k_scale=scale, v_scale=scale)),
        ("buffers", dict(k=fpool, length=ln, buffers=3, mode="kernel")),
        ("per-slot", dict(k=fpool, length=np.zeros((3,), np.int32))),
        ("block_tables", dict(k=fpool, length=ln, bt=np.zeros((3, 2),
                                                              np.int32))),
    ]
    for match, kw in calls:
        k = kw.pop("k")
        table = kw.pop("bt", bt)
        length = kw.pop("length")
        jkw = {n: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for n, v in kw.items()}
        tkw = {n: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for n, v in kw.items()}
        if tkw.get("mode") == "kernel":
            tkw["mode"] = "auto"     # a CPU tensor cannot take the kernel
        with pytest.raises(ValueError, match=match):
            jops.decode_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                              block_tables=jnp.asarray(table),
                              length=jnp.asarray(length), **jkw)
        with pytest.raises(ValueError, match=match):
            tops.decode_paged(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(k),
                              block_tables=torch.from_numpy(table),
                              length=torch.from_numpy(length), **tkw)


def test_decode_paged_clamps_length_to_the_table():
    """Stale host bookkeeping (a length past max_pages * ps) reads no
    further than the table covers, as in the reference."""
    case = _paged_case(6, 4, 2, 8, [16, 9], False)
    full = _torch_paged(case)
    case["length"] = np.asarray([16 + 100, 9], np.int32)
    case["bt"] = case["bt"][:, :2]
    np.testing.assert_array_equal(_torch_paged(case).numpy(), full.numpy())


# ---------------------------------------------------------------------------
# Page pool, block tables, scheduler gate
# ---------------------------------------------------------------------------


def test_kvpool_doctests():
    res = doctest.testmod(tkv, verbose=False)
    assert res.attempted > 0 and res.failed == 0


def test_pool_and_block_tables_follow_the_reference():
    """A seeded sequence of assign/extend/release over 4 slots hands out
    the same page ids, tables and accounting in both implementations."""
    rng = np.random.default_rng(9)
    pools = [jkv.PagePool(24, 4), tkv.PagePool(24, 4)]
    tables = [jkv.BlockTables(pools[0], 4, 8), tkv.BlockTables(pools[1], 4, 8)]
    lengths = {}
    for _ in range(200):
        slot = int(rng.integers(4))
        op = rng.random()
        if slot not in lengths:
            n = int(rng.integers(1, 12))
            got = [t.assign(slot, n) for t in tables]
            if got[0] is not None:
                lengths[slot] = n
        elif op < 0.7 and lengths[slot] < 32:
            lengths[slot] += int(rng.integers(1, 4))
            got = [t.extend_to(slot, min(lengths[slot], 32))
                   for t in tables]
            if not got[0]:
                got += [t.release(slot) for t in tables]
                del lengths[slot]
        else:
            got = [t.release(slot) for t in tables]
            del lengths[slot]
        assert got[0] == got[1]
        np.testing.assert_array_equal(tables[0].table, tables[1].table)
        for attr in ("free_pages", "pages_in_use", "high_water",
                     "total_reclaimed"):
            assert getattr(pools[0], attr) == getattr(pools[1], attr), attr
        pools[1].check()
    with pytest.raises(ValueError, match="not in use"):
        pools[1].release([pools[1].null_page])


def test_scheduler_fits_gate_is_strict_fifo():
    """The reference's test on both schedulers: a request that does not
    fit stops the scan; a later one must not leapfrog it."""
    for sched_cls, req_cls in ((JScheduler, JRequest), (Scheduler, Request)):
        s = sched_cls(4)
        for rid, plen in ((0, 4), (1, 30), (2, 2)):
            s.submit(req_cls(rid=rid, prompt_len=plen, max_new=2))
        budget = {"left": 8}

        def fits(req):
            if req.prompt_len > budget["left"]:
                return False
            budget["left"] -= req.prompt_len
            return True
        assert [r.rid for r in s.pop_admissible(step=0, fits=fits)] == [0]
        assert [r.rid for r in s.queue] == [1, 2]


def test_scheduler_requeue_goes_to_head():
    for sched_cls, req_cls in ((JScheduler, JRequest), (Scheduler, Request)):
        s = sched_cls(1)
        s.submit(req_cls(rid=0, prompt_len=4, max_new=2))
        s.submit(req_cls(rid=1, prompt_len=4, max_new=2))
        victim = s.pop_admissible(step=0)[0]
        s.requeue(victim)
        assert [r.rid for r in s.queue] == [0, 1]


# ---------------------------------------------------------------------------
# Models: paged decode logits against the JAX model's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_logits_match_jax(arch, kv_dtype):
    """Two ragged decode steps of 3 slots over pools filled from numpy
    (shuffled pages, null-sink tails): logits and the pools the steps
    wrote must match the JAX model's."""
    jcfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(13)
    n_layers, hkv, d = tcfg.n_layers, tcfg.n_kv_heads, tcfg.d_head
    ps, n_pages = 4, 10
    shape = (n_layers, n_pages + 1, hkv, ps, d)
    pools = {}
    for key in ("k", "v"):
        if kv_dtype == "int8":
            pools[f"{key}_pages"] = rng.integers(-127, 128, size=shape
                                                 ).astype(np.int8)
            pools[f"{key}_scale"] = rng.uniform(
                1e-3, 2e-2, size=shape[:4]).astype(np.float32)
        else:
            pools[f"{key}_pages"] = rng.normal(size=shape).astype(np.float32)
    bt = np.full((3, 4), n_pages, np.int32)
    bt[0, :2], bt[1, :3], bt[2, :1] = [3, 7], [0, 9, 2], [5]
    pos = np.asarray([5, 9, 0], np.int32)
    jcache = jmodel.init_paged_cache(jcfg, n_pages, ps, kv_dtype=kv_dtype)
    jcache = [{"attn": {k: jnp.asarray(v, jcache[0]["attn"][k].dtype)
                        for k, v in pools.items()}}]
    tcache = tmodel.init_paged_cache(tcfg, n_pages, ps, kv_dtype=kv_dtype,
                                     device="cpu")
    for layer, c in enumerate(tcache):
        for k, v in pools.items():
            assert c["attn"][k].shape == v.shape[1:]
            c["attn"][k].copy_(torch.from_numpy(v[layer]))
    jdecode = jax.jit(lambda p, t, ps_, c, b: jmodel.decode_step(
        p, t, ps_, jcfg, c, block_tables=b))
    for _ in range(2):
        tok = rng.integers(0, jcfg.vocab_size, size=(3,)).astype(np.int32)
        jlg, jcache = jdecode(jparams, jnp.asarray(tok), jnp.asarray(pos),
                              jcache, jnp.asarray(bt))
        tlg, tcache = tmodel.decode_step(
            tparams, torch.from_numpy(tok), torch.from_numpy(pos), tcfg,
            tcache, block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **MODEL_TOL)
        pos = pos + 1
    for layer in range(n_layers):
        for k in pools:
            want = np.asarray(jcache[0]["attn"][k][layer])
            got = tcache[layer]["attn"][k].numpy()
            if got.dtype == np.int8:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, **MODEL_TOL,
                                           err_msg=k)


# ---------------------------------------------------------------------------
# Engines: greedy tokens, preemption, EOS, launcher
# ---------------------------------------------------------------------------


def _engines(slots, max_len, **kw):
    jcfg, tcfg, jparams, tparams = _models("smollm_360m")
    return (JServeEngine(jcfg, jparams, JServeConfig(
                batch_slots=slots, max_len=max_len, **kw)),
            ServeEngine(tcfg, tparams, ServeConfig(
                batch_slots=slots, max_len=max_len, **kw)))


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_smoke6_paged_greedy_tokens_equal_jax_engine(kv_dtype):
    from repro.launch import serve as jserve
    vocab = TC.get_smoke("smollm_360m").vocab_size
    trace = tserve.load_trace(tserve.resolve_trace_path("smoke6"), vocab)
    jeng, teng = _engines(3, 36, kv="paged", page_size=16, kv_dtype=kv_dtype)
    try:
        want = jserve.run_trace(jeng, trace, log=None)
        got = tserve.run_trace(teng, trace, log=None)
    finally:
        jeng.close()
        teng.close()
    assert sorted(got["results"]) == sorted(want["results"]) == list(range(6))
    for tid, toks in want["results"].items():
        np.testing.assert_array_equal(got["results"][tid], toks,
                                      err_msg=f"trace id {tid}")
    for key in ("decode_steps", "shared_steps", "pages_hwm",
                "pages_reclaimed", "preemptions", "kv_bytes_hwm"):
        assert got[key] == want[key], key
    assert teng.kv_bytes_reserved() == jeng.kv_bytes_reserved()
    assert teng.pool.pages_in_use == 0 and teng.pool.total_reclaimed > 0


def test_preemption_requeues_and_tokens_equal_jax_engine():
    """tests/test_kvpool.py's scenario: two requests whose joint growth
    exceeds a 4-page pool.  The younger is preempted mid-decode, requeued
    at the head and regenerated: tokens and preemption counts equal the
    JAX engine's, the pool drains, and a stream callback sees each token
    once."""
    rng = np.random.default_rng(31)
    vocab = TC.get_smoke("smollm_360m").vocab_size
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32)
               for n in (8, 6)]
    jeng, teng = _engines(2, 32, kv="paged", page_size=8, pool_pages=4)
    streamed = {}
    try:
        jrids = [jeng.submit(p, 12) for p in prompts]
        want = jeng.drain()
        trids = [teng.submit(p, 12, on_token=lambda r, t, d: streamed
                             .setdefault(r, []).append(t)) for p in prompts]
        got = teng.drain()
        assert teng.stats["preemptions"] == jeng.stats["preemptions"] >= 1
        assert teng.pool.pages_in_use == jeng.pool.pages_in_use == 0
    finally:
        jeng.close()
        teng.close()
    for jr, tr in zip(jrids, trids):
        np.testing.assert_array_equal(got[tr], want[jr])
        assert streamed[tr] == got[tr].tolist()


def test_eos_frees_pages_and_pool_limits_requests():
    """An EOS exit returns the request's pages the same step, and the
    reclaim pass admits the queued request into them at once; a request
    that could never fit the pool is refused at submit."""
    _, tcfg, _, tparams = _models("smollm_360m")
    rng = np.random.default_rng(2)
    p = rng.integers(0, tcfg.vocab_size, size=(6,)).astype(np.int32)
    scfg = ServeConfig(batch_slots=1, max_len=32, kv="paged", page_size=4,
                       pool_pages=4)
    probe = ServeEngine(tcfg, tparams, scfg)
    try:
        ref = probe.generate(p[None, :], 8)[0]
    finally:
        probe.close()
    eos = int(ref[2])
    stop = int(np.argmax(ref == eos))
    eng = ServeEngine(tcfg, tparams, ServeConfig(
        batch_slots=1, max_len=32, kv="paged", page_size=4, pool_pages=4,
        eos_id=eos))
    try:
        with pytest.raises(ValueError, match="pool"):
            eng.submit(np.zeros((14,), np.int32), 4)       # 5 pages > 4
        first, second = eng.submit(p, 8), eng.submit(p, 8)
        while eng.result(first) is None:
            ev = eng.step()
        assert first in ev["finished"] and ev["admitted"][-1] == second
        assert eng.stats["eos_exits"] == 1
        assert eng.pool.pages_in_use == 2          # second's prompt only
        res = eng.drain()
        assert eng.pool.pages_in_use == 0 and eng.stats["eos_exits"] == 2
    finally:
        eng.close()
    for rid in (first, second):
        np.testing.assert_array_equal(res[rid], ref[:stop + 1])


def test_launcher_paged_int8_replays_and_verifies(capsys):
    tserve.main(["--trace", "smoke6", "--batch_slots", "3", "--kv", "paged",
                 "--page_size", "16", "--kv-dtype", "int8", "--verify",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "96 tokens" in out and "paged kv: page_size=16 kv_dtype=int8" in out
    assert "verify OK: 6 requests bit-identical to one-shot paged/int8" in out
