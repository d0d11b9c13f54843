"""RWKV-6 serving in the port against the JAX package: the WKV recurrence
from a carried state (``ref_wkv_state``, the plain version of the
``wkv6_state`` kernel), the cached time-mix and channel-mix, and the
engine's recurrent bypass (exact-length prefill, dense state whatever
``kv`` asks, no page dtype, no chunks).

f32 throughout (the SMOKE config computes in f32): the recurrence at the
JAX kernel suite's rtol = atol = 2e-5, one block at 1e-5, and greedy
tokens equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch import obs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv as twkv
from repro_torch.models import rwkv as trwkv
from repro_torch.serving.engine import ServeConfig, ServeEngine

ARCH = "rwkv6_3b"
WKV_TOL = dict(rtol=2e-5, atol=2e-5)
LENGTHS = (4, 11)                       # 11 is off every prefill bucket


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wkv_inputs(b, h, t, n, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, n)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6.0, 1.0, (b, h, t, n)))
               ).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, s0


def _jax_scan(r, k, v, w, u, s0):
    """The reference's cached branch: ``lax.scan`` of ``_wkv_step`` over
    time from s0 (``repro/models/rwkv.py:146-162``)."""
    b, h, t, n = r.shape
    tb = lambda z: jnp.asarray(z).transpose(2, 0, 1, 3)   # noqa: E731
    uf = jnp.broadcast_to(jnp.asarray(u), (t, b, h, n))
    s_final, ys = jax.lax.scan(jrwkv._wkv_step, jnp.asarray(s0),
                               (tb(r), tb(k), tb(v), tb(w), uf))
    return np.asarray(ys.transpose(1, 2, 0, 3)), np.asarray(s_final)


@pytest.mark.parametrize("b,h,t,n", [(2, 3, 1, 16), (2, 2, 11, 16),
                                     (1, 2, 40, 64)])
def test_ref_wkv_state_matches_reference_scan(b, h, t, n):
    r, k, v, w, u, s0 = _wkv_inputs(b, h, t, n, seed=t)
    want_y, want_s = _jax_scan(r, k, v, w, u, s0)
    y, s_end = ref.ref_wkv_state(*(torch.from_numpy(x)
                                   for x in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(y.numpy(), want_y, **WKV_TOL)
    np.testing.assert_allclose(s_end.numpy(), want_s, **WKV_TOL)
    # From a zero state: the zero-state recurrence training runs.
    zero = torch.zeros((b, h, n, n))
    y0, _ = ref.ref_wkv_state(*(torch.from_numpy(x) for x in (r, k, v, w, u)),
                              zero)
    np.testing.assert_allclose(
        y0.numpy(), ref.ref_wkv(*(torch.from_numpy(x)
                                  for x in (r, k, v, w, u))).numpy(),
        **WKV_TOL)
    if t == 1:
        return
    # Two calls carrying the state equal one call over both segments.
    cut = t // 2
    args = [torch.from_numpy(x) for x in (r, k, v, w)]
    y1, s1 = ref.ref_wkv_state(*(x[:, :, :cut] for x in args),
                               torch.from_numpy(u), torch.from_numpy(s0))
    y2, s2 = ref.ref_wkv_state(*(x[:, :, cut:] for x in args),
                               torch.from_numpy(u), s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 2).numpy(), want_y,
                               **WKV_TOL)
    np.testing.assert_allclose(s2.numpy(), want_s, **WKV_TOL)


def test_wkv_state_routes_and_refuses_grad():
    r, k, v, w, u, s0 = (torch.from_numpy(x)
                         for x in _wkv_inputs(1, 2, 3, 16, seed=1))
    obs.configure(registry=obs.Registry())
    y, s_end = ops.wkv_state(r, k, v, w, u, s0)
    reg = obs.get_obs().registry
    assert reg.counter("ops.wkv_state.ref").value == 1
    assert reg.counter("ops.wkv_state.kernel").value == 0
    got = twkv.wkv6_state(r, k, v, w, u, s0)         # CPU: the plain version
    assert torch.equal(got[0], y) and torch.equal(got[1], s_end)
    with pytest.raises(RuntimeError, match="inference-only"):
        twkv.wkv6_state(r.requires_grad_(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="s0"):
        ops.wkv_state(r.detach(), k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv_state(r.detach(), k, v, w, u, s0, mode="kernel")


def test_cached_time_mix_and_channel_mix_match_reference():
    """One block from a nonzero cache (shifts and WKV state), a 5-token
    segment: outputs and the new cache match the reference's."""
    cfg = trwkv.RwkvConfig(head_size=16, lora_mix=8, lora_decay=8)
    jcfg = jrwkv.RwkvConfig(head_size=16, lora_mix=8, lora_decay=8)
    key = jax.random.PRNGKey(4)
    jtm = jrwkv.init_time_mix(key, 64, jcfg)
    jcm = jrwkv.init_channel_mix(key, 64, 224)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    cache = {"shift_tm": rng.normal(size=(2, 64)).astype(np.float32),
             "shift_cm": rng.normal(size=(2, 64)).astype(np.float32),
             "wkv": rng.normal(size=(2, 4, 16, 16)).astype(np.float32)}
    to_t = lambda tree: {k: (to_t(v) if isinstance(v, dict)  # noqa: E731
                             else torch.from_numpy(np.array(v)))
                         for k, v in tree.items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    want_tm, jnew = jax.jit(lambda p, x, c: jrwkv.time_mix(p, x, jcfg, c))(
        jtm, jnp.asarray(x), jc)
    got_tm, tnew = trwkv.time_mix(to_t(jtm), torch.from_numpy(x), cfg,
                                  to_t(cache))
    np.testing.assert_allclose(got_tm.numpy(), np.asarray(want_tm),
                               rtol=1e-5, atol=1e-5)
    for key_ in ("shift_tm", "wkv"):
        np.testing.assert_allclose(tnew[key_].numpy(), np.asarray(jnew[key_]),
                                   rtol=1e-5, atol=1e-5)
    want_cm, jnew = jax.jit(jrwkv.channel_mix)(jcm, jnp.asarray(x), jc)
    got_cm, tnew = trwkv.channel_mix(to_t(jcm), torch.from_numpy(x),
                                     to_t(cache))
    np.testing.assert_allclose(got_cm.numpy(), np.asarray(want_cm),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tnew["shift_cm"].numpy(),
                                  np.asarray(jnew["shift_cm"]))


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")
    rng = np.random.default_rng(9)
    prompts = {n: rng.integers(0, jcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in LENGTHS}
    return jcfg, tcfg, jparams, tp, prompts


def _manual_greedy(cfg, params, prompt, max_new):
    """The reference's engine-independent oracle (``tests/test_serving.py``):
    exact-length prefill and scalar-position decode through the raw JAX
    model API."""
    s = len(prompt)
    caches = jmodel.init_cache(cfg, 1, s + max_new + 4)
    last, caches = jmodel.prefill(
        params, {"tokens": jnp.asarray(prompt[None])}, cfg, caches)
    out = []
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
    for i in range(max_new):
        out.append(int(tok[0]))
        lg, caches = jmodel.decode_step(params, tok, jnp.asarray(s + i), cfg,
                                        caches)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    return np.asarray(out, np.int32)


def test_ragged_engine_equals_jax_engine_and_oracle():
    """Prompts of 4 and 11 tokens on 2 slots (``kv="paged"`` asked for),
    then a third request reusing a slot: the port's tokens equal the JAX
    engine's and the raw-model oracle's, so the state is carried per slot,
    pads never advance it and a reused slot starts from zero."""
    jcfg, tcfg, jparams, tp, prompts = _setup()
    out = {}
    for name, engine, cfg, params, scfg in (
            ("jax", JServeEngine, jcfg, jparams, JServeConfig),
            ("port", ServeEngine, tcfg, tp, ServeConfig)):
        eng = engine(cfg, params, scfg(batch_slots=2, max_len=32, kv="paged",
                                       page_size=8))
        try:
            assert eng.kv_mode == "dense"
            rids = {n: eng.submit(prompts[n], 6) for n in LENGTHS}
            res = eng.drain()
            again = eng.submit(prompts[4], 6)
            res.update(eng.drain())
        finally:
            eng.close()
        out[name] = [res[rids[n]] for n in LENGTHS] + [res[again]]
        assert eng.token_kv_bytes() == 0
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(got, want)
    for n, got in zip(LENGTHS, out["port"]):
        np.testing.assert_array_equal(
            got, _manual_greedy(jcfg, jparams, prompts[n], 6),
            err_msg=f"prompt_len={n}")
    np.testing.assert_array_equal(out["port"][2], out["port"][0])


@pytest.mark.parametrize("kw,field,want", [
    (dict(kv="paged", page_size=8, prefill_chunk=4), "prefill_chunk", 0),
    (dict(kv="paged", page_size=8, prefix_cache=True), "prefix", None),
    (dict(kv="paged", page_size=8), "kv_mode", "dense")])
def test_recurrent_bypass_as_reference(kw, field, want):
    jcfg, tcfg, jparams, tp, _ = _setup()
    for engine, cfg, params, scfg in (
            (JServeEngine, jcfg, jparams, JServeConfig),
            (ServeEngine, tcfg, tp, ServeConfig)):
        eng = engine(cfg, params, scfg(batch_slots=2, max_len=32, **kw))
        try:
            assert getattr(eng, field) == want, engine
            assert eng.pool is None and eng.blocks is None
        finally:
            eng.close()


def test_page_dtype_refused_as_reference():
    jcfg, tcfg, jparams, tp, _ = _setup()
    for engine, cfg, params, scfg in (
            (JServeEngine, jcfg, jparams, JServeConfig),
            (ServeEngine, tcfg, tp, ServeConfig)):
        with pytest.raises(ValueError, match="cannot honor"):
            engine(cfg, params, scfg(batch_slots=2, max_len=32, kv="paged",
                                     page_size=8, kv_dtype="int8"))


def test_norms_route_and_match_reference():
    """RWKV's LayerNorm and GroupNorm: ``ops.layernorm``'s plain version
    matches the reference's at 1e-6, a differentiated call (training)
    keeps autograd's plain expression, and mode "kernel" needs the card."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 2 + 0.3
    scale = (1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    want = jlayers.layernorm({"scale": scale, "bias": bias}, x)
    got = ops.layernorm(tx, ts, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    want = jlayers.groupnorm(x, 4, scale, bias, eps=64e-5)
    got = tlayers.groupnorm(tx, 4, ts, tb, eps=64e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    ts.requires_grad_()
    trained = tlayers.layernorm({"scale": ts, "bias": tb}, tx)
    assert trained.grad_fn is not None
    with pytest.raises(ValueError, match="CUDA"):
        ops.layernorm(tx, ts.detach(), tb, mode="kernel")
