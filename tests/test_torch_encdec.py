"""The port's encoder-decoder (SeamlessM4T-large-v2) against the JAX
package: the encoder stack, cross attention's prefill and decode forms,
the cross cache, the engine's ``enc_len`` and its dense bypass, the GEMM
sites a prefill and a decode step run, and the serve launcher.

Parameters are initialised in JAX and carried across with
``bridge.params_from_numpy``; inputs are drawn with numpy from a seed.
The SMOKE config computes in f32, so logits match at rtol = atol = 1e-4
(2e-4 for prefill plus decode against the full forward, the reference's
own tolerance) and greedy tokens are equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serving.engine import ServeConfig, ServeEngine

ARCH = "seamless_m4t_large_v2"
TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, params_from_numpy(tree, tcfg,
                                                        device="cpu")


def _enc(rng, b, s, d):
    return rng.standard_normal((b, s, d)).astype(np.float32)


def test_full_config_sizes_and_sites():
    """FULL: 2,034,659,328 parameters; a decode step runs the decoder's
    self attention, its cross ``wq``/``wo`` and its FFN (24 x 9 + 1
    GEMMs), a prefill also the cross ``wk``/``wv`` and the encoder's
    24 x 7."""
    cfg = TC.get(ARCH)
    assert cfg.n_params() == JC.get(ARCH).n_params() == 2_034_659_328
    decode, prefill = cfg.gemm_shapes(), cfg.gemm_shapes("prefill")
    assert sum(c for _, _, c in decode.values()) == 24 * 9 + 1
    assert sum(c for _, _, c in prefill.values()) == 24 * 11 + 1 + 24 * 7
    assert decode["lm_head"] == (1024, 256206, 1)
    assert prefill["cross wk/wv"] == (1024, 1024, 48)
    assert prefill["enc gate/up"] == (1024, 8192, 48)
    assert set(decode) < set(prefill)
    with pytest.raises(ValueError, match="step"):
        cfg.gemm_shapes("train")
    # What reads the sites and the sizes takes the config: the engine's
    # plan warm-up (decode sites at M = slots) and the efficiency model.
    from repro_torch.obs.efficiency import serve_efficiency
    from repro_torch.serving.engine import model_gemm_shapes
    assert len(model_gemm_shapes(cfg, 8, 16)) == 2 * (9 + 1)   # a layer, head
    assert 0 < serve_efficiency(cfg, 100.0, "cuda") < 1


def _sites(run):
    from repro_torch.kernels import ops
    seen = {}
    orig = ops.matmul

    def spy(a, b, **kw):
        seen[(a.shape[1], b.shape[1])] = seen.get((a.shape[1],
                                                   b.shape[1]), 0) + 1
        return orig(a, b, **kw)

    ops.matmul = spy
    try:
        run()
    finally:
        ops.matmul = orig
    return seen


def _want(shapes):
    want = {}
    for k, n, count in shapes.values():
        want[(k, n)] = want.get((k, n), 0) + count
    return want


def test_gemm_shapes_are_the_sites_prefill_and_decode_run():
    _, tcfg, _, _, tp = _params()
    rng = np.random.default_rng(1)
    caches = tmodel.init_cache(tcfg, 1, 16, device="cpu", enc_len=8)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "enc_embeds": torch.from_numpy(_enc(rng, 1, 8, tcfg.d_model))}
    assert _sites(lambda: tmodel.prefill(tp, batch, tcfg, caches)) == \
        _want(tcfg.gemm_shapes("prefill"))
    assert _sites(lambda: tmodel.decode_step(
        tp, torch.zeros((1,), dtype=torch.long), 8, tcfg, caches)) == \
        _want(tcfg.gemm_shapes())


def test_forward_logits_match_jax():
    """Training's form (no cache): the encoder, and cross attention over
    its states, at 1e-4 of JAX's logits."""
    jcfg, tcfg, jparams, _, tp = _params()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    enc = _enc(rng, 2, 11, jcfg.d_model)
    jlg, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                         "enc_embeds": jnp.asarray(enc)},
                               jcfg)
    tlg, _, _ = tmodel.forward(tp, {"tokens": torch.from_numpy(toks),
                                    "enc_embeds": torch.from_numpy(enc)},
                               tcfg)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)


def test_prefill_then_decode_matches_jax_full_forward():
    """The teacher-forced check of ``tests/test_models.py``: prefill 6
    tokens with the encoder's states written into the cross cache, then
    decode one by one against it; every position's logits within 2e-4 of
    JAX's full forward, and the caches (self and cross) equal JAX's."""
    jcfg, tcfg, jparams, _, tp = _params()
    rng = np.random.default_rng(3)
    b, s, p_len, enc_len = 2, 12, 6, 8
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    enc = _enc(rng, b, enc_len, jcfg.d_model)
    full, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                          "enc_embeds": jnp.asarray(enc)},
                                jcfg)
    jcache = jmodel.init_cache(jcfg, b, s + 4, enc_len=enc_len)
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :p_len]),
                                         "enc_embeds": jnp.asarray(enc)},
                               jcfg, jcache)
    caches = tmodel.init_cache(tcfg, b, s + 4, device="cpu", enc_len=enc_len)
    last, caches = tmodel.prefill(
        tp, {"tokens": torch.from_numpy(toks[:, :p_len]),
             "enc_embeds": torch.from_numpy(enc)}, tcfg, caches)
    np.testing.assert_allclose(last.numpy(), np.asarray(full[:, p_len - 1]),
                               **STEP_TOL)
    for i, c in enumerate(caches):
        assert set(c) == {"attn", "cross"}
        for kind in ("attn", "cross"):
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    c[kind][key].numpy(),
                    np.asarray(jcache[0][kind][key][i]), **TOL)
    cross = [c["cross"]["k"].clone() for c in caches]
    for t in range(p_len, s):
        lg, caches = tmodel.decode_step(tp, torch.from_numpy(toks[:, t]), t,
                                        tcfg, caches)
        np.testing.assert_allclose(lg.numpy(), np.asarray(full[:, t]),
                                   err_msg=f"position {t}", **STEP_TOL)
    # Decode reads the cross cache and never writes it.
    assert all(torch.equal(c["cross"]["k"], x) for c, x in zip(caches, cross))


def test_prefill_without_enc_embeds_fails_as_reference():
    jcfg, tcfg, jparams, _, tp = _params()
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError, match="enc_embeds"):
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                       jmodel.init_cache(jcfg, 1, 8, enc_len=4))
    with pytest.raises(KeyError, match="enc_embeds"):
        tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                       tmodel.init_cache(tcfg, 1, 8, device="cpu",
                                         enc_len=4))


ENC_LEN = 12


def _serve(kw, enc_lens, quantize=False):
    """Four staggered requests on 3 slots, each with its encoder input of
    ``enc_lens[i]`` rows, through both engines: (JAX tokens, port tokens,
    JAX engine, port engine)."""
    jcfg, tcfg, jparams, _, tp = _params()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3, 7)]
    encs = [_enc(rng, 1, n, jcfg.d_model) for n in enc_lens]
    out, engines = [], []
    for eng in (JServeEngine(jcfg, jparams, JServeConfig(
            batch_slots=3, max_len=24, enc_len=ENC_LEN, quantize=quantize,
            **kw)),
                ServeEngine(tcfg, tp, ServeConfig(
                    batch_slots=3, max_len=24, enc_len=ENC_LEN,
                    quantize=quantize, **kw))):
        try:
            rids = [eng.submit(p, 5, arrival=2 * i, enc_embeds=x)
                    for i, (p, x) in enumerate(zip(prompts, encs))]
            res = eng.drain()
        finally:
            eng.close()
        out.append([res[r] for r in rids])
        engines.append(eng)
    return out[0], out[1], engines[0], engines[1]


@pytest.mark.parametrize("enc_lens", [(12, 12, 12, 12), (12, 12, 7, 12)],
                         ids=["full", "one_shorter"])
def test_engine_greedy_tokens_equal_jax_engine(enc_lens):
    """Every request's encoder input ``enc_len`` long, and one request's
    shorter: the rows past it stay zero and are attended with a score of 0
    by both engines (the reference's semantics, ROADMAP Queue C)."""
    want, got, jeng, teng = _serve({}, enc_lens)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    assert teng.kv_mode == jeng.kv_mode == "dense"


@pytest.mark.parametrize("kw", [dict(kv="paged", page_size=8),
                                dict(prefill_chunk=4)],
                         ids=["paged", "chunked"])
def test_paged_and_chunked_bypass_to_dense_as_reference(kw):
    """An enc-dec cross cache has no pages and is written once at full
    length: ``kv="paged"`` serves dense and ``prefill_chunk`` monolithic,
    with the JAX engine's tokens."""
    want, got, jeng, teng = _serve(kw, (12, 12, 7, 12))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert teng.kv_mode == jeng.kv_mode == "dense"
    assert teng.prefill_chunk == jeng.prefill_chunk == 0
    assert teng.pool is None and teng.prefix is None


def test_int8_weights_equal_jax_engine():
    """``quantize=True`` quantizes the encoder's weights too: the JAX
    engine's ``quant_stats`` and tokens."""
    want, got, jeng, teng = _serve({}, (12, 12, 12, 12), quantize=True)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert teng.quant_stats == jeng.quant_stats


def test_int8_pages_and_prefix_cache_raise_as_reference():
    jcfg, tcfg, jparams, _, tp = _params()
    scfg = dict(batch_slots=2, max_len=16, enc_len=8, kv="paged",
                page_size=8, kv_dtype="int8")
    with pytest.raises(ValueError, match="cross cache"):
        JServeEngine(jcfg, jparams, JServeConfig(**scfg))
    with pytest.raises(ValueError, match="cross cache"):
        ServeEngine(tcfg, tp, ServeConfig(**scfg))


def test_launcher_fails_as_the_reference_launcher(monkeypatch):
    """The reference launcher builds no encoder inputs, so serving the
    SMOKE config fails at the first prefill with KeyError 'enc_embeds';
    the port's launcher does the same."""
    _, _, _, tree, _ = _params()
    import repro_torch.models as tmodels
    monkeypatch.setattr(tmodels, "init_params",
                        lambda cfg, seed, device, quantize=False:
                        params_from_numpy(tree, cfg, device=device))
    argv = ["--arch", ARCH, "--smoke", "--trace", "smoke6", "--batch_slots",
            "2", "--max_new", "2"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with pytest.raises(KeyError, match="enc_embeds"):
        jserve.main()
    with pytest.raises(KeyError, match="enc_embeds"):
        tserve.main(argv + ["--device", "cpu"])
