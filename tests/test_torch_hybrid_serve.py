"""The MoE decoders (Kimi-K2, Llama-4 Maverick) and the Jamba Mamba/MoE
hybrid, SMOKE, in the port against the JAX package: the int8 codes of the
new blocks' weights and the served casts, logits and the aux loss, the
GEMM sites, the engine's greedy tokens (Jamba's recurrent state on the
dense layout whatever ``kv`` asks; a Jamba whose MoE drops assignments,
where a token's routing depends on its batch-mates) and the serve
launcher.

Parameters are initialised in JAX and carried across with
``bridge.params_from_numpy``; the SMOKE configs compute in f32, so logits
match at rtol = atol = 1e-4 (the two frameworks sum in different orders;
no routing near-tie flips at these seeds, so the reference's looser MoE
tolerance is not needed) and greedy tokens are equal.
"""

import collections
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.serving import quant as jquant
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import quant as tquant
from repro_torch.serving.engine import (ServeConfig, ServeEngine,
                                        model_gemm_shapes)
from repro_torch.tuning import dispatch

ARCHS = ["jamba_v01_52b", "kimi_k2_1t_a32b", "llama4_maverick_400b_a17b"]
TOL = dict(rtol=1e-4, atol=1e-4)
LENGTHS = (4, 11, 4, 11)        # two prompt lengths: each a JAX compile
MAX_NEW = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dropping(cfg):
    """The config with min_capacity = 1: a batch of 4 decode tokens (8
    assignments into 4 experts of capacity 2) drops whenever routing is
    unbalanced; one token alone never does."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, min_capacity=1))


@functools.lru_cache(maxsize=None)
def _setup(arch, drop=False):
    if drop:            # the same parameters: capacity draws nothing
        jcfg, tcfg, jparams, tp = _setup(arch)
        return _dropping(jcfg), _dropping(tcfg), jparams, tp
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")
    return jcfg, tcfg, jparams, tp


def test_int8_codes_of_new_leaves_equal_reference():
    """Jamba SMOKE quantized by the reference (``repro.serving.quant``) and
    by the port: every expert stack, Mamba weight and router leaf has the
    reference's codes and scales bit for bit, and the leaves it keeps
    (conv_w, a_log, d, and at this width the router and x_proj, under
    2**14 elements) stay unquantized."""
    _, tcfg, jparams, _ = _setup("jamba_v01_52b")
    tree = jax.tree.map(np.asarray, jparams)
    jq, jstats = jquant.quantize_params(tree)
    tq = params_from_numpy(tree, tcfg, device="cpu", quantize=True)
    moe_at, mamba_at = 1, 0           # pattern positions (n_groups = 1)
    checked = 0
    for pos, path in ((moe_at, ("moe", "gate")), (moe_at, ("moe", "up")),
                      (moe_at, ("moe", "down")),
                      (mamba_at, ("mamba", "in_proj", "w"))):
        want, got = jq["blocks"][pos], tq["blocks"][pos]
        for k in path:
            want, got = want[k], got[k]
        assert tquant.is_quantized(got) and "q" in want, path
        np.testing.assert_array_equal(got["q"].numpy(), want["q"][0])
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      want["scale"][0])
        checked += 1
    for pos, path in ((moe_at, ("moe", "router", "w")),
                      (mamba_at, ("mamba", "conv_w")),
                      (mamba_at, ("mamba", "a_log")),
                      (mamba_at, ("mamba", "d")),
                      (mamba_at, ("mamba", "x_proj", "w"))):
        want, got = jq["blocks"][pos], tq["blocks"][pos]
        for k in path:
            want, got = want[k], got[k]
        assert isinstance(got, torch.Tensor) and not isinstance(want, dict)
    assert checked == 4
    stats = tquant.weight_stats(tq, len(tcfg.pattern), 4)
    assert stats == jstats
    # The reference's quantized tree carried across leaf for leaf.
    carried = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg,
                                device="cpu")
    flat = lambda t: jax.tree_util.tree_flatten_with_path(  # noqa: E731
        jax.tree.map(np.asarray, t))[0]
    got, want = flat(carried), flat(tq)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_router_stays_f32_and_experts_cast_when_served():
    """Serving casts dense weights and expert stacks to the compute dtype
    once; the router stays f32, as the reference keeps it."""
    _, tcfg, jparams, _ = _setup("kimi_k2_1t_a32b")
    tree = jax.tree.map(np.asarray, jparams)
    tp = params_from_numpy(tree, tcfg, device="cpu", dtype=torch.bfloat16)
    moe = tp["blocks"][0]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["gate"].dtype == moe["down"].dtype == torch.bfloat16
    assert moe["shared"]["gate"]["w"].dtype == torch.bfloat16
    assert moe["gate"].shape == (8, 128, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_logits_and_aux_match_jax(arch):
    """A 2-slot 11-token prefill, then a decode step: logits match; the
    aux sum ``forward`` returns with ``with_aux``, and the training loss's
    aux term, equal the reference's forward output."""
    jcfg, tcfg, jparams, tp = _setup(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, 2, 16)
    tcache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    jlg, jcache, jaux = jax.jit(lambda p, t, c: jmodel.forward(
        p, {"tokens": t}, jcfg, caches=c, cache_pos=jnp.zeros((), jnp.int32))
    )(jparams, jnp.asarray(toks), jcache)
    tlg, tcache, taux = tmodel.forward(
        tp, {"tokens": torch.from_numpy(toks)}, tcfg, caches=tcache,
        cache_pos=0, with_aux=True)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert float(taux) > 0
    pos = np.asarray([11, 7], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, size=(2,)).astype(np.int32)
    jlg, _ = jax.jit(lambda p, t, q, c: jmodel.decode_step(p, t, q, jcfg, c))(
        jparams, jnp.asarray(tok), jnp.asarray(pos), jcache)
    tlg, _ = tmodel.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), tcfg, tcache)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    labels = torch.from_numpy(np.roll(toks, -1, axis=1)).long()
    loss, parts = tmodel.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                      "labels": labels}, tcfg, remat=False)
    np.testing.assert_allclose(float(parts["aux"]), float(jaux), **TOL)
    assert float(loss) == pytest.approx(float(parts["ce"] + parts["aux"]))


@pytest.mark.parametrize("arch", ["jamba_v01_52b", "kimi_k2_1t_a32b"])
def test_gemm_sites_are_the_configs(arch):
    """Every GEMM a decode step issues through ``ops.matmul`` is a site of
    ``ModelConfig.gemm_shapes`` (the expert products are not GEMMs), the
    router's in f32; the engine warms the FULL config's sites each in its
    ``gemm_dtype``, the router in f32 beside the bf16 rest."""
    _, tcfg, _, tp = _setup(arch)
    seen = []
    orig = ops.matmul

    def spy(a, b, **kw):
        seen.append((a.shape[1], b.shape[1], a.dtype))
        return orig(a, b, **kw)

    caches = tmodel.init_cache(tcfg, 2, 8, device="cpu")
    ops.matmul = spy
    try:
        tmodel.decode_step(tp, torch.zeros(2, dtype=torch.long),
                           torch.tensor([1, 2]), tcfg, caches)
    finally:
        ops.matmul = orig
    want = collections.Counter()
    for name, (k, n, c) in tcfg.gemm_shapes().items():
        want[(k, n)] += c
    assert collections.Counter((k, n) for k, n, _ in seen) == want
    assert {dt for *_, dt in seen} == {torch.float32}     # SMOKE is f32
    router = tcfg.gemm_shapes()["router"]
    assert router[:2] == (tcfg.d_model, tcfg.moe.num_experts)
    full = TC.get(arch)
    dts = collections.defaultdict(set)
    for _, k, n, dt in model_gemm_shapes(full, 2, 8):
        dts[(k, n)].add(dt)
    assert dts[full.gemm_shapes()["router"][:2]] == {torch.float32}
    assert set().union(*dts.values()) == {torch.float32, torch.bfloat16}


def _trace(vocab):
    rng = np.random.default_rng(9)
    return [{"id": i, "arrival": i // 2,
             "prompt": rng.integers(0, vocab, size=(n,)).astype(np.int32),
             "max_new": MAX_NEW} for i, n in enumerate(LENGTHS)]


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, drop):
    jcfg, _, jparams, _ = _setup(arch, drop)
    eng = JServeEngine(jcfg, jparams, JServeConfig(
        batch_slots=4, max_len=24, kv="paged", page_size=8))
    try:
        rep = jserve.run_trace(eng, _trace(jcfg.vocab_size), log=None)
        assert eng.kv_mode == ("dense" if arch == "jamba_v01_52b"
                               else "paged")
    finally:
        eng.close()
    return rep["results"]


@pytest.mark.parametrize("arch,drop", [
    ("jamba_v01_52b", False), ("kimi_k2_1t_a32b", False),
    ("llama4_maverick_400b_a17b", False), ("jamba_v01_52b", True)])
def test_engine_tokens_equal_jax_engine(arch, drop):
    """Prompts of 4 and 11 tokens on 4 slots, ``kv="paged"`` asked: the
    port's greedy tokens equal the JAX engine's.  Jamba keeps its state
    on the dense layout.  With ``drop`` the batch's MoE drops
    assignments (inactive slots' tokens take capacity too), so a token's
    output depends on its batch-mates, and the port's batched tokens must
    still equal the JAX engine's batched tokens."""
    _, tcfg, _, tp = _setup(arch, drop)
    want = _jax_tokens(arch, drop)
    eng = ServeEngine(tcfg, tp, ServeConfig(batch_slots=4, max_len=24,
                                            kv="paged", page_size=8))
    try:
        got = tserve.run_trace(eng, _trace(tcfg.vocab_size), log=None)
        assert eng.kv_mode == ("dense" if arch == "jamba_v01_52b"
                               else "paged")
    finally:
        eng.close()
    assert sorted(got["results"]) == sorted(want) == [0, 1, 2, 3]
    for tid, toks in want.items():
        np.testing.assert_array_equal(got["results"][tid], toks,
                                      err_msg=f"{arch} drop={drop} id {tid}")
    if drop:
        # The drops change tokens: a one-slot engine (one token, two
        # assignments, never over capacity) gives other tokens for some
        # request, in the port as in the reference (ROADMAP Queue C).
        one = ServeEngine(tcfg, tp, ServeConfig(batch_slots=1, max_len=24))
        try:
            alone = [one.generate(t["prompt"][None, :], MAX_NEW)[0]
                     for t in _trace(tcfg.vocab_size)]
        finally:
            one.close()
        assert any(not np.array_equal(a, want[i])
                   for i, a in enumerate(alone))


def test_recurrent_hybrid_bypasses_pages_chunks_and_the_tuner():
    """Jamba's Mamba state has no pages: ``kv="paged"`` serves dense, a
    prefill chunk and the prefix cache are dropped and a page dtype is
    refused, as the reference's engine does; the tuner's serve decisions
    keep monolithic, unshared, full-precision caches."""
    jcfg, tcfg, jparams, tp = _setup("jamba_v01_52b")
    for engine, cfg, params, scfg in (
            (JServeEngine, jcfg, jparams, JServeConfig),
            (ServeEngine, tcfg, tp, ServeConfig)):
        eng = engine(cfg, params, scfg(batch_slots=2, max_len=24,
                                       kv="paged", page_size=8,
                                       prefill_chunk=4, prefix_cache=True))
        try:
            assert eng.kv_mode == "dense" and eng.prefill_chunk == 0
            assert eng.prefix is None and eng.pool is None
        finally:
            eng.close()
        with pytest.raises(ValueError, match="cannot honor"):
            engine(cfg, params, scfg(batch_slots=2, max_len=24, kv="paged",
                                     page_size=8, kv_dtype="int8"))
    assert dispatch.serve_prefill_chunk(tcfg, 24, tcfg.cdtype, -1) == 0
    assert dispatch.serve_kv_dtype(tcfg, 24, tcfg.cdtype, -1) is None
    assert dispatch.serve_prefix_cache(tcfg, 24, tcfg.cdtype, -1) is False
    with pytest.raises(ValueError, match="non-attention state"):
        tmodel.init_paged_cache(tcfg, 4, 8, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_and_verifies(arch):
    """``--arch <id> --trace smoke6 --verify`` on the CPU: every request
    bit-identical to the one-shot engine (SMOKE's min_capacity of 64 never
    drops); Jamba asked for pages serves dense (no ``paged kv:`` line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", arch, "--trace", "smoke6", "--batch_slots",
                     "3", "--kv", "paged", "--page_size", "16", "--verify",
                     "--device", "cpu"])
    text = out.getvalue()
    assert "verify OK: 6 requests" in text
    assert ("paged kv:" in text) == (arch != "jamba_v01_52b")
    assert f"arch={TC.get_smoke(arch).name}" in text
