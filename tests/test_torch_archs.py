"""The dense decoders the port serves beyond SmolLM and Qwen3, against the
JAX package: Phi-3-medium (SwiGLU, untied) and Minitron-8B (the
non-gated GELU FFN), their GEMM sites, and the serve launcher's
reference flags and default arch.

Parameters are initialised in JAX and carried across with
``bridge.params_from_numpy``; the SMOKE configs compute in f32, so logits
match at rtol = atol = 1e-4 (the two frameworks sum in different orders)
and greedy tokens are equal.
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
from repro_torch import obs
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serving.engine import ServeConfig, ServeEngine

ARCHS = ["phi3_medium_14b", "minitron_8b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_params_equal_reference(arch):
    import dataclasses
    for get in ("get", "get_smoke"):
        jcfg, tcfg = getattr(JC, get)(arch), getattr(TC, get)(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.n_params() == jcfg.n_params()
    jcfg, tcfg, jparams, tp = _params(arch)
    mlp = tp["blocks"][0]["mlp"]
    assert set(mlp) == set(jparams["blocks"][0]["mlp"])
    assert ("gate" in mlp) == (tcfg.ffn_kind == "swiglu")
    assert tmodel.param_count(tp) == jmodel.param_count(jparams)
    # The port's own draws have the reference's tree (no gate for GELU).
    own = tmodel.init_params(tcfg, seed=3, device="cpu")
    assert set(own["blocks"][1]["mlp"]) == set(mlp)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_ragged_decode_logits_match_jax(arch):
    jcfg, tcfg, jparams, tp = _params(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, 2, 16)
    tcache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    jlg, jcache, _ = jax.jit(lambda p, t, c: jmodel.forward(
        p, {"tokens": t}, jcfg, caches=c, cache_pos=jnp.zeros((), jnp.int32))
    )(jparams, jnp.asarray(toks), jcache)
    tlg, tcache, _ = tmodel.forward(tp, {"tokens": torch.from_numpy(toks)},
                                    tcfg, caches=tcache, cache_pos=0)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    pos = np.asarray([8, 5], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, size=(2,)).astype(np.int32)
    jlg, _ = jax.jit(lambda p, t, q, c: jmodel.decode_step(p, t, q, jcfg, c))(
        jparams, jnp.asarray(tok), jnp.asarray(pos), jcache)
    tlg, _ = tmodel.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), tcfg, tcache)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_greedy_tokens_equal_jax_engine(arch, kv):
    """A staggered 4-request trace on 3 slots: the port's engine gives the
    JAX engine's greedy tokens, on dense KV and on f32 pages of 8."""
    jcfg, tcfg, jparams, tp = _params(arch)
    trace = tserve.synth_trace(4, 9, 5, 2, jcfg.vocab_size, seed=5)
    kw = dict(batch_slots=3, max_len=24, kv=kv, page_size=8)
    jeng = JServeEngine(jcfg, jparams, JServeConfig(**kw))
    teng = ServeEngine(tcfg, tp, ServeConfig(**kw))
    try:
        want = jserve.run_trace(jeng, trace, log=None)
        got = tserve.run_trace(teng, trace, log=None)
    finally:
        jeng.close()
        teng.close()
    assert sorted(got["results"]) == sorted(want["results"]) == [0, 1, 2, 3]
    for tid, toks in want["results"].items():
        np.testing.assert_array_equal(got["results"][tid], toks,
                                      err_msg=f"{arch} {kv} id {tid}")
    assert got["shared_steps"] == want["shared_steps"]
    assert teng.kv_mode == jeng.kv_mode == kv


def _matmul_sites(cfg, params, run):
    """The (K, N) of every GEMM ``run`` issues through ``ops.matmul``."""
    from repro_torch.kernels import ops
    seen = []
    orig = ops.matmul

    def spy(a, b, **kw):
        seen.append((a.shape[1], b.shape[1]))
        return orig(a, b, **kw)

    ops.matmul = spy
    try:
        run()
    finally:
        ops.matmul = orig
    return seen


@pytest.mark.parametrize("arch", ["minitron_8b", "phi3_medium_14b",
                                  "rwkv6_3b"])
def test_gemm_shapes_are_the_sites_a_decode_step_runs(arch):
    """``ModelConfig.gemm_shapes`` lists exactly the GEMMs a decode step
    issues (counted on the SMOKE config), and FULL Minitron-8B's step is
    32 x 6 + 1 = 193 launches (SmolLM's 225: no gate)."""
    cfg = TC.get_smoke(arch)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    caches = tmodel.init_cache(cfg, 2, 8, device="cpu")
    sites = _matmul_sites(cfg, params, lambda: tmodel.decode_step(
        params, torch.zeros((2,), dtype=torch.long),
        torch.zeros((2,), dtype=torch.int32), cfg, caches))
    want = {}
    for k, n, count in cfg.gemm_shapes().values():
        want[(k, n)] = want.get((k, n), 0) + count
    got = {}
    for site in sites:
        got[site] = got.get(site, 0) + 1
    assert got == want
    full = TC.get(arch).gemm_shapes()
    if arch == "minitron_8b":
        assert sum(c for _, _, c in full.values()) == 193
        assert "gate/up" not in full and full["up"] == (4096, 16384, 32)
    if arch == "rwkv6_3b":
        assert full["lora_a"] == (2560, 160, 32)
        assert full["lora_b"] == (32, 2560, 160)
        assert full["cm_wv"] == (8960, 2560, 32)
        assert full["lm_head"] == (2560, 65536, 1)
        assert sum(c for _, _, c in full.values()) == 32 * 16 + 1


def test_launcher_takes_the_reference_flags():
    args = ["--arch", "minitron_8b", "--smoke", "--trace", "smoke6",
            "--batch_slots", "3", "--max_new", "4", "--device", "cpu"]
    tserve.main(args)                            # a reference command line
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        tserve.main(["--pack_min_flops", "1e9", "--device", "cpu"])
    with pytest.raises(SystemExit, match="different configs"):
        tserve.main(["--full", "--smoke", "--device", "cpu"])


def test_bare_verify_serves_qwen3_smoke_as_the_jax_launcher(monkeypatch,
                                                             capsys):
    """The bare ``--verify`` command serves qwen3 SMOKE (the reference's
    default arch) and ends in ``verify OK``; given the JAX launcher's
    parameters (PRNGKey(1)) it emits the JAX launcher's tokens."""
    import repro_torch.models as tmodels
    jcfg = JC.get_smoke("qwen3_8b")
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(tmodels, "init_params",
                        lambda cfg, seed, device, quantize=False:
                        params_from_numpy(tree, cfg, device=device))
    reps = {}

    def capture(name, module):
        orig = module.run_trace

        def run(*a, **kw):
            reps[name] = orig(*a, **kw)
            return reps[name]
        monkeypatch.setattr(module, "run_trace", run)

    capture("port", tserve)
    capture("jax", jserve)
    tserve.main(["--verify", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=qwen3-smoke" in out and "verify OK: 8 requests" in out
    obs.configure(registry=obs.Registry())
    monkeypatch.setattr("sys.argv", ["serve", "--verify"])
    jserve.main()
    assert "verify OK: 8 requests" in capsys.readouterr().out
    want, got = reps["jax"]["results"], reps["port"]["results"]
    assert sorted(got) == sorted(want) == list(range(8))
    for tid, toks in want.items():
        np.testing.assert_array_equal(got[tid], toks, err_msg=f"id {tid}")
