"""The port's M-RoPE decoder (Qwen2-VL-72B) against the JAX package:
``layers.mrope_angles``, the attention branch that rotates by (t, h, w)
positions, the model's ``embeds`` input and (B, S, 3) positions, and the
engine and launcher on its text path ((t, t, t) positions).

Parameters are initialised in JAX and carried across with
``bridge.params_from_numpy``; inputs are drawn with numpy from a seed.
The SMOKE config computes in f32, so logits match at rtol = atol = 1e-4
(2e-4 for prefill plus decode against the full forward) and greedy
tokens are equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.serving.engine import ServeConfig, ServeEngine

ARCH = "qwen2_vl_72b"
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
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def _grid_positions(b, s, offset=0):
    """(t, h, w) of a 2-D patch grid 4 patches wide: t the frame, h the
    row, w the column, all distinct from the token index."""
    i = np.arange(s) + offset
    pos = np.stack([i // 8, (i // 4) % 2, i % 4], axis=-1)
    return np.broadcast_to(pos, (b, s, 3)).astype(np.int32).copy()


@pytest.mark.parametrize("sections,d_head,theta", [
    ((16, 24, 24), 128, 1000000.0), ((4, 2, 2), 16, 10000.0)])
def test_mrope_angles_equal_jax(sections, d_head, theta):
    """Qwen2-VL FULL's and SMOKE's sections, at distinct (t, h, w), equal
    to JAX's to an f32 ulp (torch's and XLA's ``theta ** x`` may round
    apart); with t == h == w the angles are ``rope_angles``' bit for
    bit."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (2, 7, 3)).astype(np.int32)
    want = jlayers.mrope_angles(jnp.asarray(pos), d_head, sections, theta)
    got = tlayers.mrope_angles(torch.from_numpy(pos), d_head, sections,
                               theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=0)
    text = np.repeat(pos[..., :1], 3, axis=-1)
    np.testing.assert_array_equal(
        tlayers.mrope_angles(torch.from_numpy(text), d_head, sections,
                             theta).numpy(),
        tlayers.rope_angles(torch.from_numpy(text[..., 0]), d_head,
                            theta).numpy())
    with pytest.raises(ValueError, match="sum"):
        tlayers.mrope_angles(torch.from_numpy(pos), d_head + 2, sections)


def test_full_config_sizes():
    cfg = TC.get(ARCH)
    assert cfg.n_params() == JC.get(ARCH).n_params() == 72_704_065_536
    shapes = cfg.gemm_shapes()
    assert shapes == cfg.gemm_shapes("prefill")
    assert shapes["gate/up"] == (8192, 29568, 160)
    assert shapes["lm_head"] == (8192, 152064, 1)
    assert sum(c for _, _, c in shapes.values()) == 80 * 7 + 1


@pytest.mark.parametrize("inputs", ["embeds", "tokens"])
def test_forward_logits_match_jax(inputs):
    """Patch embeddings at distinct (t, h, w) positions, and text tokens
    at the default (t, t, t): logits at 1e-4 of JAX's."""
    jcfg, tcfg, jparams, tp = _params()
    rng = np.random.default_rng(1)
    if inputs == "embeds":
        batch = {"embeds": rng.standard_normal(
                     (2, 10, jcfg.d_model)).astype(np.float32),
                 "positions": _grid_positions(2, 10)}
    else:
        batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                        (2, 10)).astype(np.int32)}
    jlg, _, _ = jmodel.forward(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tlg, _, _ = tmodel.forward(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)


@pytest.mark.parametrize("grid", [False, True], ids=["text_pos", "grid_pos"])
def test_prefill_then_decode_matches_jax_full_forward(grid):
    """The teacher-forced check of ``tests/test_models.py`` with
    ``embeds``: prefill 6 patches, then decode the rest one by one, every
    position's logits within 2e-4 of JAX's full forward.  ``text_pos``
    runs the reference's own form ((t, t, t) positions, ``decode_step``
    with ``embeds``); ``grid_pos`` the patch grid's distinct (t, h, w),
    each decode step a one-token ``forward`` at its cache offset."""
    jcfg, tcfg, jparams, tp = _params()
    rng = np.random.default_rng(2)
    b, s, p_len = 2, 12, 6
    emb = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = (_grid_positions(b, s) if grid else
           np.broadcast_to(np.arange(s, dtype=np.int32)[None, :, None],
                           (b, s, 3)).copy())
    full, _, _ = jmodel.forward(jparams, {"embeds": jnp.asarray(emb),
                                          "positions": jnp.asarray(pos)},
                                jcfg)
    caches = tmodel.init_cache(tcfg, b, s + 4, device="cpu")
    last, caches = tmodel.prefill(
        tp, {"embeds": torch.from_numpy(emb[:, :p_len]),
             "positions": torch.from_numpy(pos[:, :p_len])}, tcfg, caches)
    np.testing.assert_allclose(last.numpy(), np.asarray(full[:, p_len - 1]),
                               **STEP_TOL)
    for t in range(p_len, s):
        if grid:
            lg, caches, _ = tmodel.forward(
                tp, {"embeds": torch.from_numpy(emb[:, t:t + 1]),
                     "positions": torch.from_numpy(pos[:, t:t + 1])},
                tcfg, caches=caches, cache_pos=t)
            lg = lg[:, 0]
        else:
            lg, caches = tmodel.decode_step(
                tp, torch.zeros((b,), dtype=torch.long), t, tcfg, caches,
                embeds=torch.from_numpy(emb[:, t]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(full[:, t]),
                                   err_msg=f"position {t}", **STEP_TOL)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_greedy_tokens_equal_jax_engine(kv):
    """A staggered 4-request trace on 3 slots, the text path: the port's
    engine gives the JAX engine's greedy tokens, on dense KV and on f32
    pages of 8."""
    jcfg, tcfg, jparams, tp = _params()
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
                                      err_msg=f"{kv} id {tid}")
    assert teng.kv_mode == jeng.kv_mode == kv


def test_launcher_serves_smoke_as_the_jax_launcher(monkeypatch):
    """``--arch qwen2_vl_72b`` (SMOKE) on smoke6 ends in ``verify OK``
    with the JAX launcher's tokens, given its parameters."""
    jcfg = JC.get_smoke(ARCH)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    import repro_torch.models as tmodels
    monkeypatch.setattr(tmodels, "init_params",
                        lambda cfg, seed, device, quantize=False:
                        params_from_numpy(tree, cfg, device=device))
    reps = {}
    for name, module in (("port", tserve), ("jax", jserve)):
        def run(*a, _orig=module.run_trace, _name=name, **kw):
            reps[_name] = _orig(*a, **kw)
            return reps[_name]
        monkeypatch.setattr(module, "run_trace", run)
    argv = ["--arch", ARCH, "--trace", "smoke6", "--batch_slots", "3",
            "--verify"]
    tserve.main(argv + ["--device", "cpu"])
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jserve.main()
    assert sorted(reps["port"]["results"]) == sorted(reps["jax"]["results"])
    for tid, toks in reps["jax"]["results"].items():
        np.testing.assert_array_equal(reps["port"]["results"][tid], toks)
