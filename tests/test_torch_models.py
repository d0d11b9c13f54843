"""The port's models (repro_torch.models) against the JAX package's.

Parameters are initialised in JAX and carried across with
``bridge.params_from_numpy`` (torch cannot reproduce jax.random).  Logits
are compared at f32 (both SMOKE configs compute in f32) at rtol = atol =
1e-4: the two frameworks sum in different orders, and the differences
grow through two layers and the lm head.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as jmodel
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.models import model as tmodel

ARCHS = ["smollm_360m", "qwen3_8b"]
# Every ported config: RWKV-6, the MoE and hybrid ones, the enc-dec
# SeamlessM4T and the M-RoPE Qwen2-VL.
CONFIG_ARCHS = ARCHS + ["rwkv6_3b", "kimi_k2_1t_a32b",
                        "llama4_maverick_400b_a17b", "jamba_v01_52b",
                        "seamless_m4t_large_v2", "qwen2_vl_72b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's default pool of one thread per
    core only oversubscribes the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(jax cfg, port cfg, jax params, numpy tree, port params); shared
    by the tests, which never write to parameters."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, params_from_numpy(tree, tcfg,
                                                        device="cpu")


def test_port_configs_equal_reference():
    import dataclasses
    for arch in CONFIG_ARCHS:
        for get in ("get", "get_smoke"):
            jcfg, tcfg = getattr(JC, get)(arch), getattr(TC, get)(arch)
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            assert tcfg.n_params() == jcfg.n_params()
            assert tcfg.cdtype == getattr(torch, jcfg.compute_dtype)


def test_unported_arch_raises():
    """Every architecture id of the reference builds (FULL and SMOKE); an
    id the reference does not have raises ValueError."""
    from repro.configs.registry import ARCH_IDS
    assert sorted(TC.PORTED) == sorted(ARCH_IDS)
    for arch in ("seamless_m4t_large_v2", "qwen2_vl_72b"):
        assert TC.get(arch).name == JC.get(arch).name
        assert TC.get_smoke(arch).name == JC.get_smoke(arch).name
    with pytest.raises(ValueError, match="unknown arch"):
        TC.get("no_such_arch")


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_bridge_round_trips_every_leaf(arch):
    jcfg, tcfg, _, tree, tp = _params(arch)
    n_layers = jcfg.n_layers
    assert len(tp["blocks"]) == n_layers
    seen = 0
    stacked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        # The decoder's stacks, one per pattern position, and an enc-dec
        # model's encoder stack: one leading layer axis to unstack.
        lead = (["blocks"] if keys[0] == "blocks" else
                ["encoder", "blocks"] if keys[:2] == ["encoder", "blocks"]
                else None)
        if lead is not None:
            stack, period = keys[len(lead)], (len(jcfg.pattern)
                                              if keys[0] == "blocks" else 1)
            layers = tp
            for k in lead:
                layers = layers[k]
            for g in range(leaf.shape[0]):
                node = layers[g * period + stack]
                for k in keys[len(lead) + 1:]:
                    node = node[k]
                np.testing.assert_array_equal(node.numpy(), leaf[g])
                seen += 1
            stacked += 1
        else:
            node = tp
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), leaf)
            seen += 1
    assert seen == sum(
        x.shape[0] if p[0].key == "blocks" or (
            p[0].key == "encoder" and p[1].key == "blocks") else 1
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0])
    if tcfg.encoder_decoder:
        assert len(tp["encoder"]["blocks"]) == jcfg.n_encoder_layers
        assert {"ln_cross", "cross_attn"} <= set(tp["blocks"][0])
        assert stacked > len(tree["blocks"][0])
    if tcfg.tie_embeddings:
        table_t = tp["embed"]["table_t"]
        assert table_t.is_contiguous()
        assert torch.equal(table_t, tp["embed"]["table"].t())
    else:
        assert "table_t" not in tp["embed"]
    assert tmodel.param_count(tp) == jmodel.param_count(tree)


def test_bridge_casts_weights_once_to_compute_dtype():
    _, tcfg, _, tree, _ = _params("smollm_360m")
    tp = params_from_numpy(tree, tcfg, device="cpu", dtype=torch.bfloat16)
    assert tp["blocks"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert tp["embed"]["table_t"].dtype == torch.bfloat16
    assert tp["blocks"][0]["ln1"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_ragged_decode_match_jax(arch):
    """A 3-slot batch prefilled on a padded 16-token bucket, then two
    ragged decode steps at per-slot positions (5, 12, 1) and (6, 13, 2):
    logits and the KV caches must match the JAX model's."""
    jcfg, tcfg, jparams, _, tp = _params(arch)
    rng = np.random.default_rng(7)
    max_len, bucket = 32, 16
    toks = rng.integers(0, jcfg.vocab_size, size=(3, bucket)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, 3, max_len)
    tcache = tmodel.init_cache(tcfg, 3, max_len, device="cpu")
    # Jitted: one XLA program per call shape is cheaper to run here than
    # the eager model's op-by-op dispatch.
    jforward = jax.jit(lambda p, t, c, pos: jmodel.forward(
        p, {"tokens": t}, jcfg, caches=c, cache_pos=pos))
    jdecode = jax.jit(lambda p, t, pos, c: jmodel.decode_step(p, t, pos, jcfg,
                                                              c))
    jlg, jcache, _ = jforward(jparams, jnp.asarray(toks), jcache,
                              jnp.zeros((), jnp.int32))
    tlg, tcache, _ = tmodel.forward(tp, {"tokens": torch.from_numpy(toks)},
                                    tcfg, caches=tcache, cache_pos=0)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    pos = np.asarray([5, 12, 1], np.int32)
    for _ in range(2):
        tok = rng.integers(0, jcfg.vocab_size, size=(3,)).astype(np.int32)
        jlg, jcache = jdecode(jparams, jnp.asarray(tok), jnp.asarray(pos),
                              jcache)
        tlg, tcache = tmodel.decode_step(tp, torch.from_numpy(tok),
                                         torch.from_numpy(pos), tcfg, tcache)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        pos = pos + 1
    for layer in range(tcfg.n_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tcache[layer]["attn"][key].numpy(),
                np.asarray(jcache[0]["attn"][key][layer]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_seeded_and_shaped_like_reference(arch):
    """Seeded init: same seed, same tensors; every parameter has the
    reference's shape; dense weights have its N(0, 1/d_in) spread."""
    _, cfg, _, tree, bridged = _params(arch)
    a = tmodel.init_params(cfg, seed=3, device="cpu")
    b = tmodel.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["blocks"][1]["mlp"]["down"]["w"],
                       b["blocks"][1]["mlp"]["down"]["w"])
    shapes = jax.tree.map(lambda t: tuple(t.shape), bridged)
    assert jax.tree.map(lambda t: tuple(t.shape), a) == shapes
    w = a["blocks"][0]["attn"]["wq"]["w"]
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.01
    assert tmodel.param_count(a) == jmodel.param_count(tree)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = TC.get_smoke("smollm_360m")
    for entry_point in (lambda: tmodel.init_params(cfg),
                        lambda: tmodel.init_cache(cfg, 2, 16),
                        lambda: tmodel.init_paged_cache(cfg, 4, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            entry_point()
