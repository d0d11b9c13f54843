"""The port's int8 weight-only quantization (``serving.quant``'s weight
half) against the JAX package's: the codes and scales bit for bit, the
stats, the weight-fetch hook, and the engine's greedy tokens with
``quantize=True``.

Quantization is held to the reference's own f32 parameters, carried
across with ``bridge.params_from_numpy``; a bf16-compute config is
quantized from the f32 values too, never from the bf16 copies.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as jmodel
from repro.serving import quant as jquant
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import dequant as tdequant
from repro_torch.kernels import ops as tops
from repro_torch.models import model as tmodel
from repro_torch.serving import quant
from repro_torch.serving.engine import ServeConfig, ServeEngine

ARCH = "smollm_360m"
RAGGED = (5, 17, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch=ARCH):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("shape", [(64, 48), (3, 40, 24), (2, 16, 8)])
def test_quantize_weight_bit_equal_to_reference(shape):
    """Stacked (G, K, N) and unstacked (K, N) weights, with ties at .5 and
    an all-zero channel: the same codes, scales and dequantized values."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                                   # scale 0 -> codes 0
    w[..., 1] = np.linspace(-127, 127, shape[-2])[..., :] / 127 * 2.5
    want = jquant.quantize_weight(w)
    got = quant.quantize_weight(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    for dt, jdt in ((torch.float32, np.float32), (torch.bfloat16, "bfloat16")):
        want_d = np.asarray(jquant.dequantize_weight(want, jdt)).astype(
            np.float32)
        got_d = quant.dequantize_weight(got, dt).float().numpy()
        np.testing.assert_array_equal(got_d, want_d)
    # A stack quantizes as its layers do.
    if len(shape) == 3:
        for g in range(shape[0]):
            one = quant.quantize_weight(torch.from_numpy(w[g]))
            assert torch.equal(one["q"], got["q"][g])
            assert torch.equal(one["scale"], got["scale"][g])


def _walk_pairs(jtree, tp, n_pattern):
    """(reference leaf, port leaf) for every leaf, the port's per-layer
    blocks matched to the reference's stacks."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "blocks":
            for g in range(leaf.shape[0]):
                node = tp["blocks"][g * n_pattern + keys[1]]
                for k in keys[2:]:
                    node = node[k]
                yield keys, np.asarray(leaf)[g], node
        else:
            node = tp
            for k in keys:
                node = node[k]
            yield keys, np.asarray(leaf), node


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_quantized_params_bit_equal_and_stats_equal(compute):
    """The bridge's and the engine's int8 trees hold the reference
    ``quantize_params``' codes and scales bit for bit, quantized from f32
    whatever the compute dtype; ``quantize_params`` and the engine give
    the reference's stats."""
    jcfg, tcfg, jparams, tree = _setup()
    jcfg = dataclasses.replace(jcfg, compute_dtype=compute)
    tcfg = dataclasses.replace(tcfg, compute_dtype=compute)
    jq, jstats = jquant.quantize_params(jparams)
    tq = params_from_numpy(tree, tcfg, device="cpu", quantize=True)
    seen = 0
    for keys, want, got in _walk_pairs(jq, tq, len(tcfg.pattern)):
        if keys[-1] in ("q", "scale"):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=keys)
            seen += 1
        else:                   # kept, cast to the compute dtype or not
            want = torch.from_numpy(want).to(got.dtype)
            assert torch.equal(got, want), keys
    assert seen > 0
    # The tied head keeps an int8 transpose, no copy in the compute dtype.
    table_t = tq["embed"]["table_t"]
    assert table_t["q_t"].dtype == torch.int8
    assert torch.equal(table_t["q_t"], tq["embed"]["table"]["q"].t())
    # quantize_params on the port's f32 tree: the reference's stats.
    f32 = params_from_numpy(tree, tcfg, device="cpu", dtype=torch.float32)
    f32["embed"].pop("table_t")
    _, stats = quant.quantize_params(f32, tcfg.n_groups)
    assert stats == jstats
    eng = ServeEngine(tcfg, tq, ServeConfig(batch_slots=1, max_len=16,
                                            quantize=True))
    jeng = JServeEngine(jcfg, jparams, JServeConfig(batch_slots=1,
                                                    max_len=16,
                                                    quantize=True))
    try:
        assert eng.quant_stats == jeng.quant_stats == jstats
    finally:
        eng.close()
        jeng.close()


def test_init_params_quantizes_as_drawn():
    """``init_params(quantize=True)`` gives the codes of quantizing the
    f32 draws, and the served (bf16) values are those of casting every
    leaf after drawing it."""
    cfg = dataclasses.replace(TC.get_smoke(ARCH), compute_dtype="bfloat16")
    f32 = tmodel.init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    served = tmodel.init_params(cfg, seed=4, device="cpu")
    q = tmodel.init_params(cfg, seed=4, device="cpu", quantize=True)
    f32["embed"].pop("table_t")
    want, _ = quant.quantize_params(f32, cfg.n_groups)
    q["embed"].pop("table_t")
    served["embed"].pop("table_t")

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree

    n_int8 = 0
    for got, ref in zip(leaves(q), leaves(want), strict=True):
        assert torch.equal(got, ref.to(got.dtype))   # kept: cast to bf16
        n_int8 += got.dtype == torch.int8
    assert n_int8 > 2
    for s, f in zip(leaves(served), leaves(f32), strict=True):
        assert torch.equal(s, f if s.dtype == f.dtype else f.bfloat16())


def test_maybe_dequant_passes_other_leaves():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert quant.maybe_dequant(x, torch.float32) is x
    assert quant.maybe_dequant(x, torch.bfloat16).dtype == torch.bfloat16
    qw = quant.quantize_weight(x)
    assert torch.equal(quant.maybe_dequant(qw, torch.float32),
                       quant.dequantize_weight(qw, torch.float32))
    assert not quant.is_quantized(x) and quant.is_quantized(qw)
    small = {"w": torch.ones((4, 4)), "scale": torch.ones(4)}
    out, stats = quant.quantize_params({"blocks": [small]}, 2)
    assert out["blocks"][0]["w"] is small["w"] and stats["quantized"] == 0


@pytest.mark.parametrize("q_shape,s_shape", [
    ((3, 40, 32), (3, 32)),      # a stack of (K, N) weights
    ((64, 48), (48,)),           # one weight
    ((2, 5, 48), (48,)),         # gathered embedding rows, one scale row
    ((16, 40, 1), (16, 1)),      # the tied head's transpose, a scale a row
    ((3, 7, 10), (3, 10))])      # N not a multiple of 16
def test_dequantize_layouts_bit_equal_to_reference(q_shape, s_shape):
    """``ops.dequantize`` (the ``dequant`` kernel's plain version on the
    CPU) in every layout the weight fetch gives it: the reference's
    ``q.astype(f32) * scale`` rounded to f32 and to bf16, bit for bit."""
    rng = np.random.default_rng(len(q_shape) + q_shape[-1])
    q = rng.integers(-127, 128, size=q_shape).astype(np.int8)
    scale = (rng.random(s_shape) * 0.02).astype(np.float32)
    mid = (1,) * (len(q_shape) - len(s_shape))
    s_b = scale.reshape(*s_shape[:-1], *mid, s_shape[-1])
    for dt, jdt in ((torch.float32, np.float32), (torch.bfloat16, "bfloat16")):
        want = np.asarray(jax.numpy.asarray(q, np.float32) * s_b).astype(jdt)
        got = tops.dequantize(torch.from_numpy(q), torch.from_numpy(scale),
                              dt)
        assert got.dtype == dt and got.shape == q_shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))


def test_dequantize_validates_and_kernel_mode_needs_cuda():
    q = torch.zeros((4, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tops.dequantize(q, torch.ones(32), torch.bfloat16, mode="kernel")
    with pytest.raises(ValueError, match="int8 codes"):
        tdequant.dequantize(q.float(), torch.ones(32), torch.bfloat16)
    with pytest.raises(ValueError, match="leading dims"):
        tdequant.dequantize(q, torch.ones(16), torch.bfloat16)
    with pytest.raises(ValueError, match="leading dims"):
        tdequant.dequantize(q[None], torch.ones((2, 32)), torch.bfloat16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        tdequant.dequantize(q, torch.ones(32), torch.float16)
    assert tdequant.groups_of(torch.zeros((3, 5, 4, 32), dtype=torch.int8),
                              torch.ones((3, 32))) == (3, 20, 32)
    assert [tdequant.vec_width(k, n) for k, n in
            ((5, 32), (32, 1), (5, 1), (16, 40))] == [16, 16, 1, 1]


def test_engine_rejects_quantizing_bf16_copies():
    _, tcfg, _, tree = _setup()
    bf16 = params_from_numpy(tree, tcfg, device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32 weights"):
        ServeEngine(tcfg, bf16, ServeConfig(batch_slots=1, max_len=16,
                                            quantize=True))


def test_ragged_three_slot_quantized_tokens_equal_jax_engine():
    """A ragged 3-slot batch (prompt lengths 5/17/1) with quantize=True:
    the port's greedy tokens equal the JAX engine's, the port quantizing
    the bridged f32 parameters itself."""
    jcfg, tcfg, jparams, tree = _setup()
    tp = params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = {n: rng.integers(0, jcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in RAGGED}
    out = {}
    for name, engine, cfg, params, scfg in (
            ("jax", JServeEngine, jcfg, jparams, JServeConfig),
            ("port", ServeEngine, tcfg, tp, ServeConfig)):
        eng = engine(cfg, params, scfg(batch_slots=3, max_len=64,
                                       quantize=True))
        try:
            rids = {n: eng.submit(prompts[n], 8) for n in RAGGED}
            res = eng.drain()
        finally:
            eng.close()
        out[name] = {n: res[rids[n]] for n in RAGGED}
    for n in RAGGED:
        np.testing.assert_array_equal(out["port"][n], out["jax"][n],
                                      err_msg=f"prompt_len={n}")
