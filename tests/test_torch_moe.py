"""The port's MoE FFN (repro_torch.models.moe) against the JAX package's.

Routing is compared first (top-k indices and keep masks equal), then the
outputs and the aux loss at rtol = atol = 1e-5: f32 throughout, the two
frameworks sum the router and expert products in different orders.  The
parameters are the reference's, carried across as numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-5, atol=1e-5)
D = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@functools.partial(jax.jit, static_argnums=2)
def _jax_routing(p, x, cfg):
    """The reference's routing (``repro/models/moe.py:83-103``): top-k
    indices and keep masks, (G, Tg, k)."""
    b, s, d = x.shape
    t = b * s
    groups = (cfg.dispatch_groups
              if t % max(cfg.dispatch_groups, 1) == 0 else 1)
    tg = t // groups
    xg = jnp.asarray(x).reshape(groups, tg, d)
    probs = jax.nn.softmax(xg @ p["router"]["w"], axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    flat = jax.nn.one_hot(idx, cfg.num_experts, dtype=jnp.int32).reshape(
        groups, tg * cfg.top_k, cfg.num_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - 1) * flat, axis=-1).reshape(
        groups, tg, cfg.top_k)
    return idx, pos < jmoe.capacity(tg, cfg)


# Jitted: one XLA program per case is cheaper here than the eager
# reference's op-by-op compiles.
_jax_init_moe = jax.jit(jmoe.init_moe, static_argnums=(1, 2))
_jax_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=2)


# (top_k, n_shared, combine, dispatch_groups, min_capacity)
# min_capacity 64 never drops at these sizes; 1 does.
CASES = [(1, 0, "scatter", 1, 64), (1, 1, "gather", 1, 64),
         (2, 0, "gather", 1, 64), (2, 1, "scatter", 4, 64),
         (4, 0, "scatter", 1, 64), (4, 1, "gather", 4, 64),
         (2, 0, "scatter", 1, 1), (2, 1, "gather", 4, 1)]


@pytest.mark.parametrize("top_k,n_shared,combine,groups,min_cap", CASES)
def test_moe_ffn_matches_reference(top_k, n_shared, combine, groups,
                                   min_cap):
    kw = dict(num_experts=8, top_k=top_k, d_ff=48, n_shared=n_shared,
              shared_d_ff=40 if n_shared else 0, combine=combine,
              dispatch_groups=groups, min_capacity=min_cap)
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    p = jax.tree.map(np.asarray,
                     _jax_init_moe(jax.random.PRNGKey(top_k), D, jcfg))
    rng = np.random.default_rng(top_k + 10 * groups)
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    tp = _to_torch(p)
    want_idx, want_keep = map(np.asarray, _jax_routing(p, x, jcfg))
    xt = torch.from_numpy(x)
    t = x.shape[0] * x.shape[1]
    r = tmoe.route(tp, xt.reshape(groups, t // groups, D), tcfg)
    np.testing.assert_array_equal(r.idx.numpy(), want_idx)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    if min_cap == 1:
        assert not want_keep.all(), "the case must drop assignments"
    else:
        assert want_keep.all()
    want, want_aux = _jax_moe_ffn(p, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tp, xt, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    out, none = tmoe.moe_ffn(tp, xt, tcfg, with_aux=False)
    assert none is None and torch.equal(out, got)


def test_combine_forms_agree_and_top_k_breaks_ties_low():
    """Both combine forms give one output (the reference's
    ``test_moe_scatter_combine_equals_gather``), and equal router
    probabilities pick the lower expert first, as ``jax.lax.top_k``."""
    kw = dict(num_experts=4, top_k=2, d_ff=16, min_capacity=1)
    p = _to_torch(jax.tree.map(np.asarray, _jax_init_moe(
        jax.random.PRNGKey(3), D, jmoe.MoEConfig(**kw))))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 9, D)).astype(np.float32))
    outs = [tmoe.moe_ffn(p, x, tmoe.MoEConfig(combine=c, **kw))[0]
            for c in ("scatter", "gather")]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    probs = torch.tensor([[0.25, 0.25, 0.3, 0.2], [0.1, 0.3, 0.3, 0.3]])
    vals, idx = tmoe.top_k(probs, 2)
    assert idx.tolist() == [[2, 0], [1, 2]]
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
