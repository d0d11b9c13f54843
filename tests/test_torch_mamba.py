"""The port's Mamba block (repro_torch.models.mamba) against the JAX
package's: the causal conv with a carried window, the plain selective scan
(the ``selective_scan`` kernel's CPU version) against the reference's
chunked associative scan, and the block with and without a cache.

f32 throughout: the scan at the JAX kernel suite's rtol = atol = 2e-5 (the
associative scan multiplies the decays in another order than the step
loop), the block at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro_torch import obs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as tscan
from repro_torch.models import mamba as tmamba

SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
D = 32
CFG = dict(d_state=8, d_conv=4, expand=2, chunk=16)

# Jitted: one XLA program per call shape is cheaper here than the eager
# reference's op-by-op compiles.
_jax_forward = jax.jit(jmamba.mamba_forward, static_argnums=2)
_jax_scan = jax.jit(jmamba._ssm_scan_chunked, static_argnums=3)


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


def test_causal_conv_carries_its_window():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    state = rng.normal(size=(2, 3, 24)).astype(np.float32)
    for st in (None, state):
        want_y, want_s = jmamba._causal_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if st is None else jnp.asarray(st))
        got_y, got_s = tmamba._causal_conv(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # One call over 5 tokens == 5 calls of one, the window carried.
    y1, s1 = tmamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), torch.from_numpy(state))
    s, ys = torch.from_numpy(state), []
    for i in range(5):
        y, s = tmamba._causal_conv(torch.from_numpy(x[:, i:i + 1]),
                                   torch.from_numpy(w), torch.from_numpy(b), s)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y1.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(s, s1)


def _scan_inputs(b, t, di, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, di)))).astype(np.float32)
    x = rng.normal(size=(b, t, di)).astype(np.float32)
    bm = rng.normal(size=(b, t, n)).astype(np.float32)
    c = rng.normal(size=(b, t, n)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32)[None], (di, 1)) \
        * rng.uniform(0.2, 1.0, size=(di, 1)).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32)
    return dt, x, bm, c, a, h0


@pytest.mark.parametrize("t", [1, 37])
def test_plain_scan_matches_reference_chunked_scan(t):
    """37 steps in chunks of 16 (not a multiple), from a nonzero h0."""
    dt, x, bm, c, a, h0 = _scan_inputs(2, t, 24, 8, seed=t)
    dtf = jnp.asarray(dt)
    da = jnp.exp(dtf[..., None] * jnp.asarray(a))
    dbx = (dtf * jnp.asarray(x))[..., None] * jnp.asarray(bm)[:, :, None, :]
    h_all, h_final = _jax_scan(da, dbx, jnp.asarray(h0), 16)
    want_y = jnp.einsum("bsdn,bsn->bsd", h_all, jnp.asarray(c))
    y, h = ref.selective_scan(*(torch.from_numpy(v)
                                for v in (dt, x, bm, c, a, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_final), **SCAN_TOL)


def test_scan_routes_and_refuses_the_kernel_on_cpu():
    args = [torch.from_numpy(v) for v in _scan_inputs(1, 3, 8, 4, seed=1)]
    obs.configure(registry=obs.Registry())
    y, h = ops.selective_scan(*args)
    reg = obs.get_obs().registry
    assert reg.counter("ops.selective_scan.ref").value == 1
    assert reg.counter("ops.selective_scan.kernel").value == 0
    got = tscan.selective_scan(*args)           # CPU: the plain version
    assert torch.equal(got[0], y) and torch.equal(got[1], h)
    assert tscan.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan(*args, mode="kernel")
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan(*args[:5], args[5][:, :4])
    # Two calls carrying the state equal one call over both segments.
    first = tscan.selective_scan(*(v[:, :2] for v in args[:4]), *args[4:])
    second = tscan.selective_scan(*(v[:, 2:] for v in args[:4]), args[4],
                                  first[1])
    np.testing.assert_allclose(torch.cat([first[0], second[0]], 1).numpy(),
                               y.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(second[1].numpy(), h.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_mamba_block_matches_reference_with_and_without_cache():
    """Without a cache (37 tokens: the reference's chunked scan), and with
    one: an 11-token prefill from the zero cache, then two decode steps;
    outputs and caches match."""
    jcfg, tcfg = jmamba.MambaConfig(**CFG), tmamba.MambaConfig(**CFG)
    p = jax.tree.map(np.asarray,
                     jmamba.init_mamba(jax.random.PRNGKey(2), D, jcfg))
    tp = _to_torch(p)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 37, D)).astype(np.float32)
    want, _ = _jax_forward(p, jnp.asarray(x), jcfg)
    got, none = tmamba.mamba_forward(tp, torch.from_numpy(x), tcfg)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    jc = jmamba.init_mamba_cache(2, D, jcfg, jnp.float32)
    tc = tmamba.init_mamba_cache(2, D, tcfg, torch.float32)
    assert tc["conv"].shape == jc["conv"].shape
    assert tc["ssm"].dtype == torch.float32
    for seg in (x[:, :11], x[:, 11:12], x[:, 12:13]):
        want, jc = _jax_forward(p, jnp.asarray(seg), jcfg, jc)
        got, tc = tmamba.mamba_forward(tp, torch.from_numpy(seg), tcfg, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **SCAN_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **SCAN_TOL)


def test_init_mamba_has_the_reference_tree():
    jcfg, tcfg = jmamba.MambaConfig(**CFG), tmamba.MambaConfig(**CFG)
    want = jax.tree.map(lambda v: (tuple(v.shape), str(v.dtype)),
                        jmamba.init_mamba(jax.random.PRNGKey(0), D, jcfg))
    got = tmamba.init_mamba(torch.Generator().manual_seed(0), D, tcfg)
    assert jax.tree.map(lambda v: (tuple(v.shape), str(v.dtype)[6:]),
                        got) == want
    np.testing.assert_allclose(
        got["a_log"].numpy(), np.asarray(
            jmamba.init_mamba(jax.random.PRNGKey(0), D, jcfg)["a_log"]),
        rtol=1e-7, atol=0)
    dt = tmamba.softplus(got["dt_proj"]["b"])
    assert float(dt.min()) >= 0.001 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6
    assert tmamba.softplus(torch.tensor([30.0, -30.0])).tolist() == \
        pytest.approx(np.asarray(jax.nn.softplus(jnp.asarray([30.0, -30.0]))))
