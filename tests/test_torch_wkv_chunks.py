"""The wkv6 kernels' chunked algorithm (``csrc/wkv.cu``), in its plain
torch form, against the plain recurrence and the JAX package.

``ref_wkv_chunked`` and ``ref_wkv_bwd_chunked`` follow the kernels'
phases: each chunk's state from zero and its decay product, a scan over
the chunks, and every chunk replayed from the state it starts from (and,
for the gradient, walked back from the gradient it ends with).  Here, in
f32 on the CPU, they are held against ``ref_wkv``/``ref_wkv_bwd``, JAX's
Pallas kernel in interpret mode and ``jax.vjp`` of JAX's oracle, at
rtol = atol = 2e-5 (tests/test_torch_train.py's wkv6 bound: the sums run
in another order).  Decays include exactly 0 (a chunk's decay product
underflows to 0, and nothing may divide by it), exactly 1, and values
down to ~6e-4, as ``exp(-exp(x))`` of the model gives them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv as twkv

TS = (1, 37, 64, 100)
CHUNKS = (8, 16, 64)
NS = (16, 64)
TOL = dict(rtol=2e-5, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _full(n):
    """Inputs (B=2, H=3, T=max(TS)) at the training path's scale, JAX's
    forward (the Pallas kernel, interpret mode) and a jitted VJP of its
    oracle.  Every T of TS takes the first T steps: the recurrence is
    causal, so its y is a prefix of this y, and its gradients are this
    VJP's for gy zeroed past T, cut to T steps."""
    t = max(TS)
    rng = np.random.default_rng(n)
    b, h = 2, 3
    r, k, v, gy = ((rng.normal(size=(b, h, t, n)) * 0.5).astype(np.float32)
                   for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(-8, 2, size=(b, h, t, n))))
    w[:, :, ::5, : n // 2] = 0.0
    w[:, :, 2::7, n // 2:] = 1.0
    w = w.astype(np.float32)
    u = (rng.normal(size=(h, n)) * 0.1).astype(np.float32)
    arrs = (r, k, v, w, u)
    y = jops.wkv(*map(jnp.asarray, arrs), chunk=32, mode="kernel")
    vjp = jax.jit(lambda xs, g: jax.vjp(jref.ref_wkv, *xs)[1](g))
    return arrs, gy, np.asarray(y), vjp


@functools.lru_cache(maxsize=None)
def _case(t, n):
    arrs, gy, y, vjp = _full(n)
    cut = tuple(a[:, :, :t] for a in arrs[:4]) + (arrs[4],)
    gy_t = np.where(np.arange(gy.shape[2])[:, None] < t, gy, 0)
    grads = vjp(tuple(map(jnp.asarray, arrs)), jnp.asarray(gy_t))
    grads = [np.asarray(g)[:, :, :t] for g in grads[:4]] + [
        np.asarray(grads[4])]
    return cut, gy[:, :, :t], y[:, :, :t], grads


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("t", TS)
def test_chunked_forward_matches_plain_and_jax_kernel(t, n, chunk):
    arrs, _, want_jax, _ = _case(t, n)
    xs = [torch.from_numpy(a) for a in arrs]
    got = tref.ref_wkv_chunked(*xs, chunk)
    np.testing.assert_allclose(got.numpy(), tref.ref_wkv(*xs).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), want_jax, **TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("t", TS)
def test_chunked_backward_matches_plain_and_jax_vjp(t, n, chunk):
    arrs, gy, _, want_jax = _case(t, n)
    xs = [torch.from_numpy(a) for a in arrs] + [torch.from_numpy(gy)]
    got = tref.ref_wkv_bwd_chunked(*xs, chunk)
    want = tref.ref_wkv_bwd(*xs)
    for name, g, w_, wj in zip("rkvwu", got, want, want_jax):
        assert g.shape == w_.shape and g.dtype == w_.dtype, name
        np.testing.assert_allclose(g.numpy(), w_.numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), wj, err_msg=name, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", NS)
def test_wkv_chunk_is_one_length_the_entry_points_take(n, dtype):
    """One chunk length per (T, N, dtype), the same on every call; a
    multiple of the staged tile and no longer than the backward keeps
    tile states for (the C entry points refuse anything else); and the
    scratch holds one state per chunk boundary, none when T fits one
    chunk."""
    for t in (1, 37, 64, 65, 100, 4096):
        chunk = twkv.wkv_chunk(t, n, dtype)
        assert chunk == twkv.wkv_chunk(t, n, dtype)
        assert chunk % twkv.TILE_STEPS == 0
        assert 0 < chunk <= twkv.MAX_CHUNK
        c = twkv.n_chunks(t, chunk)
        assert (c - 1) * chunk < t <= c * chunk
        fwd = twkv.scratch_floats(2, 3, t, n, chunk, False)
        assert fwd == 6 * (c - 1) * (n * n + n)
        assert twkv.scratch_floats(2, 3, t, n, chunk, True) == \
            2 * fwd + 6 * c * n
        if t <= chunk:
            assert fwd == 0
    with pytest.raises(ValueError):
        twkv.wkv_chunk(64, 32, dtype)
    with pytest.raises(ValueError):
        twkv.wkv_chunk(0, n, dtype)
