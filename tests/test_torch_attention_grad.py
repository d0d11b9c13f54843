"""Training's attention gradient in the port against the JAX package's.

The reference trains attention by autodiff of its jnp oracle
(``repro.kernels.ref.ref_attention``); the port differentiates it through
``kernels.flash_attention.FlashAttention``: the forward kernel with each
row's log-sum-exp, and the hand-written backward ``flash_attention_bwd``.
On the CPU both halves run their plain versions (``ref.ref_attention(...,
return_lse=True)``, ``ref.attention_bwd``), which are held here against
``jax.vjp`` of the oracle on the same numpy inputs, in f32.  Tolerances
cover summation order only.  The ``cuda``-marked test holds the kernel
against its plain version on the card and skips without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_grad.py
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
except ImportError:
    # The GPU host has no JAX; it runs only the cuda-marked test.
    jax = jnp = jref = None
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.rmsnorm import RMSNorm

# (GQA group, head dim): groups 1, 3 and 4 at the SMOKE configs' 16 and
# SmolLM-360M's 64; S = 37 is no multiple of any tile.
CASES = [(1, 16), (3, 16), (4, 16), (1, 64), (3, 64), (4, 64)]
S = 37


def _inputs(seed, group, d, hkv=2, b=2, s=S):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv * group, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    do = rng.normal(size=(b, hkv * group, s, d)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do):
    """(out, (dq, dk, dv), lse) of the reference's oracle, causal."""
    out, vjp = jax.vjp(lambda q_, k_, v_: jref.ref_attention(
        q_, k_, v_, causal=True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    group = q.shape[1] // k.shape[1]
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q),
                        jnp.repeat(jnp.asarray(k), group, axis=1))
    logits = logits * q.shape[-1] ** -0.5
    mask = np.tril(np.ones((q.shape[2], q.shape[2]), bool))
    lse = jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1)
    return (np.asarray(out), [np.asarray(g) for g in grads],
            np.asarray(lse))


def _close_to_max(got, want, tol, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("group,d", CASES)
def test_plain_backward_and_function_match_jax_vjp(group, d):
    """``ref.attention_bwd`` from the plain forward's o and lse, and
    ``ops.attention``'s autograd through ``FlashAttention``, against
    ``jax.vjp`` of ``ref_attention``: every gradient within 1e-5 of its
    largest element, lse within 1e-5 of JAX's logsumexp over the causal
    logits."""
    q, k, v, do = _inputs(group * 100 + d, group, d)
    jout, jgrads, jlse = _jax_vjp(q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tref.ref_attention(tq, tk, tv, causal=True, return_lse=True)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=1e-5)
    plain = tref.attention_bwd(tq, tk, tv, out, lse, tdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fn_out = tops.attention(*leaves, causal=True)
    assert type(fn_out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(fn_out.detach(), out)
    fn_out.backward(tdo)
    for name, p, f, want in zip(("dq", "dk", "dv"), plain,
                                (x.grad for x in leaves), jgrads):
        assert p.shape == want.shape, name
        _close_to_max(p.numpy(), want, 1e-5, name)
        assert torch.equal(f, p), name   # the Function runs the same halves


def test_wrappers_run_the_plain_halves_on_the_cpu():
    """On CPU tensors ``flash_attention(return_lse=True)`` and
    ``flash_attention_bwd`` are the plain versions, bit for bit."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 3, 16))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    want_out, want_lse = tref.ref_attention(q, k, v, causal=True,
                                            return_lse=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    got = flash_attention_bwd(q, k, v, out, lse, do)
    want = tref.attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_lse_of_a_row_with_no_valid_key_is_inf():
    """kv_len = 0 masks every key: the row's output is zeros (the kernels'
    guard) and its lse +inf, so exp(s - lse) gives it no weight."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(6, 1, 16, s=5))
    out, lse = tref.ref_attention(q, k, v, causal=True, kv_len=0,
                                  return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.isinf(lse).all() and (lse > 0).all()


@pytest.mark.parametrize("kw", [dict(causal=False), dict(q_offset=3),
                                dict(kv_len=30)])
def test_training_attention_takes_only_causal_self_attention(kw):
    """The backward takes training's form only (causal at q_offset 0 over
    every key): any other raises, in the forward of the Function (so a
    step fails before its backward) and in the backward's wrapper; the
    plain route (mode="ref") still differentiates any form."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, 3, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with pytest.raises(NotImplementedError, match="q_offset 0"):
        tops.attention(*leaves, **kw)
    with pytest.raises(NotImplementedError, match="q_offset 0"):
        flash_attention_bwd(q, k, v, q, q[..., 0], do, **kw)
    tops.attention(*leaves, mode="ref", **kw).sum().backward()
    assert all(x.grad is not None for x in leaves)


def test_inference_attention_keeps_the_forward_route():
    """Without grad (serving) ``ops.attention`` takes today's route: the
    plain forward on the CPU, no Function, every form."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(8, 3, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        out = tops.attention(*leaves, causal=False)
    assert out.grad_fn is None
    assert torch.equal(out, tref.ref_attention(q, k, v, causal=False))


def test_rmsnorm_function_differentiates_the_plain_expression():
    """``RMSNorm`` (the kernel forward and the plain expression's gradient)
    on CPU tensors: the plain forward's values and torch autograd's
    gradients of ``ref.rmsnorm``, bit for bit."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, 5, 48)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(size=(48,)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(3, 5, 48)).astype(np.float32))
    a = [t.clone().requires_grad_() for t in (x, scale)]
    b = [t.clone().requires_grad_() for t in (x, scale)]
    ya = RMSNorm.apply(*a, 1e-6)
    yb = tref.rmsnorm(*b, 1e-6)
    assert torch.equal(ya, yb)
    ya.backward(gy)
    yb.backward(gy)
    assert torch.equal(a[0].grad, b[0].grad)
    assert torch.equal(a[1].grad, b[1].grad)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU build")


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_matches_plain():
    """The backward kernel against ``ref.attention_bwd`` on the forward
    kernel's o and lse: SmolLM-360M's 15/5 heads of 64 and Qwen3-8B's
    32/8 of 128 in bf16 (ragged S = 100), within 5e-2 of each gradient's
    largest element (P and dS rounded to bf16 for the tensor cores, the
    outputs once); the SMOKE configs' 6/2 heads of 16 and D = 64 in f32
    within 1e-4.  Two calls give the same bits (no atomics), and the
    forward's o with lse equals serving's."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    for b, hq, hkv, s, d, dtype, tol in [
            (2, 15, 5, 100, 64, torch.bfloat16, 5e-2),
            (1, 32, 8, 100, 128, torch.bfloat16, 5e-2),
            (2, 6, 2, 37, 16, torch.float32, 1e-4),
            (2, 15, 5, 77, 64, torch.float32, 1e-4)]:
        q, do = (torch.randn((b, hq, s, d), generator=g, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        assert torch.equal(o, flash_attention(q, k, v, causal=True))
        got = flash_attention_bwd(q, k, v, o, lse, do)
        again = flash_attention_bwd(q, k, v, o, lse, do)
        want = tref.attention_bwd(*(t.float() for t in (q, k, v, o)), lse,
                                  do.float())
        torch.cuda.synchronize()
        for x, y, w in zip(got, again, want):
            assert torch.equal(x, y)
            err = (x.float() - w).abs().max().item()
            assert err <= tol * w.abs().max().item(), (b, hq, s, d, err)
