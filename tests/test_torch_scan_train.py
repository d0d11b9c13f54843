"""Training Jamba: the selective scan's backward, its autograd Function and
the Jamba SMOKE training step, against torch autograd and the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU ``SelectiveScan`` runs the plain forward and ``ref.selective_scan_bwd``;
the reference differentiates its chunked associative scan
(``repro/models/mamba.py:_ssm_scan_chunked``) and the contraction with C by
``jax.vjp``.  The ``cuda``-marked tests hold the backward kernel to the
plain backward on the card (Jamba-v0.1's width, a length that is not a
multiple of 8, a ragged width), two calls to the same bits and a sequence
alone to its rows of the batch; they skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_scan_train.py
"""

import functools
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch import configs as TC
from repro_torch import obs
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as tscan
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw

ARCH = "jamba_v01_52b"
NAMES = ("gdt", "gx", "gbm", "gc", "ga", "gh0")

_jax_scan = jax.jit(jmamba._ssm_scan_chunked, static_argnums=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's default pool of one thread per
    core only oversubscribes the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmpdir_path():
    path = tempfile.mkdtemp()
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _inputs(b, t, di, n, seed):
    """dt, x, bm, c, a, h0, gy, ght: Mamba-like, in f32 numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, di)) - 2.0))
    x, gy = (rng.normal(size=(b, t, di)) for _ in range(2))
    bm, c = (rng.normal(size=(b, t, n)) for _ in range(2))
    a = -np.tile(np.arange(1, n + 1)[None], (di, 1)) \
        * rng.uniform(0.2, 1.0, size=(di, 1))
    h0, ght = (rng.normal(size=(b, di, n)) for _ in range(2))
    return [v.astype(np.float32) for v in (dt, x, bm, c, a, h0, gy, ght)]


def _torch(*arrays):
    return [torch.from_numpy(v) for v in arrays]


def _autograd_vjp(dt, x, bm, c, a, h0, gy, ght):
    """Torch autograd of the plain loop, ``ref.selective_scan``."""
    leaves = [v.clone().requires_grad_(True) for v in (dt, x, bm, c, a, h0)]
    y, h = ref.selective_scan(*leaves)
    out = (y * gy).sum() + (0 if ght is None else (h * ght).sum())
    return torch.autograd.grad(out, leaves)


@pytest.mark.parametrize("b,t,di,n,with_ght", [
    (2, 13, 24, 8, True), (1, 16, 16, 16, False), (3, 1, 8, 4, True),
])
def test_plain_bwd_matches_torch_autograd(b, t, di, n, with_ght):
    """The plain backward is the same f32 operations as autograd of the
    plain forward, up to the order in which autograd adds a's terms over
    (b, t): rtol = atol = 1e-6."""
    args = _torch(*_inputs(b, t, di, n, seed=t))
    ght = args[7] if with_ght else None
    got = ref.selective_scan_bwd(*args[:7], ght)
    want = _autograd_vjp(*args[:7], ght)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("t", [1, 37])
def test_plain_bwd_matches_jax_vjp_of_reference_scan(t):
    """The geometries of tests/test_torch_mamba.py (B=2, di=24, N=8, 37
    steps in chunks of 16) against ``jax.vjp`` of the reference's chunked
    scan plus its contraction (mamba.py:158), with gy and the final
    state's gradient.  rtol = atol = 1e-4: the associative scan multiplies
    the decays in another order than the step loop, and the adjoint walks
    through every step."""
    dt, x, bm, c, a, h0, gy, ght = _inputs(2, t, 24, 8, seed=30 + t)

    def fwd(dt, x, bm, c, a, h0):
        da = jnp.exp(dt[..., None] * a)
        dbx = (dt * x)[..., None] * bm[:, :, None, :]
        h_all, h_final = _jax_scan(da, dbx, h0, 16)
        return jnp.einsum("bsdn,bsn->bsd", h_all, c), h_final

    _, vjp = jax.vjp(fwd, *(jnp.asarray(v) for v in (dt, x, bm, c, a, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(ght)))
    got = ref.selective_scan_bwd(*_torch(dt, x, bm, c, a, h0, gy, ght))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("carry", [False, True])
def test_selective_scan_function_on_cpu(carry):
    """``SelectiveScan`` on CPU tensors: the plain forward's bits and
    autograd of the plain loop's gradients (rtol = atol = 1e-6, as above).
    Without ``carry`` the loss reads y alone and h0 takes no gradient (the
    training path: no hT gradient, gh0 None); with it the loss reads hT
    too and h0 requires grad.  ``ops.selective_scan`` takes the Function
    when an input requires grad, ticking the ``.ref`` route on the CPU;
    ``mode="ref"`` differentiates the plain loop by autograd."""
    dt, x, bm, c, a, h0, gy, ght = _torch(*_inputs(2, 11, 16, 8, seed=5))
    leaves = [v.clone().requires_grad_(True) for v in (dt, x, bm, c, a)]
    h0l = h0.clone().requires_grad_(carry)
    obs.configure(registry=obs.Registry())
    y, h = ops.selective_scan(*leaves, h0l)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    reg = obs.get_obs().registry
    assert reg.counter("ops.selective_scan.ref").value == 1
    assert reg.counter("ops.selective_scan.kernel").value == 0
    want_y, want_h = ref.selective_scan(dt, x, bm, c, a, h0)
    assert torch.equal(y.detach(), want_y) and torch.equal(h.detach(), want_h)
    out = (y * gy).sum() + ((h * ght).sum() if carry else 0)
    grads = torch.autograd.grad(out, leaves + ([h0l] if carry else []))
    want = _autograd_vjp(dt, x, bm, c, a, h0, gy, ght if carry else None)
    for name, g, w in zip(NAMES, grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    y_ref, _ = ops.selective_scan(*leaves, h0l, mode="ref")
    assert type(y_ref.grad_fn).__name__ != "SelectiveScanBackward"
    assert torch.equal(y_ref.detach(), y.detach())
    with torch.no_grad():                  # serving: the raw wrapper
        y_ng, _ = ops.selective_scan(*leaves, h0l)
    assert y_ng.grad_fn is None and torch.equal(y_ng, want_y)


def test_bwd_wrapper_on_cpu_is_the_plain_backward():
    """The wrapper on CPU tensors runs ``ref.selective_scan_bwd`` (the
    states, a card's input, are not needed) and drops gh0 on request;
    shapes are checked."""
    args = _torch(*_inputs(2, 9, 16, 8, seed=6))
    got = tscan.selective_scan_bwd(*args[:7], ght=args[7], need_gh0=False)
    want = ref.selective_scan_bwd(*args[:7], args[7])
    assert got[5] is None and tscan.bwd_launches == 0
    assert all(torch.equal(g, w) for g, w in zip(got[:5], want[:5]))
    with pytest.raises(ValueError, match="gy"):
        tscan.selective_scan_bwd(*args[:6], args[6][:, :4])
    assert tscan.saved_states(9) == 3 and tscan.saved_states(8) == 2
    # di = 24: 2 channel blocks in one cluster, one partial of gbm and gc.
    assert tscan.scratch_floats(2, 9, 24, 8) == 2 * 2 * 9 * 1 * 8 + 2 * 24 * 8


# ---------------------------------------------------------------------------
# Jamba SMOKE: one training step against the JAX package's
# ---------------------------------------------------------------------------


def _leaf(rng, path, shape):
    """A parameter from numpy at the reference's scales: S4D-real a_log,
    unit norms and D skip, dt's bias the inverse softplus of U(0.001,
    0.1), the conv at 0.2, matrices N(0, 1 / fan_in)."""
    name = jax.tree_util.keystr(path)
    if "a_log" in name:
        return np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)), shape)
    if "scale" in name or name.endswith("['d']"):
        return np.ones(shape)
    if "conv_b" in name:
        return np.zeros(shape)
    if "['dt_proj']['b']" in name:
        return np.log(np.expm1(rng.uniform(0.001, 0.1, size=shape)))
    if "conv_w" in name:
        return rng.normal(size=shape) * 0.2
    if "table" in name:
        return rng.normal(size=shape)
    return rng.normal(size=shape) / np.sqrt(shape[-2])


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """(jax cfg, port cfg, jax params, numpy tree); never written to.  The
    parameters come from numpy in the reference's tree (its shapes by
    ``jax.eval_shape``, without running its initialiser)."""
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(rng, path, s.shape).astype(s.dtype), shapes)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree


def _batch(seed, vocab, b=2, s=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    jcfg, _, jparams, _ = _jax_setup()
    batch = {k: jnp.asarray(v) for k, v in _batch(11, jcfg.vocab_size).items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, jcfg, remat=False), has_aux=True))
    (loss, _), grads = fn(jparams)
    return float(loss), jax.tree.map(np.asarray, grads)


def _pairs(jtree, tparams):
    """(path, jax leaf, port leaf) for every leaf; the reference's stacked
    blocks (n_groups, ...) are split into the port's per-layer list."""
    jcfg = _jax_setup()[0]
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "blocks":
            for g in range(leaf.shape[0]):
                node = tparams["blocks"][g * len(jcfg.pattern) + keys[1]]
                for k in keys[2:]:
                    node = node[k]
                out.append((f"blocks/{g * len(jcfg.pattern) + keys[1]}/"
                            f"{keys[2:]}", np.asarray(leaf[g]), node))
        else:
            node = tparams
            for k in keys:
                node = node[k]
            out.append(("/".join(map(str, keys)), np.asarray(leaf), node))
    return out


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "tp_outs"), (True, "dots")])
def test_jamba_smoke_loss_and_every_gradient_match_jax(remat, policy):
    """Jamba SMOKE (seven Mamba layers, one attention layer, four MoE
    FFNs), f32: the loss at rtol = 1e-5 and every gradient leaf within
    1e-4 of its largest element, the tolerances of the RWKV training test
    (f32 sums in another order through eight layers, the scan's adjoint
    and the lm head).  Every remat policy recomputes the same arithmetic,
    so every policy gives the same loss bit for bit.  The Mamba mixers'
    scans go through ``SelectiveScan`` (its plain halves on the CPU); the
    conv, the softplus and the D skip are torch autograd's."""
    jloss, jgrads = _jax_loss_and_grads()
    _, tcfg, _, tree = _jax_setup()
    tp = tmodel.train_tree(params_from_numpy(tree, tcfg, device="cpu",
                                             dtype=torch.float32))
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(11, tcfg.vocab_size).items()}
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    obs.configure(registry=obs.Registry())
    loss, _ = tmodel.loss_fn(tp, batch, tcfg, remat=remat,
                             remat_policy=policy)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    loss.backward()
    assert obs.get_obs().registry.counter(
        "ops.selective_scan.ref").value >= 7
    pairs = _pairs(jgrads, tp)
    assert len(pairs) == len(leaves)
    for name, want, p in pairs:
        assert p.grad is not None, name
        scale = max(1e-6, float(np.abs(want).max()))
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= 1e-4 * scale, (name, err, scale)
    plain, _ = tmodel.loss_fn(
        tmodel.train_tree(params_from_numpy(tree, tcfg, device="cpu",
                                            dtype=torch.float32)),
        batch, tcfg, remat=False)
    assert loss.item() == plain.item()


def test_launcher_trains_jamba_smoke_on_cpu(tmpdir_path, capsys):
    res = tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "3",
                        "--ckpt_every", "2", "--device", "cpu",
                        "--ckpt_dir", tmpdir_path])
    assert res["final_step"] == 3 and res["restarts"] == 0
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])
    out = capsys.readouterr().out
    assert "arch=jamba-smoke" in out
    assert "[train] done: steps=3 restarts=0" in out
    assert CheckpointManager(tmpdir_path).all_steps() == [2, 3]
    assert ARCH in tlaunch.TRAINED


# ---------------------------------------------------------------------------
# On the card: the backward kernel
# ---------------------------------------------------------------------------


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU build")


def _cuda_inputs(b, t, di, n, dtype, seed):
    dt, x, bm, c, a, h0, gy, ght = (torch.from_numpy(v).cuda()
                                    for v in _inputs(b, t, di, n, seed))
    dt = dt * 0.05
    return ([v.to(dtype) for v in (dt, x, bm, c)] + [a, h0, gy.to(dtype),
                                                      ght])


def _err_to_max(got, want):
    return ((got.double() - want.double()).abs().max().item()
            / max(1.0, want.double().abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,di,n,dtype", [
    (8, 64, 8192, 16, torch.bfloat16), (8, 64, 8192, 16, torch.float32),
    (1, 448, 8192, 16, torch.bfloat16), (2, 11, 8192, 16, torch.float32),
    (3, 21, 100, 12, torch.float32), (3, 21, 100, 12, torch.bfloat16),
    (2, 13, 128, 8, torch.float32),
])
def test_cuda_scan_bwd_matches_plain_repeats_and_rows_alone(b, t, di, n,
                                                             dtype):
    """The kernel against ``ref.selective_scan_bwd`` from a nonzero state
    with a final-state gradient, as ``chip_smoke.py`` holds it: every
    output within 1e-4 (an f32 output, ga and gh0 whatever the inputs'
    dtype) or 1e-2 (a bf16 output) of its largest value; the forward's y and hT equal with and
    without saved states; two calls and a sequence alone bit for bit."""
    _require_cuda()
    dt, x, bm, c, a, h0, gy, ght = _cuda_inputs(b, t, di, n, dtype, seed=t)
    y, h, states = tscan.selective_scan_fwd(dt, x, bm, c, a, h0)
    y0, h_0 = tscan.selective_scan(dt, x, bm, c, a, h0)
    assert torch.equal(y, y0) and torch.equal(h, h_0)
    got = tscan.selective_scan_bwd(dt, x, bm, c, a, h0, gy, states, ght)
    again = tscan.selective_scan_bwd(dt, x, bm, c, a, h0, gy, states, ght)
    want = ref.selective_scan_bwd(dt, x, bm, c, a, h0, gy, ght)
    for name, g, g2, w in zip(NAMES, got, again, want):
        assert torch.equal(g, g2), name
        tol = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
        assert _err_to_max(g, w) <= tol, name
    for i in range(b if b > 1 else 0):
        one = [v[i:i + 1] for v in (dt, x, bm, c)]
        _, _, st = tscan.selective_scan_fwd(*one, a, h0[i:i + 1])
        alone = tscan.selective_scan_bwd(*one, a, h0[i:i + 1], gy[i:i + 1],
                                         st, ght[i:i + 1])
        for name, g, w in zip(NAMES[:4], alone[:4], got[:4]):
            assert torch.equal(g, w[i:i + 1]), (name, i)
