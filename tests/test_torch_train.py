"""The port's training path (RWKV-6) against the JAX package's.

Every input is made with numpy from a seed and handed to both packages;
parameters are initialised in JAX and carried across with
``bridge.params_from_numpy(..., dtype=torch.float32)``.  Everything runs
in f32 on the CPU, where the port's wkv6 wrappers run their plain
versions (``ref_wkv``/``ref_wkv_bwd``) and JAX's Pallas kernel runs in
interpret mode.  Tolerances, each stated where it is used, cover summation
order only: the two frameworks reduce in different orders, and the
differences grow through the recurrence, two layers and the lm head.
"""

import functools
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro.optim import adamw as jadamw
from repro.training import trainer as jtrainer
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv as trwkv
from repro_torch.optim import adamw
from repro_torch.training import trainer as ttrainer

ARCH = "rwkv6_3b"


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


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """(jax cfg, port cfg, jax params, numpy tree); never written to."""
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def _port_params():
    """A fresh f32 copy of the JAX params in the port's layout."""
    _, tcfg, _, tree = _jax_setup()
    return params_from_numpy(tree, tcfg, device="cpu", dtype=torch.float32)


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
                out.append((f"blocks/{g}/{keys[2:]}", np.asarray(leaf[g]),
                            node))
        else:
            node = tparams
            for k in keys:
                node = node[k]
            out.append(("/".join(map(str, keys)), np.asarray(leaf), node))
    return out


def _batch(seed, b=2, s=24, vocab=512):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _wkv_inputs(seed, b, h, t, n, w_low=0.6):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(b, h, t, n)).astype(np.float32)
    k = (rng.normal(size=(b, h, t, n)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, h, t, n)).astype(np.float32)
    w = rng.uniform(w_low, 0.99, size=(b, h, t, n)).astype(np.float32)
    u = (rng.normal(size=(h, n)) * 0.2).astype(np.float32)
    return r, k, v, w, u


# ---------------------------------------------------------------------------
# wkv6: forward and VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,t,n,chunk", [
    (2, 64, 16, 32), (3, 100, 16, 32), (1, 17, 32, 8), (4, 128, 8, 128),
])
def test_ref_wkv_matches_jax_wkv6_kernel(bh, t, n, chunk):
    """The geometries of tests/test_kernels.py:335-337, with its rtol =
    atol = 2e-5; the port's ops.wkv (the autograd Function, plain forward
    on the CPU) equals ref_wkv exactly."""
    arrs = _wkv_inputs(bh * t + n, bh, 2, t, n)
    want = jops.wkv(*map(jnp.asarray, arrs), chunk=chunk, mode="kernel")
    got = tref.ref_wkv(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(tops.wkv(*map(torch.from_numpy, arrs)), got)


@pytest.mark.parametrize("b,h,t,n,w_low", [(2, 2, 100, 16, 0.6),
                                           (1, 3, 17, 32, 0.0)])
def test_wkv_vjp_matches_jax(b, h, t, n, w_low):
    """ref_wkv_bwd and the autograd Function (CPU) against jax.vjp of the
    reference's oracle.  w_low = 0 draws decays down to 0, where dividing
    by w_t to recover S_{t-1} would blow up.  rtol = atol = 1e-4: the
    gradients sum over T steps in another order (values up to ~30)."""
    arrs = _wkv_inputs(t + n, b, h, t, n, w_low)
    gy = np.random.default_rng(1).normal(size=(b, h, t, n)).astype(np.float32)
    _, vjp = jax.vjp(jref.ref_wkv, *map(jnp.asarray, arrs))
    want = vjp(jnp.asarray(gy))
    got = tref.ref_wkv_bwd(*map(torch.from_numpy, arrs + (gy,)))
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    tops.wkv(*xs).backward(torch.from_numpy(gy))
    for name, w_, g_, x in zip("rkvwu", want, got, xs):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
        assert torch.equal(x.grad, g_), name
    # mode="ref" differentiates the plain loop with torch autograd.
    xr = [torch.from_numpy(a).requires_grad_() for a in arrs]
    tops.wkv(*xr, mode="ref").backward(torch.from_numpy(gy))
    for name, w_, x in zip("rkvwu", want, xr):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_wkv_validates_and_kernel_mode_needs_cuda():
    arrs = [torch.from_numpy(a) for a in _wkv_inputs(0, 1, 2, 8, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        tops.wkv(*arrs, mode="kernel")
    with pytest.raises(ValueError, match="u"):
        tops.wkv(*arrs[:4], arrs[4][:, :8])
    with pytest.raises(ValueError, match="one shape"):
        tops.wkv(arrs[0], arrs[1][:, :, :4], *arrs[2:])


@pytest.mark.parametrize("groups", [1, 4])
def test_layernorm_function_differentiates_the_plain_expression(groups):
    """``kernels.rmsnorm.LayerNorm``, the route RWKV-6 trains through on
    the card: its forward is the wrapper's (the plain version for these CPU
    tensors), its gradient autograd's of the plain expression, bit for bit,
    and held to JAX's LayerNorm/GroupNorm VJP."""
    from repro.models import layers as jlayers
    from repro_torch.kernels.rmsnorm import LayerNorm
    rng = np.random.default_rng(groups)
    x, gy = (rng.standard_normal((3, 5, 64)).astype(np.float32)
             for _ in range(2))
    scale, bias = (rng.standard_normal(64).astype(np.float32)
                   for _ in range(2))
    want_in = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    want = tref.layernorm(*want_in, 1e-5, groups)
    want.backward(torch.from_numpy(gy))
    got_in = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    got = LayerNorm.apply(*got_in, 1e-5, groups)
    got.backward(torch.from_numpy(gy))
    assert torch.equal(got, want)
    for name, g, w_ in zip(("x", "scale", "bias"), got_in, want_in):
        assert torch.equal(g.grad, w_.grad), name

    def jnorm(x_, s_, b_):
        if groups == 1:
            return jlayers.layernorm({"scale": s_, "bias": b_}, x_, 1e-5)
        return jlayers.groupnorm(x_, groups, s_, b_, 1e-5)
    _, vjp = jax.vjp(jnorm, x, scale, bias)
    for name, g, w_ in zip(("x", "scale", "bias"), got_in, vjp(gy)):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# RWKV-6 blocks and the whole model
# ---------------------------------------------------------------------------


def test_time_mix_and_channel_mix_match_jax():
    """rtol = atol = 1e-5 (f32, one block)."""
    cfg = trwkv.RwkvConfig(head_size=16, lora_mix=8, lora_decay=8)
    jcfg = jrwkv.RwkvConfig(head_size=16, lora_mix=8, lora_decay=8)
    key = jax.random.PRNGKey(3)
    jtm = jrwkv.init_time_mix(key, 64, jcfg)
    jcm = jrwkv.init_channel_mix(key, 64, 224)
    x = np.random.default_rng(5).normal(size=(2, 24, 64)).astype(np.float32)
    t = lambda tree: {k: torch.from_numpy(np.array(v))  # noqa: E731
                      for k, v in tree.items()}
    tm = {k: (t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in jtm.items()}
    cm = {k: (t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in jcm.items()}
    want_tm, _ = jax.jit(lambda p, x: jrwkv.time_mix(p, x, jcfg))(
        jtm, jnp.asarray(x))
    got_tm, cache = trwkv.time_mix(tm, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got_tm.numpy(), np.asarray(want_tm),
                               rtol=1e-5, atol=1e-5)
    want_cm, _ = jax.jit(jrwkv.channel_mix)(jcm, jnp.asarray(x))
    got_cm, _ = trwkv.channel_mix(cm, torch.from_numpy(x))
    np.testing.assert_allclose(got_cm.numpy(), np.asarray(want_cm),
                               rtol=1e-5, atol=1e-5)
    assert cache is None
    # The serving slice's cached branch from a zero state is the training
    # branch (held to the reference's in tests/test_torch_rwkv_serve.py).
    zero = trwkv.init_rwkv_cache(2, 64, cfg, torch.float32)
    cached, state = trwkv.time_mix(tm, torch.from_numpy(x), cfg, cache=zero)
    np.testing.assert_allclose(cached.numpy(), got_tm.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert state["wkv"].shape == (2, 4, 16, 16)
    caches = tmodel.init_cache(TC.get_smoke(ARCH), 2, 16, device="cpu")
    assert set(caches[0]["rwkv"]) == {"shift_tm", "shift_cm", "wkv"}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    jcfg, _, jparams, _ = _jax_setup()
    batch = {k: jnp.asarray(v) for k, v in _batch(11).items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, jcfg, remat=False), has_aux=True))
    (loss, _), grads = fn(jparams)
    lg, _, _ = jax.jit(lambda p: jmodel.forward(p, batch, jcfg))(jparams)
    return float(loss), np.asarray(lg), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "tp_outs")])
def test_rwkv_smoke_loss_and_every_gradient_match_jax(remat, policy):
    """Logits and loss at rtol = atol = 1e-5; every gradient leaf within
    1e-4 of its largest element (f32 sums in another order through two
    layers, the lm head and the recurrence).  Remat recomputes the same
    arithmetic, so every policy gives the same loss bit for bit."""
    jloss, jlg, jgrads = _jax_loss_and_grads()
    _, tcfg, _, _ = _jax_setup()
    tp = _port_params()
    batch = {k: torch.from_numpy(v) for k, v in _batch(11).items()}
    lg, _, _ = tmodel.forward(tp, batch, tcfg)
    np.testing.assert_allclose(lg.detach().numpy(), jlg, rtol=1e-5,
                               atol=1e-5)
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(tp, batch, tcfg, remat=remat,
                                   remat_policy=policy)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    loss.backward()
    pairs = _pairs(jgrads, tp)
    assert len(pairs) == len(leaves)
    for name, want, p in pairs:
        scale = max(1e-6, float(np.abs(want).max()))
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= 1e-4 * scale, (name, err, scale)
    ref_loss, _ = tmodel.loss_fn(_port_params(), batch, tcfg, remat=False)
    assert loss.item() == ref_loss.item()


def test_init_params_seeded_f32_and_shaped_like_reference():
    """Seeded init on the port's generator: same seed, same tensors; f32
    leaves of the reference's shapes (the bridged tree's), nothing more."""
    _, tcfg, _, tree = _jax_setup()
    a = tmodel.init_params(tcfg, seed=3, device="cpu", dtype=torch.float32)
    b = tmodel.init_params(tcfg, seed=3, device="cpu", dtype=torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(adamw.leaves(a),
                                                 adamw.leaves(b)))
    assert all(x.dtype == torch.float32 for x in adamw.leaves(a))
    shapes = jax.tree.map(lambda t: tuple(t.shape), _port_params())
    assert jax.tree.map(lambda t: tuple(t.shape), a) == shapes
    assert tmodel.param_count(a) == jmodel.param_count(tree)
    w = a["blocks"][1]["rwkv_tm"]["wr"]["w"]
    assert abs(float(w.std()) - tcfg.d_model ** -0.5) < 0.02


def test_dots_remat_raises_naming_its_item():
    """The ``dots`` policy, once a raise naming ROADMAP Queue A item 11, is
    ported (each layer checkpointed, every matrix product's output kept):
    RWKV-6 SMOKE's loss and every gradient under it match JAX's (loss at
    rtol 1e-5, every leaf within 1e-4 of its largest element), the loss
    bit-equal to the port's without remat; an unknown policy raises."""
    jloss, _, jgrads = _jax_loss_and_grads()
    _, tcfg, _, _ = _jax_setup()
    tp = _port_params()
    batch = {k: torch.from_numpy(v) for k, v in _batch(11).items()}
    for p in adamw.leaves(tp):
        p.requires_grad_(True)
    loss, _ = tmodel.loss_fn(tp, batch, tcfg, remat=True,
                             remat_policy="dots")
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    loss.backward()
    for name, want, p in _pairs(jgrads, tp):
        scale = max(1e-6, float(np.abs(want).max()))
        assert float(np.abs(p.grad.numpy() - want).max()) <= 1e-4 * scale, \
            name
    plain, _ = tmodel.loss_fn(_port_params(), batch, tcfg, remat=False)
    assert loss.item() == plain.item()
    with pytest.raises(ValueError, match="remat_policy"):
        tmodel.loss_fn(_port_params(), batch, tcfg, remat=True,
                       remat_policy="names")


# ---------------------------------------------------------------------------
# Optimizer, data, checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_matches_jax(master, monkeypatch):
    """Two updates with clipping active, against the reference's on the
    same tree; groups of a few leaves exercise the grouping.  rtol = 1e-6
    with atol = 1e-7 (f32 elementwise; lr is computed in float64 here)."""
    monkeypatch.setattr(adamw, "GROUP_ELEMENTS", 5000)
    _, _, _, tree = _jax_setup()
    cfg = dict(lr=1e-2, clip_norm=0.5, warmup_steps=1, total_steps=4,
               master_weights=master)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = _port_params()
    jstate, tstate = jadamw.init(jp, master), adamw.init(tp, master)
    rng = np.random.default_rng(2)
    for _ in range(2):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), tree)
        jp, jstate, jm = jax.jit(jadamw.update, static_argnums=0)(
            jcfg, jax.tree.map(jnp.asarray, g), jstate, jp)
        by_leaf = {id(p): torch.from_numpy(w.copy())
                   for _, w, p in _pairs(g, tp)}
        tgrads = [by_leaf[id(p)] for p in adamw.leaves(tp)]
        tp, tstate, tm = adamw.update(tcfg, tgrads, tstate, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 2
    for name, want, p in _pairs(jax.tree.map(np.asarray, jp), tp):
        np.testing.assert_allclose(p.numpy(), want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name, want, m in _pairs(jax.tree.map(np.asarray, jstate.nu),
                                tstate.nu):
        np.testing.assert_allclose(m.numpy(), want, rtol=1e-5, atol=1e-9,
                                   err_msg=name)


def test_synthetic_lm_batches_equal_reference():
    for cfg in [dict(vocab_size=512, seq_len=24, global_batch=4),
                dict(vocab_size=65536, seq_len=64, global_batch=8, seed=3)]:
        ours, theirs = SyntheticLM(DataConfig(**cfg)), \
            JSyntheticLM(JDataConfig(**cfg))
        for step in (0, 1, 17):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        it = ours.iterate(5)
        np.testing.assert_array_equal(next(it)["tokens"],
                                      theirs.batch_at(5)["tokens"])
        it.close()


def test_reference_checkpoint_restores_into_the_port_by_path(tmpdir_path):
    """The reference's manager writes params in the port's layout (one
    entry per layer), an AdamW state with a nonzero step and moments, and
    a bf16 leaf; the port restores each leaf by path, shape-checked, in
    its template's dtype.  The port's own checkpoint reads back the
    same, and the reference reads the port's params."""
    tree = _port_tree_numpy()
    jstate = jadamw.init(jax.tree.map(jnp.asarray, tree))
    jstate = jstate._replace(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda x: jnp.full(x.shape, 0.5, jnp.float32), tree))
    bf = jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)
    JCheckpointManager(tmpdir_path).save(
        4, {"params": tree, "opt": jstate, "bf": bf}, blocking=True)

    tp = _port_params()
    template = {"params": tp, "opt": adamw.init(tp),
                "bf": torch.zeros(3, dtype=torch.bfloat16)}
    mgr = CheckpointManager(tmpdir_path)
    got, step = mgr.restore(template)
    assert step == 4
    assert int(got["opt"].step) == 7 and got["opt"].step.dtype == torch.int32
    assert got["bf"].dtype == torch.bfloat16
    assert got["bf"].tolist() == [1.5, -2.25, 3.0]
    flat = adamw.leaves(got["params"])
    assert len(flat) == len(adamw.leaves(tp))
    for a, b in zip(flat, adamw.leaves(tp)):
        assert torch.equal(a, b)
    assert all(bool((m == 0.5).all()) for m in adamw.leaves(got["opt"].mu))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"bf": torch.zeros(4, dtype=torch.bfloat16)})

    mgr.save(5, got, blocking=True)
    again, _ = mgr.restore(template)
    assert int(again["opt"].step) == 7
    assert torch.equal(again["bf"], got["bf"])
    jgot, _ = JCheckpointManager(tmpdir_path).restore(
        {"params": jax.tree.map(jnp.zeros_like, tree)})
    for a, b in zip(jax.tree.leaves(jgot["params"]), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert mgr.all_steps() == [4, 5]


def _port_tree_numpy():
    """The port's param tree as numpy leaves (the layout a checkpoint of
    the port's params has)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return t.numpy().copy()
    return conv(_port_params())


# ---------------------------------------------------------------------------
# Trainer and launcher
# ---------------------------------------------------------------------------


def _port_trainer(ckpt_dir, steps, failure_hook=None, ckpt_every=10,
                  grad_accum=1):
    _, tcfg, _, _ = _jax_setup()
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    data = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                                  global_batch=4))
    params = _port_params()
    step_fn = ttrainer.make_train_step(tcfg, opt_cfg, grad_accum=grad_accum,
                                       remat=False)
    return ttrainer.Trainer(
        tcfg, ttrainer.TrainConfig(steps=steps, ckpt_every=ckpt_every,
                                   ckpt_dir=ckpt_dir, log_every=1),
        opt_cfg, params, adamw.init(params), lambda s: data.iterate(s),
        step_fn, failure_hook=failure_hook)


def test_trainer_losses_match_jax_trainer(tmpdir_path):
    """Three steps from the same parameters and batches: losses and grad
    norms at rtol 1e-4 (f32; the small differences of each step's
    gradients move the next step's parameters)."""
    jcfg, _, jparams, _ = _jax_setup()
    opt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                    global_batch=4))
    jt = jtrainer.Trainer(
        jcfg, jtrainer.TrainConfig(steps=3, ckpt_every=10,
                                   ckpt_dir=tmpdir_path + "/jax",
                                   log_every=1),
        opt_cfg, jparams, jadamw.init(jparams), lambda s: data.iterate(s),
        jax.jit(jtrainer.make_train_step(jcfg, opt_cfg, remat=False)))
    want = jt.run()["metrics"]
    got = _port_trainer(tmpdir_path + "/port", 3).run()
    assert got["restarts"] == 0 and got["final_step"] == 3
    assert [m["step"] for m in got["metrics"]] == [0, 1, 2]
    for a, b in zip(got["metrics"], want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)


def test_restart_after_injected_failure_resumes_with_equal_losses(
        tmpdir_path):
    """A failure at step 3 restores the step-2 checkpoint (params, moments
    and the step counter) and replays: every step's loss equals an
    uninterrupted run's exactly (same arithmetic on the CPU)."""
    clean = _port_trainer(tmpdir_path + "/a", 5, ckpt_every=2).run()
    fail = {3}

    def hook(step):
        if step in fail:
            fail.clear()
            raise RuntimeError("injected node failure")
    hurt = _port_trainer(tmpdir_path + "/b", 5, failure_hook=hook,
                         ckpt_every=2).run()
    assert clean["restarts"] == 0 and hurt["restarts"] == 1
    assert hurt["final_step"] == 5
    assert [m["step"] for m in hurt["metrics"]] == [0, 1, 2, 2, 3, 4]
    last = {m["step"]: m["loss"] for m in hurt["metrics"]}
    assert last == {m["step"]: m["loss"] for m in clean["metrics"]}


def test_grad_accum_matches_one_batch(tmpdir_path):
    """Two microbatches of 2 against one batch of 4: the same mean loss
    and, after one update, the same parameters (rtol 1e-5: the gradient
    is summed in another order)."""
    runs = [_port_trainer(f"{tmpdir_path}/{n}", 1, grad_accum=n)
            for n in (1, 2)]
    logs = [t.run()["metrics"][0]["loss"] for t in runs]
    np.testing.assert_allclose(logs[0], logs[1], rtol=1e-5)
    for a, b in zip(adamw.leaves(runs[0].params),
                    adamw.leaves(runs[1].params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_trainer_without_ckpt_dir_writes_to_a_fresh_directory():
    """No fixed default: each Trainer without a ckpt_dir gets its own new
    temporary directory.  remat and grad_accum are make_train_step's
    arguments, not TrainConfig fields nothing would read."""
    trainers = [_port_trainer(None, 1) for _ in range(2)]
    try:
        dirs = [t.ckpt_dir for t in trainers]
        assert dirs[0] != dirs[1]
        assert all(os.path.isdir(d) and not os.listdir(d) for d in dirs)
    finally:
        for t in trainers:
            shutil.rmtree(t.ckpt_dir, ignore_errors=True)
    for knob in ("remat", "grad_accum"):
        with pytest.raises(TypeError):
            ttrainer.TrainConfig(**{knob: 1})


def test_launcher_trains_smoke_on_cpu(tmpdir_path, capsys):
    res = tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "3",
                        "--ckpt_every", "2", "--device", "cpu",
                        "--ckpt_dir", tmpdir_path])
    assert res["final_step"] == 3 and res["restarts"] == 0
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])
    assert "[train] done: steps=3 restarts=0" in capsys.readouterr().out
    assert CheckpointManager(tmpdir_path).all_steps() == [2, 3]


@pytest.mark.parametrize("argv,match", [
    (["--model_parallel", "2"], "Queue A item 12"),
    (["--schedule", "allreduce"], "Queue A item 12"),
])
def test_launcher_rejects_what_is_not_ported(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        tlaunch.main(argv + ["--smoke", "--device", "cpu"])
