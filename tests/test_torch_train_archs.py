"""Training the attention decoders: the port against the JAX package.

Parameters are initialised in JAX and carried across with
``bridge.params_from_numpy(..., dtype=torch.float32)``, then cut to the
trained tree (``models.train_tree``: a tied table one leaf); batches come
from numpy.  Everything runs in f32 on the CPU, where ``ops.attention``
differentiates through ``FlashAttention``'s plain halves and the norms,
GEMMs and MoE products are plain torch.  Tolerances cover summation order
only, through two layers and the lm head.
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
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.training import trainer as jtrainer
from repro_torch import configs as TC
from repro_torch.bridge import params_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw
from repro_torch.training import trainer as ttrainer

POLICIES = [(False, "full"), (True, "full"), (True, "tp_outs"),
            (True, "dots")]


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
def _jax_setup(arch):
    """(jax cfg, port cfg, jax params, numpy tree); never written to."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def _port_params(arch):
    """A fresh f32 copy of the JAX params, as the tree training takes."""
    _, tcfg, _, tree = _jax_setup(arch)
    return tmodel.train_tree(params_from_numpy(tree, tcfg, device="cpu",
                                               dtype=torch.float32))


def _batch(seed, vocab, b=2, s=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, remat, policy):
    jcfg, _, jparams, _ = _jax_setup(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(11, jcfg.vocab_size).items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, jcfg, remat=remat,
                                 remat_policy=policy), has_aux=True))
    (loss, _), grads = fn(jparams)
    return float(loss), jax.tree.map(np.asarray, grads)


def _pairs(arch, jtree, tparams):
    """(path, jax leaf, port leaf) for every leaf; the reference's stacked
    blocks (n_groups, ...) are split into the port's per-layer list."""
    jcfg = _jax_setup(arch)[0]
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


def _port_loss_and_grads(arch, remat, policy):
    _, tcfg, _, _ = _jax_setup(arch)
    tp = _port_params(arch)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(11, tcfg.vocab_size).items()}
    leaves = adamw.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tmodel.loss_fn(tp, batch, tcfg, remat=remat,
                             remat_policy=policy)
    loss.backward()
    return loss.item(), tp, leaves


def _check_against_jax(arch, remat, policy):
    """Loss at rtol 1e-5; every gradient leaf within 1e-4 of its largest
    element; as many leaves as JAX's (a tied table is one)."""
    jloss, jgrads = _jax_loss_and_grads(arch, remat, policy)
    loss, tp, leaves = _port_loss_and_grads(arch, remat, policy)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    pairs = _pairs(arch, jgrads, tp)
    assert len(pairs) == len(leaves)
    for name, want, p in pairs:
        assert p.grad is not None, name
        scale = max(1e-6, float(np.abs(want).max()))
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= 1e-4 * scale, (name, err, scale)
    return loss


@pytest.mark.parametrize("remat,policy", POLICIES)
def test_smollm_smoke_loss_and_every_gradient_match_jax(remat, policy):
    """SmolLM SMOKE (tied, 6/2 heads of 16) under every remat policy
    against JAX's ``loss_fn`` under the same one.  Remat recomputes the
    same arithmetic, so every policy gives the loss without remat bit for
    bit."""
    loss = _check_against_jax("smollm_360m", remat, policy)
    assert loss == _port_loss_and_grads("smollm_360m", False, "full")[0]


def test_tied_table_is_one_leaf_with_both_gradients():
    """The trained tree has no ``table_t``: the head reads the table
    transposed, so the table's gradient is the embedding's plus the
    head's (rows of tokens the batch never holds get the head's only),
    and AdamW, the checkpoints and the optimizer state see one leaf."""
    tp = _port_params("smollm_360m")
    assert set(tp["embed"]) == {"table"}
    served = tmodel.init_params(TC.get_smoke("smollm_360m"), seed=1,
                                device="cpu", dtype=torch.float32)
    trained = tmodel.train_tree(served)
    assert "table_t" in served["embed"] and "table_t" not in trained["embed"]
    assert trained["embed"]["table"] is served["embed"]["table"]
    assert len(adamw.leaves(trained)) == len(adamw.leaves(served)) - 1
    assert tmodel.train_tree(trained) is trained
    _, tp, _ = _port_loss_and_grads("smollm_360m", False, "full")
    g = tp["embed"]["table"].grad
    assert g.shape == tp["embed"]["table"].shape
    unseen = torch.ones(g.shape[0], dtype=torch.bool)
    unseen[torch.from_numpy(_batch(11, g.shape[0])["tokens"]).long()] = False
    assert bool((g[unseen] != 0).any())      # the head's part, alone there


def test_train_step_refuses_a_serving_tree():
    _, tcfg, _, tree = _jax_setup("smollm_360m")
    served = params_from_numpy(tree, tcfg, device="cpu", dtype=torch.float32)
    opt_cfg = adamw.AdamWConfig()
    step = ttrainer.make_train_step(tcfg, opt_cfg, remat=False)
    with pytest.raises(ValueError, match="train_tree"):
        step(served, adamw.init(served), _batch(1, tcfg.vocab_size))


@pytest.mark.parametrize("arch,remat,policy", [
    ("qwen3_8b", True, "dots"),
    ("llama4_maverick_400b_a17b", True, "tp_outs"),
    ("qwen2_vl_72b", True, "full"),
])
def test_other_attention_decoders_match_jax(arch, remat, policy):
    """Qwen3 (qk-norm), Llama-4 Maverick (MoE, trained through its aux loss)
    and Qwen2-VL (M-RoPE at text positions) SMOKE at one policy each."""
    _check_against_jax(arch, remat, policy)


def _port_trainer(ckpt_dir, steps, failure_hook=None, ckpt_every=2):
    _, tcfg, _, _ = _jax_setup("smollm_360m")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    data = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                                  global_batch=4))
    params = _port_params("smollm_360m")
    return ttrainer.Trainer(
        tcfg, ttrainer.TrainConfig(steps=steps, ckpt_every=ckpt_every,
                                   ckpt_dir=ckpt_dir, log_every=1),
        opt_cfg, params, adamw.init(params), lambda s: data.iterate(s),
        ttrainer.make_train_step(tcfg, opt_cfg, remat=False),
        failure_hook=failure_hook)


def test_trainer_losses_match_jax_trainer_through_a_restart(tmpdir_path):
    """Five SmolLM SMOKE steps of the JAX trainer against the port's, whose
    run fails once at step 3 and restores the step-2 checkpoint (params,
    moments, step counter, one table leaf): every step's loss and grad
    norm within rtol 1e-4 of JAX's (f32; small differences of each step's
    gradients move the next step's parameters), and the port's replayed
    losses equal its uninterrupted run's exactly."""
    jcfg, _, jparams, _ = _jax_setup("smollm_360m")
    opt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                    global_batch=4))
    want = jtrainer.Trainer(
        jcfg, jtrainer.TrainConfig(steps=5, ckpt_every=10,
                                   ckpt_dir=tmpdir_path + "/jax",
                                   log_every=1),
        opt_cfg, jparams, jadamw.init(jparams), lambda s: data.iterate(s),
        jax.jit(jtrainer.make_train_step(jcfg, opt_cfg, remat=False))
    ).run()["metrics"]
    clean = _port_trainer(tmpdir_path + "/a", 5).run()
    fail = {3}

    def hook(step):
        if step in fail:
            fail.clear()
            raise RuntimeError("injected node failure")
    hurt = _port_trainer(tmpdir_path + "/b", 5, failure_hook=hook).run()
    assert clean["restarts"] == 0 and hurt["restarts"] == 1
    assert [m["step"] for m in hurt["metrics"]] == [0, 1, 2, 2, 3, 4]
    last = {m["step"]: m for m in hurt["metrics"]}
    assert ({s: m["loss"] for s, m in last.items()}
            == {m["step"]: m["loss"] for m in clean["metrics"]})
    for m in want:
        np.testing.assert_allclose(last[m["step"]]["loss"], m["loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(last[m["step"]]["grad_norm"],
                                   m["grad_norm"], rtol=1e-4)


def test_launcher_defaults_to_smollm_and_seamless_fails_as_the_reference(
        tmpdir_path, capsys):
    """The default arch is the reference launcher's, smollm_360m; SeamlessM4T
    fails at its first step as the reference's launcher does: the
    synthetic pipeline has no ``enc_embeds``, every retry fails with the
    KeyError, and the trainer gives up."""
    res = tlaunch.main(["--smoke", "--steps", "2", "--device", "cpu",
                        "--ckpt_dir", tmpdir_path + "/s"])
    assert res["final_step"] == 2 and res["restarts"] == 0
    assert "arch=smollm-smoke" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="enc_embeds") as err:
        tlaunch.main(["--arch", "seamless_m4t_large_v2", "--smoke",
                      "--steps", "1", "--device", "cpu", "--ckpt_dir",
                      tmpdir_path + "/m"])
    assert isinstance(err.value.__cause__, KeyError)
