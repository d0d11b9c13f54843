"""The rmsnorm kernel's plan and its fused residual add on the CPU, and
both on the card.

``kernels.rmsnorm.rms_plan`` gives the rmsnorm kernel's geometry (one warp
a row, lane l its 16-byte vectors l, l + 32, ...), a function of (d,
dtype) alone.  ``ops.add_rmsnorm`` is the residual add and the norm after
it, one launch on the card; on the CPU its plain version is ``x + r`` then
``ref.rmsnorm``.  The model stacks take it wherever no gradient runs
through the residual stream (serving); training keeps the eager adds.
The ``cuda``-marked tests hold the fused kernel to torch's add followed by
the unfused kernel, bit for bit, and a row alone to its batch.  They skip
without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_norm_fused.py
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.models.layers import rmsnorm as jrmsnorm
except ImportError:
    # The GPU host has no JAX; it runs only this file's cuda-marked tests.
    jnp = jrmsnorm = None
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as tnorm
from repro_torch.kernels.rmsnorm import RMS_MAX_WIDE, RMS_ROWS, rms_plan
from repro_torch.models import init_params, loss_fn
from repro_torch.models.model import forward
from repro_torch.serving.engine import ServeConfig, ServeEngine

DTYPES = [torch.float32, torch.bfloat16]
# The served rmsnorm widths (SmolLM-360M, Qwen3-8B's qk_norm rows, the
# SMOKE configs, Qwen3-8B / Jamba, Phi-3-medium, Qwen2-VL-72B) and ragged
# ones (rows that are not a whole number of 16-byte vectors).
WIDTHS = [960, 128, 96, 1024, 4096, 5120, 8192, 35, 100, 1, 8200, 1000]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_plan_covers_the_row_exactly(d, dtype):
    """Lane l of a row's warp holds vectors l, l + 32, ..., ``per`` of
    them: those below the row's d / vec vectors are each held once, no
    lane holds only padding, and a row of more than RMS_MAX_WIDE vectors a
    lane is walked in chunks."""
    p = rms_plan(d, dtype)
    nv = d // p.vec
    assert p.vec * nv == d and p.rows == RMS_ROWS
    held = [lane + 32 * i for lane in range(32) for i in range(p.per)
            if lane + 32 * i < nv]
    assert sorted(held) == list(range(nv))
    assert 32 * (p.per - 1) < nv
    assert p.chunked == (p.per > RMS_MAX_WIDE)
    wide = 16 // torch.tensor([], dtype=dtype).element_size()
    assert p.vec == (wide if d % wide == 0 else 1)


def test_rms_plan_depends_on_width_and_dtype_alone():
    """No row count or data enters the plan; the served widths' plans."""
    assert list(inspect.signature(rms_plan).parameters) == ["d", "dtype"]
    bf16, f32 = torch.bfloat16, torch.float32
    assert tuple(rms_plan(960, bf16)) == (8, 4, RMS_ROWS)
    assert tuple(rms_plan(128, bf16)) == (8, 1, RMS_ROWS)
    assert tuple(rms_plan(96, f32)) == (4, 1, RMS_ROWS)
    assert tuple(rms_plan(35, f32)) == (1, 2, RMS_ROWS)
    assert [rms_plan(d, bf16).per for d in (4096, 5120, 8192)] == [16, 20, 32]
    assert not any(rms_plan(d, bf16).chunked for d in (1024, 4096, 8192))
    assert rms_plan(8200, bf16).chunked and rms_plan(4100, f32).chunked
    with pytest.raises(ValueError, match="at least one"):
        rms_plan(0, bf16)


def _rows(m, d, dtype, seed):
    rng = np.random.default_rng(seed)
    x, r = ((rng.normal(size=(m, d)) * 3).astype(np.float32)
            for _ in range(2))
    scale = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(r).to(dtype),
            torch.from_numpy(scale))


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("d", [96, 960, 35, 100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_on_the_cpu_is_the_add_then_the_norm(m, d, dtype):
    """On CPU tensors the fused op (through ``ops`` and the wrapper) is
    ``x + r`` then the plain rmsnorm, bit for bit, without a launch; each
    row alone gives its rows of the batch."""
    x, r, scale = _rows(m, d, dtype, seed=m * d)
    before = (tnorm.launches, tnorm.fused_launches)
    s, y = tops.add_rmsnorm(x, r, scale, eps=1e-5)
    assert torch.equal(s, x + r) and s.dtype == dtype
    assert torch.equal(y, tref.rmsnorm(x + r, scale, 1e-5))
    s2, y2 = tnorm.add_rmsnorm(x, r, scale, 1e-5)
    assert torch.equal(s2, s) and torch.equal(y2, y)
    assert (tnorm.launches, tnorm.fused_launches) == before
    for i in range(m):
        si, yi = tops.add_rmsnorm(x[i:i + 1], r[i:i + 1], scale, eps=1e-5)
        assert torch.equal(si, s[i:i + 1]) and torch.equal(yi, y[i:i + 1])


def test_add_rmsnorm_matches_jax_and_refuses_mixed_inputs():
    """The fused op's norm within 1e-6 of the reference's jnp rmsnorm of
    the same sum (inputs from numpy); x and r of another shape or dtype
    raise on every route (no broadcast, no promotion)."""
    x, r, scale = _rows(8, 960, torch.float32, seed=7)
    s, y = tops.add_rmsnorm(x, r, scale)
    want = np.asarray(jrmsnorm({"scale": jnp.asarray(scale.numpy())},
                               jnp.asarray(x.numpy() + r.numpy())))
    np.testing.assert_array_equal(s.numpy(), x.numpy() + r.numpy())
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)
    for mode in ("auto", "ref"):
        with pytest.raises(ValueError, match="one shape and dtype"):
            tops.add_rmsnorm(x, r.double(), scale, mode=mode)
        with pytest.raises(ValueError, match="one shape and dtype"):
            tops.add_rmsnorm(x, r[:1], scale, mode=mode)
    with pytest.raises(ValueError, match="CUDA"):
        tops.add_rmsnorm(x, r, scale, mode="kernel")


def _unfused(monkeypatch):
    """The fused adds undone: ``ops.add_rmsnorm`` as torch's ``x + r``
    then ``ops.rmsnorm``, the route before the fusion."""
    norm = tops.rmsnorm

    def eager(x, r, scale, *, eps=1e-6, mode="auto"):
        s = x + r
        return s, norm(s, scale, eps=eps, mode=mode)
    monkeypatch.setattr(tops, "add_rmsnorm", eager)


def _count_fused(monkeypatch):
    """Count the plain fused op's calls (the CPU's fused route)."""
    calls = {"n": 0}
    plain = tref.add_rmsnorm

    def counted(*args):
        calls["n"] += 1
        return plain(*args)
    monkeypatch.setattr(tref, "add_rmsnorm", counted)
    return calls


@pytest.mark.parametrize("arch", ["smollm_360m", "jamba_v01_52b",
                                  "seamless_m4t_large_v2"])
def test_fused_stack_gives_the_unfused_logits(arch, monkeypatch):
    """A SMOKE model's prefill and decode logits through the fused adds
    equal those through the eager adds, bit for bit, in f32 and bf16; the
    fused route runs two adds a layer (three in an enc-dec decoder
    layer, whose encoder's layers run two) and no other."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(tconfigs.get_smoke(arch),
                                  compute_dtype=dtype)
        params = init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 6)))}
        if cfg.encoder_decoder:
            batch["enc_embeds"] = torch.from_numpy(
                rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32))
        runs = []
        for fused in (True, False):
            with monkeypatch.context() as mp:
                calls = _count_fused(mp)
                if not fused:
                    _unfused(mp)
                lg, _, _ = forward(params, batch, cfg)
                runs.append((lg, calls["n"]))
        per_layer = 3 if cfg.encoder_decoder else 2
        want = per_layer * cfg.n_layers + (2 * cfg.n_encoder_layers
                                           if cfg.encoder_decoder else 0)
        assert runs[0][1] == want and runs[1][1] == 0
        assert torch.equal(runs[0][0], runs[1][0]), (arch, dtype)


def test_fused_engine_gives_the_unfused_tokens(monkeypatch):
    """SmolLM SMOKE served on 3 slots (prefill and decode steps): the same
    tokens through the fused adds as through the eager adds."""
    cfg = tconfigs.get_smoke("smollm_360m")
    params = init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 7))
    outs = []
    for fused in (True, False):
        with monkeypatch.context() as mp:
            calls = _count_fused(mp)
            if not fused:
                _unfused(mp)
            eng = ServeEngine(cfg, params, ServeConfig(batch_slots=3,
                                                       max_len=24))
            try:
                outs.append(eng.generate(prompts, max_new=5))
            finally:
                eng.close()
            assert (calls["n"] > 0) == fused
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots"), (True, "tp_outs")])
def test_training_keeps_the_eager_adds(remat, policy, monkeypatch):
    """With the parameters requiring grad, the loss's forward takes no
    fused add (the fused kernel has no backward) and runs the plain
    rmsnorm 2 a layer plus the final norm, as before the fusion; its loss
    and gradients equal the unfused route's."""
    cfg = tconfigs.get_smoke("smollm_360m")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    leaves = [p["scale"] for p in [params["final_norm"]]
              + [b["ln1"] for b in params["blocks"]]]
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    batch = {"tokens": toks, "labels": toks}
    norms = {"n": 0}
    plain = tref.rmsnorm

    def counted(*args):
        norms["n"] += 1
        return plain(*args)
    runs = []
    for fused in (True, False):
        with monkeypatch.context() as mp:
            calls = _count_fused(mp)
            mp.setattr(tref, "rmsnorm", counted)
            if not fused:
                _unfused(mp)
            norms["n"] = 0
            loss, _ = loss_fn(params, batch, cfg, remat=remat,
                              remat_policy=policy)
            forward_norms = norms["n"]
            grads = torch.autograd.grad(loss, leaves)
            runs.append((loss.detach(), grads))
            assert calls["n"] == 0
            assert forward_norms == 2 * cfg.n_layers + 1
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [
    (960, torch.bfloat16), (1024, torch.bfloat16), (4096, torch.bfloat16),
    (5120, torch.bfloat16), (8192, torch.bfloat16), (128, torch.bfloat16),
    (96, torch.float32), (100, torch.bfloat16), (35, torch.float32),
    (3000, torch.bfloat16), (8200, torch.bfloat16), (4100, torch.float32),
    (1000, torch.bfloat16)])
def test_cuda_add_rmsnorm_is_torch_add_then_the_kernel(d, dtype):
    """The fused kernel: s torch.equal to torch's x + r, y to the unfused
    kernel on that s, at M = 1, 3, 8 and 488, every row alone equal to
    its rows of the batch; one launch a call, counted as an rmsnorm
    launch."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(d)
    x, r = ((torch.randn((488, d), generator=g, device="cuda") * 3).to(dtype)
            for _ in range(2))
    scale = 1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
    before = (tnorm.launches, tnorm.fused_launches)
    s, y = tnorm.add_rmsnorm(x, r, scale)
    assert (tnorm.launches - before[0], tnorm.fused_launches - before[1]) \
        == (1, 1)
    assert torch.equal(s, x + r)
    assert torch.equal(y, tnorm.rmsnorm(x + r, scale))
    for m in (1, 3, 8):
        sm, ym = tnorm.add_rmsnorm(x[:m].contiguous(), r[:m].contiguous(),
                                   scale)
        assert torch.equal(sm, s[:m]) and torch.equal(ym, y[:m]), m
    alone = [tnorm.add_rmsnorm(x[i:i + 1].contiguous(),
                               r[i:i + 1].contiguous(), scale)[1]
             for i in range(8)]
    assert torch.equal(torch.cat(alone), y[:8])
    want = tops.add_rmsnorm(x, r, scale, mode="ref")[1]
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    err = (y.double() - want.double()).abs()
    assert bool((err <= tol * want.double().abs() + 1e-30).all())
