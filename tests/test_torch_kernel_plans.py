"""The launch plan of the port's redesigned layernorm kernel on the CPU,
and the redesigned attention backward and layernorm kernels on the card.

``kernels.rmsnorm.ln_plan`` decides how the layernorm kernel spreads a
row over threads, a function of (w, dtype) alone, so a row's summation
order, and so its bits, do not depend on what else the call holds.  The
attention backward's block schedule is fixed inside its kernel by the
shape; the ``cuda``-marked tests hold both kernels to their plain versions
and a batch element (or row) computed alone to its slice of a batch.  They
skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_plans.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.rmsnorm import (LN_MAX_PER, LN_MAX_THREADS,
                                         layernorm, ln_plan)

def test_bwd_wrapper_on_the_cpu_runs_the_plain_version():
    """CPU tensors run ``ref.attention_bwd``."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for shape in ((1, 4, 9, 16), (1, 2, 9, 16), (1, 2, 9, 16),
                                 (1, 4, 9, 16)))
    o, lse = tref.ref_attention(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = tref.attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


LN_WIDTHS = [16, 64, 960, 2560, 37, 100, 5120]


@pytest.mark.parametrize("w", LN_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_plan_covers_the_row_exactly(w, dtype):
    """Thread t holds vectors t, t + threads, ... (``per`` of them); those
    below the row's w / vec vectors are each held by exactly one thread,
    a thread holds at most LN_MAX_PER, and a row of at most 32 vectors
    stays inside one warp."""
    p = ln_plan(w, dtype)
    nv = w // p.vec
    assert p.vec * nv == w and p.threads & (p.threads - 1) == 0
    held = [t + i * p.threads for t in range(p.threads) for i in range(p.per)
            if t + i * p.threads < nv]
    assert sorted(held) == list(range(nv))
    assert 1 <= p.per <= LN_MAX_PER
    assert (p.per - 1) * p.threads < nv      # no thread holds only padding
    if nv <= 32:
        assert p.threads <= 32
    else:
        assert p.threads >= 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_plan_depends_on_width_and_dtype_alone(dtype):
    """The plan is a function of (w, dtype): 16-byte vectors when w is a
    whole number of them, and RWKV-6 3B's rows (2560 bf16: 64 threads of
    5 vectors; its GroupNorm's 64: 8 lanes of 1) as the kernel expects."""
    for w in LN_WIDTHS:
        assert ln_plan(w, dtype) == ln_plan(w, dtype)
    wide = 4 if dtype == torch.float32 else 8
    assert ln_plan(64, dtype).vec == wide and ln_plan(37, dtype).vec == 1
    if dtype == torch.bfloat16:
        assert tuple(ln_plan(2560, dtype)) == (8, 64, 5)
        assert tuple(ln_plan(64, dtype)) == (8, 8, 1)


def test_ln_plan_refuses_rows_too_wide():
    """No positive width is too wide: a row past LN_MAX_THREADS x
    LN_MAX_PER vectors gets 256 threads of more than LN_MAX_PER vectors,
    walked in chunks.  Only a row of no values is refused."""
    assert tuple(ln_plan(8 * 8 * 256 + 8, torch.bfloat16)) == (8, 256, 9)
    for w in (0, -1):
        with pytest.raises(ValueError, match="at least one"):
            ln_plan(w, torch.bfloat16)


# Each width's plan before rows wider than 2048 vectors were taken:
# (vec, threads, per) for f32 and bf16, as RWKV-6's replays ran them.
LN_PLANS = {
    torch.float32: [(4, 4, 1), (4, 16, 1), (4, 32, 8), (4, 128, 5),
                    (1, 32, 2), (4, 16, 2), (4, 256, 5)],
    torch.bfloat16: [(8, 2, 1), (8, 8, 1), (8, 32, 4), (8, 64, 5),
                     (1, 32, 2), (1, 32, 4), (8, 128, 5)],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_plan_keeps_every_narrower_rows_plan(dtype):
    """LN_WIDTHS keep their plans exactly, and so does every width up to
    2048 vectors: the rule without the cap on threads, which never bound
    there."""
    assert [tuple(ln_plan(w, dtype)) for w in LN_WIDTHS] == LN_PLANS[dtype]
    for w in range(1, 2048 * 8 + 1):
        p = ln_plan(w, dtype)
        nv = w // p.vec
        if nv > 2048:
            continue
        need = -(-nv // LN_MAX_PER)
        threads = (1 << (nv.bit_length() - 1) if nv <= 32
                   else max(32, 1 << (need - 1).bit_length()))
        assert tuple(p) == (p.vec, threads, -(-nv // threads)), w


@pytest.mark.parametrize("w,dtype,per", [
    (2561, torch.bfloat16, 11), (4097, torch.bfloat16, 17),
    (8193, torch.float32, 33)])
def test_ln_plan_takes_rows_wider_than_the_registers(w, dtype, per):
    """Rows of more than 2048 vectors: 256 threads, each walking ``per``
    vectors (in chunks of LN_MAX_PER), the row covered exactly."""
    p = ln_plan(w, dtype)
    assert (p.vec, p.threads, p.per) == (1, LN_MAX_THREADS, per)
    nv = w // p.vec
    held = sorted(t + i * p.threads for t in range(p.threads)
                  for i in range(p.per) if t + i * p.threads < nv)
    assert held == list(range(nv))


def test_layernorm_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
    for groups in (1, 2):
        assert torch.equal(layernorm(x, scale, bias, 1e-5, groups),
                           tref.layernorm(x, scale, bias, 1e-5, groups))


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU build")


def _bwd_inputs(b, hq, hkv, s, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b, hq, s, d), generator=g, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (4, 15, 5, 2048, 64), (1, 32, 8, 2048, 128), (2, 15, 5, 37, 64),
    (2, 15, 5, 77, 128), (2, 15, 5, 100, 64)])
def test_cuda_bwd_matches_plain_and_a_batch_element_alone(b, hq, hkv, s, d):
    """The bf16 backward (``wgmma`` and TMA) against ``ref.attention_bwd``
    on the forward kernel's o and lse: each gradient within 3e-2 of its
    largest element (P and dS rounded to bf16, the outputs once); two
    calls bit-identical; and every batch element computed alone (B = 1)
    equal, bit for bit, to its slice of the batched call."""
    _require_cuda()
    q, k, v, do = _bwd_inputs(b, hq, hkv, s, d, seed=s + d)
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    again = flash_attention_bwd(q, k, v, o, lse, do)
    want = tref.attention_bwd(*(t.float() for t in (q, k, v, o)), lse,
                              do.float())
    torch.cuda.synchronize()
    for x, y, w in zip(got, again, want):
        assert torch.equal(x, y)
        err = (x.float() - w).abs().max().item()
        assert err <= 3e-2 * w.abs().max().item(), (b, hq, s, d, err)
    for i in range(b):
        alone = flash_attention_bwd(*(t[i:i + 1].contiguous() for t in
                                      (q, k, v, o, lse, do)))
        for x, y in zip(alone, got):
            assert torch.equal(x[0], y[i])


@pytest.mark.cuda
@pytest.mark.parametrize("w,groups,dtype", [
    (2560, 1, torch.bfloat16), (2560, 40, torch.bfloat16),
    (64, 4, torch.float32), (37, 1, torch.float32),
    (2561, 1, torch.bfloat16), (16392, 1, torch.bfloat16),
    (8193, 1, torch.float32)])
def test_cuda_layernorm_rows_alone_equal_the_batch(w, groups, dtype):
    """The layernorm kernel within its tolerance of the plain version
    (1e-5 (1 + |plain|) in f32, 1e-2 (1 + |plain|) in bf16), and every row
    (a GroupNorm's rows of 64 included) the same bits alone, in a batch of
    8 and in one of 512; rows wider than 2048 vectors (walked in chunks)
    too."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(w + groups)
    x = (torch.randn((512, w), generator=g, device="cuda") * 3 + 0.5
         ).to(dtype)
    scale = 1 + 0.1 * torch.randn((w,), generator=g, device="cuda")
    bias = 0.1 * torch.randn((w,), generator=g, device="cuda")
    whole = layernorm(x, scale, bias, 1e-5, groups)
    want = tops.layernorm(x, scale, bias, eps=1e-5, groups=groups,
                          mode="ref")
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (whole.double() - want.double()).abs()
    assert bool((err <= tol * (1 + want.double().abs())).all())
    assert torch.equal(layernorm(x[:8].contiguous(), scale, bias, 1e-5,
                                 groups), whole[:8])
    alone = torch.cat([layernorm(x[i:i + 1].contiguous(), scale, bias, 1e-5,
                                 groups) for i in range(8)])
    assert torch.equal(alone, whole[:8])
