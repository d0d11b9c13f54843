"""The launch plan of the port's ``selective_scan`` kernel on the CPU, and
the kernel itself on the card.

``kernels.selective_scan.scan_plan`` gives the kernel's geometry (a thread
four states, ``lanes`` threads a channel, ``channels`` channels a block,
time in tiles of ``steps``), a function of (di, N, dtype) alone.  On the CPU
the wrapper runs the plain version.  The ``cuda``-marked tests hold the
kernel to its plain version at Jamba-v0.1 52B's decode and 448-token
prompt shapes, a prompt split in two (the state carried) to the whole,
and a sequence alone to its rows of the batch, bit for bit.  They skip
without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_scan_plan.py
"""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tscan
from repro_torch.kernels.selective_scan import (CLUSTER, MAX_STATE,
                                                SMEM_LIMIT, STATES, scan_plan,
                                                scratch_floats)

# (di, N): Jamba-v0.1 52B FULL, its SMOKE config, and ragged widths.
PLAN_CASES = ([(8192, 16), (128, 8)]
              + [(100, n) for n in range(1, MAX_STATE + 1)])
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("di,n", PLAN_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_plan_covers_each_channel_and_state_once(di, n, dtype):
    """Over the plan's grid every (channel, state) below (di, N) is
    walked by exactly one thread, a channel's states by consecutive
    threads of one block, and the block's shared memory fits."""
    p = scan_plan(di, n, dtype)
    assert p.lanes * STATES >= n and p.lanes & (p.lanes - 1) == 0
    assert p.lanes == 1 or p.lanes // 2 * STATES < n   # the least such
    blocks, batch = p.blocks(di, 3)
    assert batch == 3
    owned = [(d, j + q) for bx in range(blocks) for t in range(p.threads)
             for d, j in [p.owner(bx, t)] for q in range(STATES)]
    live = [(d, j) for d, j in owned if d < di and j < n]
    assert sorted(live) == [(d, j) for d in range(di) for j in range(n)]
    assert len(set(owned)) == len(owned)
    for bx in range(blocks):
        for t in range(p.threads):
            d, j = p.owner(bx, t)
            assert (j == t % p.lanes * STATES
                    and d == bx * p.channels + t // p.lanes)
    assert 0 < p.smem <= SMEM_LIMIT
    assert p.threads <= 1024


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_plan_depends_on_the_shape_alone(dtype):
    """The plan is a function of (di, N, dtype): no batch, length or data
    enters it, nor the grid's channel blocks; 16-byte staging where a row
    is a whole number of 16-byte chunks; Jamba's 16 states 4 threads a
    channel, 64 threads a block."""
    assert list(inspect.signature(scan_plan).parameters) == ["di", "n",
                                                             "dtype"]
    for di, n in PLAN_CASES:
        assert scan_plan(di, n, dtype) == scan_plan(di, n, dtype)
        p = scan_plan(di, n, dtype)
        assert p.blocks(di, 1)[0] == p.blocks(di, 8)[0]
        es = torch.tensor([], dtype=dtype).element_size()
        assert p.wide == (di * es % 16 == 0 and n * es % 16 == 0)
    jamba = scan_plan(8192, 16, dtype)
    assert (jamba.lanes, jamba.channels, jamba.threads) == (4, 16, 64)
    assert jamba.wide and scan_plan(128, 8, dtype).wide
    assert not scan_plan(100, 16, torch.bfloat16).wide
    assert not scan_plan(128, 12, torch.bfloat16).wide


@pytest.mark.parametrize("di,n", PLAN_CASES + [(16, 16), (17, 4), (48, 8),
                                               (113, 8), (129, 16), (200, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_plan_bwd_clusters_cover_the_channel_blocks(di, n, dtype):
    """The backward's grid is whole clusters of CLUSTER channel blocks,
    its padding blocks past di and fewer than a cluster; the scratch holds one partial a cluster for gbm and gc and one a
    sequence for ga."""
    p = scan_plan(di, n, dtype)
    blocks = p.blocks(di, 2)[0]
    grid, batch = p.bwd_blocks(di, 2)
    assert batch == 2 and grid % CLUSTER == 0
    assert blocks <= grid < blocks + CLUSTER
    assert scratch_floats(3, 11, di, n) == 2 * 3 * 11 * (grid // CLUSTER) * n \
        + 3 * di * n


def test_scan_plan_bwd_at_jamba():
    """Jamba-v0.1 52B (di = 8192, N = 16): clusters of 8 of the 512
    channel blocks, so the channel partials of an 8 x 64 step shrink 8x,
    to 4.2 MB (4,194,304 bytes) from 33.5 MB."""
    p = scan_plan(8192, 16, torch.bfloat16)
    assert CLUSTER == 8 and p.bwd_blocks(8192, 8) == (512, 8)
    part_bc = scratch_floats(8, 64, 8192, 16) - 8 * 8192 * 16
    assert 4 * part_bc == 4_194_304
    assert 4 * part_bc * CLUSTER == 2 * 8 * 64 * 512 * 16 * 4


@pytest.mark.parametrize("n", [0, MAX_STATE + 1, 64])
def test_scan_plan_refuses_states_it_cannot_hold(n):
    with pytest.raises(ValueError, match="N <="):
        scan_plan(128, n, torch.float32)
    with pytest.raises(ValueError, match="f32 or bf16"):
        scan_plan(128, 8, torch.float16)


def _inputs(b, t, di, n, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.1, (b, t, di)).astype(np.float32)
    x, bm, c = (rng.normal(size=shape).astype(np.float32)
                for shape in ((b, t, di), (b, t, n), (b, t, n)))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    h0 = (0.5 * rng.normal(size=(b, di, n))).astype(np.float32)
    return [torch.from_numpy(v).to(device=device,
                                   dtype=dtype if i < 4 else torch.float32)
            for i, v in enumerate((dt, x, bm, c, a, h0))]


@pytest.mark.parametrize("t,split", [(11, 5), (12, 7)])
def test_cpu_wrapper_is_the_plain_version_and_a_split_prompt_the_whole(
        t, split):
    """CPU tensors run ``ref.selective_scan`` unchanged, without a launch;
    the plain version over [0, split) then [split, T), the state carried,
    gives the whole prompt's y and state."""
    args = _inputs(2, t, 24, 8, seed=t)
    before = tscan.launches
    y, h = tscan.selective_scan(*args)
    want_y, want_h = tref.selective_scan(*args)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert tscan.launches == before
    y1, h1 = tscan.selective_scan(*(v[:, :split] for v in args[:4]),
                                  *args[4:])
    y2, h2 = tscan.selective_scan(*(v[:, split:] for v in args[:4]),
                                  args[4], h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(h2, h, rtol=1e-6, atol=1e-6)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(8, 1), (1, 448), (2, 37)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_scan_matches_plain_split_and_alone(b, t, dtype):
    """At Jamba's width (di=8192, N=16): y within one bf16 ulp (bf16) or
    1e-5 (1 + |plain|) (f32) of the plain version and the state within
    1e-5 (1 + |plain|), as ``chip_smoke.py`` holds it; the prompt split
    at T // 2 with the state carried equal to the whole, and every
    sequence alone equal to its rows of the batch, bit for bit."""
    _require_cuda()
    args = _inputs(b, t, 8192, 16, seed=b + t, dtype=dtype, device="cuda")
    y, h = tscan.selective_scan(*args)
    want_y, want_h = tref.selective_scan(*args)
    torch.cuda.synchronize()
    err_y = (y.double() - want_y.double()).abs()
    if dtype == torch.float32:
        assert (err_y <= 1e-5 * (1 + want_y.double().abs())).all()
    else:
        assert (err_y <= 2.0 ** -7 * want_y.double().abs()
                + 2.0 ** -16).all()
    assert ((h - want_h).abs() <= 1e-5 * (1 + want_h.abs())).all()
    if t > 1:
        s = t // 2
        y1, h1 = tscan.selective_scan(*(v[:, :s] for v in args[:4]),
                                      *args[4:])
        y2, h2 = tscan.selective_scan(*(v[:, s:] for v in args[:4]),
                                      args[4], h1)
        assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    for i in range(b if b > 1 else 0):
        yi, hi = tscan.selective_scan(*(v[i:i + 1] for v in args[:4]),
                                      args[4], args[5][i:i + 1])
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(hi, h[i:i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("di,n", [(128, 8), (100, 3), (100, 16), (36, 12)])
def test_cuda_scan_ragged_plans(di, n):
    """The plain-load staging (rows not whole 16-byte chunks) and the
    narrow lane counts against the plain version, f32 and bf16."""
    _require_cuda()
    for dtype in DTYPES:
        args = _inputs(3, 21, di, n, seed=di + n, dtype=dtype,
                       device="cuda")
        y, h = tscan.selective_scan(*args)
        want_y, want_h = tref.selective_scan(*args)
        err_y = (y.double() - want_y.double()).abs()
        if dtype == torch.float32:
            assert (err_y <= 1e-5 * (1 + want_y.double().abs())).all()
        else:
            assert (err_y <= 2.0 ** -7 * want_y.double().abs()
                    + 2.0 ** -16).all()
        assert ((h - want_h).abs() <= 1e-5 * (1 + want_h.abs())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("di,n", [(16, 8), (24, 4), (100, 12), (128, 8),
                                  (200, 4), (8192, 16)])
def test_cuda_scan_bwd_clusters(di, n):
    """The backward on one cluster padded from 1, 2 and 7 channel blocks,
    one of 8 blocks, two padded from 13, and Jamba's 64, against the plain
    backward, f32 and bf16: each output within 1e-4 (f32) or 1e-2 (bf16)
    of its largest value; two calls, and each sequence alone, bit for
    bit."""
    _require_cuda()
    for dtype in DTYPES:
        args = _inputs(3, 19, di, n, seed=di + n, dtype=dtype, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(di)
        gy = torch.randn((3, 19, di), generator=gen, device="cuda").to(dtype)
        ght = torch.randn((3, di, n), generator=gen, device="cuda")
        _, _, states = tscan.selective_scan_fwd(*args)
        got = tscan.selective_scan_bwd(*args, gy, states, ght)
        again = tscan.selective_scan_bwd(*args, gy, states, ght)
        want = tref.selective_scan_bwd(*args, gy, ght)
        for g, g2, w in zip(got, again, want):
            assert torch.equal(g, g2)
            tol = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
            assert ((g.double() - w.double()).abs().max().item()
                    <= tol * max(1.0, w.double().abs().max().item()))
        for i in range(3):
            one = [v[i:i + 1] for v in args[:4]]
            _, _, st = tscan.selective_scan_fwd(*one, args[4],
                                                args[5][i:i + 1])
            alone = tscan.selective_scan_bwd(*one, args[4], args[5][i:i + 1],
                                             gy[i:i + 1], st, ght[i:i + 1])
            for g, w in zip(alone[:4], got[:4]):
                assert torch.equal(g, w[i:i + 1])
