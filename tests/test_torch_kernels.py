"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the JAX Pallas kernel run in interpret mode (``ops.*(mode=
"kernel")``, as tests/test_kernels.py runs it) on the same numpy inputs.
The ``cuda``-marked tests hold each hand-written CUDA kernel against its
plain version; they decide inside the test whether a card is present and
skip without one.  On the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""

import inspect

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
except ImportError:
    # The GPU host has no JAX; it runs only this file's cuda-marked tests
    # (python -m pytest -m cuda tests/test_torch_kernels.py).
    jnp = jops = None
from repro_torch import configs as tconfigs
from repro_torch.configs.gama_paper import ARRAY_GEMMS
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv as twkv
from repro_torch.kernels.decode_attention import (flash_decode,
                                                  flash_paged_decode)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import gama_gemm
from repro_torch.kernels.rmsnorm import rmsnorm, vec_width
from repro_torch.kernels.wkv import wkv6, wkv6_bwd
from repro_torch.serving import quant as tquant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: torch's default pool of one thread per
    core only oversubscribes the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(x, jdtype=None, tdtype=torch.float32):
    return (jnp.asarray(x, jdtype or jnp.float32),
            torch.from_numpy(x).to(tdtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU build")


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(100, 300, 50), (257, 129, 127)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax_gama_gemm(m, k, n, dtype):
    """f32 at the JAX suite's rtol 1e-5 (test_kernels.py:44); bf16 at 2e-2:
    both round one f32 sum to bf16, in another summation order."""
    rng = _rng(m * 7 + n)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    ja, ta = _both(_normal(rng, (m, k)), jd, td)
    jb, tb = _both(_normal(rng, (k, n)), jd, td)
    want = jops.matmul(ja, jb, mode="kernel")
    got = tops.matmul(ta, tb)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("out_dtype,scale", [
    ("int32", 1.0), ("int16", 0.05), ("int8", 0.002)])
@pytest.mark.parametrize("m,k,n", [(64, 256, 64), (33, 100, 65)])
def test_matmul_int8_epilogue_exact(m, k, n, out_dtype, scale):
    rng = _rng(k + n)
    a = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b),
                       out_dtype=jnp.dtype(out_dtype), scale=scale,
                       mode="kernel")
    got = tops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      out_dtype=getattr(torch, out_dtype), scale=scale)
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("out_dtype", ["int16", "int8"])
def test_requant_rounds_half_to_even(out_dtype):
    """Accumulators that land exactly on .5 after scaling pin the
    rounding rule: half to even (2.5 -> 2, 3.5 -> 4, -2.5 -> -2), as
    jnp.round and the CUDA epilogue's rintf, not half away from zero."""
    acc = [5, 7, -5, -7, 1, -1, 9, 300, -300]
    # A row of ones times columns that sum to each accumulator value.
    a = np.ones((1, 3), np.int8)
    b = np.asarray([[v // 3, v // 3, v - 2 * (v // 3)] for v in acc],
                   np.int8).T.copy()
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b),
                       out_dtype=jnp.dtype(out_dtype), scale=0.5,
                       mode="kernel")
    got = tops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      out_dtype=getattr(torch, out_dtype), scale=0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, :7].tolist() == [2, 4, -2, -4, 0, 0, 4]


# The weight GEMMs of the two served decoders, and the paper's Table V.
_MODEL_GEMMS = {f"{arch}:{name}": (k, n, torch.bfloat16)
                for arch in ("smollm_360m", "qwen3_8b")
                for name, (k, n, _) in tconfigs.get(arch).gemm_shapes().items()}
_TABLE_V_GEMMS = {
    f"tableV:{name}": (k, n, torch.bfloat16 if name.startswith("bf16")
                       else torch.int8)
    for name, (m, k, n) in ARRAY_GEMMS.items()}


@pytest.mark.parametrize("label", sorted({**_MODEL_GEMMS, **_TABLE_V_GEMMS}))
def test_gemm_k_walk_is_the_same_for_every_m(label):
    """Rows independent of the batch: the K slices (their number and
    boundaries, the order each output is summed in) do not depend on M,
    for M = 1..1024; the slices cover [0, K) in order, none empty."""
    k, n, dtype = {**_MODEL_GEMMS, **_TABLE_V_GEMMS}[label]
    walks = {tgemm.k_walk(tgemm.plan(m, k, n, dtype), k, dtype)
             for m in range(1, 1025)}
    assert len(walks) == 1, walks
    (walk,) = walks
    assert walk[0][0] == 0 and walk[-1][1] == k
    assert all(lo < hi for lo, hi in walk)
    assert all(a[1] == b[0] for a, b in zip(walk, walk[1:]))
    assert len(walk) == tgemm.splits_for(k, n, dtype)
    for m in (1, 16, 17, 512):
        tgemm.check_plan(tgemm.plan(m, k, n, dtype), k, dtype)


@pytest.mark.parametrize("label", sorted(
    label for label, (k, n, dtype) in _MODEL_GEMMS.items()
    if k * n * dtype.itemsize > 4 * 2 ** 20))
def test_gemm_decode_plans_fill_the_card(label):
    """A decode GEMM whose weight exceeds 4 MiB is bound by its bytes: its
    plan gives every SM of the H100 at least one block, at M = 1..16.
    (Smaller weights, SmolLM's attention projections, are bound by
    latency.)"""
    k, n, dtype = _MODEL_GEMMS[label]
    for m in range(1, 17):
        p = tgemm.plan(m, k, n, dtype)
        assert p.bm == 16 and tgemm.blocks(p, m, n) >= tgemm.SMS, (m, p)


def test_gemm_plan_rejects_what_the_kernel_does_not_take():
    for dtype in (torch.float16, torch.int16, torch.float64):
        with pytest.raises(ValueError, match="takes"):
            tgemm.plan(3, 960, 960, dtype)
    with pytest.raises(ValueError, match="empty"):
        tgemm.plan(0, 960, 960, torch.bfloat16)
    good = tgemm.plan(3, 960, 960, torch.bfloat16)
    tgemm.check_plan(good, 960, torch.bfloat16)
    tgemm.check_plan(tgemm.plan(3, 129, 127, torch.float32), 129,
                     torch.float32)
    bad = [good._replace(bm=32), good._replace(bn=48),
           good._replace(splits=0), good._replace(splits=9),
           good._replace(cluster=2), good._replace(stages=1),
           good._replace(stages=9), tgemm.Plan(64, 64, 1, 0, 4),
           tgemm.Plan(128, 128, 1, 0, 8)]      # 280 KB of shared memory
    for p in bad:
        with pytest.raises(ValueError, match="does not take"):
            tgemm.check_plan(p, 960, torch.bfloat16)
    # More slices than K chunks (K = 100 is two chunks of 64 bf16).
    with pytest.raises(ValueError, match="does not take"):
        tgemm.check_plan(good._replace(splits=3), 100, torch.bfloat16)
    # f32 runs only on the SIMT kernel's tile.
    with pytest.raises(ValueError, match="does not take"):
        tgemm.check_plan(good, 960, torch.float32)
    # K shorter than one chunk: one slice.
    assert tgemm.plan(3, 10, 5000, torch.bfloat16).splits == 1


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def _attn_inputs(rng, b, hq, hkv, sq, sk, d):
    return (_both(_normal(rng, (b, hq, sq, d))),
            _both(_normal(rng, (b, hkv, sk, d))),
            _both(_normal(rng, (b, hkv, sk, d))))


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1), (15, 5)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_gqa_matches_jax_flash_attention(hq, hkv, causal):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(_rng(hq), 1, hq, hkv, 64,
                                                64, 32)
    want = jops.attention(jq, jk, jv, causal=causal, bq=32, bk=32,
                          mode="kernel")
    got = tops.attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,sk,q_offset", [(16, 80, 64), (33, 77, 44)])
def test_attention_q_offset_matches_jax(sq, sk, q_offset):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(_rng(sq), 1, 4, 2, sq, sk, 64)
    want = jops.attention(jq, jk, jv, causal=True, q_offset=q_offset,
                          bq=32, bk=32, mode="kernel")
    got = tops.attention(tq, tk, tv, causal=True, q_offset=q_offset)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_attention_kv_len_matches_jax_on_unmasked_rows():
    """kv_len < Sk: the JAX kernel takes kv_len as its padded-cache mask
    (its ops wrapper sets it to the unpadded Sk), so the reference is the
    JAX kernel on the cache cut to kv_len.  Every row keeps a valid key
    (q_offset >= 0, causal), so no row is fully masked: there the port's
    plain version gives 0 like the kernel, while JAX's oracle gives NaN."""
    (_, tq), (_, tk), (_, tv) = _attn_inputs(_rng(5), 1, 6, 2, 16, 64, 32)
    kv_len = 40
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in
                  (tq, tk[:, :, :kv_len], tv[:, :, :kv_len]))
    want = jops.attention(jq, jk, jv, causal=True, q_offset=20, bq=16,
                          bk=32, mode="kernel")
    got = tops.attention(tq, tk, tv, causal=True, q_offset=20,
                         kv_len=kv_len)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)
    # Keys past kv_len never matter: garbage there changes nothing.
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, :, kv_len:] = 1e4
    tv2[:, :, kv_len:] = -1e4
    same = tops.attention(tq, tk2, tv2, causal=True, q_offset=20,
                          kv_len=kv_len)
    assert torch.equal(same, got)


@pytest.mark.parametrize("sq,sk,q_offset", [(16, 36, 0), (33, 77, 44)])
def test_attention_smoke_head_dim_matches_jax(sq, sk, q_offset):
    """The SMOKE configs' prefill: 6/2 heads of 16 in f32."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(_rng(sq + 16), 2, 6, 2, sq,
                                                sk, 16)
    want = jops.attention(jq, jk, jv, causal=True, q_offset=q_offset,
                          bq=16, bk=32, mode="kernel")
    got = tops.attention(tq, tk, tv, causal=True, q_offset=q_offset)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_attention_fully_masked_row_is_zero():
    (_, tq), (_, tk), (_, tv) = _attn_inputs(_rng(6), 1, 2, 1, 4, 8, 32)
    out = tops.attention(tq, tk, tv, causal=False, kv_len=0)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("d", [64, 128, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_plan_kv_tile_depends_on_head_dim_and_dtype_only(d, dtype):
    """The KV tiles a row passes through start at multiples of the tile
    width from key 0, so the width is fixed by (D, dtype): every B, Sq and
    Sk of the serve path gives the same one (q_offset and kv_len are not
    even inputs of the plan), and every plan is one the kernel takes.
    (The bf16 route takes no head dim 16: its tile width raises.)"""
    if d not in tfa.HEAD_DIMS[dtype]:
        with pytest.raises(ValueError, match="head dims"):
            tfa.kv_tile(d, dtype)
        return
    widths = set()
    for b in (1, 2, 8):
        for hq, hkv in ((15, 5), (32, 8), (8, 8)):
            for sq in (1, 16, 33, 200, 232, 256, 488, 512, 4096):
                for sk in (16, 36, 48, 496, 512, 8192):
                    p = tfa.plan(b, hq, hkv, sq, sk, d, dtype)
                    tfa.check_plan(p, hq, hkv, d, dtype)
                    widths.add(p.kv_tile)
    assert widths == {tfa.kv_tile(d, dtype)}
    assert set(inspect.signature(tfa.plan).parameters) == {
        "b", "hq", "hkv", "sq", "sk", "d", "dtype"}
    for hq, hkv in ((15, 5), (32, 8), (8, 8)):
        cands = list(tfa.candidates(hq, hkv, d, dtype))
        for p in cands:
            tfa.check_plan(p, hq, hkv, d, dtype)
            assert p.kv_tile == tfa.kv_tile(d, dtype)
        for sq in (16, 488):
            assert tfa.plan(1, hq, hkv, sq, 496, d, dtype) in cands


def test_attention_plan_routes_by_dtype():
    """bf16 goes to the tensor cores, f32 to the SIMT kernel, whatever the
    shape: the route is not a fallback."""
    for sq, sk in ((16, 36), (488, 496), (512, 512)):
        assert tfa.plan(1, 15, 5, sq, sk, 64, torch.bfloat16).route == "tc"
        assert tfa.plan(1, 15, 5, sq, sk, 64, torch.float32) == tfa.Plan(
            "simt", 16, 1, 1, tfa.SIMT_KV_TILE)
    assert tfa.kv_tile(64, torch.bfloat16) == 64
    assert tfa.kv_tile(128, torch.float32) == 32


@pytest.mark.parametrize("d", [16, 32, 96, 256])
def test_attention_plan_raises_for_other_head_dims(d):
    """16 is the SMOKE configs' head dim: the f32 SIMT route takes it
    (test_attention_plan_f32_takes_the_smoke_head_dim), bf16 does not."""
    for dtype in (torch.bfloat16, torch.float32):
        if d in tfa.HEAD_DIMS[dtype]:
            continue
        with pytest.raises(ValueError, match="head dims"):
            tfa.plan(1, 4, 2, 16, 32, d, dtype)
    with pytest.raises(ValueError, match="head dims"):
        tfa.plan(1, 4, 2, 16, 32, d, torch.bfloat16)


@pytest.mark.parametrize("sq,sk", [(16, 36), (33, 77), (1, 48)])
def test_attention_plan_f32_takes_the_smoke_head_dim(sq, sk):
    """The SMOKE configs (6/2 heads of 16, f32) prefill on the SIMT kernel's
    one plan; the same shapes in bf16 raise."""
    assert tfa.HEAD_DIMS[torch.float32] == (16, 64, 128)
    p = tfa.plan(1, 6, 2, sq, sk, 16, torch.float32)
    assert p == tfa.Plan("simt", 16, 1, 1, tfa.SIMT_KV_TILE)
    tfa.check_plan(p, 6, 2, 16, torch.float32)
    assert list(tfa.candidates(6, 2, 16, torch.float32)) == [p]
    with pytest.raises(ValueError, match="head dims"):
        tfa.plan(1, 6, 2, sq, sk, 16, torch.bfloat16)


def test_attention_plan_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="f32 or bf16"):
        tfa.plan(1, 4, 2, 16, 32, 64, torch.float16)
    with pytest.raises(ValueError, match="hq % hkv"):
        tfa.plan(1, 6, 4, 16, 32, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="empty"):
        tfa.plan(1, 4, 2, 0, 32, 64, torch.bfloat16)
    good = tfa.plan(1, 15, 5, 488, 496, 64, torch.bfloat16)
    for bad in (good._replace(kv_tile=32), good._replace(rows=48),
                good._replace(heads=2), good._replace(stages=5),
                good._replace(route="simt"),
                tfa.Plan("tc", 64, 3, 2, 64),          # 12 warps
                tfa.Plan("tc", 16, 1, 1, 64)):         # a 1-tile ring
        with pytest.raises(ValueError, match="does not take"):
            tfa.check_plan(bad, 15, 5, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        tfa.check_plan(good, 15, 5, 64, torch.float32)


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,sk,d", [
    pytest.param(8, 2, 256, 64, id="8-2-256"),
    pytest.param(15, 5, 100, 64, id="15-5-100"),
    (8, 2, 256, 16), (15, 5, 100, 16)])
def test_decode_matches_jax_flash_decode(hq, hkv, sk, d):
    rng = _rng(sk + (d != 64) * d)
    jq, tq = _both(_normal(rng, (3, hq, d)))
    jk, tk = _both(_normal(rng, (3, hkv, sk, d)))
    jv, tv = _both(_normal(rng, (3, hkv, sk, d)))
    lengths = np.asarray([sk, sk // 2, 7], np.int32)
    want = jops.decode(jq, jk, jv, length=jnp.asarray(lengths), bk=128,
                       mode="kernel")
    got = tops.decode(tq, tk, tv, length=torch.from_numpy(lengths))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
def test_decode_chunk_depends_on_head_dim_and_kv_dtype_only(d, kv_dtype):
    """A slot's keys split into chunks counted from key 0 whose size is
    fixed by (D, KV dtype) alone -- the function takes nothing else, so no
    B, length, max_pages or Sk can move a chunk boundary -- and is a
    multiple of the kernels' 32-key tile."""
    assert set(inspect.signature(tdec.decode_chunk).parameters) == {
        "d", "kv_dtype"}
    c = tdec.decode_chunk(d, kv_dtype)
    assert c % tfa.SIMT_KV_TILE == 0 and c >= tfa.SIMT_KV_TILE
    assert tdec.decode_chunk(d, kv_dtype) == c


@pytest.mark.parametrize("d", [32, 96, 256])
def test_decode_chunk_raises_for_other_head_dims(d):
    with pytest.raises(ValueError, match="head dims"):
        tdec.decode_chunk(d, torch.bfloat16)
    with pytest.raises(ValueError, match="KV dtypes"):
        tdec.decode_chunk(64, torch.float16)


def test_decode_wrappers_take_head_dim_16_in_f32_only():
    """The SMOKE configs decode in f32 at head dim 16 (f32 and int8 pools);
    the plain versions run it on the CPU, and the CUDA path's checks take
    it in f32 and refuse it in bf16 with "head dims"."""
    assert tfa.HEAD_DIMS[torch.float32] == (16, 64, 128)
    tfa.check_head_dim("flash_decode", 16, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        tfa.check_head_dim("flash_paged_decode", 16, torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dims"):
            tfa.check_head_dim("flash_decode", 96, dtype)
    rng = _rng(16)
    q = torch.from_numpy(_normal(rng, (2, 6, 16)))
    k = torch.from_numpy(_normal(rng, (2, 2, 40, 16)))
    v = torch.from_numpy(_normal(rng, (2, 2, 40, 16)))
    length = torch.tensor([40, 3], dtype=torch.int32)
    out = flash_decode(q, k, v, length=length)
    assert torch.equal(out, tref.ref_decode_attention(q, k, v, length=length))


def test_decode_length_zero_is_zero_and_over_long_is_clamped():
    rng = _rng(9)
    tq = torch.from_numpy(_normal(rng, (2, 4, 32)))
    tk = torch.from_numpy(_normal(rng, (2, 2, 24, 32)))
    tv = torch.from_numpy(_normal(rng, (2, 2, 24, 32)))
    out = tops.decode(tq, tk, tv, length=torch.tensor([0, 99]))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    full = tops.decode(tq, tk, tv, length=torch.tensor([24, 24]))
    assert torch.equal(out[1], full[1])


# ---------------------------------------------------------------------------
# Rejections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ref", "kernel"])
def test_rejects_non_divisible_gqa(mode):
    """hq % hkv != 0 raises on every path, before any kernel is reached
    (so the kernel mode raises the GQA error here, not the CPU one)."""
    rng = _rng(3)
    q4 = torch.from_numpy(_normal(rng, (1, 5, 32, 16)))
    kv4 = torch.from_numpy(_normal(rng, (1, 3, 32, 16)))
    with pytest.raises(ValueError, match="divisible"):
        tops.attention(q4, kv4, kv4, mode=mode)
    q3 = torch.from_numpy(_normal(rng, (2, 6, 16)))
    kv3 = torch.from_numpy(_normal(rng, (2, 4, 64, 16)))
    with pytest.raises(ValueError, match="divisible"):
        tops.decode(q3, kv3, kv3, mode=mode)


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_decode_rejects_bad_length_shape(mode):
    rng = _rng(4)
    q = torch.from_numpy(_normal(rng, (3, 4, 16)))
    kv = torch.from_numpy(_normal(rng, (3, 2, 32, 16)))
    with pytest.raises(ValueError, match="per-slot"):
        tops.decode(q, kv, kv, length=torch.tensor(5), mode=mode)


def test_kernel_mode_on_cpu_tensors_raises():
    rng = _rng(2)
    a = torch.from_numpy(_normal(rng, (8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        tops.matmul(a, a.t().contiguous(), mode="kernel")
    q = torch.from_numpy(_normal(rng, (1, 2, 8, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        tops.attention(q, q, q, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tops.decode(q[:, :, 0], q, q, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tops.decode(q[:, :, 0], q, q, length=torch.tensor([3]),
                    mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tops.rmsnorm(a, torch.ones(16), mode="kernel")


def _kernel_calls(dev, grad):
    """One call of each kernel wrapper on tensors of ``dev``."""
    f = dict(device=dev, requires_grad=grad)
    a, bm = torch.ones((4, 8), **f), torch.ones((8, 4), **f)
    q4, kv4 = torch.ones((1, 2, 4, 64), **f), torch.ones((1, 2, 8, 64), **f)
    q3 = torch.ones((1, 2, 64), **f)
    length = torch.ones((1,), dtype=torch.int32, device=dev)
    pool = torch.ones((2, 2, 4, 64), **f)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    x = torch.ones((1, 2, 3, 64), **f)
    u = torch.ones((2, 64), **f)
    return {
        "gama_gemm": lambda: gama_gemm(a, bm),
        "flash_attention": lambda: flash_attention(q4, kv4, kv4),
        "flash_decode": lambda: flash_decode(q3, kv4, kv4, length=length),
        "flash_paged_decode": lambda: flash_paged_decode(
            q3, pool, pool, table, length=length),
        "wkv6": lambda: wkv6(x, x, x, x, u),
        "wkv6_bwd": lambda: wkv6_bwd(x, x, x, x, u, x),
        "rmsnorm": lambda: rmsnorm(x, u[0]),
    }


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """A launched kernel's output has no grad_fn, so a gradient through it
    would silently be zero: off the CPU, every wrapper raises when autograd
    is on and an input requires grad.  Meta tensors reach that branch
    without a card; under no_grad the same calls get past the check to the
    device check.  (The plain versions on CPU tensors stay differentiable.)"""
    for name, call in _kernel_calls("meta", True).items():
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()
    for name, call in _kernel_calls("cpu", True).items():
        out = call()
        out = out[0] if isinstance(out, tuple) else out
        assert out.requires_grad, name


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype,tol", [
    (torch.bfloat16, torch.bfloat16, 1e-2), (torch.float32, torch.float32,
                                             1e-4),
    (torch.int8, torch.int32, 0), (torch.int8, torch.int16, 0),
    (torch.int8, torch.int8, 0)])
def test_cuda_gemm_matches_plain(dtype, out_dtype, tol):
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in [(3, 960, 320), (16, 2560, 960), (257, 129, 127)]:
        if dtype == torch.int8:
            a = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                              dtype=torch.int8)
            b = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                              dtype=torch.int8)
        else:
            a = torch.randn((m, k), generator=g, device="cuda").to(dtype)
            b = (torch.randn((k, n), generator=g, device="cuda")
                 / k ** 0.5).to(dtype)
        got = gama_gemm(a, b, out_dtype=out_dtype, scale=0.01)
        want = tops.matmul(a, b, out_dtype=out_dtype, scale=0.01, mode="ref")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _cuda_gemm_inputs(g, m, k, n, dtype):
    if dtype == torch.int8:
        return (torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                              dtype=torch.int8),
                torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                              dtype=torch.int8))
    return (torch.randn((m, k), generator=g, device="cuda").to(dtype),
            (torch.randn((k, n), generator=g, device="cuda")
             / k ** 0.5).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.int8, torch.int32),
    (torch.int8, torch.int16), (torch.int8, torch.int8)])
def test_cuda_gemm_ragged_shapes(dtype, out_dtype):
    """M, K and N off every tile multiple, pitches that are and are not 16
    bytes (cp.async or element loads), K shorter than one chunk and
    slices of one chunk.  bf16 within 1e-2 * (1 + |plain|): both round one
    f32 sum to bf16 in another order.  int8 exact, with scales that put
    part of the int16/int8 outputs in saturation."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    scale = {torch.int16: 0.05, torch.int8: 0.002}.get(out_dtype, 1.0)
    for m, k, n in [(1, 10, 5000), (3, 40, 77), (5, 100, 33),
                    (7, 136, 200), (13, 129, 127), (17, 333, 250),
                    (33, 1000, 130), (70, 272, 1000), (257, 129, 127),
                    (3, 960, 960), (3, 2560, 960)]:
        a, b = _cuda_gemm_inputs(g, m, k, n, dtype)
        got = gama_gemm(a, b, out_dtype=out_dtype, scale=scale)
        want = tops.matmul(a, b, out_dtype=out_dtype, scale=scale,
                           mode="ref")
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (m, n)
        if dtype == torch.int8:
            assert torch.equal(got, want), (m, k, n)
        else:
            err = (got.double() - want.double()).abs()
            assert (err <= 1e-2 * (1 + want.double().abs())).all(), (
                m, k, n, err.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(_MODEL_GEMMS))
def test_cuda_gemm_rows_independent_of_batch(label):
    """Every row of an M-row product is bit for bit the row computed
    alone (M = 1), at M = 3, 8, 16 and 512: what the serving engine's
    --verify needs of a multi-slot batch against a one-slot engine."""
    _require_cuda()
    k, n, dtype = _MODEL_GEMMS[label]
    g = torch.Generator(device="cuda").manual_seed(k + n)
    a, b = _cuda_gemm_inputs(g, 512, k, n, dtype)
    alone = torch.cat([gama_gemm(a[i:i + 1], b) for i in range(512)])
    for m in (3, 8, 16, 512):
        got = gama_gemm(a[:m].contiguous(), b)
        torch.cuda.synchronize()
        same = (got == alone[:m]).all(dim=1)
        assert same.all(), (m, (~same).nonzero().flatten().tolist()[:8])


@pytest.mark.cuda
def test_cuda_gemm_refuses_a_plan_it_does_not_take():
    """The kernel checks the plan itself: a plan that check_plan rejects
    raises from the launch and writes nothing."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    a, b = _cuda_gemm_inputs(g, 3, 100, 64, torch.bfloat16)
    good = tgemm.plan(3, 100, 64, torch.bfloat16)
    for p in [good._replace(bm=32), good._replace(splits=3),
              good._replace(splits=9), good._replace(cluster=2),
              good._replace(stages=9), tgemm.Plan(128, 128, 1, 0, 8)]:
        with pytest.raises(ValueError):
            tgemm.check_plan(p, 100, torch.bfloat16)
        out = torch.zeros((3, 64), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="invalid argument"):
            tgemm.launch(a, b, out, p)
        torch.cuda.synchronize()
        assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
def test_cuda_flash_attention_matches_plain(dtype, tol):
    """The serve path's prefill shapes (SmolLM-360M's 15/5 heads at the
    16-token bucket against 36- and 48-row caches, the 488-token bucket
    against the 496-row scratch cache, 512 x 512), a ragged batch at a
    q_offset, Qwen3-8B's 32/8 heads of 128, and in f32 the SMOKE configs'
    6/2 heads of 16.  bf16 within 2e-2 * (1 +
    |plain|): P is rounded to bf16 for P.V and the output once from f32;
    f32 at the JAX suite's 2e-5."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    for (b, hq, hkv, sq, sk, d, off) in [(1, 15, 5, 16, 36, 64, 0),
                                          (1, 15, 5, 16, 48, 64, 0),
                                          (1, 15, 5, 488, 496, 64, 0),
                                          (1, 15, 5, 512, 512, 64, 0),
                                          (2, 8, 2, 33, 77, 64, 44),
                                          (1, 32, 8, 16, 40, 128, 0),
                                          (1, 32, 8, 16, 48, 128, 0),
                                          (1, 32, 8, 512, 512, 128, 0),
                                          (1, 6, 2, 16, 36, 16, 0),
                                          (2, 6, 2, 33, 77, 16, 44)]:
        if d not in tfa.HEAD_DIMS[dtype]:
            continue           # the SMOKE head dim, 16: f32 only
        q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype)
        got = flash_attention(q, k, v, causal=True, q_offset=off)
        want = tops.attention(q, k, v, causal=True, q_offset=off, mode="ref")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _cuda_attn_case(g, b, hq, hkv, sq, sk, d, dtype=torch.bfloat16):
    return (torch.randn((b, hq, sq, d), generator=g, device="cuda").to(dtype),
            torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype),
            torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
def test_cuda_flash_attention_kv_len_and_masked_rows(dtype, tol):
    """kv_len < Sk, causal and not, with keys past kv_len set to values
    that would swamp the softmax: they change nothing.  A fully masked row
    (kv_len = 0, or every key in its future) is exactly 0."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(7)
    for (hq, hkv, sq, sk, d, off, kv_len, causal) in [
            (15, 5, 100, 160, 64, 40, 130, True),
            (15, 5, 70, 200, 64, 0, 93, False),
            (32, 8, 40, 300, 128, 200, 230, True)]:
        q, k, v = _cuda_attn_case(g, 1, hq, hkv, sq, sk, d, dtype)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, kv_len:], v2[:, :, kv_len:] = 1e4, -1e4
        got = flash_attention(q, k2, v2, causal=causal, q_offset=off,
                              kv_len=kv_len)
        want = tops.attention(q, k, v, causal=causal, q_offset=off,
                              kv_len=kv_len, mode="ref")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(got, flash_attention(
            q, k, v, causal=causal, q_offset=off, kv_len=kv_len))
    q, k, v = _cuda_attn_case(g, 2, 15, 5, 80, 96, 64, dtype)
    for causal in (True, False):
        out = flash_attention(q, k, v, causal=causal, kv_len=0)
        assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_attention_rows_independent_of_chunking(d):
    """A row's bits do not depend on how the prompt is split: 488 tokens
    prefilled whole against a 496-row cache equal, row for row under
    torch.equal, the same rows prefilled as [0, 256) + [256, 488) or the
    unaligned [0, 200) + [200, 488) at runtime q_offsets; and every row of
    a B=2 call equals the same row of each B=1 call."""
    _require_cuda()
    hq, hkv = (15, 5) if d == 64 else (32, 8)
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = _cuda_attn_case(g, 2, hq, hkv, 488, 496, d)
    whole = flash_attention(q, k, v, causal=True)
    for cut in (256, 200):
        parts = [flash_attention(q[:, :, lo:hi].contiguous(), k, v,
                                 causal=True, q_offset=lo)
                 for lo, hi in ((0, cut), (cut, 488))]
        assert torch.equal(torch.cat(parts, dim=2), whole), cut
    for i in range(2):
        alone = flash_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                v[i:i + 1].contiguous(), causal=True)
        assert torch.equal(alone, whole[i:i + 1]), i


@pytest.mark.cuda
def test_cuda_flash_attention_every_plan_gives_the_same_bits():
    """Every plan the kernel takes (query rows, packed GQA heads, ring
    depth) gives the default plan's bits, at the prefill shapes."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(9)
    for (hq, hkv, sq, sk, d) in [(15, 5, 16, 48, 64), (15, 5, 488, 496, 64),
                                 (32, 8, 100, 300, 128)]:
        q, k, v = _cuda_attn_case(g, 1, hq, hkv, sq, sk, d)
        want = flash_attention(q, k, v, causal=True, q_offset=sk - sq)
        n = 0
        for p in tfa.candidates(hq, hkv, d, torch.bfloat16):
            got = torch.empty_like(q)
            tfa.launch(q, k, v, got, p, causal=True, scale=d ** -0.5,
                       q_offset=sk - sq, kv_len=sk)
            torch.cuda.synchronize()
            assert torch.equal(got, want), p
            n += 1
        assert n >= 12


@pytest.mark.cuda
def test_cuda_flash_attention_misaligned_operands_are_copied():
    """cp.async needs 16-byte aligned rows: q, k and v that start 2 bytes
    off that boundary give the aligned operands' bits."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = _cuda_attn_case(g, 1, 15, 5, 40, 64, 64)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view
    want = flash_attention(q, k, v, causal=True, q_offset=24)
    got = flash_attention(shifted(q), shifted(k), shifted(v), causal=True,
                          q_offset=24)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_a_plan_it_does_not_take():
    """The kernel checks the plan itself: a plan that check_plan rejects
    raises from the launch and writes nothing."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = _cuda_attn_case(g, 1, 15, 5, 40, 64, 64)
    good = tfa.plan(1, 15, 5, 40, 64, 64, torch.bfloat16)
    for p in [good._replace(kv_tile=32), good._replace(rows=48),
              good._replace(heads=2), good._replace(stages=5),
              good._replace(route="simt"), tfa.Plan("tc", 64, 3, 2, 64)]:
        with pytest.raises(ValueError):
            tfa.check_plan(p, 15, 5, 64, torch.bfloat16)
        out = torch.zeros_like(q)
        with pytest.raises(RuntimeError, match="invalid argument"):
            tfa.launch(q, k, v, out, p, causal=True, scale=0.125,
                       q_offset=0, kv_len=64)
        torch.cuda.synchronize()
        assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
def test_cuda_flash_decode_matches_plain(dtype, tol):
    """The smoke6 shape, Qwen3-8B's heads, slots of 517 and 4096 keys (many
    chunks, merged) beside a zero-length and a one-key slot, and in f32
    the SMOKE head dim 16."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    for (hq, hkv, sk, d, lengths) in [(15, 5, 36, 64, [36, 0, 7]),
                                      (32, 8, 100, 128, [100, 0, 7]),
                                      (15, 5, 4100, 64, [4096, 517, 0, 1]),
                                      (32, 8, 4096, 128, [517, 4096, 9]),
                                      (6, 2, 600, 16, [600, 0, 517, 64])]:
        if d not in tfa.HEAD_DIMS[dtype]:
            continue
        b = len(lengths)
        q = torch.randn((b, hq, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype)
        length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = flash_decode(q, k, v, length=length)
        want = tops.decode(q, k, v, length=length, mode="ref")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _cuda_paged_case(g, dtype, pool, hq, hkv, d, ps, lengths):
    """Pools with shuffled, disjoint per-slot pages and null-sink tails."""
    slot_pages = [-(-n // ps) for n in lengths]
    n_pool, max_pages = sum(slot_pages) + 3, max(slot_pages) + 1
    perm = torch.randperm(n_pool, generator=g, device="cuda").tolist()
    bt = torch.full((len(lengths), max_pages), n_pool, dtype=torch.int32)
    for i, n in enumerate(slot_pages):
        bt[i, :n], perm = torch.tensor(perm[:n]), perm[n:]
    q = torch.randn((len(lengths), hq, d), generator=g, device="cuda")
    pools = [torch.randn((n_pool + 1, hkv, ps, d), generator=g,
                         device="cuda").to(dtype) for _ in range(2)]
    scales = {}
    if pool == "int8":
        (kq, ks), (vq, vs) = (tquant.quantize_kv_pages(p) for p in pools)
        pools, scales = [kq, vq], {"k_scale": ks, "v_scale": vs}
    return (q.to(dtype), pools[0], pools[1], bt.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), scales)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
def test_cuda_flash_paged_decode_matches_plain(dtype, tol, pool):
    """Both buffering variants against the plain version, bit-identical to
    each other; page sizes that straddle the kernel's 32-key tiles; a
    zero-length slot; slots of 517 and 4096 keys (many chunks, merged);
    a NaN null sink that changes nothing; a float pool bit-identical to
    flash_decode on the gathered cache; and in f32 the SMOKE head dim 16
    (f32 and int8 pools)."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    for (hq, hkv, d, ps) in [(15, 5, 64, 16), (32, 8, 128, 7),
                             (8, 8, 64, 5), (6, 2, 16, 16)]:
        if d not in tfa.HEAD_DIMS[dtype]:
            continue
        q, kp, vp, bt, ln, sc = _cuda_paged_case(
            g, dtype, pool, hq, hkv, d, ps, [0, 1, 33, 100, 64, 517, 4096])
        one, two = (flash_paged_decode(q, kp, vp, bt, length=ln, buffers=n,
                                       **sc) for n in (1, 2))
        want = tops.decode_paged(q, kp, vp, block_tables=bt, length=ln,
                                 mode="ref", **sc)
        sink = kp.shape[0] - 1
        kn, vn = kp.clone(), vp.clone()
        scn = {k: v.clone() for k, v in sc.items()}
        for t in (scn.values() if pool == "int8" else (kn, vn)):
            t[sink] = float("nan")
        nan_sink = flash_paged_decode(q, kn, vn, bt, length=ln, **scn)
        torch.cuda.synchronize()
        torch.testing.assert_close(two.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(one, two) and torch.equal(nan_sink, two)
        assert (two[0] == 0).all()
        if pool == "float":
            dense = flash_decode(q, tref.gather_pages(kp, bt).contiguous(),
                                 tref.gather_pages(vp, bt).contiguous(),
                                 length=ln)
            assert torch.equal(dense, two)


def _chunk_lengths(c):
    """Lengths on and around the chunk boundaries, and two long slots."""
    return [1, c - 1, c, c + 1, 2 * c - 1, 2 * c, 2 * c + 1, 517, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pool,d", [
    (torch.bfloat16, "float", 64), (torch.bfloat16, "int8", 128),
    (torch.float32, "float", 16), (torch.float32, "int8", 16),
    (torch.float32, "float", 64)])
def test_cuda_decode_lengths_across_chunk_boundaries(dtype, pool, d):
    """Slots that end just before, on and just after a chunk boundary, and
    long ones, against the plain version; paged == dense on the gathered
    cache for float pools."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    kvd = torch.int8 if pool == "int8" else dtype
    lengths = _chunk_lengths(tdec.decode_chunk(d, kvd))
    hq, hkv = (15, 5) if d != 128 else (32, 8)
    q, kp, vp, bt, ln, sc = _cuda_paged_case(g, dtype, pool, hq, hkv, d, 16,
                                             lengths)
    got = flash_paged_decode(q, kp, vp, bt, length=ln, **sc)
    want = tops.decode_paged(q, kp, vp, block_tables=bt, length=ln,
                             mode="ref", **sc)
    # A length past max_pages * ps is clamped to it, as the plain version
    # reads it.
    over = ln.clone()
    over[-1] = 10 ** 6
    got_over = flash_paged_decode(q, kp, vp, bt, length=over, **sc)
    want_over = tops.decode_paged(q, kp, vp, block_tables=bt, length=over,
                                  mode="ref", **sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_over.float(), want_over.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(got_over[:-1], got[:-1])
    if pool == "float":
        kc = tref.gather_pages(kp, bt).contiguous()
        vc = tref.gather_pages(vp, bt).contiguous()
        dense = flash_decode(q, kc, vc, length=ln)
        torch.cuda.synchronize()
        assert torch.equal(dense, got)
        torch.testing.assert_close(
            dense.float(), tops.decode(q, kc, vc, length=ln,
                                       mode="ref").float(),
            rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pool,d", [
    (torch.bfloat16, "float", 64), (torch.bfloat16, "int8", 64),
    (torch.float32, "float", 16), (torch.float32, "int8", 16)])
def test_cuda_decode_slot_bits_independent_of_batch_and_cache_size(
        dtype, pool, d):
    """A slot's output is bit for bit the same alone (B=1), in a batch of 8,
    with max_pages doubled (the paged kernel) and with Sk doubled (the dense
    one): the chunks depend on key positions only."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    lengths = [449, 487, 1, 64, 65, 517, 4096, 130]
    q, kp, vp, bt, ln, sc = _cuda_paged_case(g, dtype, pool, 15, 5, d, 16,
                                             lengths)
    batch = flash_paged_decode(q, kp, vp, bt, length=ln, **sc)
    wide = torch.cat([bt, torch.full_like(bt, kp.shape[0] - 1)], dim=1)
    doubled = flash_paged_decode(q, kp, vp, wide, length=ln, **sc)
    assert torch.equal(doubled, batch)
    for i in range(len(lengths)):
        alone = flash_paged_decode(q[i:i + 1], kp, vp, bt[i:i + 1],
                                   length=ln[i:i + 1], **sc)
        assert torch.equal(alone, batch[i:i + 1]), (pool, i)
    if pool == "float":
        kc = tref.gather_pages(kp, bt).contiguous()
        vc = tref.gather_pages(vp, bt).contiguous()
        dense = flash_decode(q, kc, vc, length=ln)
        assert torch.equal(dense, batch)
        long_k = torch.cat([kc, torch.zeros_like(kc)], dim=2)
        long_v = torch.cat([vc, torch.zeros_like(vc)], dim=2)
        assert torch.equal(flash_decode(q, long_k, long_v, length=ln), dense)
        for i in (0, 6):
            alone = flash_decode(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                                 length=ln[i:i + 1])
            assert torch.equal(alone, dense[i:i + 1])


@pytest.mark.cuda
def test_cuda_flash_decode_misaligned_cache_is_copied():
    """The dense kernel copies 16-byte chunks of K and V: a cache that
    starts 2 bytes off that boundary is copied first, with the same
    output."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((2, 15, 64), generator=g, device="cuda").bfloat16()
    flat = torch.randn(2 * 5 * 100 * 64 + 1, generator=g,
                       device="cuda").bfloat16()
    k = flat[1:].view(2, 5, 100, 64)
    assert k.data_ptr() % 16 and k.is_contiguous()
    length = torch.tensor([100, 37], dtype=torch.int32, device="cuda")
    got = flash_decode(q, k, k, length=length)
    want = flash_decode(q, k.clone(), k.clone(), length=length)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_decode_refuses_another_chunk_and_bf16_head_dim_16():
    """The entry points check the chunk size against their own table, and
    bf16 q takes no head dim 16."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    q, kp, vp, bt, ln, _ = _cuda_paged_case(g, torch.float32, "float", 4, 2,
                                            16, 16, [100, 3])
    out = torch.empty_like(q)
    chunk = tdec.decode_chunk(16, torch.float32)
    for bad in (chunk // 2, chunk * 2):
        with pytest.raises(RuntimeError, match="launch failed"):
            tdec.launch_paged(tdec._paged_lib(), bad, q, kp, vp, bt, ln, out,
                              0.25, None, None, 2)
        with pytest.raises(RuntimeError, match="launch failed"):
            tdec.launch(tdec._lib(), bad, q, kp, vp, ln, out, 0.25)
    with pytest.raises(ValueError, match="head dims"):
        flash_paged_decode(q.bfloat16(), kp.bfloat16(), vp.bfloat16(), bt,
                           length=ln)
    kc = tref.gather_pages(kp, bt).contiguous().bfloat16()
    with pytest.raises(ValueError, match="head dims"):
        flash_decode(q.bfloat16(), kc, kc, length=ln)


def _cuda_wkv_case(g, b, h, t, n, dtype):
    """Inputs of the training path's scale: decays from the real decay's
    range exp(-exp(x)), x in [-8, 2] (down to ~6e-4), r/k/v ~ N(0, 0.25)."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = ((randn(b, h, t, n) * 0.5).to(dtype) for _ in range(3))
    x = torch.rand((b, h, t, n), generator=g, device="cuda") * 10 - 8
    w = torch.exp(-torch.exp(x))
    u = randn(h, n) * 0.1
    gy = randn(b, h, t, n).to(dtype)
    return r, k, v, w, u, gy


def _close_to_max(got, want, tol):
    """|got - want| <= tol * max(1, max|want|): the kernels and the plain
    versions sum in different orders, so where a sum cancels the error is
    relative to the terms, not to the result."""
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert got.dtype == want.dtype and err <= tol * scale, (err, scale)


def _past_chunk_edge(n, dtype):
    """The shortest T > wkv_chunk(T) that ends one step into a chunk."""
    return next(t for t in range(2, 4097)
                if t % twkv.wkv_chunk(t, n, dtype) == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,h,t,n,w_zero", [
    (8, 40, 64, 64, False), (8, 40, 100, 64, False), (2, 4, 37, 16, False),
    (2, 4, 1, 64, False), (2, 4, "edge", 64, False), (1, 40, 4096, 64, False),
    (2, 4, 100, 16, True)])
def test_cuda_wkv6_and_bwd_match_plain(b, h, t, n, w_zero, dtype, tol):
    """The training shape, a ragged T, the SMOKE head size, one step, a T
    one step past a chunk edge, the long prompt, and decays of exactly 0
    in places (a chunk's decay product underflows to 0: no division may
    follow).  bf16 outputs round once from f32 (one ulp is 2**-8 of the
    value); f32 at 1e-4 of the largest value.  Both kernels repeat their
    bits (no atomics)."""
    _require_cuda()
    if t == "edge":
        t = _past_chunk_edge(n, dtype)
    g = torch.Generator(device="cuda").manual_seed(t + n)
    r, k, v, w, u, gy = _cuda_wkv_case(g, b, h, t, n, dtype)
    if w_zero:
        w[:, :, ::7] = 0.0
        w[:, :, 3::11, : n // 2] = 1.0
    y = wkv6(r, k, v, w, u)
    y_again = wkv6(r, k, v, w, u)
    grads = wkv6_bwd(r, k, v, w, u, gy)
    again = wkv6_bwd(r, k, v, w, u, gy)
    want_y = tops.wkv(r, k, v, w, u, mode="ref")
    want = tref.ref_wkv_bwd(r, k, v, w, u, gy)
    torch.cuda.synchronize()
    _close_to_max(y, want_y, tol)
    for got_g, want_g in zip(grads, want):
        _close_to_max(got_g, want_g, tol if got_g.dtype == dtype else 1e-4)
    assert torch.equal(y, y_again)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(grads, again))


# The norms of the serve path: SmolLM-360M (960 bf16), the SMOKE configs
# (96 f32), Qwen3-8B's qk_norm (128 bf16) and d_model (4096 bf16), and rows
# that are not a whole number of 16-byte vectors.
@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [
    (960, torch.bfloat16), (96, torch.float32), (128, torch.bfloat16),
    (4096, torch.bfloat16), (100, torch.bfloat16), (35, torch.float32)])
def test_cuda_rmsnorm_matches_plain_and_rows_do_not_depend_on_the_call(
        d, dtype):
    """Within 1e-6 relative of the plain version (float64 sums) in f32 and
    one bf16 ulp in bf16; every row torch.equal at M = 1, 3, 8, 488 and
    512 and computed alone."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(d)
    x = (torch.randn((512, d), generator=g, device="cuda") * 3).to(dtype)
    scale = 1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
    whole = rmsnorm(x, scale)
    want = tops.rmsnorm(x, scale, mode="ref")
    torch.cuda.synchronize()
    assert whole.dtype == dtype and torch.isfinite(whole.float()).all()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    err = (whole.double() - want.double()).abs()
    assert bool((err <= tol * want.double().abs() + 1e-30).all()), \
        err.max().item()
    for m in (1, 3, 8, 488):
        assert torch.equal(rmsnorm(x[:m].contiguous(), scale), whole[:m]), m
    alone = torch.cat([rmsnorm(x[i:i + 1].contiguous(), scale)
                       for i in range(16)])
    assert torch.equal(alone, whole[:16])
    # A view off the 16-byte boundary is copied, not read misaligned.
    if vec_width(d, dtype) > 1:
        odd = torch.empty(512 * d + 1, dtype=dtype, device="cuda")[1:]
        odd = odd.view(512, d).copy_(x)
        assert torch.equal(rmsnorm(odd, scale), whole)


@pytest.mark.cuda
@pytest.mark.parametrize("q_shape,s_shape", [
    ((3, 40, 32), (3, 32)), ((960, 49152, 1), (960, 1)),
    ((2, 5, 48), (48,)), ((3, 7, 10), (3, 10)), ((17, 5, 1), (17, 1))])
def test_cuda_dequant_bit_equal_to_plain(q_shape, s_shape):
    """The dequant kernel against its plain version, bit for bit, in f32
    and bf16: the 16-code path (N a multiple of 16, or one scale a row),
    the one-code path, and a code view off the 16-byte boundary."""
    _require_cuda()
    from repro_torch.kernels.dequant import dequantize
    g = torch.Generator(device="cuda").manual_seed(q_shape[-1])
    q = torch.randint(-127, 128, q_shape, generator=g, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand(s_shape, generator=g, device="cuda") * 0.02
    for dtype in (torch.float32, torch.bfloat16):
        got = dequantize(q, scale, dtype)
        assert torch.equal(got, tops.dequantize(q, scale, dtype, mode="ref"))
        odd = torch.empty(q.numel() + 1, dtype=torch.int8,
                          device="cuda")[1:].view(q_shape).copy_(q)
        assert torch.equal(dequantize(odd, scale, dtype), got)


def _cuda_scan_case(g, b, t, di, n, dtype):
    dt = (torch.rand((b, t, di), generator=g, device="cuda") * 0.2).to(dtype)
    x, bm, c = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                for shape in ((b, t, di), (b, t, n), (b, t, n)))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda")[None] \
        * (0.2 + torch.rand((di, 1), generator=g, device="cuda"))
    h0 = torch.randn((b, di, n), generator=g, device="cuda")
    return dt, x, bm, c, a, h0


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,di,n,dtype", [
    (8, 1, 8192, 16, torch.bfloat16), (1, 11, 8192, 16, torch.bfloat16),
    (1, 448, 8192, 16, torch.bfloat16), (8, 1, 8192, 16, torch.float32),
    (1, 448, 8192, 16, torch.float32), (3, 12, 128, 8, torch.float32),
    (2, 40, 100, 5, torch.float32)])
def test_cuda_selective_scan_matches_plain_and_rows_do_not_depend_on_batch(
        b, t, di, n, dtype):
    """Within 1e-5 relative of the plain version in f32 (y and the final
    state); in bf16, y within one bf16 ulp (2**-7 * |plain|, plus 2**-16
    for the f32 contraction's other summation order before the cast) and
    the f32 state within 1e-5; h0 x 1.01 breaks those bounds in either
    dtype; each sequence alone gives its rows of the batch bit for bit,
    and two calls repeat their bits."""
    _require_cuda()
    from repro_torch.kernels.selective_scan import selective_scan
    g = torch.Generator(device="cuda").manual_seed(t + n)
    args = _cuda_scan_case(g, b, t, di, n, dtype)
    y, h = selective_scan(*args)
    y2, h2 = selective_scan(*args)
    want_y, want_h = tops.selective_scan(*args, mode="ref")
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)

    def within(got, want, is_y):
        err = (got.double() - want.double()).abs()
        w = want.double().abs()
        if not is_y or dtype == torch.float32:
            return bool((err <= 1e-5 * (1 + w)).all())
        return bool((err <= 2.0 ** -7 * w + 2.0 ** -16).all())

    assert within(y, want_y, True) and within(h, want_h, False)
    yc, hc = selective_scan(*args[:5], args[5] * 1.01)
    assert not (within(yc, want_y, True) and within(hc, want_h, False))
    for i in range(b):
        yi, hi = selective_scan(*(v[i:i + 1] for v in args[:4]), args[4],
                                args[5][i:i + 1])
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(hi, h[i:i + 1])
