#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py          # from the repository root, no arguments

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every CUDA kernel of ``src/repro_torch/csrc`` with ``nvcc``
   (``-Xptxas -v`` output printed).
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serve path's shapes (the GEMM at every weight GEMM of
   SmolLM-360M at M = 1, 3, 8, 16 and 512 and of Qwen3-8B at M = 3, the
   paper's Table V GEMMs and ragged shapes; flash attention at the
   prefill shapes the replays run -- the 16-token bucket against the
   36-row dense and 48-row paged caches, the 488-token bucket against the
   496-row scratch cache of the 8 x 448 replay -- and at 512 x 512,
   Qwen3-8B's heads of 128, a kv_len below Sk, f32, and the SMOKE
   configs' heads of 16 in f32; both decode kernels at the smoke6 and
   the 8 x 448 replay's decode shapes, lengths on and around the chunk
   boundaries up to 4096 keys, a long-context Qwen3-8B shape, bf16, f32
   and int8 pools in shuffled page order, and head dim 16 in f32), with
   the error against a stated tolerance, and timed with CUDA events
   beside its roofline bound, its plain version and one PyTorch library
   call computing the same function where there is one (a yardstick the
   port never calls).  Bit-for-bit checks: the GEMM's rows independent
   of the batch (every row at M = 3, 8, 16 and 512 equal to the row
   alone); flash attention's rows independent of how a prompt is split
   (488 tokens whole equal to [0, 256) + [256, 488) and [0, 200) +
   [200, 488) at runtime q_offsets, and B = 2 equal to B = 1); a decode
   slot alone equal to its row of the batch and of a batch with doubled
   max_pages (paged) or Sk (dense), buffers=1 equal to buffers=2, a
   float pool equal to flash_decode on the gathered cache, and a NaN
   null sink page changing nothing.
4. Serve: the SMOKE config (f32, heads of 16) replays smoke6 on dense
   KV, f32 pages and int8 pages, then the serve launcher runs with its
   defaults (dense, then ``--kv paged --page_size 16``), all under
   ``--verify``.  SmolLM-360M FULL (32 layers, d_model 960, bf16, seeded
   random weights) replays traces through the port's continuous-batching
   ``ServeEngine`` with every GEMM, prefill attention and decode attention
   on the kernels: ``benchmarks/traces/smoke6.jsonl`` on the dense KV
   cache, then four paged-KV replays (bf16 pages, int8 pages, a 4-page
   pool that forces preemption, and 8 requests of 448-token prompts).
   Launch counts are reset just before and read just after each measured
   replay and checked per path; each replay ends with ``--verify``'s check
   (bit-identical to a one-slot one-shot engine).  Then a
   kernel-vs-plain-GEMM logit check, a 448-token prompt's prefill logits
   with the attention kernel against the same prefill with the plain
   attention, a profile of a decode step (by kernel and by kind, with its
   225 ``gama_gemm`` launches checked) and one of the 8 x 448 replay (its
   prefill attention's and paged decode's device time).
5. Train: the wkv6 forward and backward kernels against their plain
   versions at the training shape, a ragged length and a long one, and
   the head-16 builds the SMOKE config runs (bf16, and f32 at the
   launcher's shape); then RWKV-6 3B FULL (32 layers, d_model 2560, f32
   parameters, bf16 compute, seeded random weights) takes training steps
   through ``make_train_step`` (each step's wkv6 launches counted), one
   step profiled; a 2-layer step with the kernels against one with the
   plain recurrence, in f32 and in bf16 compute, each beside a control;
   the training launcher at SMOKE size; and a restart after an injected
   failure that must resume with the uninterrupted run's losses.
6. A ``{"kernels": [...]}`` JSON line, the card line, and last the
   ``{"ok": true, "device": ...}`` line.

Any failure raises and exits non-zero before the last line is printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs.gama_paper import ARRAY_GEMMS  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_chunk, flash_decode, flash_paged_decode)
from repro_torch.kernels.flash_attention import blocks as attn_blocks  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import plan as attn_plan  # noqa: E402
from repro_torch.kernels.gemm import gama_gemm  # noqa: E402
from repro_torch.kernels.gemm import blocks as gemm_blocks  # noqa: E402
from repro_torch.kernels.gemm import plan as gemm_plan  # noqa: E402
from repro_torch.kernels import wkv as wkv_mod  # noqa: E402
from repro_torch.kernels.wkv import wkv6, wkv6_bwd  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step, forward, init_cache, init_paged_cache, init_params, loss_fn)
from repro_torch.models.layers import set_gemm_mode  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    TrainConfig, Trainer, make_train_step)
from repro_torch.serving.engine import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serving.kvpool import pages_for  # noqa: E402
from repro_torch.serving.quant import quantize_kv_pages  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; dense, 700 W): device
# memory bytes/s, and operations/s by input type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
L2_BYTES = 50 * 2 ** 20
DEV = "cuda"

SOURCES = {"gama_gemm": "src/repro_torch/csrc/gemm.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "flash_decode": "src/repro_torch/csrc/decode_attention.cu",
           "flash_paged_decode":
               "src/repro_torch/csrc/paged_decode_attention.cu",
           "wkv6": "src/repro_torch/csrc/wkv.cu",
           "wkv6_bwd": "src/repro_torch/csrc/wkv.cu"}
# wkv6_bwd replaces the VJP that JAX derives through the same pallas_call.
REPLACES = {"gama_gemm": "src/repro/kernels/gemm.py:113",
            "flash_attention": "src/repro/kernels/flash_attention.py:145",
            "flash_decode": "src/repro/kernels/decode_attention.py:127",
            "flash_paged_decode": "src/repro/kernels/decode_attention.py:415",
            "wkv6": "src/repro/kernels/wkv.py:70",
            "wkv6_bwd": "src/repro/kernels/wkv.py:70"}
# The long replay: 8 requests of 448-token prompts and 32 new tokens on 8
# slots; max_len = 488 is also its last prefill bucket, and its scratch
# cache has pages_for(488, 16) * 16 = 496 rows.
LONG_REQS, LONG_PROMPT, LONG_NEW = 8, 448, 32
LONG_LEN = LONG_PROMPT + LONG_NEW + 8
SERVE_KERNELS = ("gama_gemm", "flash_attention", "flash_decode",
                 "flash_paged_decode")
TRAIN_KERNELS = ("wkv6", "wkv6_bwd")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def device_ms(make_call, input_bytes: int, reps: int = 24) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph
    (so host dispatch does not count), replayed 5 times between CUDA
    events.  The calls rotate over copies of the inputs until they cover
    twice the L2 (at most 256 copies), so weights come from device memory
    as on the serve path, where 32 layers of weights pass through L2."""
    copies = max(1, min(256, math.ceil(2 * L2_BYTES / max(1, input_bytes))))
    calls = [make_call() for _ in range(copies)]
    reps = max(reps, copies)
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % copies]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def bound(nbytes: float, ops_: float, dtype: torch.dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops_ / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max |got - want|; fails unless |got - want| <= tol * (1 + |want|)
    elementwise (tol = 0: exact)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    err = (g - w).abs()
    if (err > tol * (1 + w.abs())).any():
        raise AssertionError(f"max abs err {err.max().item():.3e} over "
                             f"tolerance {tol:g} * (1 + |plain|)")
    return err.max().item()


# ---------------------------------------------------------------------------
# 3. Kernels against their plain versions
# ---------------------------------------------------------------------------

RESULTS = {name: {"max_abs_err": 0.0} for name in SOURCES}


def _gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


def _rand(shape, dtype, gen, scale=1.0):
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=gen, device=DEV,
                             dtype=torch.int8)
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def decode_bound(b, hq, hkv, d, lengths, q_elt, kv_elt, table_entries=0):
    """Bytes of a decode call: q and out once; each valid K and V row once
    per KV head at ``kv_elt`` bytes a value (an int8 row's f32 scale
    spread over its D values); the block-table entries the lengths need;
    the lengths.  Operations: 4 * D per (query head, valid key)."""
    rows = sum(lengths)
    nbytes = (2 * b * hq * d * q_elt + 2 * hkv * d * rows * kv_elt
              + 4 * table_entries + 4 * b)
    return nbytes, 4.0 * d * hq * rows


def check_gemm(label, m, k, n, dtype, out_dtype, scale, tol, seed, main=False,
               per_step=None):
    """gama_gemm against its plain version, timed beside torch.matmul (or
    torch._int_mm).  The plain version is timed only for weights up to
    256 MB (it widens B to f32 on every call)."""
    gen = _gen(seed)
    a = _rand((m, k), dtype, gen)
    b = _rand((k, n), dtype, gen, scale=k ** -0.5)
    got = gama_gemm(a, b, out_dtype=out_dtype, scale=scale)
    want = ops.matmul(a, b, out_dtype=out_dtype, scale=scale, mode="ref")
    torch.cuda.synchronize()
    err = max_err(got, want, tol)
    del want
    RESULTS["gama_gemm"]["max_abs_err"] = max(
        RESULTS["gama_gemm"]["max_abs_err"], err)
    elt = a.element_size()
    nbytes = (m * k + k * n) * elt + m * n * got.element_size()

    def mk(fn):
        def make():
            bb = _rand((k, n), dtype, gen, scale=k ** -0.5)
            return lambda: fn(a, bb)
        return make

    kern = device_ms(mk(lambda x, y: gama_gemm(x, y, out_dtype=out_dtype,
                                              scale=scale)), nbytes)
    plain = None
    if k * n * elt <= 256 * 2 ** 20:
        plain = device_ms(mk(lambda x, y: ops.matmul(
            x, y, out_dtype=out_dtype, scale=scale, mode="ref")), nbytes)
    lib = None
    if dtype != torch.int8 or (out_dtype == torch.int32 and m > 16
                               and k % 8 == 0 and n % 8 == 0):
        lib_fn = (torch.matmul if dtype != torch.int8 else torch._int_mm)
        lib = device_ms(mk(lib_fn), nbytes)
    bms, by = bound(nbytes, 2.0 * m * k * n, dtype)
    p = gemm_plan(m, k, n, dtype)
    print(f"[kernel] gama_gemm {label} M={m} K={k} N={n} "
          f"{str(dtype)[6:]}->{str(out_dtype)[6:]} plan={tuple(p)} "
          f"blocks={gemm_blocks(p, m, n)} max_abs_err={err:.3e} "
          f"tol={tol:g}*(1+|plain|) kernel_ms={kern:.5f} "
          f"plain_ms={'not timed' if plain is None else f'{plain:.5f}'} "
          f"library_ms={'null' if lib is None else f'{lib:.5f}'} "
          f"bound_ms={bms:.5f} ({by}) kernel/library="
          f"{'n/a' if lib is None else f'{kern / lib:.2f}'} "
          f"bound/kernel={bms / kern:.3f}"
          + ("" if per_step is None else f" launches_per_decode_step="
             f"{per_step}"))
    if main:
        RESULTS["gama_gemm"].update(ms=kern, plain_ms=plain, library_ms=lib,
                                    bound_ms=bms, bound_by=by,
                                    shape=f"M={m} K={k} N={n} {label}")


def gemm_rows_independent(cfgs, ms):
    """Rows independent of the batch (what ``--verify`` needs of the serve
    path): at every weight GEMM of ``cfgs``, each row of an M-row product
    must be ``torch.equal`` to the same row computed alone (M = 1)."""
    checked = 0
    for cfg in cfgs:
        for label, (k, n, _) in cfg.gemm_shapes().items():
            gen = _gen(k + n)
            a = _rand((max(ms), k), torch.bfloat16, gen)
            b = _rand((k, n), torch.bfloat16, gen, scale=k ** -0.5)
            alone = torch.cat([gama_gemm(a[i:i + 1], b)
                               for i in range(max(ms))])
            for m in ms:
                got = gama_gemm(a[:m].contiguous(), b)
                same = (got == alone[:m]).all(dim=1)
                if not bool(same.all()):
                    bad = (~same).nonzero().flatten().tolist()[:8]
                    raise AssertionError(
                        f"gama_gemm row-independence: {cfg.name}:{label} "
                        f"M={m} rows {bad} differ from the row alone")
                checked += m
            del a, b, alone
    torch.cuda.synchronize()
    print(f"[kernel] gama_gemm row-independence: every row torch.equal to "
          f"the row computed alone (M=1) at M={list(ms)} on the weight "
          f"GEMMs of {[c.name for c in cfgs]}: {checked} rows, OK")


def _attn_bound(b, hq, hkv, sq, d, elt, keys_per_row, kv_rows):
    """Bytes: q and out once, K and V rows [0, kv_rows) once per KV head;
    operations: 4 * D per (query row, key it attends to)."""
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * kv_rows * d) * elt
    return nbytes, 4.0 * d * hq * b * keys_per_row


def check_attention(label, b, hq, hkv, sq, sk, d, q_offset, dtype, tol, seed,
                    main=False, kv_len=None):
    gen = _gen(seed)
    q = _rand((b, hq, sq, d), dtype, gen)
    k = _rand((b, hkv, sk, d), dtype, gen)
    v = _rand((b, hkv, sk, d), dtype, gen)
    kv = sk if kv_len is None else kv_len
    args = dict(causal=True, q_offset=q_offset, kv_len=kv)
    got = flash_attention(q, k, v, **args)
    want = ops.attention(q, k, v, mode="ref", **args)
    torch.cuda.synchronize()
    err = max_err(got, want, tol)
    r = RESULTS["flash_attention"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    per_row = [max(0, min(kv, q_offset + i + 1)) for i in range(sq)]
    nbytes, flops = _attn_bound(b, hq, hkv, sq, d, q.element_size(),
                                sum(per_row), max(per_row))
    kern = device_ms(lambda: (lambda: flash_attention(q, k, v, **args)),
                     nbytes)
    plain = device_ms(lambda: (lambda: ops.attention(
        q, k, v, mode="ref", **args)), nbytes)
    lib = None
    if q_offset == 0 and kv == sk:
        # SDPA's causal mask is top-left aligned: query i sees keys <= i,
        # the same function as q_offset = 0.  KV expanded to Hq up front.
        kq = k.repeat_interleave(hq // hkv, 1)
        vq = v.repeat_interleave(hq // hkv, 1)
        lib = device_ms(lambda: (lambda: F.scaled_dot_product_attention(
            q, kq, vq, is_causal=True)), nbytes)
    bms, by = bound(nbytes, flops, dtype)
    p = attn_plan(b, hq, hkv, sq, sk, d, dtype)
    print(f"[kernel] flash_attention {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} "
          f"Sk={sk} D={d} q_offset={q_offset} kv_len={kv} {str(dtype)[6:]} "
          f"plan={tuple(p)} blocks={attn_blocks(p, b, hq, sq)} "
          f"max_abs_err={err:.3e} tol={tol:g}*(1+|plain|) "
          f"kernel_ms={kern:.5f} "
          f"plain_ms={plain:.5f} library_ms="
          f"{'null' if lib is None else f'{lib:.5f}'} bound_ms={bms:.6f} "
          f"({by}) kernel/library="
          f"{'n/a' if lib is None else f'{kern / lib:.2f}'} "
          f"bound/kernel={bms / kern:.4f}")
    if main:
        r.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bms,
                 bound_by=by, shape=f"B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                                    f"Sk={sk} D={d}")


def attention_rows_independent(hq, hkv, d, sq, sk, cuts, seed):
    """A row's bits do not depend on how the prompt is split (what chunked
    prefill needs): ``sq`` tokens prefilled whole against an ``sk``-row
    cache must equal, under torch.equal, the same rows prefilled in two
    chunks cut at each of ``cuts`` (runtime q_offsets, same cache), and
    every row of a B=2 call the same row of each B=1 call."""
    gen = _gen(seed)
    q = _rand((2, hq, sq, d), torch.bfloat16, gen)
    k = _rand((2, hkv, sk, d), torch.bfloat16, gen)
    v = _rand((2, hkv, sk, d), torch.bfloat16, gen)
    whole = flash_attention(q, k, v, causal=True)
    for cut in cuts:
        parts = [flash_attention(q[:, :, lo:hi].contiguous(), k, v,
                                 causal=True, q_offset=lo)
                 for lo, hi in ((0, cut), (cut, sq))]
        if not torch.equal(torch.cat(parts, dim=2), whole):
            raise AssertionError(f"flash_attention: rows of [0, {cut}) + "
                                 f"[{cut}, {sq}) differ from the whole "
                                 f"prefill (Hq={hq} D={d})")
    for i in range(2):
        alone = flash_attention(q[i:i + 1].contiguous(),
                                k[i:i + 1].contiguous(),
                                v[i:i + 1].contiguous(), causal=True)
        if not torch.equal(alone, whole[i:i + 1]):
            raise AssertionError(f"flash_attention: batch row {i} of B=2 "
                                 f"differs from B=1 (Hq={hq} D={d})")
    torch.cuda.synchronize()
    print(f"[kernel] flash_attention rows independent of chunking: Hq={hq} "
          f"Hkv={hkv} D={d} Sq={sq} Sk={sk}: whole == chunks cut at {cuts} "
          f"(runtime q_offset) and B=2 == B=1, torch.equal, OK")


def _sdpa_decode(q, kc, vc, length):
    """SDPA on a dense cache expanded to Hq heads beforehand, keys at or
    past each slot's length masked: a make() for device_ms (the aside)."""
    grp = q.shape[1] // kc.shape[1]
    kq, vq = (x.repeat_interleave(grp, 1) for x in (kc, vc))
    mask = (torch.arange(kc.shape[2], device=DEV)[None, :]
            < length[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q[:, :, None], kq, vq,
                                                  attn_mask=mask)


def check_decode(label, hq, hkv, sk, d, lengths, dtype, tol, seed,
                 main=False):
    """flash_decode against its plain version, timed over copies of the
    cache that cover twice the L2 (a decode step finds its layer's cache
    in device memory) beside its bound, the plain version and SDPA on the
    same cache.  Bit for bit: every slot alone (B=1) equals its row of the
    batch, and, when no length passes Sk, so does the batch against a
    cache zero-padded to 2 * Sk (the chunks depend on key positions
    only)."""
    gen = _gen(seed)
    b = len(lengths)
    q = _rand((b, hq, d), dtype, gen)
    k = _rand((b, hkv, sk, d), dtype, gen)
    v = _rand((b, hkv, sk, d), dtype, gen)
    length = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    got = flash_decode(q, k, v, length=length)
    want = ops.decode(q, k, v, length=length, mode="ref")
    torch.cuda.synchronize()
    err = max_err(got, want, tol)
    alone = all(torch.equal(flash_decode(
        q[i:i + 1], k[i:i + 1].contiguous(), v[i:i + 1].contiguous(),
        length=length[i:i + 1]), got[i:i + 1]) for i in range(b))
    wide = "n/a (a length past Sk)"
    if max(lengths) <= sk:
        kw, vw = (torch.cat([x, torch.zeros_like(x)], dim=2) for x in (k, v))
        wide = torch.equal(flash_decode(q, kw, vw, length=length), got)
        del kw, vw
    torch.cuda.synchronize()
    if not (alone and wide is not False):
        raise AssertionError(f"flash_decode {label}: B=1 == batch {alone}, "
                             f"2*Sk == Sk {wide}")
    r = RESULTS["flash_decode"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    nbytes, flops = decode_bound(b, hq, hkv, d,
                                 [min(n, sk) for n in lengths],
                                 q.element_size(), q.element_size())
    cache_bytes = 2 * k.numel() * k.element_size()

    def fresh():
        return _rand(k.shape, dtype, gen), _rand(v.shape, dtype, gen)

    def mk(fn):
        def make():
            kc, vc = fresh()
            return lambda: fn(q, kc, vc, length=length)
        return make

    kern = device_ms(mk(flash_decode), cache_bytes)
    plain = device_ms(mk(lambda *a, **kw: ops.decode(*a, mode="ref", **kw)),
                      cache_bytes)
    lib = device_ms(lambda: _sdpa_decode(q, *fresh(), length), cache_bytes)
    bms, by = bound(nbytes, flops, dtype)
    chunk = decode_chunk(d, dtype)
    print(f"[kernel] flash_decode {label} B={b} Hq={hq} Hkv={hkv} Sk={sk} "
          f"D={d} lengths={lengths} {str(dtype)[6:]} chunk={chunk} blocks="
          f"{b * hkv * -(-sk // chunk)} max_abs_err={err:.3e} "
          f"tol={tol:g}*(1+|plain|) slot_alone_equal_batch={alone} "
          f"sk_doubled_equal={wide} kernel_ms={kern:.5f} "
          f"plain_ms={plain:.5f} library_ms={lib:.5f} (SDPA on the cache "
          f"expanded to Hq) bound_ms={bms:.6f} ({by}) "
          f"bound/kernel={bms / kern:.4f}")
    if main:
        r.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bms,
                 bound_by=by, shape=f"B={b} Hq={hq} Hkv={hkv} Sk={sk} D={d} "
                                    f"lengths={lengths} {str(dtype)[6:]}")
    return kern


def check_paged_decode(label, hq, hkv, d, ps, lengths, pool, tol, seed,
                       main=False, dtype=torch.bfloat16):
    """flash_paged_decode (both buffering variants) against its plain
    version, on q in ``dtype`` with pools in q's dtype (``pool="float"``)
    or int8 whose pages sit in a shuffled order, timed over copies of the
    pools that cover twice the L2.  Bit for bit: buffers=1 == buffers=2;
    a NaN null sink page changes nothing; every slot alone (B=1) equals
    its row of the batch, and so does the batch with max_pages doubled
    (the extra entries on the null sink); a float pool equals flash_decode
    on the gathered cache."""
    gen = _gen(seed)
    b = len(lengths)
    slot_pages = [pages_for(n, ps) for n in lengths]
    max_pages, n_pool = max(slot_pages) + 1, sum(slot_pages) + 8
    perm = torch.randperm(n_pool, generator=gen, device=DEV).tolist()
    table = torch.full((b, max_pages), n_pool, dtype=torch.int32)
    for i, n in enumerate(slot_pages):
        table[i, :n] = torch.tensor(perm[:n])
        perm = perm[n:]
    table = table.to(DEV)
    length = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    q = _rand((b, hq, d), dtype, gen)

    def pools():
        kv = [_rand((n_pool + 1, hkv, ps, d), dtype, gen) for _ in range(2)]
        if pool == "int8":
            (kq, ks), (vq, vs) = map(quantize_kv_pages, kv)
            return kq, vq, {"k_scale": ks, "v_scale": vs}
        return kv[0], kv[1], {}

    kp, vp, sc = pools()
    got = {n: flash_paged_decode(q, kp, vp, table, length=length, buffers=n,
                                 **sc) for n in (1, 2)}
    want = ops.decode_paged(q, kp, vp, block_tables=table, length=length,
                            mode="ref", **sc)
    torch.cuda.synchronize()
    err = max_err(got[2], want, tol)
    same_buffers = torch.equal(got[1], got[2])
    # The null sink (page n_pool) full of NaN: never read, so no change.
    kn, vn = kp.clone(), vp.clone()
    scn = {k: v.clone() for k, v in sc.items()}
    if pool == "int8":
        for v in scn.values():
            v[n_pool] = float("nan")
    else:
        kn[n_pool], vn[n_pool] = float("nan"), float("nan")
    nan_safe = all(torch.equal(flash_paged_decode(
        q, kn, vn, table, length=length, buffers=n, **scn), got[n])
        for n in (1, 2))
    del kn, vn, scn
    alone = all(torch.equal(flash_paged_decode(
        q[i:i + 1], kp, vp, table[i:i + 1], length=length[i:i + 1], **sc),
        got[2][i:i + 1]) for i in range(b))
    wide_table = torch.cat([table, torch.full_like(table, n_pool)], dim=1)
    wide = torch.equal(flash_paged_decode(q, kp, vp, wide_table,
                                          length=length, **sc), got[2])
    same_dense = "n/a (int8 pool)"
    if pool == "float":
        dense = flash_decode(q, ref.gather_pages(kp, table).contiguous(),
                             ref.gather_pages(vp, table).contiguous(),
                             length=length)
        same_dense = torch.equal(dense, got[2])
    torch.cuda.synchronize()
    if not (same_buffers and nan_safe and alone and wide
            and same_dense is not False):
        raise AssertionError(
            f"flash_paged_decode {label} {pool}: buffers1==buffers2 "
            f"{same_buffers}, NaN sink unreachable {nan_safe}, B=1 == batch "
            f"{alone}, 2*max_pages == max_pages {wide}, equal to "
            f"flash_decode on the gathered cache {same_dense}")
    r = RESULTS["flash_paged_decode"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    kv_elt = kp.element_size() + (4 / d if pool == "int8" else 0)
    nbytes, flops = decode_bound(b, hq, hkv, d, lengths, q.element_size(),
                                 kv_elt, sum(slot_pages))
    pool_bytes = 2 * kp.numel() * kp.element_size()

    def mk(**kw):
        def make():
            k2, v2, s2 = pools()
            return lambda: flash_paged_decode(q, k2, v2, table, length=length,
                                              **s2, **kw)
        return make

    kern = device_ms(mk(buffers=2), pool_bytes)
    kern1 = device_ms(mk(buffers=1), pool_bytes)
    plain = device_ms(lambda: (lambda: ops.decode_paged(
        q, kp, vp, block_tables=table, length=length, mode="ref", **sc)),
        pool_bytes)
    aside = ""
    if pool == "float":
        def make_sdpa():
            k2, v2, _ = pools()
            return _sdpa_decode(q, ref.gather_pages(k2, table),
                                ref.gather_pages(v2, table), length)
        sdpa = device_ms(make_sdpa, pool_bytes)
        aside = f" aside_sdpa_on_pregathered_cache_ms={sdpa:.5f}"
    bms, by = bound(nbytes, flops, dtype)
    chunk = decode_chunk(d, kp.dtype)
    print(f"[kernel] flash_paged_decode {label} B={b} Hq={hq} Hkv={hkv} D={d} "
          f"ps={ps} lengths={lengths} max_pages={max_pages} "
          f"pool={str(kp.dtype)[6:]} q={str(dtype)[6:]} chunk={chunk} "
          f"blocks={b * hkv * -(-max_pages * ps // chunk)} "
          f"max_abs_err={err:.3e} tol={tol:g}*(1+|plain|) "
          f"buffers1_equal_buffers2={same_buffers} "
          f"equal_flash_decode_on_gathered_cache={same_dense} "
          f"nan_null_sink_unreachable={nan_safe} "
          f"slot_alone_equal_batch={alone} max_pages_doubled_equal={wide} "
          f"kernel_ms={kern:.5f} "
          f"kernel_buffers1_ms={kern1:.5f} plain_ms={plain:.5f} "
          f"bound_ms={bms:.6f} ({by} at {HBM_BYTES_S / 1e12:g} TB/s) "
          f"bound/kernel={bms / kern:.4f} "
          f"library_ms=null (no single PyTorch call gathers pages through a "
          f"block table and attends){aside}")
    if main:
        r.update(ms=kern, plain_ms=plain, library_ms=None, bound_ms=bms,
                 bound_by=by, shape=f"B={b} Hq={hq} Hkv={hkv} D={d} ps={ps} "
                                    f"lengths={lengths} pool={pool}")
    return kern


def kernel_phase(cfg, max_len, smoke_len):
    # bf16 GEMMs: both sides sum in f32 in another order and round once to
    # bf16, so they may differ by one bf16 ulp (< 2**-7 relative).
    bf16_tol, f32_tol = 1e-2, 1e-4
    for name, (m, k, n) in ARRAY_GEMMS.items():
        out = {"int8-int32": torch.int32, "int8-int16": torch.int16,
               "int8-int8": torch.int8, "bf16-bf16": torch.bfloat16}[name]
        dtype = torch.bfloat16 if name.startswith("bf16") else torch.int8
        # Scales that put part of each int16/int8 output in saturation.
        scale = {"int8-int16": 0.05, "int8-int8": 0.0005}.get(name, 1.0)
        check_gemm(f"tableV:{name}", m, k, n, dtype, out, scale,
                   0 if dtype == torch.int8 else bf16_tol, seed=len(name))
    check_gemm("ragged-f32", 257, 129, 127, torch.float32, torch.float32,
               1.0, f32_tol, seed=3)
    # Ragged bf16/int8 shapes: pitches of 16 bytes and not (cp.async or
    # element loads), K shorter than one chunk.
    for m, k, n in [(1, 10, 5000), (13, 129, 127), (70, 272, 1000)]:
        check_gemm("ragged", m, k, n, torch.bfloat16, torch.bfloat16, 1.0,
                   bf16_tol, seed=m + k)
        check_gemm("ragged", m, k, n, torch.int8, torch.int8, 0.002, 0,
                   seed=m + n)
    qwen = C.get("qwen3_8b")
    for arch, ms in ((cfg, (1, 3, 8, 16, 512)), (qwen, (3,))):
        for m in ms:
            for label, (k, n, per_step) in arch.gemm_shapes().items():
                check_gemm(f"{arch.name}:{label}", m, k, n, torch.bfloat16,
                           torch.bfloat16, 1.0, bf16_tol, seed=m + k + n,
                           main=(arch is cfg and m == 3
                                 and label == "lm_head"),
                           per_step=per_step if m <= 16 else None)
    gemm_rows_independent([cfg, qwen], (3, 8, 16, 512))
    # Attention: bf16 within 2e-2 * (1 + |plain|) (P rounds to bf16 for
    # P.V and the output once from f32), f32 at the JAX suite's 2e-5.  The
    # replays' prefill shapes: the 16-token bucket against the dense smoke6
    # cache (max_len rows) and the paged scratch (48 rows), and the 488
    # bucket against the long replay's 496-row scratch.
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    long_cache = pages_for(LONG_LEN, 16) * 16
    check_attention("prefill", 1, hq, hkv, 16, max_len, dh, 0,
                    torch.bfloat16, 2e-2, seed=11)
    check_attention("prefill-paged", 1, hq, hkv, 16,
                    pages_for(max_len, 16) * 16, dh, 0, torch.bfloat16, 2e-2,
                    seed=16)
    check_attention(f"prefill-{LONG_LEN}", 1, hq, hkv, LONG_LEN, long_cache,
                    dh, 0, torch.bfloat16, 2e-2, seed=17, main=True)
    check_attention("q_offset", 1, hq, hkv, 16, 80, dh, 64, torch.bfloat16,
                    2e-2, seed=12)
    check_attention("prefill-512", 1, hq, hkv, 512, 512, dh, 0,
                    torch.bfloat16, 2e-2, seed=15)
    check_attention("kv_len", 1, hq, hkv, 100, 160, dh, 40, torch.bfloat16,
                    2e-2, seed=18, kv_len=130)
    check_attention("d128", 1, 32, 8, 16, 48, 128, 0, torch.bfloat16, 2e-2,
                    seed=13)
    check_attention("d128-512", 1, 32, 8, 512, 512, 128, 0, torch.bfloat16,
                    2e-2, seed=19)
    check_attention("f32-ragged", 2, 8, 2, 33, 77, 64, 44, torch.float32,
                    2e-5, seed=14)
    # The SMOKE configs' prefill: 6/2 heads of 16 in f32, the 16-token
    # bucket against the dense smoke6 cache and the paged scratch.
    check_attention("smoke-d16-prefill", 1, 6, 2, 16, smoke_len, 16, 0,
                    torch.float32, 2e-5, seed=38)
    check_attention("smoke-d16-prefill-paged", 1, 6, 2, 16,
                    pages_for(smoke_len, 16) * 16, 16, 0, torch.float32, 2e-5,
                    seed=39)
    check_attention("smoke-d16-ragged", 2, 6, 2, 33, 77, 16, 44,
                    torch.float32, 2e-5, seed=40)
    attention_rows_independent(hq, hkv, dh, LONG_LEN, long_cache, (256, 200),
                               seed=20)
    attention_rows_independent(32, 8, 128, LONG_LEN, long_cache, (256, 200),
                               seed=25)
    # Decode: bf16 outputs round once from f32 math (2e-2 * (1 + |plain|)),
    # f32 at 2e-5.  The long replay's decode step (8 slots at 449-487 keys
    # against 31 pages of 16 or a 496-row cache) is the kernels line's
    # shape; lengths on and around the chunk boundaries and up to 4096
    # keys; Qwen3-8B's heads at long context; the SMOKE head dim 16 in f32.
    long_lens = [LONG_PROMPT + 1 + (LONG_LEN - LONG_PROMPT - 2) * i // 7
                 for i in range(8)]
    c = decode_chunk(dh, torch.bfloat16)
    edges = [1, c - 1, c, c + 1, 517, 4096]
    long_ctx = [4096, 3584, 3072, 2560, 2048, 1536, 1024, 517]
    check_decode("serve", hq, hkv, max_len, dh, [28, 20, 13], torch.bfloat16,
                 2e-2, seed=21)
    check_decode("long-replay", hq, hkv, long_cache, dh, long_lens,
                 torch.bfloat16, 2e-2, seed=26, main=True)
    check_decode("zero-length", hq, hkv, max_len, dh, [max_len, 0, 7],
                 torch.bfloat16, 2e-2, seed=22)
    check_decode("past-sk", hq, hkv, 100, dh, [130, 0, 99], torch.bfloat16,
                 2e-2, seed=27)
    check_decode("chunk-edges", hq, hkv, 4096, dh, edges, torch.bfloat16,
                 2e-2, seed=28)
    check_decode("d128", 32, 8, 100, 128, [100, 13, 0], torch.bfloat16, 2e-2,
                 seed=23)
    check_decode("long-context-qwen3-8b-heads", 32, 8, 4096, 128, long_ctx,
                 torch.bfloat16, 2e-2, seed=29)
    check_decode("f32", hq, hkv, 70, dh, [70, 33, 1], torch.float32, 2e-5,
                 seed=24)
    c16 = decode_chunk(16, torch.float32)
    check_decode("smoke-d16", 6, 2, smoke_len, 16, [28, 20, 13],
                 torch.float32, 2e-5, seed=30)
    check_decode("smoke-d16-chunk-edges", 6, 2, 600, 16,
                 [1, c16 - 1, c16, c16 + 1, 517, 600], torch.float32, 2e-5,
                 seed=35)
    # Paged decode: int8 pools are dequantized in f32 on both sides.
    for pool in ("float", "int8"):
        check_paged_decode("serve", hq, hkv, dh, 16, [28, 20, 13], pool,
                           2e-2, seed=31)
        check_paged_decode("long-replay", hq, hkv, dh, 16, long_lens, pool,
                           2e-2, seed=33, main=(pool == "float"))
        check_paged_decode("chunk-edges", hq, hkv, dh, 16, edges, pool, 2e-2,
                           seed=34)
        check_paged_decode("long-context-qwen3-8b-heads", 32, 8, 128, 16,
                           long_ctx, pool, 2e-2, seed=32)
        check_paged_decode("smoke-d16", 6, 2, 16, 16, [28, 20, 13], pool,
                           2e-5, seed=36, dtype=torch.float32)
        check_paged_decode("smoke-d16-chunk-edges", 6, 2, 16, 16,
                           [1, c16 - 1, c16, c16 + 1, 517], pool, 2e-5,
                           seed=37, dtype=torch.float32)


# ---------------------------------------------------------------------------
# 4. Serve
# ---------------------------------------------------------------------------


def logits_kernel_vs_ref(cfg, params, prompt, max_len, steps=4):
    """One prefill plus ``steps`` greedy decode steps on a one-slot cache,
    in gemm mode ``mode``; returns the stacked logits and the launch
    counts of the prefill and of the first decode step."""
    def run(mode):
        set_gemm_mode(mode)
        caches = init_cache(cfg, 1, max_len, DEV)
        bucket = 16
        toks = torch.zeros((1, bucket), dtype=torch.long, device=DEV)
        toks[0, :len(prompt)] = torch.as_tensor(prompt, device=DEV)
        c0 = K.launch_counts()
        lg, caches = forward(params, {"tokens": toks}, cfg, caches=caches,
                             cache_pos=0)
        c1 = K.launch_counts()
        out = [lg[0, len(prompt) - 1]]
        tok = torch.argmax(out[-1])[None]
        for i in range(steps):
            pos = torch.tensor([len(prompt) + i], dtype=torch.int32,
                               device=DEV)
            lg, caches = decode_step(params, tok, pos, cfg, caches)
            if i == 0:
                c2 = K.launch_counts()
            out.append(lg[0])
            tok = torch.argmax(lg, -1)
        torch.cuda.synchronize()
        per_prefill = {n: c1[n] - c0[n] for n in c0}
        per_decode = {n: c2[n] - c1[n] for n in c0}
        return torch.stack(out), per_prefill, per_decode
    kern, per_prefill, per_decode = run("kernel")
    plain, _, _ = run("ref")
    set_gemm_mode("kernel")
    return kern, plain, per_prefill, per_decode


def profile_decode(cfg, params, max_len, steps=5):
    """Where a decode step's time goes, on the dense cache and on bf16
    pages of 16 rows (3 pages a slot): wall time per batched 3-slot decode
    step (host clock, synchronised, the profiler off; the two layouts
    timed in turns dense, paged, paged, dense) beside the device time of
    the kernels each ran (``torch.profiler`` CUDA events), by kernel
    name."""
    tok = torch.zeros(3, dtype=torch.long, device=DEV)
    pos = torch.tensor([20, 14, 7], dtype=torch.int32, device=DEV)
    layouts = {
        "dense": (init_cache(cfg, 3, max_len, DEV), None),
        "paged": (init_paged_cache(cfg, 9, 16, device=DEV),
                  torch.arange(9, dtype=torch.int32, device=DEV).view(3, 3)),
    }

    def run(kind):
        caches, tables = layouts[kind]
        t0 = time.perf_counter()
        for _ in range(steps):
            decode_step(params, tok, pos, cfg, caches, block_tables=tables)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    for kind in layouts:
        run(kind)                          # warm-up
    walls = {kind: [] for kind in layouts}
    for kind in ("dense", "paged", "paged", "dense"):
        walls[kind].append(run(kind))
    print(f"[profile] decode step wall_ms in turns (profiler off): "
          f"{json.dumps(walls)}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for kind in layouts:
        wall_ms = sum(walls[kind]) / len(walls[kind])
        with torch.profiler.profile(activities=acts) as prof:
            traced_ms = run(kind)
        by_name, by_kind = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = _kernel_name(e)[:60]
                us = e.time_range.elapsed_us()
                n, t = by_name.get(name, (0, 0.0))
                by_name[name] = (n + 1, t + us)
                n, t = by_kind.get(_kind(name), (0, 0.0))
                by_kind[_kind(name)] = (n + 1, t + us)
        if not by_name:
            print(f"[profile] decode step ({kind} KV) wall_ms={wall_ms:.3f}; "
                  f"device time not measured (the profiler saw no CUDA "
                  f"events)")
            continue
        device_ms = sum(us for _, us in by_name.values()) / 1e3 / steps
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        print(f"[profile] decode step (3 slots, {kind} KV, smollm-360m FULL): "
              f"wall_ms={wall_ms:.3f} (profiler off, mean of 2) "
              f"traced_wall_ms={traced_ms:.3f} device_ms={device_ms:.3f} "
              f"device_idle_share={1 - device_ms / wall_ms:.3f} "
              f"kernels_per_step="
              f"{sum(n for n, _ in by_name.values()) // steps}")
        for group, (n, us) in sorted(by_kind.items(),
                                     key=lambda kv: -kv[1][1]):
            print(f"[profile]   by kind: {group}: {n // steps} launches per "
                  f"step, {us / 1e3 / steps:.3f} ms per step")
        for name, (n, us) in top:
            print(f"[profile]   {name}: {n // steps} per step, "
                  f"{us / 1e3 / steps:.3f} ms per step")
        gemms = by_kind.get("GEMM (gama_gemm)", (0, 0.0))[0] // steps
        want = sum(c for _, _, c in cfg.gemm_shapes().values())
        if gemms != want:
            raise AssertionError(f"decode step ({kind} KV): {gemms} gama_gemm "
                                 f"launches, expected {want}")


def replay(cfg, params, trace, scfg, label):
    """One path of the main run: a warm-up replay, then the measured replay
    with every launch count set to 0 just before and read just after, its
    outputs checked, and ``--verify``'s bit-identity check.  Returns the
    measured replay's launch counts."""
    engine = ServeEngine(cfg, params, scfg)
    try:
        S.run_trace(engine, trace, log=None)     # warm-up replay
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        rep = S.run_trace(engine, trace, log=None)
        torch.cuda.synchronize()
        counts = K.launch_counts()
    finally:
        engine.close()
    peak = torch.cuda.max_memory_allocated()
    if len(rep["results"]) != len(trace):
        raise AssertionError(f"{label}: {len(rep['results'])}/{len(trace)} "
                             f"requests completed")
    for tid, toks in rep["results"].items():
        t = next(x for x in trace if x["id"] == tid)
        if toks.shape != (t["max_new"],) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label} request {tid}: bad tokens {toks}")
    paged = ""
    if scfg.kv == "paged":
        paged = (f" page_size={scfg.page_size} kv_dtype="
                 f"{scfg.kv_dtype or cfg.cache_dtype} "
                 f"pool_pages={engine.pool.num_pages}"
                 f" preemptions={rep['preemptions']} pages_hwm="
                 f"{rep['pages_hwm']} "
                 f"pages_reclaimed={rep['pages_reclaimed']}")
    print(f"[serve] {label}: arch={cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} dtype={cfg.compute_dtype} kv={scfg.kv} slots="
          f"{scfg.batch_slots} max_len={scfg.max_len}{paged} "
          f"requests={len(rep['results'])} tokens={rep['tokens']} "
          f"wall_s={rep['wall_s']:.4f} tok_s={rep['tok_s']:.2f} "
          f"itl_p50_ms={rep['p50_ms']:.3f} itl_p99_ms={rep['p99_ms']:.3f} "
          f"ttft_p50_ms={rep['ttft_p50_ms']:.3f} "
          f"ttft_p99_ms={rep['ttft_p99_ms']:.3f} "
          f"decode_steps={rep['decode_steps']} "
          f"shared_steps={rep['shared_steps']} "
          f"kv_bytes_high_water={rep['kv_bytes_hwm']} "
          f"kv_bytes_reserved={rep['kv_bytes_reserved']} "
          f"max_memory_allocated={peak}")
    print(f"[serve] {label}: launches {json.dumps(counts)}")
    # Every path runs the GEMM and prefill attention; decode goes through
    # the dense kernel on the dense cache and the paged one on the pool.
    must = ["gama_gemm", "flash_attention",
            "flash_paged_decode" if scfg.kv == "paged" else "flash_decode"]
    missing = [n for n in must if counts[n] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on this "
                             f"path: {missing}")
    if scfg.kv == "paged" and counts["flash_decode"]:
        raise AssertionError(f"{label}: the paged path launched the dense "
                             f"flash_decode {counts['flash_decode']} times")
    S._verify(cfg, params, trace, rep["results"], scfg)
    return counts, rep


@contextlib.contextmanager
def attention_mode(mode):
    """Route the models' ``ops.attention`` calls through ``mode`` for a
    while (``"ref"``: the plain version, no kernel)."""
    orig = ops.attention

    def routed(*args, **kwargs):
        return orig(*args, mode=mode, **kwargs)
    ops.attention = routed
    try:
        yield
    finally:
        ops.attention = orig


def prefill_attention_kernel_vs_ref(cfg, params, prompt_len, bucket,
                                    cache_len, seed=5):
    """One ``prompt_len``-token prompt (random tokens from ``seed``) padded
    to its ``bucket`` and prefilled from position 0 against a
    ``cache_len``-row cache, as the long replay does: its logits with
    ``flash_attention`` (one launch a layer) against the same prefill with
    the plain attention (none), the GEMMs on the kernel in both.  Bound:
    max |logit diff| <= 0.1 over the prompt's positions, the GEMM check's
    bound: each path rounds an f32 attention output to bf16 in every layer
    (the kernel also rounds P to bf16 before P.V), so they differ by about
    one bf16 ulp there, and the difference compounds over the layers."""
    gen = _gen(seed)
    toks = torch.zeros((1, bucket), dtype=torch.long, device=DEV)
    toks[0, :prompt_len] = torch.randint(0, cfg.vocab_size, (prompt_len,),
                                         generator=gen, device=DEV)

    def run(mode):
        caches = init_cache(cfg, 1, cache_len, DEV)
        before = K.launch_counts()["flash_attention"]
        with attention_mode(mode):
            lg, _ = forward(params, {"tokens": toks}, cfg, caches=caches,
                            cache_pos=0)
        torch.cuda.synchronize()
        return (lg[0, :prompt_len].float(),
                K.launch_counts()["flash_attention"] - before)
    kern, n_kern = run("auto")
    plain, n_plain = run("ref")
    if not torch.isfinite(kern).all():
        raise AssertionError("non-finite prefill logits")
    diff = (kern - plain).abs()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    tol = 0.1
    print(f"[serve] prefill attention kernel vs plain ({cfg.name}, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, a "
          f"{prompt_len}-token prompt in the {bucket} bucket, Sq={bucket} "
          f"Sk={cache_len}): max |logit diff|={diff.max().item():.4e} "
          f"mean={diff.mean().item():.4e} (tol {tol}, logit std "
          f"{plain.std().item():.3f}) over {prompt_len} positions, argmax "
          f"agreement={agree:.4f}; flash_attention launches {n_kern} "
          f"(kernel) / {n_plain} (plain)")
    if n_kern != cfg.n_layers or n_plain != 0:
        raise AssertionError(f"prefill attention launches: {n_kern} with the "
                             f"kernel, {n_plain} with the plain version")
    if diff.max().item() > tol:
        raise AssertionError(f"prefill attention kernel vs plain logits "
                             f"differ by {diff.max().item()}")


def _device_by_name(prof):
    """(count, device us) of every CUDA kernel a profile saw, by name."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = _kernel_name(e)
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + e.time_range.elapsed_us())
    return by_name


def profile_replay(cfg, params, trace, scfg, label):
    """Where the long replay's device time goes: one more replay (after a
    warm-up) under ``torch.profiler``, its wall (host clock, synchronised)
    beside the device time by kind, and the prefill attention's launches
    and device time."""
    engine = ServeEngine(cfg, params, scfg)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        S.run_trace(engine, trace, log=None)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            S.run_trace(engine, trace, log=None)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        engine.close()
    by_name = _device_by_name(prof)
    if not by_name:
        print(f"[profile] {label}: wall_ms={wall_ms:.3f}; device time not "
              f"measured (the profiler saw no CUDA events)")
        return
    by_kind = {}
    for name, (n, us) in by_name.items():
        k, t = by_kind.get(_kind(name), (0, 0.0))
        by_kind[_kind(name)] = (k + n, t + us)
    busy = sum(us for _, us in by_name.values()) / 1e3
    print(f"[profile] {label} replay (traced): wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy:.3f} device_idle_share="
          f"{1 - busy / wall_ms:.3f} kernels="
          f"{sum(n for n, _ in by_name.values())}")
    for kind, (n, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        print(f"[profile]   by kind: {kind}: {n} launches, {us / 1e3:.3f} ms")
    attn = [(name, n, us) for name, (n, us) in by_name.items()
            if name.startswith("flash_attention")]
    for name, n, us in attn:
        print(f"[profile]   prefill attention {name}: {n} launches, "
              f"{us / 1e3:.3f} ms, {us / n:.2f} us each")
    if not attn:
        raise AssertionError(f"{label}: the profile saw no prefill "
                             f"attention kernel")
    dec = [(name, n, us) for name, (n, us) in by_name.items()
           if name.startswith("paged_decode")]
    for name, n, us in dec:
        print(f"[profile]   flash_paged_decode {name}: {n} launches, "
              f"{us / 1e3:.3f} ms, {us / n:.2f} us each")
    if not dec:
        raise AssertionError(f"{label}: the profile saw no paged decode "
                             f"kernel")


def smoke_serve_phase(cfg, trace, max_len):
    """The SMOKE config (f32, heads of 16) on the card: smoke6 replayed on
    dense KV, on f32 pages of 16 and on int8 pages, each through
    ``replay`` (launch counts per path, ``--verify``'s check); then the
    serve launcher itself with its defaults (SMOKE, a synthetic trace, the
    card), dense and paged, under ``--verify``.  Returns the replays'
    launch counts."""
    set_gemm_mode("kernel")
    params = init_params(cfg, seed=1, device=DEV)
    paged = dict(kv="paged", page_size=16)
    total = {n: 0 for n in SERVE_KERNELS}
    for label, scfg in (
            ("SMOKE dense smoke6", ServeConfig(batch_slots=3,
                                               max_len=max_len)),
            ("SMOKE paged-f32 smoke6", ServeConfig(batch_slots=3,
                                                   max_len=max_len, **paged)),
            ("SMOKE paged-int8 smoke6", ServeConfig(
                batch_slots=3, max_len=max_len, kv_dtype="int8", **paged))):
        counts, _ = replay(cfg, params, trace, scfg, label)
        for n in total:
            total[n] += counts[n]
    for argv in (["--verify"],
                 ["--kv", "paged", "--page_size", "16", "--verify"]):
        K.reset_launch_counts()
        S.main(argv)                 # raises unless it prints "verify OK"
        torch.cuda.synchronize()
        counts = K.launch_counts()
        print(f"[serve] launcher {' '.join(argv)}: launches "
              f"{json.dumps(counts)}")
        decode = "flash_paged_decode" if "paged" in argv else "flash_decode"
        missing = [n for n in ("gama_gemm", "flash_attention", decode)
                   if counts[n] == 0]
        if missing:
            raise AssertionError(f"launcher {argv}: kernels never launched: "
                                 f"{missing}")
    del params
    return total


def serve_phase(cfg, max_len):
    set_gemm_mode("kernel")
    params = init_params(cfg, seed=1, device=DEV)
    smoke6 = S.load_trace(S.resolve_trace_path("smoke6"), cfg.vocab_size,
                          seed=0)
    long8 = S.synth_trace(LONG_REQS, LONG_PROMPT, LONG_NEW, 3,
                          cfg.vocab_size, seed=0)
    paged = dict(kv="paged", page_size=16)
    paths = [
        ("dense smoke6", smoke6, ServeConfig(batch_slots=3, max_len=max_len)),
        ("paged-bf16 smoke6", smoke6,
         ServeConfig(batch_slots=3, max_len=max_len, **paged)),
        ("paged-int8 smoke6", smoke6,
         ServeConfig(batch_slots=3, max_len=max_len, kv_dtype="int8",
                     **paged)),
        ("paged-bf16 smoke6 pool_pages=4", smoke6,
         ServeConfig(batch_slots=3, max_len=max_len, pool_pages=4, **paged)),
        ("paged-bf16 synth 8x448+32", long8,
         ServeConfig(batch_slots=LONG_REQS, max_len=LONG_LEN, **paged)),
    ]
    total = {n: 0 for n in SERVE_KERNELS}
    for label, trace, scfg in paths:
        counts, rep = replay(cfg, params, trace, scfg, label)
        if "pool_pages=4" in label and rep["preemptions"] < 1:
            raise AssertionError(f"{label}: no preemption in a 4-page pool")
        for n in total:
            total[n] += counts[n]

    kern, ref_lg, per_prefill, per_decode = logits_kernel_vs_ref(
        cfg, params, smoke6[0]["prompt"], max_len)
    if not torch.isfinite(kern).all():
        raise AssertionError("non-finite logits")
    diff = (kern - ref_lg).abs().max().item()
    same = (kern.argmax(-1) == ref_lg.argmax(-1)).float().mean().item()
    # Each GEMM path rounds its f32 sum to bf16 (<= 1 ulp apart); the
    # differences compound over 32 layers of random weights.
    tol = 0.1
    print(f"[serve] gemm kernel vs ref: 1 prefill + 4 decode steps, max "
          f"|logit diff|={diff:.4e} (tol {tol}, logit std "
          f"{ref_lg.std().item():.3f}), argmax agreement={same:.2f}; launches "
          f"per prefill {json.dumps(per_prefill)}, per decode step "
          f"{json.dumps(per_decode)}")
    if diff > tol:
        raise AssertionError(f"kernel vs ref logits differ by {diff}")
    prefill_attention_kernel_vs_ref(cfg, params, LONG_PROMPT, LONG_LEN,
                                    pages_for(LONG_LEN, 16) * 16)
    # The decode step's profile first: it counts every launch of a step,
    # and one taken after the long replay's profile (140k kernels) missed
    # 60 of the ~11k kernels of its 5 steps.
    profile_decode(cfg, params, max_len)
    profile_replay(cfg, params, long8, paths[-1][2], paths[-1][0])
    return total


# ---------------------------------------------------------------------------
# 5. Train: wkv6 kernels, then RWKV-6 3B
# ---------------------------------------------------------------------------


def _wkv_inputs(gen, b, h, t, n, dtype=torch.bfloat16):
    """Inputs at the scale of the training path: r, k, v ~ N(0, 0.25) in
    ``dtype`` (the compute dtype), u ~ N(0, 0.01), and decays w = exp(-exp(x))
    from the real decay's range, x uniform in [-8, 2]: w from ~6e-4 (near 0)
    to ~0.9997."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    r, k, v = ((randn(b, h, t, n) * 0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(
        torch.rand((b, h, t, n), generator=gen, device=DEV) * 10 - 8))
    u = randn(h, n) * 0.1
    gy = randn(b, h, t, n).to(dtype)
    return r, k, v, w, u, gy


def _err_to_max(got, want, tol):
    """Max |got - want|; fails unless it is <= tol * max(1, max |want|).
    The kernels and the plain versions sum in different orders, and where
    a sum cancels the error is relative to its terms, not its result."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError("kernel output has non-finite values")
    scale = max(1.0, want.float().abs().max().item())
    err = (got.double() - want.double()).abs().max().item()
    if err > tol * scale:
        raise AssertionError(f"max abs err {err:.3e} over {tol:g} * "
                             f"max(1, max|plain|) = {tol * scale:.3e}")
    return err


def check_wkv(label, b, h, t, n, seed, main=False, dtype=torch.bfloat16):
    """wkv6 and wkv6_bwd against ref_wkv and ref_wkv_bwd, r/k/v/gy in
    ``dtype``.  Tolerances, of the largest value: with bf16 r/k/v, the bf16
    outputs (y, gr, gk, gv) 1e-2 (one bf16 ulp is 2**-8 of a value) and the
    f32 ones (gw, gu) 1e-3 (f32 sums over up to 4096 steps in another
    order); with f32 r/k/v (only T=64 here) every output 1e-4.  Both
    kernels must also repeat themselves bit for bit (no atomics).  Each
    line names the chunk length (``wkv_chunk``), the blocks of each
    kernel one call launches and its scratch bytes."""
    gen = _gen(seed)
    r, k, v, w, u, gy = _wkv_inputs(gen, b, h, t, n, dtype)
    f32 = dtype == torch.float32
    tol_act, tol_f32 = (1e-4, 1e-4) if f32 else (1e-2, 1e-3)
    tol_text = "1e-4" if f32 else "1e-2 (bf16) / 1e-3 (f32)"
    y = wkv6(r, k, v, w, u)
    y_again = wkv6(r, k, v, w, u)
    grads = wkv6_bwd(r, k, v, w, u, gy)
    again = wkv6_bwd(r, k, v, w, u, gy)
    want_y = ref.ref_wkv(r, k, v, w, u)
    want = ref.ref_wkv_bwd(r, k, v, w, u, gy)
    torch.cuda.synchronize()
    errs = {"y": _err_to_max(y, want_y, tol_act)}
    for name, got_g, want_g in zip(("gr", "gk", "gv", "gw", "gu"), grads,
                                   want):
        errs[name] = _err_to_max(got_g, want_g,
                                 tol_act if name in ("gr", "gk", "gv")
                                 else tol_f32)
    if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
        raise AssertionError(f"wkv6_bwd {label}: two runs differ")
    if not torch.equal(y, y_again):
        raise AssertionError(f"wkv6 {label}: two runs differ")
    del want, again, y_again
    elems = b * h * t * n
    # Bytes: every input read once, every output written once.  Operations:
    # the least the recurrence needs per (b, h, t): 4 N^2 forward (r.S and
    # the rank-1 state update), 12 N^2 backward (the state again, and
    # r/k/v/w's four products with S or G plus G's update).
    e = r.element_size()
    fwd_bytes = elems * (3 * e + 4 + e) + h * n * 4
    bwd_bytes = elems * (4 * e + 4 + 3 * e + 4) + 2 * h * n * 4
    steps = b * h * t

    def mk(fn):
        def make():     # fresh inputs per copy, rotated past the L2
            args = _wkv_inputs(gen, b, h, t, n, dtype)
            return lambda: fn(*args)
        return make

    fwd_ms = device_ms(mk(lambda *a: wkv6(*a[:5])), fwd_bytes)
    bwd_ms = device_ms(mk(wkv6_bwd), bwd_bytes)
    # The plain versions loop over T in Python: at long T one call per
    # graph does.
    plain_reps = 24 if t <= 128 else 1
    fwd_plain = device_ms(mk(lambda *a: ref.ref_wkv(*a[:5])), fwd_bytes,
                          reps=plain_reps)
    bwd_plain = device_ms(mk(ref.ref_wkv_bwd), bwd_bytes, reps=plain_reps)
    out = {}
    chunk = wkv_mod.wkv_chunk(t, n, dtype)
    for name, ms, plain, nbytes, flops, err in (
            ("wkv6", fwd_ms, fwd_plain, fwd_bytes, 4.0 * n * n * steps,
             errs["y"]),
            ("wkv6_bwd", bwd_ms, bwd_plain, bwd_bytes, 12.0 * n * n * steps,
             max(v_ for k_, v_ in errs.items() if k_ != "y"))):
        bms, by = bound(nbytes, flops, torch.float32)
        bwd = name == "wkv6_bwd"
        grid = wkv_mod.blocks(b, h, t, n, chunk, bwd)
        res = RESULTS[name]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        print(f"[kernel] {name} {label} B={b} H={h} T={t} N={n} "
              f"r/k/v={'f32' if f32 else 'bf16'} w/u=f32 max_abs_err={err:.3e} "
              f"tol={('1e-4' if f32 else '1e-2') if name == 'wkv6' else tol_text}"
              f"*max(1,max|plain|) kernel_ms={ms:.5f} plain_ms={plain:.5f} "
              f"bound_ms={bms:.6f} ({by}: {nbytes / 1e6:.2f} MB at "
              f"{HBM_BYTES_S / 1e12:g} TB/s, {flops / 1e9:.3f} GFLOP f32 at "
              f"{PEAK_OPS_S[torch.float32] / 1e12:g} TFLOP/s) library_ms=null "
              f"(none: no single PyTorch call computes the WKV6 recurrence) "
              f"chunk={chunk} chunks={wkv_mod.n_chunks(t, chunk)} "
              f"blocks={sum(grid.values())} {json.dumps(grid)} scratch_bytes="
              f"{4 * wkv_mod.scratch_floats(b, h, t, n, chunk, bwd)}")
        out[name] = ms
        if main:
            res.update(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms,
                       bound_by=by, shape=f"B={b} H={h} T={t} N={n}")
    print(f"[kernel] wkv6_bwd {label} per-output max_abs_err "
          f"{json.dumps({k_: float(f'{v_:.3e}') for k_, v_ in errs.items()})}"
          f" repeatable=True (wkv6 and wkv6_bwd)")
    return out


def wkv_phase():
    check_wkv("train-shape", 8, 40, 64, 64, seed=41, main=True)
    check_wkv("ragged-T", 8, 40, 100, 64, seed=42)
    check_wkv("long-prompt", 1, 40, 4096, 64, seed=43)
    check_wkv("smoke-head", 2, 4, 37, 16, seed=44)
    # The build the SMOKE launcher and the restart check run: f32 compute,
    # head size 16, at their batch (8 x 64 tokens, 4 heads).
    check_wkv("smoke-launcher", 8, 4, 64, 16, seed=45, dtype=torch.float32)


@contextlib.contextmanager
def wkv_mode(mode, u_scale=1.0):
    """Route the models' ``ops.wkv`` calls through ``mode`` for a while, with
    the bonus u scaled by ``u_scale`` (the controls' perturbation)."""
    orig = ops.wkv

    def routed(r, k, v, w, u):
        return orig(r, k, v, w, u * u_scale if u_scale != 1.0 else u,
                    mode=mode)
    ops.wkv = routed
    try:
        yield
    finally:
        ops.wkv = orig


def _batches(cfg, batch, seq_len, seed):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                  global_batch=batch, seed=seed))


def _kernel_name(e):
    return e.name.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("<")[0].split("(")[0][:70]


def _kind(name):
    low = name.lower()
    if "wkv6" in low:
        return name
    if low.startswith("gemm_"):      # csrc/gemm.cu's kernels
        return "GEMM (gama_gemm)"
    if low.startswith("flash_attention"):
        return "prefill attention (flash_attention)"
    if low.startswith(("flash_decode", "paged_decode")):
        return "decode attention (flash_decode, flash_paged_decode)"
    if any(x in low for x in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "GEMM (torch.matmul)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "AdamW (torch._foreach_*)"
    if "reduce" in low or "norm" in low:
        return "reductions"
    return "elementwise and other torch"


def train_phase(steps=4):
    """RWKV-6 3B FULL: f32 params on the card, ``steps`` training steps at
    global batch 8 x 64 tokens through make_train_step (no remat: every
    activation fits), the first a warm-up; launch counts reset just before
    the measured steps and read just after; then one profiled step."""
    set_gemm_mode("ref")
    cfg = C.get("rwkv6_3b")
    # The serve phase's engines may sit in reference cycles holding the
    # SmolLM weights and KV pools (~1 GB): free them, so that the peak is
    # the training step's own.
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=2, device=DEV, dtype=torch.float32)
    n_params = sum(p.numel() for p in adamw.leaves(params))
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    opt = adamw.init(params)
    step_fn = make_train_step(cfg, opt_cfg, remat=False)
    data = _batches(cfg, 8, 64, seed=0)
    tokens = 8 * 64
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} heads={cfg.d_model // cfg.rwkv.head_size}x"
          f"{cfg.rwkv.head_size} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"params={n_params} (f32) compute={cfg.compute_dtype} "
          f"global_batch=8 seq_len=64 remat=off gemm=torch.matmul")
    total = {n: 0 for n in TRAIN_KERNELS}
    step_ms = []
    for i in range(steps):
        batch = data.batch_at(i)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step_fn(params, opt, batch)
        end.record()
        end.synchronize()
        counts = K.launch_counts()
        ms = start.elapsed_time(end)
        loss = float(m["loss"])
        print(f"[train] step {i}{' (warm-up)' if i == 0 else ''}: "
              f"loss={loss:.5f} grad_norm={float(m['grad_norm']):.5f} "
              f"lr={m['lr']:.3e} step_ms={ms:.3f} tok_s={tokens / ms * 1e3:.1f}"
              f" max_memory_allocated={torch.cuda.max_memory_allocated()} "
              f"launches={json.dumps({n: counts[n] for n in TRAIN_KERNELS})}")
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss at step {i}")
        bad = {n: counts[n] for n in TRAIN_KERNELS
               if counts[n] != cfg.n_layers}
        if bad:
            raise AssertionError(f"expected {cfg.n_layers} launches of each "
                                 f"wkv kernel per step, got {bad}")
        if i:
            step_ms.append(ms)
            for n in TRAIN_KERNELS:
                total[n] += counts[n]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    batch = data.batch_at(steps)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_kind = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = _kernel_name(e)
            us = e.time_range.elapsed_us()
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + us)
            n, t = by_kind.get(_kind(name), (0, 0.0))
            by_kind[_kind(name)] = (n + 1, t + us)
    if not by_name:
        print(f"[profile] train step wall_ms={wall_ms:.3f}; device time not "
              f"measured (the profiler saw no CUDA events)")
    else:
        busy = sum(t for _, t in by_name.values()) / 1e3
        plain_wall = sum(step_ms) / len(step_ms)
        print(f"[profile] train step (rwkv6-3b FULL, 8x64 tokens): traced "
              f"wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
              f"device_idle_share={1 - busy / wall_ms:.3f} (traced); "
              f"against the measured steps' mean {plain_wall:.3f} ms "
              f"(profiler off) {1 - busy / plain_wall:.3f}; kernels="
              f"{sum(n for n, _ in by_name.values())}")
        for kind, (n, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
            print(f"[profile]   by kind: {kind}: {n} launches, "
                  f"{us / 1e3:.3f} ms ({us / 1e3 / busy:.3f} of busy)")
        for name, (n, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:15]:
            print(f"[profile]   {name}: {n} launches, {us / 1e3:.3f} ms")
    del params, opt, m
    torch.cuda.empty_cache()
    return total


def _grads(cfg, params, batch, mode, u_scale=1.0):
    """Loss and the gradient of every leaf with ``ops.wkv`` in ``mode``.  A
    ``ref`` run must launch no wkv kernel: the counts may not move."""
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    before = K.launch_counts()
    with wkv_mode(mode, u_scale):
        loss, _ = loss_fn(params, batch, cfg, remat=False)
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    moved = {n: K.launch_counts()[n] - before[n] for n in TRAIN_KERNELS}
    if mode == "ref" and any(moved.values()):
        raise AssertionError(f"the plain run launched wkv kernels: {moved}")
    return loss.item(), grads, moved


def _grad_diff(names, g_a, g_b):
    """Per leaf: max |a - b| over the largest |b| of that leaf."""
    return {n: (a - b_).abs().max().item() / max(b_.abs().max().item(), 1e-30)
            for n, a, b_ in zip(names, g_a, g_b)}


def _worst(rel, n=5):
    return json.dumps({k: float(f"{v:.3e}") for k, v in
                       sorted(rel.items(), key=lambda kv: -kv[1])[:n]})


def train_kernel_vs_plain():
    """One step's loss and gradients at FULL width and 2 layers, with the
    wkv6 kernels (``ops.wkv`` auto) and with the plain recurrence (``ref``,
    torch autograd of the loop), same parameters and batch, twice:

    * f32 compute: the two differ only in the f32 summation order inside
      the recurrence.  Bounds: the loss within 1e-5, every leaf's gradient
      within 1e-4 of its largest element.  Control: the plain run with u
      1% off must break the gradient bound, so a wrong kernel would.
    * bf16 compute (the FULL config's): y, gr, gk and gv round to bf16,
      and a last-bit difference before rounding flips a bf16 ulp (2**-8).
      Control: the plain run with u scaled by 1 + 1e-6, a change of the
      size of a summation-order difference, gives the rounding floor.
      Bounds, as a witness that the step stays finite and close: the loss
      within 1e-2, every leaf within 5e-2 of its largest element."""
    base = dataclasses.replace(C.get("rwkv6_3b"), n_layers=2)
    params = init_params(base, seed=3, device=DEV, dtype=torch.float32)
    names = [n for n, _ in _leaf_names(params)]
    batch = {k: torch.as_tensor(v, device=DEV)
             for k, v in _batches(base, 8, 64, seed=1).batch_at(0).items()}
    for compute, loss_tol, grad_tol, u_scale in (
            ("float32", 1e-5, 1e-4, 1.01), ("bfloat16", 1e-2, 5e-2, 1 + 1e-6)):
        cfg = dataclasses.replace(base, compute_dtype=compute)
        loss_k, g_k, counts = _grads(cfg, params, batch, "auto")
        loss_p, g_p, _ = _grads(cfg, params, batch, "ref")
        rel = _grad_diff(names, g_k, g_p)
        del g_k
        loss_c, g_c, _ = _grads(cfg, params, batch, "ref", u_scale)
        rel_c = _grad_diff(names, g_c, g_p)
        del g_c, g_p
        print(f"[train] kernel vs plain (rwkv6-3b width, 2 layers, 8x64 "
              f"tokens, compute={compute}): loss {loss_k:.7f} vs "
              f"{loss_p:.7f} (|diff| {abs(loss_k - loss_p):.3e}, bound "
              f"{loss_tol:g}); gradient max rel diff {max(rel.values()):.3e}"
              f" over {len(rel)} leaves (bound {grad_tol:g}), largest: "
              f"{_worst(rel)}; launches {json.dumps(counts)}")
        print(f"[train]   control, plain with u x {u_scale!r} vs plain "
              f"({'must break the bound' if compute == 'float32' else 'the bf16 rounding floor'}): "
              f"loss |diff| {abs(loss_c - loss_p):.3e}, gradient max rel diff "
              f"{max(rel_c.values()):.3e}, largest: {_worst(rel_c)}")
        if counts != {"wkv6": 2, "wkv6_bwd": 2}:
            raise AssertionError(f"kernel path launched {counts}")
        if abs(loss_k - loss_p) > loss_tol or max(rel.values()) > grad_tol:
            raise AssertionError(f"kernel and plain training steps differ "
                                 f"({compute})")
        if compute == "float32" and max(rel_c.values()) <= grad_tol:
            raise AssertionError("the f32 bound does not catch u 1% off")
    del params
    torch.cuda.empty_cache()


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaf_names(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def trainer_phase():
    """The training launcher at SMOKE size on the card, then a restart
    check: a Trainer that fails once at step 3 restores the step-2
    checkpoint and must log the uninterrupted run's losses exactly."""
    ckpt_root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        K.reset_launch_counts()
        res = TL.main(["--arch", "rwkv6_3b", "--smoke", "--steps", "6",
                       "--device", DEV,
                       "--ckpt_every", "2", "--ckpt_dir",
                       os.path.join(ckpt_root, "launcher")])
        counts = K.launch_counts()
        if res["restarts"] != 0 or res["final_step"] != 6:
            raise AssertionError(f"launcher: {res}")
        print(f"[train] launcher --smoke --steps 6 --ckpt_every 2: "
              f"final_step={res['final_step']} restarts={res['restarts']} "
              f"losses={[round(m['loss'], 5) for m in res['metrics']]} "
              f"launches={json.dumps({n: counts[n] for n in TRAIN_KERNELS})}")
        if not counts["wkv6"] or not counts["wkv6_bwd"]:
            raise AssertionError("the launcher's steps ran no wkv kernel")

        cfg = C.get_smoke("rwkv6_3b")

        def run(tag, hook=None):
            params = init_params(cfg, seed=0, device=DEV, dtype=torch.float32)
            opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                        total_steps=6)
            data = _batches(cfg, 8, 64, seed=0)
            t = Trainer(cfg, TrainConfig(
                steps=6, ckpt_every=2, log_every=1,
                ckpt_dir=os.path.join(ckpt_root, tag)), opt_cfg, params,
                adamw.init(params), lambda s: data.iterate(s),
                make_train_step(cfg, opt_cfg, remat=True,
                                remat_policy="tp_outs"), failure_hook=hook)
            return t.run()
        clean = run("clean")
        fail = {3}

        def hook(step):
            if step in fail:
                fail.clear()
                raise RuntimeError("injected node failure")
        hurt = run("hurt", hook)
        want = {m["step"]: m["loss"] for m in clean["metrics"]}
        got = {m["step"]: m["loss"] for m in hurt["metrics"]}
        print(f"[train] restart: uninterrupted losses "
              f"{[want[s] for s in sorted(want)]}; with a failure at step 3 "
              f"steps {[m['step'] for m in hurt['metrics']]} restarts="
              f"{hurt['restarts']} final losses {[got[s] for s in sorted(got)]}"
              f" equal={got == want}")
        if clean["restarts"] != 0 or hurt["restarts"] != 1 or got != want:
            raise AssertionError("restart did not resume the uninterrupted "
                                 "run's losses")
        if [m["step"] for m in hurt["metrics"]] != [0, 1, 2, 2, 3, 4, 5]:
            raise AssertionError("restart did not resume from step 2")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    for name, log in logs.items():
        print(f"[build] {name}:\n{log.strip()}")
    print(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f}s")

    cfg = C.get("smollm_360m")
    trace = S.load_trace(S.resolve_trace_path("smoke6"), cfg.vocab_size)
    max_len = max(len(t["prompt"]) + t["max_new"] for t in trace) + 8
    smoke_cfg = C.get_smoke("smollm_360m")
    smoke_trace = S.load_trace(S.resolve_trace_path("smoke6"),
                               smoke_cfg.vocab_size)
    smoke_len = max(len(t["prompt"]) + t["max_new"] for t in smoke_trace) + 8
    kernel_phase(cfg, max_len, smoke_len)
    wkv_phase()
    counts = smoke_serve_phase(smoke_cfg, smoke_trace, smoke_len)
    for name, n in serve_phase(cfg, max_len).items():
        counts[name] += n
    counts.update(train_phase())
    train_kernel_vs_plain()
    trainer_phase()

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=REPLACES[name], launches=counts[name],
        max_abs_err=RESULTS[name]["max_abs_err"],
        **{k: RESULTS[name][k] for k in keys}) for name in SOURCES]}
    print("[shapes] " + json.dumps({n: RESULTS[n]["shape"] for n in SOURCES}))
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
