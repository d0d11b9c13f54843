#!/usr/bin/env python3
"""Time the PyTorch port's ``flash_decode`` and ``flash_paged_decode`` on the
card at the serve path's decode shapes, beside the byte bound, the plain
version, SDPA on a pregathered cache and, optionally, an older build of
both kernels, in one process on one card, in turns.

    python3 tools/decode_table.py [--baseline DIR] [--sweep] [--json PATH]

Shapes: SmolLM-360M's 15/5 heads of 64 at the smoke6 replay's decode (3
slots, lengths 28/20/13, 48-key tables, a 36-row dense cache) and at the
8 x 448-token replay's (8 slots, lengths 449-487, 31-page tables of 16,
a 496-row dense cache), in bf16 and int8 pages, and at lengths on and
around the chunk boundaries up to 4096 keys; Qwen3-8B's 32/8 heads of
128 at 8 slots of 517-4096 keys; the SMOKE configs' 6/2 heads of 16 in f32
with f32 and int8 pages.  The paged kernel runs with ``buffers`` 2 and 1;
the dense kernel on the pages gathered into a dense cache.

``--baseline DIR`` names a directory holding older ``decode_attention.cu``,
``paged_decode_attention.cu`` and their ``common.cuh`` with the entry
points the port's first kernels had (one block per slot and KV head, no
chunk argument), e.g. ``git show b9ad07e:src/repro_torch/csrc/<file>``.
They are built with the port's nvcc flags, checked against the plain
version, held bit for bit against the new kernels on every slot whose keys
fit in one chunk, and timed at the same shapes (order: baseline, kernel,
library, library, kernel, baseline; each column is the mean of its two
turns; the baseline takes no head dim 16).  ``--sweep`` also builds the
kernels with other chunk sizes (``-DREPRO_DECODE_CHUNK``) and times each
at every shape: the timings ``kernels/decode_attention.py:decode_chunk``
was chosen from.  Every time is device time from CUDA events around a
CUDA graph of calls that rotate over copies of the pools covering twice
the 50 MB L2.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import bound, decode_bound, device_ms, max_err  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.serving.kvpool import pages_for  # noqa: E402
from repro_torch.serving.quant import quantize_kv_pages  # noqa: E402

LONG = [449, 454, 460, 465, 471, 476, 482, 487]
QWEN_LONG = [4096, 3584, 3072, 2560, 2048, 1536, 1024, 517]
# (label, hq, hkv, d, q dtype, pool, page size, lengths, max_pages, dense Sk)
SHAPES = [
    ("smollm_360m smoke6 bf16", 15, 5, 64, torch.bfloat16, "float", 16,
     [28, 20, 13], 3, 36),
    ("smollm_360m 8x448 bf16", 15, 5, 64, torch.bfloat16, "float", 16, LONG,
     31, 496),
    ("smollm_360m 8x448 int8", 15, 5, 64, torch.bfloat16, "int8", 16, LONG,
     31, 496),
    ("smollm_360m chunk edges bf16", 15, 5, 64, torch.bfloat16, "float", 16,
     [1, 31, 32, 33, 64, 65, 517, 4096], 257, 4096),
    ("qwen3_8b long-context bf16", 32, 8, 128, torch.bfloat16, "float", 16,
     QWEN_LONG, 257, 4096),
    ("smoke d16 f32 smoke6", 6, 2, 16, torch.float32, "float", 16,
     [28, 20, 13], 3, 36),
    ("smoke d16 int8 smoke6", 6, 2, 16, torch.float32, "int8", 16,
     [28, 20, 13], 3, 36),
]
SWEEP = (32, 64, 128, 256)
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def _nvcc_all(jobs):
    """Compile ``(out, src, include, extra flags)`` jobs in parallel."""
    procs = []
    for out, src, inc, extra in jobs:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        procs.append((src, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *extra, "-I", inc, "-o", out,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")


def load_baseline(directory: str):
    """The older kernels in ``directory``: (dense, paged) launchers."""
    out = os.path.join(ROOT, "build", "decode_baseline")
    names = ("decode_attention", "paged_decode_attention")
    _nvcc_all([(os.path.join(out, f"{n}.so"),
                os.path.join(directory, f"{n}.cu"), directory, [])
               for n in names])
    dense = ctypes.CDLL(os.path.join(out, "decode_attention.so"))
    paged = ctypes.CDLL(os.path.join(out, "paged_decode_attention.so"))
    fd, fp = dense.flash_decode_launch, paged.flash_paged_decode_launch
    fd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fp.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fd.restype = fp.restype = ctypes.c_int

    def call_dense(q, k, v, length):
        b, hq, d = q.shape
        o = torch.empty_like(q)
        err = fd(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                 o.data_ptr(), b, hq, k.shape[1], k.shape[2], d,
                 dec._DTYPES[q.dtype], d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline flash_decode failed: {err}")
        return o

    def call_paged(q, kp, vp, bt, length, k_scale=None, v_scale=None):
        b, hq, d = q.shape
        o = torch.empty_like(q)
        err = fp(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                 None if k_scale is None else k_scale.data_ptr(),
                 None if v_scale is None else v_scale.data_ptr(),
                 bt.data_ptr(), length.data_ptr(), o.data_ptr(), b, hq,
                 kp.shape[1], kp.shape[2], d, bt.shape[1],
                 dec._DTYPES[q.dtype], dec._KV_DTYPES[kp.dtype], 2,
                 d ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline flash_paged_decode failed: {err}")
        return o
    return call_dense, call_paged


def load_chunk_variants():
    """The port's decode kernels built with every chunk size of
    :data:`SWEEP`: {chunk: (dense lib, paged lib)}."""
    jobs, libs = [], {}
    for c in SWEEP:
        out = os.path.join(ROOT, "build", f"decode_chunk{c}")
        for n in ("decode_attention", "paged_decode_attention"):
            jobs.append((os.path.join(out, f"{n}.so"),
                         str(_build.CSRC / f"{n}.cu"), str(_build.CSRC),
                         [f"-DREPRO_DECODE_CHUNK={c}"]))
    _nvcc_all(jobs)
    for c in SWEEP:
        out = os.path.join(ROOT, "build", f"decode_chunk{c}")
        libs[c] = tuple(dec.bind(ctypes.CDLL(os.path.join(out, f"{n}.so")))
                        for n in ("decode_attention",
                                  "paged_decode_attention"))
    return libs


def make_case(gen, hq, hkv, d, dtype, pool, ps, lengths, max_pages, sk):
    """q, pools in shuffled page order (null sink last), block tables,
    lengths, and the pages gathered into a dense (B, Hkv, sk, D) cache."""
    b = len(lengths)
    slot_pages = [pages_for(n, ps) for n in lengths]
    n_pool = sum(slot_pages) + 8
    perm = torch.randperm(n_pool, generator=gen, device="cuda").tolist()
    table = torch.full((b, max_pages), n_pool, dtype=torch.int32)
    for i, n in enumerate(slot_pages):
        table[i, :n], perm = torch.tensor(perm[:n]), perm[n:]
    case = {"q": torch.randn((b, hq, d), generator=gen,
                             device="cuda").to(dtype),
            "bt": table.cuda(),
            "ln": torch.tensor(lengths, dtype=torch.int32, device="cuda"),
            "sc": {}}

    def pools():
        kv = [torch.randn((n_pool + 1, hkv, ps, d), generator=gen,
                          device="cuda").to(dtype) for _ in range(2)]
        if pool == "int8":
            (kq, ks), (vq, vs) = map(quantize_kv_pages, kv)
            return kq, vq, {"k_scale": ks, "v_scale": vs}
        return kv[0], kv[1], {}

    def dense(kp, vp, sc):
        """The gathered cache in q's dtype, cut or zero-padded to sk."""
        out = []
        for pages, s in ((kp, sc.get("k_scale")), (vp, sc.get("v_scale"))):
            c = ref.gather_pages(ref.dequantize_pool(pages, s), case["bt"])
            c = c.to(dtype)[:, :, :sk]
            pad = sk - c.shape[2]
            if pad > 0:
                c = F.pad(c, (0, 0, 0, pad))
            out.append(c.contiguous())
        return out

    case["kp"], case["vp"], case["sc"] = pools()
    case["kc"], case["vc"] = dense(case["kp"], case["vp"], case["sc"])
    case["pools"], case["dense"] = pools, dense
    return case


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline",
                    help="directory with older decode_attention.cu, "
                         "paged_decode_attention.cu and common.cuh")
    ap.add_argument("--sweep", action="store_true",
                    help=f"also time chunk sizes {SWEEP}")
    ap.add_argument("--json", help="write the table here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_table: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[decode_table] card: {card}")
    _build.build()
    base = load_baseline(args.baseline) if args.baseline else None
    variants = load_chunk_variants() if args.sweep else {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = []
    for label, hq, hkv, d, dtype, pool, ps, lengths, max_pages, sk in SHAPES:
        case = make_case(gen, hq, hkv, d, dtype, pool, ps, lengths,
                         max_pages, sk)
        q, bt, ln = case["q"], case["bt"], case["ln"]
        kvd = torch.int8 if pool == "int8" else dtype
        chunk = dec.decode_chunk(d, kvd)
        tol = TOL[dtype]
        want = ops.decode_paged(q, case["kp"], case["vp"], block_tables=bt,
                                length=ln, mode="ref", **case["sc"])
        got = dec.flash_paged_decode(q, case["kp"], case["vp"], bt, length=ln,
                                     **case["sc"])
        got_dense = dec.flash_decode(q, case["kc"], case["vc"], length=ln)
        torch.cuda.synchronize()
        err = max_err(got, want, tol)
        err_dense = max_err(got_dense, ops.decode(
            q, case["kc"], case["vc"], length=ln, mode="ref"), tol)
        if pool == "float" and not torch.equal(got, got_dense):
            raise AssertionError(f"{label}: paged != dense on the gathered "
                                 f"cache")
        one_chunk = [i for i, n in enumerate(lengths) if n <= chunk]
        same_as_baseline = None
        use_base = base is not None and d != 16
        if use_base:
            b_paged = base[1](q, case["kp"], case["vp"], bt, ln,
                              **case["sc"])
            b_dense = base[0](q, case["kc"], case["vc"], ln)
            torch.cuda.synchronize()
            max_err(b_paged, want, tol)
            same_as_baseline = all(
                torch.equal(got[i], b_paged[i])
                and torch.equal(got_dense[i], b_dense[i]) for i in one_chunk)
            if not same_as_baseline:
                raise AssertionError(f"{label}: slots within one chunk "
                                     f"{one_chunk} differ from the baseline")

        def rotate(fn):
            def make():
                kp, vp, sc = case["pools"]()
                kc, vc = case["dense"](kp, vp, sc)
                return lambda: fn(kp, vp, sc, kc, vc)
            return make

        kv_elt = case["kp"].element_size() + (4 / d if pool == "int8" else 0)
        pool_bytes = 2 * case["kp"].numel() * case["kp"].element_size()
        nbytes, flops = decode_bound(
            len(lengths), hq, hkv, d, lengths, q.element_size(), kv_elt,
            sum(pages_for(n, ps) for n in lengths))
        fns = {
            "kernel": lambda kp, vp, sc, kc, vc: dec.flash_paged_decode(
                q, kp, vp, bt, length=ln, **sc),
            "kernel_buffers1": lambda kp, vp, sc, kc, vc:
                dec.flash_paged_decode(q, kp, vp, bt, length=ln, buffers=1,
                                       **sc),
            "dense": lambda kp, vp, sc, kc, vc: dec.flash_decode(
                q, kc, vc, length=ln),
        }
        if use_base:
            fns["baseline"] = lambda kp, vp, sc, kc, vc: base[1](
                q, kp, vp, bt, ln, **sc)
            fns["baseline_dense"] = lambda kp, vp, sc, kc, vc: base[0](
                q, kc, vc, ln)
        makers = {who: rotate(fn) for who, fn in fns.items()}
        grp = hq // hkv
        mask = (torch.arange(sk, device="cuda")[None, :]
                < ln[:, None])[:, None, None, :]

        def make_sdpa():
            # SDPA on a cache gathered and expanded to Hq heads beforehand.
            kp, vp, sc = case["pools"]()
            kc, vc = case["dense"](kp, vp, sc)
            kq, vq = (x.repeat_interleave(grp, 1) for x in (kc, vc))
            return lambda: F.scaled_dot_product_attention(
                q[:, :, None], kq, vq, attn_mask=mask)
        makers["library"] = make_sdpa
        times = {who: [] for who in makers}
        order = ["baseline", "baseline_dense", "kernel", "kernel_buffers1",
                 "dense", "library"]
        for who in order + order[::-1]:
            if who in makers:
                times[who].append(device_ms(makers[who], pool_bytes))
        plain = device_ms(lambda: (lambda: ops.decode_paged(
            q, case["kp"], case["vp"], block_tables=bt, length=ln,
            mode="ref", **case["sc"])), pool_bytes)
        sweep = {}
        for c, (lib_d, lib_p) in variants.items():
            def paged_c(kp, vp, sc, kc, vc, c=c, lib=lib_p):
                out = torch.empty_like(q)
                dec.launch_paged(lib, c, q, kp, vp, bt, ln, out, d ** -0.5,
                                 sc.get("k_scale"), sc.get("v_scale"), 2)
                return out

            def dense_c(kp, vp, sc, kc, vc, c=c, lib=lib_d):
                out = torch.empty_like(q)
                dec.launch(lib, c, q, kc, vc, ln, out, d ** -0.5)
                return out
            p_out = paged_c(case["kp"], case["vp"], case["sc"], None, None)
            torch.cuda.synchronize()
            max_err(p_out, want, tol)
            if c == chunk and not torch.equal(p_out, got):
                raise AssertionError(f"{label}: the chunk-{c} build differs "
                                     f"from the port's kernel")
            sweep[c] = {"paged_ms": device_ms(rotate(paged_c), pool_bytes),
                        "dense_ms": device_ms(rotate(dense_c), pool_bytes)}
        bms, by = bound(nbytes, flops, dtype)
        mean = {who: sum(t) / len(t) for who, t in times.items()}
        row = {"shape": label, "hq": hq, "hkv": hkv, "d": d,
               "dtype": str(dtype)[6:], "pool": pool, "page_size": ps,
               "lengths": lengths, "max_pages": max_pages, "dense_sk": sk,
               "chunk": chunk,
               "blocks": len(lengths) * hkv * -(-max_pages * ps // chunk),
               "active_blocks": hkv * sum(max(1, -(-n // chunk))
                                          for n in lengths),
               "max_abs_err": err, "dense_max_abs_err": err_dense,
               "one_chunk_slots_equal_baseline": same_as_baseline,
               "kernel_ms": mean["kernel"],
               "kernel_ms_turns": times["kernel"],
               "kernel_buffers1_ms": mean["kernel_buffers1"],
               "dense_ms": mean["dense"],
               "baseline_ms": mean.get("baseline"),
               "baseline_dense_ms": mean.get("baseline_dense"),
               "library_ms": mean["library"], "plain_ms": plain,
               "bound_ms": bms, "bound_by": by,
               "bound_over_kernel": bms / mean["kernel"], "sweep": sweep}
        table.append(row)
        fmt = (lambda x: "n/a" if x is None else f"{x:.5f}")
        print(f"[decode_table] {label} B={len(lengths)} Hq={hq} Hkv={hkv} "
              f"D={d} pool={pool} ps={ps} lengths={lengths} "
              f"max_pages={max_pages} Sk={sk} chunk={chunk} blocks="
              f"{row['blocks']} (active {row['active_blocks']}) "
              f"max_abs_err={err:.3e} paged_ms={fmt(mean['kernel'])} "
              f"buffers1_ms={fmt(mean['kernel_buffers1'])} "
              f"dense_ms={fmt(mean['dense'])} "
              f"baseline_paged_ms={fmt(mean.get('baseline'))} "
              f"baseline_dense_ms={fmt(mean.get('baseline_dense'))} "
              f"sdpa_pregathered_ms={fmt(mean['library'])} "
              f"plain_ms={plain:.5f} bound_ms={bms:.6f} ({by}) "
              f"bound/paged={bms / mean['kernel']:.4f} one-chunk slots "
              f"{one_chunk} equal to baseline: {same_as_baseline}")
        for c, t in sweep.items():
            print(f"[decode_table]   chunk {c}: paged_ms={t['paged_ms']:.5f} "
                  f"dense_ms={t['dense_ms']:.5f}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card, "rows": table}, fh, indent=1)
    print(f"[decode_table] card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
