#!/usr/bin/env python3
"""Time the PyTorch port's ``gama_gemm`` on the card at the serve path's
GEMM shapes, beside ``torch.matmul`` and, optionally, an older build of the
kernel, in one process on one card, in turns.

    python3 tools/gemm_table.py [--baseline DIR] [--sweep] [--json PATH]

Shapes: SmolLM-360M's weight GEMMs at M = 1, 3, 8, 16 and 512, Qwen3-8B's
at M = 3, and the GAMA paper's Table V array GEMMs.  ``--baseline DIR``
names a directory holding an older ``gemm.cu`` (and its ``common.cuh``)
with the entry point ``gama_gemm_launch(a, b, c, m, k, n, code, scale,
stream)``, as the port's first kernel had; it is built with the port's
nvcc flags and timed at the same shapes (order: baseline, kernel,
library, library, kernel, baseline; each column is the mean of its two
turns).  Every time is device time from CUDA events around a CUDA graph
of calls that rotate over copies of B covering twice the 50 MB L2, so the
weight comes from device memory as on the serve path.  ``--sweep`` also
times every plan the kernel takes at each shape (the timings
``kernels/gemm.py:plan`` was fitted to) and fails unless all of them give
the default plan's bits.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import L2_BYTES, bound, device_ms  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.configs.gama_paper import ARRAY_GEMMS  # noqa: E402
from repro_torch.kernels import _build, gemm  # noqa: E402

CODES = {torch.bfloat16: 1, torch.int32: 2, torch.int16: 3, torch.int8: 4}


def candidates(m: int, k: int, n: int, dtype: torch.dtype):
    """Every plan the kernel takes for this shape with the K walk of
    ``splits_for``: 16-row tiles up to m = 64, 64 rows above 16, 128 above
    64; the slices as a cluster or in one block; rings of 3, 4, 6, 8."""
    splits = gemm.splits_for(k, n, dtype)
    for bm, bns in gemm.TC_TILES.items():
        if not ((bm == 16 and m <= 64) or (bm == 64 and m > 16)
                or (bm == 128 and m > 64)):
            continue
        for bn in bns:
            for cluster in (0, 1) if splits > 1 else (0,):
                for stages in (3, 4, 6, 8):
                    p = gemm.Plan(bm, bn, splits, cluster, stages)
                    if gemm.smem_bytes(p, dtype) <= gemm.SMEM_LIMIT:
                        yield p


def load_baseline(directory: str):
    """Build ``directory/gemm.cu`` with the port's flags; its launcher."""
    out = os.path.join(ROOT, "build", "gemm_baseline.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", directory,
                           "-o", out, os.path.join(directory, "gemm.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the baseline:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = ctypes.CDLL(out).gama_gemm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(a, b, out_dtype):
        out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                          device=a.device)
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                 a.shape[1], b.shape[1], CODES[out_dtype], 1.0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline gemm launch failed: CUDA error {err}")
        return out
    return call


def shapes():
    """(label, m, k, n, dtype, out dtype, launches per decode step)."""
    rows = []
    for arch, ms in (("smollm_360m", (1, 3, 8, 16, 512)), ("qwen3_8b", (3,))):
        cfg = C.get(arch)
        for m in ms:
            for name, (k, n, launches) in cfg.gemm_shapes().items():
                rows.append((f"{arch}:{name}", m, k, n, torch.bfloat16,
                             torch.bfloat16, launches))
    for name, (m, k, n) in ARRAY_GEMMS.items():
        dtype = torch.bfloat16 if name.startswith("bf16") else torch.int8
        out = {"int8-int32": torch.int32, "int8-int16": torch.int16,
               "int8-int8": torch.int8}.get(name, torch.bfloat16)
        rows.append((f"tableV:{name}", m, k, n, dtype, out, None))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="directory with an older gemm.cu")
    ap.add_argument("--json", help="write the table here as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every plan the kernel takes at each "
                         "shape, and check that all give the same bits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_table: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[gemm_table] card: {card}")
    _build.build()
    base = load_baseline(args.baseline) if args.baseline else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = []
    for label, m, k, n, dtype, out_dtype, per_step in shapes():
        if dtype == torch.int8:
            a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                              dtype=torch.int8)
        else:
            a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b_bytes = k * n * a.element_size()
        copies = max(1, min(256, math.ceil(2 * L2_BYTES / b_bytes)))  # as device_ms
        if dtype == torch.int8:
            bs = [torch.randint(-128, 128, (k, n), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(copies)]
        else:
            bs = [(torch.randn((k, n), generator=gen, device="cuda")
                   * k ** -0.5).to(dtype) for _ in range(copies)]

        def calls(fn):
            return [(lambda bb=bb: fn(a, bb)) for bb in bs]

        def timed(fns):   # chip_smoke.device_ms takes one call per copy
            return device_ms(itertools.cycle(fns).__next__, b_bytes)

        lib_fn = None
        if dtype != torch.int8:
            lib_fn = torch.matmul
        elif out_dtype == torch.int32 and m > 16 and k % 8 == 0 and n % 8 == 0:
            lib_fn = torch._int_mm
        times = {"baseline": [], "kernel": [], "library": []}
        order = ["baseline", "kernel", "library", "library", "kernel",
                 "baseline"]
        for who in order:
            if who == "baseline" and base is not None:
                times[who].append(timed(calls(
                    lambda x, y: base(x, y, out_dtype))))
            elif who == "kernel":
                times[who].append(timed(calls(
                    lambda x, y: gemm.gama_gemm(x, y, out_dtype=out_dtype))))
            elif who == "library" and lib_fn is not None:
                times[who].append(timed(calls(lib_fn)))
        sweep = []
        if args.sweep:
            want = gemm.gama_gemm(a, bs[0], out_dtype=out_dtype)
            for cand in candidates(m, k, n, dtype):
                got = torch.empty_like(want)
                gemm.launch(a, bs[0], got, cand)
                if not torch.equal(got, want):
                    raise AssertionError(f"{label} M={m}: plan {tuple(cand)} "
                                         f"differs from the default plan")
                outs = [torch.empty_like(want) for _ in bs]
                sweep.append((timed([
                    (lambda bb=bb, o=o: gemm.launch(a, bb, o, cand))
                    for bb, o in zip(bs, outs)]), tuple(cand)))
            sweep.sort()
        del bs
        nbytes = (m * k + k * n) * a.element_size() + m * n * out_dtype.itemsize
        bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n, dtype)
        p = gemm.plan(m, k, n, dtype)
        row = {"shape": label, "m": m, "k": k, "n": n,
               "dtype": f"{str(dtype)[6:]}->{str(out_dtype)[6:]}",
               "plan": p._asdict(), "blocks": gemm.blocks(p, m, n),
               "launches_per_decode_step": per_step if m <= 16 else None,
               "kernel_ms": sum(times["kernel"]) / 2,
               "kernel_ms_turns": times["kernel"],
               "baseline_ms": (sum(times["baseline"]) / 2
                               if times["baseline"] else None),
               "library_ms": (sum(times["library"]) / 2
                              if times["library"] else None),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "sweep": sweep}
        table.append(row)
        fmt = (lambda x: "n/a" if x is None else f"{x:.5f}")
        print(f"[gemm_table] {label} M={m} K={k} N={n} {row['dtype']} "
              f"plan={tuple(p)} blocks={row['blocks']} "
              f"kernel_ms={fmt(row['kernel_ms'])} "
              f"baseline_ms={fmt(row['baseline_ms'])} "
              f"library_ms={fmt(row['library_ms'])} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
              f"per_step={per_step if m <= 16 else '-'}")
        if sweep:
            print(f"[gemm_table]   sweep of {len(sweep)} plans, all the same "
                  f"bits; fastest: " + "; ".join(
                      f"{p}={t:.5f}" for t, p in sweep[:4]))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card, "rows": table}, fh, indent=1)
    print(f"[gemm_table] card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
