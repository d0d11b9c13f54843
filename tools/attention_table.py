#!/usr/bin/env python3
"""Time the PyTorch port's ``flash_attention`` on the card at the serve
path's prefill shapes, beside ``scaled_dot_product_attention`` and,
optionally, an older build of the kernel, in one process on one card, in
turns.

    python3 tools/attention_table.py [--baseline DIR] [--sweep] [--json PATH]

Shapes (B = 1, causal from key 0, bf16): SmolLM-360M's 15/5 heads of 64 at
the 16-token bucket against 36- and 48-row caches (the dense and paged
smoke6 replays), the 488-token bucket against the 496-row scratch cache
(the 8 x 448-token replay) and 512 x 512; Qwen3-8B's 32/8 heads of 128 at
16 x 48 and 512 x 512.  ``--baseline DIR`` names a directory holding an
older ``flash_attention.cu`` (and its ``common.cuh``) with the entry point
``flash_attention_launch(q, k, v, o, b, hq, hkv, sq, sk, d, dtype, causal,
q_offset, kv_len, scale, stream)``, as the port's first kernel had; it is
built with the port's nvcc flags, checked against the plain version and
timed at the same shapes (order: baseline, kernel, library, library,
kernel, baseline; each column is the mean of its two turns).  Every time is
device time from CUDA events around a CUDA graph of calls on the same
inputs (warm in L2, as after the prefill's K/V projections).  The library
call is SDPA on K/V expanded to Hq heads beforehand.  ``--sweep`` also
times every plan the kernel takes at each shape (the timings
``kernels/flash_attention.py:plan`` was fitted to) and fails unless all of
them give the default plan's bits.  Needs a CUDA card.
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

from chip_smoke import _attn_bound, bound, device_ms, max_err  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (label, hq, hkv, sq, sk, d)
SHAPES = [("smollm_360m prefill-16 dense", 15, 5, 16, 36, 64),
          ("smollm_360m prefill-16 paged", 15, 5, 16, 48, 64),
          ("smollm_360m prefill-488", 15, 5, 488, 496, 64),
          ("smollm_360m prefill-512", 15, 5, 512, 512, 64),
          ("qwen3_8b prefill-16", 32, 8, 16, 48, 128),
          ("qwen3_8b prefill-512", 32, 8, 512, 512, 128)]


def load_baseline(directory: str):
    """Build ``directory/flash_attention.cu`` with the port's flags; its
    launcher (bf16, causal, from key 0)."""
    out = os.path.join(ROOT, "build", "attention_baseline.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", directory,
                           "-o", out,
                           os.path.join(directory, "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the baseline:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = ctypes.CDLL(out).flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v):
        b, hq, sq, d = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 hq, k.shape[1], sq, k.shape[2], d, 1, 1, 0, k.shape[2],
                 d ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline attention launch failed: CUDA "
                               f"error {err}")
        return out
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline",
                    help="directory with an older flash_attention.cu")
    ap.add_argument("--json", help="write the table here as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every plan the kernel takes at each "
                         "shape, and check that all give the same bits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_table: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[attention_table] card: {card}")
    _build.build()
    base = load_baseline(args.baseline) if args.baseline else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = torch.bfloat16
    table = []
    for label, hq, hkv, sq, sk, d in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((1, hq, sq, d), (1, hkv, sk, d),
                                 (1, hkv, sk, d)))
        kq = k.repeat_interleave(hq // hkv, 1)
        vq = v.repeat_interleave(hq // hkv, 1)
        want = ops.attention(q, k, v, causal=True, mode="ref")
        got = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(got, want, 2e-2)
        base_err = None
        if base is not None:
            base_err = max_err(base(q, k, v), want, 2e-2)
        fns = {"baseline": (lambda: base(q, k, v)) if base else None,
               "kernel": lambda: fa.flash_attention(q, k, v, causal=True),
               "library": lambda: F.scaled_dot_product_attention(
                   q, kq, vq, is_causal=True)}
        per_row = [min(sk, i + 1) for i in range(sq)]
        nbytes, flops = _attn_bound(1, hq, hkv, sq, d, 2, sum(per_row),
                                    max(per_row))
        times = {who: [] for who in fns}
        for who in ("baseline", "kernel", "library", "library", "kernel",
                    "baseline"):
            if fns[who] is not None:
                times[who].append(device_ms(lambda f=fns[who]: f, nbytes))
        sweep = []
        if args.sweep:
            for cand in fa.candidates(hq, hkv, d, dtype):
                out = torch.empty_like(q)

                def call(p=cand, o=out):
                    fa.launch(q, k, v, o, p, causal=True, scale=d ** -0.5,
                              q_offset=0, kv_len=sk)
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, got):
                    raise AssertionError(f"{label}: plan {tuple(cand)} "
                                         f"differs from the default plan")
                sweep.append((device_ms(lambda c=call: c, nbytes),
                              tuple(cand)))
            sweep.sort()
        bms, by = bound(nbytes, flops, dtype)
        p = fa.plan(1, hq, hkv, sq, sk, d, dtype)
        mean = {who: sum(t) / len(t) if t else None
                for who, t in times.items()}
        row = {"shape": label, "b": 1, "hq": hq, "hkv": hkv, "sq": sq,
               "sk": sk, "d": d, "plan": p._asdict(),
               "blocks": fa.blocks(p, 1, hq, sq), "max_abs_err": err,
               "baseline_max_abs_err": base_err,
               "kernel_ms": mean["kernel"], "kernel_ms_turns": times["kernel"],
               "baseline_ms": mean["baseline"], "library_ms": mean["library"],
               "bound_ms": bms, "bound_by": by,
               "bound_over_kernel": bms / mean["kernel"], "sweep": sweep}
        table.append(row)
        fmt = (lambda x: "n/a" if x is None else f"{x:.5f}")
        ratio = (lambda a, b_: "n/a" if a is None or b_ is None
                 else f"{a / b_:.2f}")
        print(f"[attention_table] {label} B=1 Hq={hq} Hkv={hkv} Sq={sq} "
              f"Sk={sk} D={d} plan={tuple(p)} blocks={row['blocks']} "
              f"max_abs_err={err:.3e} kernel_ms={fmt(mean['kernel'])} "
              f"baseline_ms={fmt(mean['baseline'])} "
              f"library_ms={fmt(mean['library'])} bound_ms={bms:.6f} ({by}) "
              f"kernel/library={ratio(mean['kernel'], mean['library'])} "
              f"kernel/baseline={ratio(mean['kernel'], mean['baseline'])} "
              f"bound/kernel={bms / mean['kernel']:.4f}")
        if sweep:
            print(f"[attention_table]   sweep of {len(sweep)} plans, all the "
                  f"same bits; fastest: " + "; ".join(
                      f"{c}={t:.5f}" for t, c in sweep[:5]))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card, "rows": table}, fh, indent=1)
    print(f"[attention_table] card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
