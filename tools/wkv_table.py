#!/usr/bin/env python3
"""Time the PyTorch port's ``wkv6`` and ``wkv6_bwd`` on the card at the
training path's shapes, beside the bound, the plain version and,
optionally, an older build of both kernels, in one process on one card,
in turns.

    python3 tools/wkv_table.py [--baseline DIR] [--sweep] [--json PATH]

Shapes: the five of ``chip_smoke.py``'s ``wkv_phase``: RWKV-6 3B's
training step (B=8 H=40 T=64 N=64, bf16 r/k/v), a ragged T=100, the long
prompt (B=1 H=40 T=4096), the SMOKE head size 16 in bf16 (B=2 H=4 T=37)
and the SMOKE launcher's f32 build (B=8 H=4 T=64 N=16).  Inputs as
``chip_smoke.py`` makes them: decays exp(-exp(x)), x uniform in [-8, 2].

``--baseline DIR`` names a directory holding an older ``wkv.cu`` and its
``common.cuh`` with the entry points the port's first kernels had (a
per-step state scratch, no chunk argument), e.g. ``git show
0280ef5:src/repro_torch/csrc/<file>``.  It is built with the port's nvcc
flags, checked against the plain version, and timed at the same shapes
(order: baseline, kernel, kernel, baseline; each column the mean of its
two turns).  ``--sweep`` also builds the kernels with other chunk lengths
(``-DREPRO_WKV_CHUNK``), checks each against the plain version, checks
that the length the table gives repeats the port's bits, and times each
at every shape: the timings ``kernels/wkv.py:wkv_chunk`` was chosen from.

Every time is device time from CUDA events around a CUDA graph of calls
that rotate over copies of the inputs covering twice the 50 MB L2.  For
each shape the tool also prints the scratch bytes of one call of each
kernel and the peak memory one ``wkv6_bwd`` call adds (outputs included;
``max_memory_allocated`` around it), for the new kernels and the baseline.
Needs a CUDA card.
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

from chip_smoke import (_err_to_max, _wkv_inputs, bound,  # noqa: E402
                        device_ms)
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import wkv as W  # noqa: E402

# (label, B, H, T, N, r/k/v dtype): chip_smoke.py's wkv_phase.
SHAPES = [
    ("train-shape", 8, 40, 64, 64, torch.bfloat16),
    ("ragged-T", 8, 40, 100, 64, torch.bfloat16),
    ("long-prompt", 1, 40, 4096, 64, torch.bfloat16),
    ("smoke-head", 2, 4, 37, 16, torch.bfloat16),
    ("smoke-launcher", 8, 4, 64, 16, torch.float32),
]
SWEEP = (16, 32, 64, 128)
# chip_smoke.py's check_wkv tolerances, of the largest value: bf16
# outputs 1e-2, f32 outputs 1e-3 (bf16 inputs) or 1e-4 (f32 inputs).
TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


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
    """The older kernels in ``directory``: (forward, backward) callables
    with the wrappers' signatures."""
    out = os.path.join(ROOT, "build", "wkv_baseline", "wkv.so")
    _nvcc_all([(out, os.path.join(directory, "wkv.cu"), directory, [])])
    lib = ctypes.CDLL(out)
    fwd, bwd = lib.wkv6_fwd_launch, lib.wkv6_bwd_launch
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int

    def call_fwd(r, k, v, w, u):
        b, h, t, n = r.shape
        y = torch.empty_like(r)
        err = fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), y.data_ptr(), b, h, t, n, W._DTYPES[r.dtype],
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline wkv6 failed: {err}")
        return y

    def call_bwd(r, k, v, w, u, gy):
        b, h, t, n = r.shape
        gr, gk, gv = (torch.empty_like(x) for x in (r, k, v))
        gw, gu = torch.empty_like(w), torch.empty_like(u)
        part = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
        states = torch.empty((b * h * t * n * n,), dtype=torch.float32,
                             device=r.device)
        err = bwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), gy.data_ptr(), gr.data_ptr(), gk.data_ptr(),
                  gv.data_ptr(), gw.data_ptr(), gu.data_ptr(),
                  part.data_ptr(), states.data_ptr(), b, h, t, n,
                  W._DTYPES[r.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline wkv6_bwd failed: {err}")
        return gr, gk, gv, gw, gu
    return call_fwd, call_bwd


def load_chunk_variants():
    """The port's wkv kernels built with every chunk length of
    :data:`SWEEP`: {chunk: library}."""
    jobs = [(os.path.join(ROOT, "build", f"wkv_chunk{c}", "wkv.so"),
             str(_build.CSRC / "wkv.cu"), str(_build.CSRC),
             [f"-DREPRO_WKV_CHUNK={c}"]) for c in SWEEP]
    _nvcc_all(jobs)
    return {c: W.bind(ctypes.CDLL(out)) for c, (out, *_) in zip(SWEEP, jobs)}


def variant_calls(lib, chunk):
    def fwd(r, k, v, w, u):
        y = torch.empty_like(r)
        W.launch_fwd(lib, chunk, r, k, v, w, u, y)
        return y

    def bwd(r, k, v, w, u, gy):
        outs = tuple(torch.empty_like(x) for x in (r, k, v, w, u))
        W.launch_bwd(lib, chunk, r, k, v, w, u, gy, *outs)
        return outs
    return fwd, bwd


def check(fwd, bwd, args, want_y, want, dtype):
    """Hold a (forward, backward) pair against the plain versions at
    chip_smoke.py's tolerances; returns (y, grads, max error)."""
    tol_act, tol_f32 = TOL[dtype]
    y, grads = fwd(*args[:5]), bwd(*args)
    torch.cuda.synchronize()
    err = _err_to_max(y, want_y, tol_act)
    for g, wg in zip(grads, want):
        err = max(err, _err_to_max(g, wg, tol_act if g.dtype == dtype
                                   else tol_f32))
    return y, grads, err


def peak_extra_bytes(bwd, args):
    """Memory one backward call adds at its peak, its outputs included."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = bwd(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline",
                    help="directory with an older wkv.cu and common.cuh")
    ap.add_argument("--sweep", action="store_true",
                    help=f"also time chunk lengths {SWEEP}")
    ap.add_argument("--json", help="write the table here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv_table: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[wkv_table] card: {card}")
    _build.build()
    base = load_baseline(args.baseline) if args.baseline else None
    variants = load_chunk_variants() if args.sweep else {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = []
    for label, b, h, t, n, dtype in SHAPES:
        inputs = _wkv_inputs(gen, b, h, t, n, dtype)
        want_y = ref.ref_wkv(*inputs[:5])
        want = ref.ref_wkv_bwd(*inputs)
        chunk = W.wkv_chunk(t, n, dtype)
        y, grads, err = check(W.wkv6, W.wkv6_bwd, inputs, want_y, want,
                              dtype)
        calls = {"kernel": (lambda *a: W.wkv6(*a[:5]), W.wkv6_bwd)}
        base_err = None
        if base is not None:
            _, _, base_err = check(base[0], base[1], inputs, want_y, want,
                                   dtype)
            calls["baseline"] = (lambda *a: base[0](*a[:5]), base[1])
        peak = {who: peak_extra_bytes(bwd, inputs)
                for who, (_, bwd) in calls.items()}
        del want
        e = inputs[0].element_size()
        elems = b * h * t * n
        fwd_bytes = elems * (3 * e + 4 + e) + h * n * 4
        bwd_bytes = elems * (4 * e + 4 + 3 * e + 4) + 2 * h * n * 4

        def rotate(fn):
            def make():
                a = _wkv_inputs(gen, b, h, t, n, dtype)
                return lambda: fn(*a)
            return make

        times = {f"{who}_{d}": [] for who in calls for d in ("fwd", "bwd")}
        order = [x for x in ("baseline", "kernel") if x in calls]
        for who in order + order[::-1]:
            fwd, bwd = calls[who]
            times[f"{who}_fwd"].append(device_ms(rotate(fwd), fwd_bytes))
            times[f"{who}_bwd"].append(device_ms(rotate(bwd), bwd_bytes))
        reps = 24 if t <= 128 else 1
        plain_fwd = device_ms(rotate(lambda *a: ref.ref_wkv(*a[:5])),
                              fwd_bytes, reps=reps)
        plain_bwd = device_ms(rotate(ref.ref_wkv_bwd), bwd_bytes, reps=reps)
        sweep = {}
        for c, lib in variants.items():
            fwd, bwd = variant_calls(lib, c)
            vy, vg, verr = check(fwd, bwd, inputs, want_y,
                                 ref.ref_wkv_bwd(*inputs), dtype)
            if c == chunk and not (torch.equal(vy, y) and all(
                    torch.equal(p, q) for p, q in zip(vg, grads))):
                raise AssertionError(f"{label}: the chunk-{c} build differs "
                                     f"from the port's kernels")
            sweep[c] = {"fwd_ms": device_ms(rotate(lambda *a: fwd(*a[:5])),
                                            fwd_bytes),
                        "bwd_ms": device_ms(rotate(bwd), bwd_bytes),
                        "max_abs_err": verr}
        steps = b * h * t
        fb, fby = bound(fwd_bytes, 4.0 * n * n * steps, torch.float32)
        bb, bby = bound(bwd_bytes, 12.0 * n * n * steps, torch.float32)
        mean = {k_: sum(v_) / len(v_) for k_, v_ in times.items()}
        row = {"shape": label, "b": b, "h": h, "t": t, "n": n,
               "dtype": str(dtype)[6:], "chunk": chunk,
               "chunks": W.n_chunks(t, chunk),
               "blocks_fwd": W.blocks(b, h, t, n, chunk, False),
               "blocks_bwd": W.blocks(b, h, t, n, chunk, True),
               "scratch_bytes_fwd": 4 * W.scratch_floats(b, h, t, n, chunk,
                                                         False),
               "scratch_bytes_bwd": 4 * W.scratch_floats(b, h, t, n, chunk,
                                                         True),
               "baseline_scratch_bytes_bwd": 4 * (elems * n + b * h * n),
               "peak_extra_bytes_bwd": peak["kernel"],
               "baseline_peak_extra_bytes_bwd": peak.get("baseline"),
               "max_abs_err": err, "baseline_max_abs_err": base_err,
               "fwd_ms": mean["kernel_fwd"], "bwd_ms": mean["kernel_bwd"],
               "fwd_ms_turns": times["kernel_fwd"],
               "bwd_ms_turns": times["kernel_bwd"],
               "baseline_fwd_ms": mean.get("baseline_fwd"),
               "baseline_bwd_ms": mean.get("baseline_bwd"),
               "plain_fwd_ms": plain_fwd, "plain_bwd_ms": plain_bwd,
               "bound_fwd_ms": fb, "bound_fwd_by": fby,
               "bound_bwd_ms": bb, "bound_bwd_by": bby, "sweep": sweep}
        table.append(row)
        fmt = (lambda x: "n/a" if x is None else f"{x:.5f}")
        print(f"[wkv_table] {label} B={b} H={h} T={t} N={n} "
              f"r/k/v={row['dtype']} chunk={chunk} chunks={row['chunks']} "
              f"max_abs_err={err:.3e} fwd_ms={fmt(mean['kernel_fwd'])} "
              f"bwd_ms={fmt(mean['kernel_bwd'])} "
              f"baseline_fwd_ms={fmt(mean.get('baseline_fwd'))} "
              f"baseline_bwd_ms={fmt(mean.get('baseline_bwd'))} "
              f"plain_fwd_ms={plain_fwd:.5f} plain_bwd_ms={plain_bwd:.5f} "
              f"bound_fwd_ms={fb:.6f} ({fby}) bound_bwd_ms={bb:.6f} ({bby})")
        print(f"[wkv_table]   blocks fwd {json.dumps(row['blocks_fwd'])} bwd "
              f"{json.dumps(row['blocks_bwd'])}; scratch bytes fwd "
              f"{row['scratch_bytes_fwd']} bwd {row['scratch_bytes_bwd']} "
              f"(baseline bwd {row['baseline_scratch_bytes_bwd']}); peak "
              f"extra bytes of one wkv6_bwd call {peak['kernel']} (baseline "
              f"{peak.get('baseline')})")
        for c, s in sweep.items():
            print(f"[wkv_table]   chunk {c}: fwd_ms={s['fwd_ms']:.5f} "
                  f"bwd_ms={s['bwd_ms']:.5f} max_abs_err="
                  f"{s['max_abs_err']:.3e}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card, "rows": table}, fh, indent=1)
    print(f"[wkv_table] card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
