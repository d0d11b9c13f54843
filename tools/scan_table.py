#!/usr/bin/env python3
"""Time the PyTorch port's ``selective_scan`` and ``selective_scan_bwd`` on
the card at the shapes ``chip_smoke.py`` checks, beside the bound, the
plain version and, optionally, an older build of the kernels, in one
process on one card, in turns.

    python3 tools/scan_table.py [--baseline DIR [--cluster K] [--jamba]]
                                [--json PATH]

Shapes: those of ``chip_smoke.py``'s ``hybrid_kernel_phase``: Jamba-v0.1
52B's decode (B=8 T=1 di=8192 N=16), a serial prompt (T=11) and a
448-token one, each in bf16 and f32, and the SMOKE config's di=128 N=8 in
f32 (B=3 T=1 and B=1 T=12).  Inputs as ``chip_smoke.py`` makes them, from
a nonzero state.  The backward at ``chip_smoke.py``'s ``SCAN_BWD_SHAPES``
(Jamba's 8 x 64 training step in bf16 and f32, a 448-token prompt, T=11,
a ragged width and the SMOKE f32 shape) beside its bound, its plain
version and its scratch bytes.

``--baseline DIR`` names a directory holding an older
``selective_scan.cu`` whose forward entry takes the plan and a
saved-states pointer and whose backward entry takes the plan without a
cluster size (as at ``2083920``), and the headers it includes
(``common.cuh``, ``tc.cuh``), e.g. ``git show
2083920:src/repro_torch/csrc/<file>``; it reaches the card only if it is
on disk in the repo, so put it under ``build/``.  It is built with the
port's nvcc flags; its forward's y and final state must equal the port's
bit for bit at every shape, its backward's gdt, gx, ga and gh0 too (gbm
and gc, whose sums over channels run in another order, are held to the
plain backward's bounds and their largest difference printed); both are
timed at the same shapes (order: baseline, kernel, kernel, baseline; each
column the mean of its two turns).

``--cluster K`` (with ``--baseline``) builds the baseline with
``-DSCAN_BWD_CLUSTER=K`` and gives its backward the scratch of clusters
of K channel blocks.  The source at ``2083920`` ignores the flag; its one
partial a channel block is K = 1, the default.  ``--baseline src/repro_torch/csrc
--cluster 1`` times the port's own backward with clusters of one block
against the shipped clusters of 8.

``--jamba`` (with ``--baseline``) also serves Jamba-v0.1 52B FULL with
int8 weights (seed 1, as ``chip_smoke.py``): smoke6 on 2 slots and the
8 x 448-token trace on 8 slots, each replayed with the port's kernel,
then with the older kernel in its place, then the port's again, and
prints each replay's token digest: the three must be equal.

Every time is device time from CUDA events around a CUDA graph of calls
that rotate over copies of the inputs covering twice the 50 MB L2.  Each
row also holds the kernel's plan (``scan_plan``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import (LONG_LEN, LONG_NEW, LONG_PROMPT,  # noqa: E402
                        LONG_REQS, SCAN_BWD_OPS, SCAN_BWD_SHAPES,
                        _scan_bwd_errs, _scan_bwd_inputs, _scan_inputs,
                        bound, device_ms)
from repro_torch import configs as C  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import selective_scan as S  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServeEngine  # noqa: E402

# (label, B, T, di, N, dtype): chip_smoke.py's hybrid_kernel_phase.
SHAPES = [
    (f"{kind}-{tag}", b, t, 8192, 16, dtype)
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))
    for kind, b, t in (("decode", 8, 1), ("prompt-11", 1, 11),
                       ("prompt-448", 1, 448))
] + [("smoke-decode", 3, 1, 128, 8, torch.float32),
     ("smoke-prompt", 1, 12, 128, 8, torch.float32)]


def base_scratch_floats(b: int, t: int, di: int, n: int,
                        cluster: int) -> int:
    """The baseline backward's f32 scratch: gbm's and gc's partials of
    each cluster of ``cluster`` channel blocks, and ga's of each
    sequence."""
    clusters = -(-(-(-di // S.CHANNELS)) // cluster)
    return 2 * b * t * clusters * n + b * di * n


def load_baseline(directory: str, cluster: int = 1):
    """The older kernels in ``directory``: callables with the wrappers'
    signatures, the forward (y, hT) and the backward (gdt, gx, gbm, gc,
    ga, gh0 from the forward's saved states), the backward built with
    clusters of ``cluster`` channel blocks."""
    out = os.path.join(ROOT, "build", "scan_baseline", "selective_scan.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, f"-DSCAN_BWD_CLUSTER={cluster}",
         "-I", directory, "-o", out,
         os.path.join(directory, "selective_scan.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the baseline:\n{proc.stdout}")
    lib = ctypes.CDLL(out)
    fn = lib.selective_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bwd = lib.selective_scan_bwd_launch
    bwd.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int

    def forward(dt, x, bm, c, a, h0, save=False):
        b, t, di = dt.shape
        n = a.shape[-1]
        y, h_end = torch.empty_like(x), torch.empty_like(h0)
        states = (torch.empty((b, S.saved_states(t), di, n),
                              device=x.device) if save else None)
        plan = S.scan_plan(di, n, x.dtype)
        err = fn(dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
                 a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_end.data_ptr(),
                 None if states is None else states.data_ptr(), b, t, di, n,
                 S._DTYPES[x.dtype], plan.lanes, plan.channels, plan.steps,
                 int(plan.wide), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline selective_scan failed: {err}")
        return (y, h_end, states) if save else (y, h_end)

    def backward(dt, x, bm, c, a, h0, gy, states, ght):
        b, t, di = dt.shape
        n = a.shape[-1]
        plan = S.scan_plan(di, n, x.dtype)
        gdt, gx, gbm, gc = (torch.empty_like(v) for v in (dt, x, bm, c))
        ga, gh0 = torch.empty_like(a), torch.empty_like(h0)
        scratch = torch.empty(base_scratch_floats(b, t, di, n, cluster),
                              device=x.device)
        err = bwd(dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
                  a.data_ptr(), states.data_ptr(), gy.data_ptr(),
                  ght.data_ptr(), gdt.data_ptr(), gx.data_ptr(),
                  gbm.data_ptr(), gc.data_ptr(), ga.data_ptr(),
                  gh0.data_ptr(), scratch.data_ptr(), scratch.numel(), b, t,
                  di, n, S._DTYPES[x.dtype], plan.lanes, plan.channels,
                  plan.steps, int(plan.wide),
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline selective_scan_bwd failed: {err}")
        return gdt, gx, gbm, gc, ga, gh0
    return forward, backward


def bwd_rows(gen, base_fwd, base_bwd, cluster):
    """The backward at SCAN_BWD_SHAPES: within the plain backward's bounds,
    two calls equal; beside the older backward (gdt, gx, ga, gh0 equal bit
    for bit) when given; timed."""
    rows = []
    for label, b, t, di, n, dtype in SCAN_BWD_SHAPES:
        args, gy, ght = _scan_bwd_inputs(gen, b, t, di, n, dtype)
        y, h, states = S.selective_scan_fwd(*args)
        got = S.selective_scan_bwd(*args, gy, states, ght)
        again = S.selective_scan_bwd(*args, gy, states, ght)
        errs, bad = _scan_bwd_errs(got, ref.selective_scan_bwd(*args, gy,
                                                               ght))
        if bad or not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError(f"bwd {label}: {bad or 'two calls differ'}")
        calls = {"kernel": lambda a=args, g=gy, s=states, e=ght:
                 S.selective_scan_bwd(*a, g, s, e)}
        same, diff_bc = None, None
        if base_bwd is not None:
            by, bh, bst = base_fwd(*args, save=True)
            old = base_bwd(*args, gy, bst, ght)
            torch.cuda.synchronize()
            if not (torch.equal(by, y) and torch.equal(bh, h)
                    and torch.equal(bst, states)):
                raise AssertionError(f"bwd {label}: the baseline forward's "
                                     f"bits differ")
            same = all(torch.equal(got[k], old[k]) for k in (0, 1, 4, 5))
            if not same:
                raise AssertionError(f"bwd {label}: gdt, gx, ga or gh0 "
                                     f"differ from the baseline's")
            diff_bc = max((got[k].double() - old[k].double()).abs().max()
                          .item() for k in (2, 3))
            calls["baseline"] = lambda a=args, g=gy, s=bst, e=ght: base_bwd(
                *a, g, s, e)
        e = args[0].element_size()
        nbytes = ((5 * b * t * di + 4 * b * t * n) * e + 2 * di * n * 4
                  + 3 * b * di * n * 4)
        times = {who: [] for who in calls}
        order = [x for x in ("baseline", "kernel") if x in calls]
        for who in order + order[::-1]:
            times[who].append(device_ms(lambda c=calls[who]: c, nbytes))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        bms, by_ = bound(nbytes, float(SCAN_BWD_OPS) * b * t * di * n,
                         torch.float32)
        plan = S.scan_plan(di, n, dtype)
        row = {"shape": label, "b": b, "t": t, "di": di, "n": n,
               "dtype": str(dtype)[6:], "plan": plan._asdict(),
               "grid": plan.bwd_blocks(di, b), "max_err": errs,
               "gdt_gx_ga_gh0_equal_baseline": same,
               "gbm_gc_max_abs_diff_baseline": diff_bc,
               "ms": mean["kernel"], "ms_turns": times["kernel"],
               "baseline_ms": mean.get("baseline"),
               "baseline_ms_turns": times.get("baseline"),
               "scratch_bytes": 4 * S.scratch_floats(b, t, di, n),
               "baseline_cluster": cluster if base_bwd else None,
               "baseline_scratch_bytes": 4 * base_scratch_floats(
                   b, t, di, n, cluster),
               "bound_ms": bms, "bound_by": by_}
        rows.append(row)
        fmt = (lambda v: "n/a" if v is None else f"{v:.5f}")
        print(f"[scan_table] bwd {label} B={b} T={t} di={di} N={n} "
              f"{row['dtype']} plan={json.dumps(row['plan'])} "
              f"baseline_cluster={row['baseline_cluster']} grid="
              f"{row['grid']} ms={fmt(mean['kernel'])} baseline_ms="
              f"{fmt(mean.get('baseline'))} gdt,gx,ga,gh0==baseline={same} "
              f"gbm,gc max|diff| to baseline={diff_bc} scratch_bytes="
              f"{row['scratch_bytes']} (baseline "
              f"{row['baseline_scratch_bytes']}) bound_ms={bms:.6f} ({by_}) "
              f"bound/kernel={bms / mean['kernel']:.3f}")
    return rows


@contextlib.contextmanager
def kernel_in_place(fn):
    """The Mamba mixer's ``selective_scan`` kernel replaced by ``fn``
    (counted as a launch of the kernel) while the block runs."""
    port = ops.selective_scan_kernel

    def counted(*args):
        S.launches += 1
        return fn(*args)
    ops.selective_scan_kernel = counted
    try:
        yield
    finally:
        ops.selective_scan_kernel = port


def jamba_tokens(base) -> bool:
    """Jamba-v0.1 52B FULL int8 replays with the port's kernel, the older
    one, and the port's again: True when every replay's tokens agree."""
    cfg = C.get("jamba_v01_52b")
    params = init_params(cfg, seed=1, device="cuda", quantize=True)
    traces = {
        "smoke6 (2 slots)": (SV.load_trace(SV.resolve_trace_path("smoke6"),
                                           cfg.vocab_size, seed=0),
                             ServeConfig(batch_slots=2, max_len=36,
                                         quantize=True)),
        "8x448+32 (8 slots)": (SV.synth_trace(LONG_REQS, LONG_PROMPT,
                                              LONG_NEW, 3, cfg.vocab_size,
                                              seed=0),
                               ServeConfig(batch_slots=LONG_REQS,
                                           max_len=LONG_LEN, quantize=True))}
    same = True
    for name, (trace, scfg) in traces.items():
        digests = []
        for who in ("kernel", "baseline", "kernel"):
            swap = (kernel_in_place(base) if who == "baseline"
                    else contextlib.nullcontext())
            with swap:
                engine = ServeEngine(cfg, params, scfg)
                try:
                    rep = SV.run_trace(engine, trace, log=None)
                finally:
                    engine.close()
            h = hashlib.sha256()
            for tid in sorted(rep["results"]):
                h.update(rep["results"][tid].astype("int64").tobytes())
            digests.append(h.hexdigest()[:16])
        same = same and len(set(digests)) == 1
        print(f"[scan_table] {cfg.name} FULL int8 {name}: token digests "
              f"kernel {digests[0]}, baseline {digests[1]}, kernel "
              f"{digests[2]}: {'equal' if len(set(digests)) == 1 else 'DIFFER'}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline",
                    help="directory with an older selective_scan.cu and "
                         "common.cuh")
    ap.add_argument("--cluster", type=int, default=1,
                    help="the baseline backward's cluster size (default 1: "
                         "one partial a channel block, as at 2083920)")
    ap.add_argument("--jamba", action="store_true",
                    help="also replay Jamba-v0.1 52B FULL int8 with each "
                         "kernel and compare the tokens (needs --baseline)")
    ap.add_argument("--json", help="write the table here as JSON")
    args = ap.parse_args(argv)
    if args.jamba and not args.baseline:
        ap.error("--jamba needs --baseline")
    if args.cluster not in (1, 2, 4, 8):
        ap.error("--cluster takes 1, 2, 4 or 8")
    if not torch.cuda.is_available():
        print("scan_table: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[scan_table] card: {card}")
    _build.build()
    base_fwd, base_bwd = (load_baseline(args.baseline, args.cluster)
                          if args.baseline else (None, None))
    base = base_fwd
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = []
    for label, b, t, di, n, dtype in SHAPES:
        inputs = _scan_inputs(gen, b, t, di, n, dtype)
        y, h = S.selective_scan(*inputs)
        want_y, want_h = ref.selective_scan(*inputs)
        torch.cuda.synchronize()
        err = max((y.double() - want_y.double()).abs().max().item(),
                  (h - want_h).abs().max().item())
        calls = {"kernel": S.selective_scan}
        same = None
        if base is not None:
            by, bh = base(*inputs)
            torch.cuda.synchronize()
            same = torch.equal(by, y) and torch.equal(bh, h)
            if not same:
                raise AssertionError(f"{label}: the baseline's bits differ "
                                     f"from the kernel's")
            calls["baseline"] = base
        e = inputs[0].element_size()
        nbytes = ((3 * b * t * di + 2 * b * t * n) * e + di * n * 4
                  + 2 * b * di * n * 4)

        def rotate(fn):
            def make():
                a = _scan_inputs(gen, b, t, di, n, dtype)
                return lambda: fn(*a)
            return make

        times = {who: [] for who in calls}
        order = [x for x in ("baseline", "kernel") if x in calls]
        for who in order + order[::-1]:
            times[who].append(device_ms(rotate(calls[who]), nbytes))
        plain = device_ms(rotate(ref.selective_scan), nbytes,
                          reps=24 if t <= 16 else 1)
        bms, by_ = bound(nbytes, 7.0 * b * t * di * n, torch.float32)
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        plan = S.scan_plan(di, n, dtype)
        row = {"shape": label, "b": b, "t": t, "di": di, "n": n,
               "dtype": str(dtype)[6:], "plan": plan._asdict(),
               "blocks": plan.blocks(di, b), "max_abs_err": err,
               "bits_equal_baseline": same, "ms": mean["kernel"],
               "ms_turns": times["kernel"],
               "baseline_ms": mean.get("baseline"),
               "baseline_ms_turns": times.get("baseline"),
               "plain_ms": plain, "bound_ms": bms, "bound_by": by_}
        table.append(row)
        fmt = (lambda x: "n/a" if x is None else f"{x:.5f}")
        print(f"[scan_table] {label} B={b} T={t} di={di} N={n} "
              f"{row['dtype']} plan={json.dumps(row['plan'])} "
              f"max_abs_err={err:.3e} ms={fmt(mean['kernel'])} "
              f"baseline_ms={fmt(mean.get('baseline'))} "
              f"bits==baseline={same} plain_ms={plain:.5f} "
              f"bound_ms={bms:.6f} ({by_}) "
              f"bound/kernel={bms / mean['kernel']:.3f}")
    bwd = bwd_rows(gen, base_fwd, base_bwd, args.cluster)
    same = jamba_tokens(base) if args.jamba else None
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card, "rows": table, "bwd_rows": bwd,
                       "jamba_tokens_equal": same}, fh, indent=1)
    print(f"[scan_table] card: {card}")
    return 0 if same is not False else 1


if __name__ == "__main__":
    sys.exit(main())
