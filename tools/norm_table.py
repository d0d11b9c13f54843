#!/usr/bin/env python3
"""Time the PyTorch port's ``rmsnorm`` kernel and its fused residual add on
the card at the shapes ``chip_smoke.py`` checks, beside the bound, the
plain version, ``F.rms_norm`` and, optionally, an older build of the
kernel, in one process on one card, in turns.

    python3 tools/norm_table.py [--baseline DIR] [--json PATH]

Shapes: ``chip_smoke.py``'s ``NORM_SHAPES`` (every served rmsnorm width:
960, 1024, 4096, 5120 and 8192 in bf16, Qwen3-8B's qk_norm rows of 128,
the SMOKE configs' 96 in f32), inputs as ``chip_smoke.py`` makes them.
Each row: the kernel, the fused form (``add_rmsnorm``: x + r and the norm
in one launch), x + r then the kernel, x + r then ``F.rms_norm`` (the
fused form's yardstick), the plain version, ``F.rms_norm``, and both
bounds (bytes: x (and r) read, y (and s) written).

``--baseline DIR`` names a directory holding an older ``rmsnorm.cu``
whose entry takes (x, scale, y, rows, d, dtype, vec, eps, stream) and the
``common.cuh`` it includes, e.g. ``git show
2083920:src/repro_torch/csrc/<file>``; it reaches the card only if it is
on disk in the repo, so put it under ``build/``.  It is built with the
port's nvcc flags; the kernel's output must equal the older kernel's bit
for bit at every shape, and the fused form's must equal torch's x + r
followed by the older kernel; both are timed (order: baseline, kernel,
fused, x + r then baseline, and back).  Then SmolLM-360M (full width,
``SERVE_LAYERS`` layers, seed 1, as ``chip_smoke.py``) replays the 8 x
448-token trace on bf16 pages with the port's kernels, with the older
kernel in place (and the residual adds eager), and with the port's again,
and prints each replay's token digest: the three must be equal.

Every time is device time from CUDA events around a CUDA graph of calls.
Needs a CUDA card.
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
                        LONG_REQS, NORM_SHAPES, bound, card_line, device_ms,
                        norm_bounds, norm_inputs, norm_times, served)
from repro_torch import configs as C  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import rmsnorm as R  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.layers import set_gemm_mode  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServeEngine  # noqa: E402


def load_baseline(directory: str):
    """The older kernel in ``directory``: a callable (x, scale, eps) with
    the wrapper's checks left to the caller."""
    out = os.path.join(ROOT, "build", "norm_baseline", "rmsnorm.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", directory, "-o", out,
         os.path.join(directory, "rmsnorm.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the baseline:\n{proc.stdout}")
    fn = ctypes.CDLL(out).rmsnorm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(x, scale, eps=1e-6):     # as that kernel's wrapper called it
        d = x.shape[-1]
        rows = x.reshape(-1, d).contiguous()
        y = torch.empty_like(rows)
        scale = scale.float().contiguous()
        err = fn(rows.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 rows.shape[0], d, R._DTYPES[x.dtype],
                 R.vec_width(d, x.dtype), float(eps),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline rmsnorm failed: {err}")
        return y.reshape(x.shape)
    return call


@contextlib.contextmanager
def kernel_in_place(base):
    """The models' rmsnorm kernel replaced by ``base`` (counted as a launch
    of the kernel) and the fused adds undone (torch's x + r, then
    ``base``) while the model runs: the serve path as it was."""
    port, port_add = ops.rmsnorm_kernel, ops.add_rmsnorm_kernel

    def counted(x, scale, eps=1e-6):
        R.launches += 1
        return base(x, scale, eps)

    def unfused(x, r, scale, eps=1e-6):
        s = x + r
        return s, counted(s, scale, eps)
    ops.rmsnorm_kernel, ops.add_rmsnorm_kernel = counted, unfused
    try:
        yield
    finally:
        ops.rmsnorm_kernel, ops.add_rmsnorm_kernel = port, port_add


def smollm_tokens(base) -> bool:
    """SmolLM-360M's 8 x 448 replay with the port's kernels, the older
    rmsnorm in place, and the port's again: True when the token digests
    agree."""
    set_gemm_mode("kernel")
    cfg = served(C.get("smollm_360m"))
    params = init_params(cfg, seed=1, device="cuda")
    trace = SV.synth_trace(LONG_REQS, LONG_PROMPT, LONG_NEW, 3,
                           cfg.vocab_size, seed=0)
    scfg = ServeConfig(batch_slots=LONG_REQS, max_len=LONG_LEN, kv="paged",
                       page_size=16)
    digests = []
    for who in ("kernel", "baseline", "kernel"):
        swap = (kernel_in_place(base) if who == "baseline"
                else contextlib.nullcontext())
        with swap:
            engine = ServeEngine(cfg, params, scfg)
            try:
                before = R.launches
                rep = SV.run_trace(engine, trace, log=None)
                launched = R.launches - before
            finally:
                engine.close()
        h = hashlib.sha256()
        for tid in sorted(rep["results"]):
            h.update(rep["results"][tid].astype("int64").tobytes())
        digests.append(h.hexdigest()[:16])
        print(f"[norm_table] {cfg.name} ({cfg.n_layers} layers) 8x448+32 "
              f"on bf16 pages, {who}: {launched} rmsnorm launches, token "
              f"digest {digests[-1]}")
    same = len(set(digests)) == 1
    print(f"[norm_table] token digests kernel {digests[0]}, baseline "
          f"{digests[1]}, kernel {digests[2]}: "
          f"{'equal' if same else 'DIFFER'}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline",
                    help="directory with an older rmsnorm.cu and common.cuh")
    ap.add_argument("--json", help="write the table here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("norm_table: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[norm_table] card: {card}")
    _build.build()
    base = load_baseline(args.baseline) if args.baseline else None
    table = []
    for i, (label, m, d, dtype) in enumerate(NORM_SHAPES):
        x, r, scale = norm_inputs(m, d, dtype, seed=50 + i)
        y = R.rmsnorm(x, scale)
        s, yf = R.add_rmsnorm(x, r, scale)
        same = None
        if base is not None:
            same = (torch.equal(base(x, scale), y)
                    and torch.equal(s, x + r)
                    and torch.equal(base(x + r, scale), yf))
            if not same:
                raise AssertionError(f"{label}: the kernel's or the fused "
                                     f"form's bits differ from the "
                                     f"baseline's")
        xm, rm = x[:m].contiguous(), r[:m].contiguous()
        (nb, no), (fb, fo) = norm_bounds(m, d, dtype)
        turns = {}
        if base is not None:
            calls = {"baseline": lambda: base(xm, scale),
                     "kernel": lambda: R.rmsnorm(xm, scale),
                     "fused": lambda: R.add_rmsnorm(xm, rm, scale),
                     "add+baseline": lambda: base(xm + rm, scale)}
            order = list(calls)
            for who in order + order[::-1]:
                turns.setdefault(who, []).append(
                    device_ms(lambda c=calls[who]: c, fb))
        t = norm_times(xm, rm, scale)
        mean = {k: sum(v) / len(v) for k, v in turns.items()}
        bms, by = bound(nb, no, torch.float32)
        fms, fby = bound(fb, fo, torch.float32)
        row = {"shape": label, "m": m, "d": d, "dtype": str(dtype)[6:],
               "plan": R.rms_plan(d, dtype)._asdict(),
               "bits_equal_baseline": same,
               "ms": mean.get("kernel", t["kernel"]),
               "fused_ms": mean.get("fused", t["fused"]),
               "baseline_ms": mean.get("baseline"),
               "add_then_baseline_ms": mean.get("add+baseline"),
               "turns": turns,
               "add_then_kernel_ms": t["add+kernel"],
               "add_then_library_ms": t["add+library"],
               "plain_ms": t["plain"], "library_ms": t["library"],
               "bound_ms": bms, "bound_by": by, "fused_bound_ms": fms,
               "fused_bound_by": fby}
        table.append(row)
        fmt = (lambda v: "n/a" if v is None else f"{v:.5f}")
        print(f"[norm_table] {label} M={m} d={d} {row['dtype']} "
              f"plan={tuple(row['plan'].values())} ms={fmt(row['ms'])} "
              f"baseline_ms={fmt(row['baseline_ms'])} "
              f"fused_ms={fmt(row['fused_ms'])} "
              f"add_then_baseline_ms={fmt(row['add_then_baseline_ms'])} "
              f"add_then_kernel_ms={fmt(t['add+kernel'])} "
              f"add_then_library_ms={fmt(t['add+library'])} "
              f"plain_ms={fmt(t['plain'])} library_ms={fmt(t['library'])} "
              f"(F.rms_norm) bound_ms={bms:.6f} ({by}) "
              f"fused_bound_ms={fms:.6f} ({fby}) bits==baseline={same}")
    tokens = smollm_tokens(base) if base is not None else None
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump({"card": card, "rows": table,
                       "smollm_tokens_equal": tokens}, fh, indent=1)
    print(f"[norm_table] card: {card}")
    return 0 if tokens is not False else 1


if __name__ == "__main__":
    sys.exit(main())
