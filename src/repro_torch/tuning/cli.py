"""Autotuner CLI (counterpart of ``repro/tuning/cli.py``) —
``python -m repro_torch.tuning.cli {tune,show,clear}``.

Examples (set ``REPRO_TORCH_TUNING_CACHE``, or pass ``--cache``, to keep
the default ``~/.cache/repro_torch/tuning_cache.json`` untouched)::

    # gama_gemm plans for one GEMM shape (M,N,K) on the card; a second
    # run is a cache hit.
    python -m repro_torch.tuning.cli tune --op gemm --shape 8,2560,960

    # flash_attention plans for (Sq, Sk, D).
    python -m repro_torch.tuning.cli tune --op attention --shape 488,496,64

    # The decode chunk for (Sk, D), the WKV chunk for (T, N): one
    # candidate each, measured and checked.
    python -m repro_torch.tuning.cli tune --op decode --shape 496,64
    python -m repro_torch.tuning.cli tune --op wkv --shape 64,64

    # The pack grid of a sharded GEMM on a 2x4 mesh: analytic (the
    # measured pack GEMM comes with the multi-device slice).
    python -m repro_torch.tuning.cli tune --op pack \\
        --shape 4096,4096,4096 --mesh 2,4

    # The engine's tunables, measured end to end through ServeEngine on
    # the arch's SMOKE config; --shape is prompt_len,max_new.  Kernel ops
    # need the card; serve also runs on the CPU.
    python -m repro_torch.tuning.cli tune --op serve --arch smollm_360m \\
        --shape 8,8 --keep 2 --reps 1 --device cpu

    python -m repro_torch.tuning.cli show
    python -m repro_torch.tuning.cli clear
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.tuning import dispatch
from repro_torch.tuning.cache import TuningCache, default_cache_path
from repro_torch.tuning.space import torch_dtype


def _parse_shape(text: str, n: int = 3) -> List[int]:
    parts = [p for p in text.replace("x", ",").split(",") if p]
    if len(parts) != n:
        raise SystemExit(f"--shape wants {n} comma-separated ints, "
                         f"got {text!r}")
    return [int(p) for p in parts]


def _cache_from(args) -> TuningCache:
    if args.cache:
        dispatch.set_cache_path(args.cache)
    return dispatch.get_cache()


def cmd_tune(args) -> int:
    try:
        torch_dtype(args.dtype)
    except ValueError:
        raise SystemExit(f"unknown --dtype {args.dtype!r} "
                         "(try bf16, f32, int8)")
    tc = _cache_from(args)
    common = dict(keep=args.keep, warmup=args.warmup, reps=args.reps,
                  force=args.force, cache=tc, device=args.device)
    if args.op == "gemm":
        m, n, k = _parse_shape(args.shape)
        res = dispatch.tune_gemm(m, k, n, args.dtype, **common)
    elif args.op == "attention":
        sq, sk, d = _parse_shape(args.shape)
        res = dispatch.tune_attention(sq, sk, d, args.dtype, **common)
    elif args.op == "pack":
        m, n, k = _parse_shape(args.shape)
        da, ma = _parse_shape(args.mesh, 2)
        res = dispatch.tune_pack(m, k, n, args.dtype, data_axis=da,
                                 model_axis=ma, **common)
    elif args.op == "decode":
        sk, d = _parse_shape(args.shape, 2)
        res = dispatch.tune_decode(sk, d, args.dtype, **common)
    elif args.op == "wkv":
        t, n = _parse_shape(args.shape, 2)
        res = dispatch.tune_wkv(t, n, args.dtype, **common)
    elif args.op == "serve":
        from repro_torch import configs as C
        plen, max_new = _parse_shape(args.shape, 2)
        cfg = C.get_smoke(args.arch)
        res = dispatch.tune_serve(cfg, max_len=plen + max_new + 8,
                                  prompt_len=plen, max_new=max_new, **common)
    else:  # pragma: no cover - argparse choices guard this
        raise SystemExit(f"unknown op {args.op!r}")

    for t in res.trials:
        cfg = t.get("config")
        us = t.get("us")
        ok = t.get("ok", True)
        us_s = f"{us:.1f} us" if isinstance(us, (int, float)) else "analytic"
        print(f"  candidate {cfg} -> "
              f"{us_s}{'' if ok else '  [NUMERICS FAIL]'}")
    print(res.summary())
    print(f"cache: {tc.path}")
    return 0 if res.best is not None else 1


def cmd_show(args) -> int:
    tc = _cache_from(args)
    entries = {k: v for k, v in sorted(tc.entries.items())
               if args.filter in k}
    if args.json:
        print(json.dumps(entries, indent=1, sort_keys=True))
        return 0
    if not entries:
        print(f"(no entries{' matching ' + args.filter if args.filter else ''}"
              f" in {tc.path})")
        return 0
    for key, e in entries.items():
        us = e.get("us")
        us_s = f"{us:.1f} us" if isinstance(us, (int, float)) else "-"
        print(f"{key}\n    config={e.get('config')} {us_s}")
    print(f"{len(entries)} entries in {tc.path}")
    return 0


def cmd_clear(args) -> int:
    tc = _cache_from(args)
    n = tc.clear()
    dispatch.reset()
    if args.cache:
        dispatch.set_cache_path(args.cache)
    print(f"cleared {n} entries ({tc.path})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning.cli",
        description="GAMA kernel autotuner for the port (analytic prune + "
                    "measurement on the card + persistent cache)")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default {default_cache_path()}; "
                         "or set $REPRO_TORCH_TUNING_CACHE)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tune", help="tune one op/shape and persist the best")
    t.add_argument("--op",
                   choices=("gemm", "attention", "pack", "decode", "wkv",
                            "serve"),
                   default="gemm")
    t.add_argument("--shape", required=True,
                   help="gemm/pack: M,N,K; attention: Sq,Sk,D; "
                        "decode: Sk,D; wkv: T,N; serve: plen,max_new")
    t.add_argument("--arch", default="smollm_360m",
                   help="serve: arch whose smoke config drives the trace")
    t.add_argument("--dtype", default="bf16")
    t.add_argument("--mesh", default="1,1",
                   help="pack: data_axis,model_axis")
    t.add_argument("--keep", type=int, default=8,
                   help="candidates surviving the analytic prune")
    t.add_argument("--warmup", type=int, default=1)
    t.add_argument("--reps", type=int, default=3)
    t.add_argument("--force", action="store_true",
                   help="re-measure even on a cache hit")
    t.add_argument("--device", default="cuda",
                   help="the device to tune on; 'cpu' only for --op serve "
                        "(the kernels have no CPU build)")
    t.set_defaults(fn=cmd_tune)

    s = sub.add_parser("show", help="list cached entries")
    s.add_argument("--filter", default="", help="substring key filter")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_show)

    c = sub.add_parser("clear", help="drop all entries + delete the file")
    c.set_defaults(fn=cmd_clear)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
