"""Training launcher (counterpart of ``repro/launch/train.py``) on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 6
                                  # SmolLM-360M FULL on the card
    ... --arch rwkv6_3b --smoke --steps 6 --ckpt_every 2
    ... --arch jamba_v01_52b --smoke --steps 3 --device cpu
    ... --smoke --device cpu      # the plain versions

Builds the model from a seeded generator with f32 parameters (a tied table
one leaf), AdamW, the synthetic LM pipeline and the fault-tolerant
``Trainer``; every GEMM is a plain matrix product in the compute dtype
(gemm mode ``ref``, as the reference's launcher leaves it), attention runs
through the flash_attention forward and backward kernels, the norms
through their kernels, and the wkv6 and selective-scan recurrences
through their forward and backward kernels.  Every step's loss is logged
(the reference logs every fifth).  Options and the default arch mirror the
reference's; a mesh (``--model_parallel > 1``, ``--schedule``) waits for
the multi-device slice.  SeamlessM4T fails at its first step with
``KeyError 'enc_embeds'``, as the reference launcher does (the synthetic
pipeline has no encoder inputs).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch import configs as C
from repro_torch import resolve_device

# Architectures the reference's launcher trains: all of them.
# (SeamlessM4T is taken, and fails as the reference's does.)
TRAINED = ("smollm_360m", "qwen3_8b", "phi3_medium_14b", "minitron_8b",
           "qwen2_vl_72b", "llama4_maverick_400b_a17b", "kimi_k2_1t_a32b",
           "rwkv6_3b", "jamba_v01_52b", "seamless_m4t_large_v2")


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="smollm_360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global_batch", type=int, default=8)
    ap.add_argument("--seq_len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model_parallel", type=int, default=1)
    ap.add_argument("--schedule", type=str, default="rs_ag",
                    choices=["rs_ag", "allreduce"])
    ap.add_argument("--remat_policy", type=str, default="tp_outs",
                    choices=["full", "dots", "tp_outs"])
    ap.add_argument("--no_remat", action="store_true")
    ap.add_argument("--ckpt_dir", type=str, default=None)
    ap.add_argument("--ckpt_every", type=int, default=25)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu, which runs the plain "
                         "versions of the kernels")
    args = ap.parse_args(argv)

    if args.model_parallel > 1 or args.schedule != "rs_ag":
        raise NotImplementedError(
            "--model_parallel > 1 and --schedule need a device mesh: they "
            "come with the multi-device slice (ROADMAP Queue A item 12)")
    if args.arch not in TRAINED:
        raise NotImplementedError(
            f"training {args.arch!r} is not ported (trained: {TRAINED})")
    dev = resolve_device(args.device)

    from repro_torch.models.layers import gemm_mode

    # The plain GEMMs for this run only: the mode is process-wide, and a
    # serving engine started later in the process must find its own.
    with gemm_mode("ref"):
        return _train(args, dev)


def _train(args, dev) -> dict:
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_params, param_count, train_tree
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import (TrainConfig, Trainer,
                                              make_train_step)

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[train] arch={cfg.name} device={dev} ({kind})")
    params = train_tree(init_params(cfg, seed=0, device=dev,
                                    dtype=torch.float32))
    print(f"[train] params: {param_count(params)/1e6:.2f}M")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=5,
                                total_steps=args.steps)
    opt_state = adamw.init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    step = make_train_step(cfg, opt_cfg, remat=not args.no_remat,
                           remat_policy=args.remat_policy)
    trainer = Trainer(
        cfg, TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, log_every=1),
        opt_cfg, params, opt_state, lambda s: data.iterate(s), step)
    result = trainer.run()
    for m in result["metrics"]:
        print(f"  step {m['step']:4d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.2f} ({m['dt']*1e3:.0f} ms)")
    print(f"[train] done: steps={result['final_step']} "
          f"restarts={result['restarts']} "
          f"stragglers={len(result['straggler_events'])} ckpt={trainer.ckpt_dir}")
    return result


if __name__ == "__main__":
    main()
