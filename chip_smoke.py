#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py          # from the repository root, no arguments
    python3 chip_smoke.py --phases "encdec kernels,serve vl"   # a part

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
   null sink page changing nothing.  ``rmsnorm`` (no Pallas counterpart)
   at every served width: SmolLM-360M's d_model 960 in bf16 (8, 128 and
   488 rows), SeamlessM4T's 1024, Qwen3-8B's 4096 and qk_norm rows of
   128, Phi-3-medium's 5120 and Qwen2-VL-72B's 8192 in bf16, the SMOKE
   configs' 96 in f32, every row ``torch.equal`` at M = 1, 3, 8, 488 and
   512 and alone, a control with the scale 1% off that must fail; and
   its fused form (the residual add in the same launch) ``torch.equal``
   to torch's ``x + r`` followed by the unfused kernel, rows alone equal
   to the batch, timed beside ``x + r`` then ``F.rms_norm``.
4. Serve: the SMOKE config (f32, heads of 16) replays smoke6 on dense
   KV, f32 pages and int8 pages, an impossible ITL target trips the
   flight recorder (its file written with reason ``slo_breach``), then
   the serve launcher runs with its defaults (dense, then ``--kv paged
   --page_size 16``), all under ``--verify``, and three more launcher
   runs: shared16 with the prefix cache, smoke6 in chunks of 16 under a
   budget of 12, bursty24 on the wall clock in chunks of 16; and
   ``--arrivals pareto --rate 16 --dump-trace`` writes a trace that
   ``load_trace`` reads back.  SmolLM-360M at full width
   (d_model 960, 15/5 heads of 64, bf16, seeded random weights) and
   ``SERVE_LAYERS`` = 8 of its 32 layers replays traces through the port's continuous-batching
   ``ServeEngine`` with every GEMM, prefill attention and decode attention
   on the kernels: ``benchmarks/traces/smoke6.jsonl`` on the dense KV
   cache, then four paged-KV replays (bf16 pages, int8 pages, a 4-page
   pool that forces preemption, and 8 requests of 448-token prompts).
   Launch counts, the metrics registry and the tracer are reset just
   before and read just after each measured replay and checked per path
   (every ``ops.*.ref`` route counter 0, each ``.kernel`` counter equal
   to its kernel's launches); each replay ends with ``--verify``'s check
   (bit-identical to a one-slot one-shot engine).  Chunked prefill and
   the prefix cache at full width: the 8 x 448 trace in chunks of 128
   (budgeted and not, bf16 pages; dense; int8 pages), each stream equal
   to its monolithic replay's, 32 chunks, attention at q_offset > 0 and
   the latency rows beside the monolithic run's; shared16 with the prefix
   cache off and on (bf16 and int8 pages), cached equal to uncached, the
   hit rate and live page high-waters equal to the JAX engine's.  The
   observability layer at full width: bursty24 on the wall clock (speed
   1) in chunks of 32 under a budget of 8 + 2 x 32, each stream equal to
   its one-shot engine's; the 8 x 448 replay with the tracer on, its
   snapshot, Chrome trace and flight record written, validated and
   rendered by ``tools/obs_report.py``, ``flash_paged_decode`` placed on
   the H100 roofline, its streams equal to the untraced replay's.  Then a
   kernel-vs-plain-GEMM logit check, a 448-token prompt's prefill logits
   with the attention kernel against the same prefill with the plain
   attention, a profile of a decode step (by kernel and by kind, with its
   7 ``gama_gemm`` launches a layer and the head's checked), the 8-slot
   decode step with the eager plain norm, with the rmsnorm kernel after
   eager residual adds, and with the adds fused into the kernel (wall,
   device time, kernels a step, torch's add kernels left, 2 rmsnorm
   launches a layer and the final norm's checked, 2 kernels a layer
   fewer fused), the engine's
   own step attribution (``device_ms``, ``bubble_ms``,
   ``bubble_fraction``) beside ``torch.profiler``'s device-busy time and
   idle share for the same 8-slot decode steps, and the step's wall with
   the metrics registry on and off, in turns; and a profile of the 8 x
   448 replay (its prefill attention's and paged decode's device time).
   Tune (every phase above runs untuned, from an empty tuning cache in a
   temporary directory; nothing under ``~/.cache`` is read or written):
   the port's autotuner (``repro_torch.tuning``) against a cache of its
   own in a temporary directory measures ``gama_gemm``'s plans at
   SmolLM-360M FULL's weight GEMMs at M = 8 and 488, ``flash_attention``'s
   at the 8 x 448 prefill (488 x 496, D = 64) and Qwen3-8B's 512 x 512 at
   D = 128, and the decode and wkv kernels' one chunk at their served
   shapes, each candidate's output ``torch.equal`` to the analytic plan's
   (the winner against the analytic plan in ms); the same tunes again
   must be cache hits; ``tune_serve`` on SmolLM-360M at full width and
   8 layers (max_len 64, 3 candidates; its cache key names the arch and
   width, so the FULL launcher below resolves it); the 8 x 448 replay with the tuned cache in turns with
   the untuned one (untuned, tuned, tuned, untuned), every stream equal,
   each replay's ``gama_gemm`` device time from ``torch.profiler``, every
   ``ops.*.ref`` 0; the serve launcher with ``--batch_slots 0 --kv paged
   --page_size 0 --prefill-chunk -1 --verify`` resolving the tuned
   serve entry; and the host time of a dispatch memo hit.
   Archs: ``wkv6_state`` (the wkv6 forward from a carried state, which
   RWKV-6 serving runs) against its plain loop from a nonzero state at
   RWKV-6 3B's decode, a serial prompt and a 448-token one, in bf16 and
   f32 (a control with the state 1% off must fail; from a zero state its
   y is wkv6's bit for bit); the ``layernorm`` kernel (RWKV-6's
   LayerNorm and GroupNorm in a fixed order, a row read once, rows
   bit-identical at every M; timed at 3B's decode, prompt and training
   rows beside ``F.layer_norm`` / ``F.group_norm``; under autograd, as
   training runs it, its gradients the plain ones); the ``dequant``
   kernel (int8 weights to bf16, the plain bits) at the quantized
   replays' weights; ``gama_gemm`` at every weight GEMM
   of RWKV-6 3B, Phi-3-medium and
   Minitron-8B and of the SMOKE configs; Phi-3-medium's heads in
   attention and decode.  Then the serve launcher's bare ``--verify``
   (qwen3 SMOKE, the default arch) and smoke6 on the phi3, minitron and
   rwkv6 SMOKE configs, and, one model at a time at full width and 8
   layers: Qwen3-8B (dense and bf16 pages), Phi-3-medium (bf16 pages;
   int8 weights), Minitron-8B (dense: 6 GEMMs a layer and the head), the
   three also 8 x 448 on bf16 pages, SmolLM-360M with int8 weights (one
   dequant a weight a step checked); and RWKV-6 3B FULL at its 32 layers
   (``kv="paged"`` asked, the state kept dense; smoke6 and 8 x 448), each
   replay under ``--verify``'s check with its routes held to the
   launches, each model's decode step timed (wall and device) with its
   ``max_memory_allocated``.
   Hybrid: ``selective_scan`` (Mamba's recurrence; no Pallas
   counterpart) against its plain loop from a nonzero state at
   Jamba-v0.1 52B's decode (8 slots), a serial prompt and a 448-token
   one, in bf16 and f32 (a control with the state 1% off must fail; each
   slot alone equal to its rows of the batch bit for bit; a prompt split
   in two with the state carried equal to the whole bit for bit) and at
   the SMOKE width; ``gama_gemm`` at every Jamba weight GEMM (the MoE router
   in f32) at M = 2, 8 and 448, rows independent of M, and at the MoE
   and hybrid SMOKE configs' GEMMs.  Then the serve launcher's Jamba
   (dense, and ``--kv paged`` asked: the Mamba state stays dense),
   Kimi-K2 and Llama-4 Maverick SMOKE runs under ``--verify``, and
   Jamba-v0.1 52B FULL with int8 weights: one MoE layer's token rows
   alone equal to their drop-free batch, smoke6 on 2 slots under
   ``--verify``, the 8 x 448 trace on 8 slots twice (equal tokens, the
   MoE's dropped assignments counted), and its 8-slot decode step (wall,
   device time by kind, launches by kernel checked, routes held).
   Enc-dec and M-RoPE: the kernels at the shapes SeamlessM4T-large-v2
   (GQA group 1) and Qwen2-VL-72B (group 8, heads of 128) serve, each
   with a control that must fail its tolerance: ``flash_attention``
   without the causal mask (the encoder's 448 x 448, the cross attention
   at prefill against 448 encoder rows, rows independent of their
   neighbours), ``flash_decode`` over 448 cross rows and 449-487 self
   rows, ``flash_paged_decode``, ``gama_gemm`` at every decode and prefill
   GEMM (Seamless's lm head N = 256206 on the unaligned path, Qwen2-VL's
   K = 8192 x N = 29568 and 152064), ``dequant`` at Qwen2-VL's int8
   weights, and the SMOKE f32 forms.  Then SeamlessM4T-large-v2 FULL
   (bf16, seed 1) through the engine API with a 448-frame encoder input
   a request: smoke6 on 3 slots and 8 x 448 on 8 slots, each stream equal
   to a one-slot one-shot engine's, ``kv="paged"`` asked (dense), its
   8-slot decode step and the encoder's device time; the serve launcher's
   SMOKE runs of both ids (Qwen2-VL ``verify OK``, Seamless failing with
   KeyError 'enc_embeds' as the reference launcher does); Qwen2-VL-72B
   FULL with int8 weights: resident bytes and init peak and its 8-slot
   decode step at all 80 layers, then at 8 layers smoke6 on 3 slots
   under ``--verify`` and 8 x 448 dense and on bf16 pages with equal
   tokens; and Qwen2-VL SMOKE from patch
   embeddings at distinct (t, h, w) positions, kernels against the plain
   route on the card.
5. Train: the wkv6 forward and backward kernels against their plain
   versions at the training shape, a ragged length and a long one, and
   the head-16 builds the SMOKE config runs (bf16, and f32 at the
   launcher's shape); ``flash_attention_bwd`` (the attention backward,
   ``csrc/flash_attention_bwd.cu``) against ``ref.attention_bwd`` on the
   forward kernel's o and lse at SmolLM-360M's 4 x 2048 and 8 x 64,
   Qwen3-8B's 32/8 heads of 128 at 1 x 2048, ragged lengths, and in f32
   the SMOKE heads of 16, 64 and 128 (f32 within 1e-4 of each gradient's
   largest element; bf16 within 4 x a rounding-floor control; a control
   with lse + 0.1 that must fail; two calls bit-identical, and each batch
   element alone equal to its slice of the batch; the forward's o with lse
   equal to serving's), timed beside its bound, the plain version and
   SDPA's backward; at the end of the run its dQ and dK/dV passes are
   timed apart by the profiler.
   Then RWKV-6 3B FULL (32 layers, d_model 2560, f32 parameters, bf16
   compute, seeded random weights) takes
   training steps through ``make_train_step`` (each step's wkv6 and
   layernorm launches counted), one step profiled; a 2-layer step with
   the kernels against one with the plain recurrence, in f32 and in bf16
   compute, each beside a control.  SmolLM-360M FULL (tied, f32
   parameters, bf16 compute, the launcher's ``tp_outs`` remat) trains at
   8 x 64 and 4 x 2048 tokens (each step's flash_attention,
   flash_attention_bwd and rmsnorm launches checked, ``ops.attention.ref``
   0, losses falling), one step of each profiled, and a 2-layer step with
   attention and the norms on their kernels against their plain versions
   in f32 and bf16, each beside a control.  The training launcher at
   SMOKE size for RWKV-6, for its default arch, SmolLM-360M, and for
   Jamba, each with a restart after an injected failure that must resume
   with the uninterrupted run's losses.  ``selective_scan_bwd`` (the
   Mamba scan's backward, ``csrc/selective_scan.cu``) against
   ``ref.selective_scan_bwd`` at Jamba-v0.1's training shape (8 x 64
   tokens, d_inner 8192, 16 states) in bf16 and f32, a 448-token prompt,
   T=11, a ragged width on plain loads and the SMOKE f32 shape (a control
   with A x 1.01 that must fail; two calls, and each sequence alone
   against its batch rows, bit for bit; the forward that saves the tile
   states giving y and hT bit for bit), timed beside its bound and the
   plain backward.  Then Jamba-v0.1 52B at full width cut to the first
   two blocks of its period (Mamba + dense FFN, Mamba + 16-expert MoE;
   3.74 B f32 parameters, bf16 compute, ``tp_outs``) takes training steps
   at 8 x 64 tokens (each step's selective_scan, selective_scan_bwd and
   rmsnorm launches checked, ``ops.selective_scan.ref`` 0; step time,
   tokens/s and peak memory), one profiled, and a 1-layer step with the
   scan's kernels against the plain scan in f32 and bf16, each beside a
   control.
6. A ``[phase]`` line with each phase's seconds, a ``{"kernels":
   [...]}`` JSON line, the card line, and last the ``{"ok": true,
   "device": ...}`` line.

Any failure raises and exits non-zero before the last line is printed.
``--phases`` runs only the named phases (the names of the ``[phase]``
lines) and then stops without the kernels line or the ``ok`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import hw  # noqa: E402
from repro_torch.configs.gama_paper import ARRAY_GEMMS  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels.dequant import dequantize as dequant_kernel  # noqa: E402,E501
from repro_torch.kernels.rmsnorm import add_rmsnorm as add_rmsnorm_kernel  # noqa: E402,E501
from repro_torch.kernels.rmsnorm import layernorm as layernorm_kernel  # noqa: E402,E501
from repro_torch.kernels.rmsnorm import rms_plan  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    scan_plan, selective_scan as scan_kernel, selective_scan_bwd as scan_bwd,
    selective_scan_fwd as scan_fwd)
from repro_torch.kernels import selective_scan as scan_mod  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_chunk, flash_decode, flash_paged_decode)
from repro_torch.kernels.flash_attention import blocks as attn_blocks  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd  # noqa: E402,E501
from repro_torch.kernels.flash_attention import plan as attn_plan  # noqa: E402
from repro_torch.kernels.gemm import gama_gemm  # noqa: E402
from repro_torch.kernels.gemm import blocks as gemm_blocks  # noqa: E402
from repro_torch.kernels.gemm import plan as gemm_plan  # noqa: E402
from repro_torch.kernels import dequant as dequant_mod  # noqa: E402
from repro_torch.kernels import wkv as wkv_mod  # noqa: E402
from repro_torch.kernels.wkv import wkv6, wkv6_bwd, wkv6_state  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step, forward, init_cache, init_paged_cache, init_params, loss_fn,
    train_tree)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import set_gemm_mode  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    TrainConfig, Trainer, make_train_step)
from repro_torch.serving.engine import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serving.kvpool import pages_for  # noqa: E402
from repro_torch.serving.quant import quantize_kv_pages  # noqa: E402
from repro_torch.tuning import dispatch  # noqa: E402
from repro_torch.tuning.space import (  # noqa: E402
    AttentionCandidate, GemmCandidate)

# Published H100 SXM peaks (NVIDIA data sheet; dense, 700 W), from the
# port's hardware model: device memory bytes/s, operations/s by input type,
# and the L2 a timed working set must exceed.
HBM_BYTES_S = hw.H100_SXM.hbm_bw
PEAK_OPS_S = {torch.bfloat16: hw.H100_SXM.peak_bf16_flops,
              torch.float32: hw.H100_SXM.peak_f32_flops,
              torch.int8: hw.H100_SXM.peak_int8_ops}
L2_BYTES = hw.H100_SXM.l2_bytes
DEV = "cuda"

SOURCES = {"gama_gemm": "src/repro_torch/csrc/gemm.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/csrc/flash_attention_bwd.cu",
           "flash_decode": "src/repro_torch/csrc/decode_attention.cu",
           "flash_paged_decode":
               "src/repro_torch/csrc/paged_decode_attention.cu",
           "wkv6": "src/repro_torch/csrc/wkv.cu",
           "wkv6_bwd": "src/repro_torch/csrc/wkv.cu",
           "wkv6_state": "src/repro_torch/csrc/wkv.cu",
           "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
           "layernorm": "src/repro_torch/csrc/rmsnorm.cu",
           "dequant": "src/repro_torch/csrc/dequant.cu",
           "selective_scan": "src/repro_torch/csrc/selective_scan.cu",
           "selective_scan_bwd": "src/repro_torch/csrc/selective_scan.cu"}
# wkv6_bwd replaces the VJP that JAX derives through the same pallas_call;
# wkv6_state the same kernel's recurrence run from a carried state (the
# reference's cached RWKV branch scans it in jnp, src/repro/models/rwkv.py).
REPLACES = {"gama_gemm": "src/repro/kernels/gemm.py:113",
            "flash_attention": "src/repro/kernels/flash_attention.py:145",
            "flash_attention_bwd": "its VJP (JAX: autodiff through "
                                   "src/repro/kernels/ref.py:46)",
            "flash_decode": "src/repro/kernels/decode_attention.py:127",
            "flash_paged_decode": "src/repro/kernels/decode_attention.py:415",
            "wkv6": "src/repro/kernels/wkv.py:70",
            "wkv6_bwd": "src/repro/kernels/wkv.py:70",
            "wkv6_state": "src/repro/kernels/wkv.py:70",
            "rmsnorm": "none: no Pallas counterpart (jnp rmsnorm at "
                       "src/repro/models/layers.py:103)",
            "layernorm": "none: no Pallas counterpart (jnp layernorm and "
                         "groupnorm at src/repro/models/layers.py:115, "
                         ":125)",
            "dequant": "none: no Pallas counterpart (jnp dequantize_weight "
                       "at src/repro/serving/quant.py:44)",
            "selective_scan": "none: no Pallas counterpart (jnp "
                              "_ssm_scan_chunked and the decode step at "
                              "src/repro/models/mamba.py:83, :151)",
            "selective_scan_bwd": "none: no Pallas counterpart (the VJP JAX "
                                  "derives through src/repro/models/"
                                  "mamba.py:83-114 and :158)"}
# The long replay: 8 requests of 448-token prompts and 32 new tokens on 8
# slots; max_len = 488 is also its last prefill bucket, and its scratch
# cache has pages_for(488, 16) * 16 = 496 rows.
LONG_REQS, LONG_PROMPT, LONG_NEW = 8, 448, 32
LONG_LEN = LONG_PROMPT + LONG_NEW + 8
SERVE_KERNELS = ("gama_gemm", "flash_attention", "flash_decode",
                 "flash_paged_decode", "rmsnorm")
ATTENTION_KERNELS = ("flash_attention", "flash_decode", "flash_paged_decode",
                     "rmsnorm")
# The chunked replays of the 8 x 448 trace: chunks of 128 tokens (448 =
# 128 + 128 + 128 + 64, 32 chunks), and a budget of the 8 decode tokens
# plus two chunks a step.
CHUNK, CHUNK_BUDGET = 128, 8 + 2 * 128
# shared16 on 4 slots, max_len 128, pages of 16: the JAX engine's prefix
# hit rate and live page high-waters (cached, uncached), as
# tests/test_torch_prefix.py holds both engines to them on the CPU.
SHARED16_HIT_RATE = 0.6
SHARED16_HWM = {True: 11, False: 20}
TRAIN_KERNELS = ("wkv6", "wkv6_bwd")
SCAN_TRAIN_KERNELS = ("selective_scan", "selective_scan_bwd")
ATTN_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm")
# The serve replays of SmolLM-360M, Qwen3-8B, Phi-3-medium, Minitron-8B and
# Qwen2-VL-72B run at full width and this many layers.  Their time is the
# host's (a decode step's device idle share is above 0.9), it grows with the
# layer count, and every layer launches the same kernels at the same shapes,
# so a cut depth drives every kernel of those paths as the full one does.
# Full depth stays where a path is the point: the training steps, RWKV-6 3B
# (the layernorm kernel's served path), Jamba-v0.1 52B, SeamlessM4T, and
# Qwen2-VL-72B's memory fit and decode step.
SERVE_LAYERS = 8


def served(cfg):
    """``cfg`` at full width and at most ``SERVE_LAYERS`` layers."""
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, SERVE_LAYERS))


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


def must_fail(label, got, wrong, tol, floor=None):
    """A control: ``got`` held against a deliberately wrong plain result
    must fail the tolerance the check uses, or the check could not see
    that error."""
    try:
        err = max_err(got, wrong, tol, floor)
    except AssertionError as e:
        print(f"[control] {label}: fails as it must ({e})")
        return
    raise AssertionError(f"control {label} passed the tolerance (max abs err "
                         f"{err:.3e}): the check cannot see this error")


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float,
            floor: float | None = None) -> float:
    """Max |got - want|; fails unless |got - want| <= tol * (1 + |want|)
    elementwise (tol = 0: exact), or, given ``floor``, unless
    |got - want| <= tol * |want| + floor."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    err = (g - w).abs()
    limit, form = ((tol * (1 + w.abs()), f"{tol:g} * (1 + |plain|)")
                   if floor is None else
                   (tol * w.abs() + floor, f"{tol:g} * |plain| + {floor:g}"))
    if (err > limit).any():
        raise AssertionError(f"max abs err {err.max().item():.3e} over "
                             f"tolerance {form}")
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
               per_step=None, control=False):
    """gama_gemm against its plain version, timed beside torch.matmul (or
    torch._int_mm).  The plain version is timed only for weights up to
    256 MB (it widens B to f32 on every call).  With ``control`` the plain
    version of B x 1.05 must fail the tolerance."""
    gen = _gen(seed)
    a = _rand((m, k), dtype, gen)
    b = _rand((k, n), dtype, gen, scale=k ** -0.5)
    got = gama_gemm(a, b, out_dtype=out_dtype, scale=scale)
    want = ops.matmul(a, b, out_dtype=out_dtype, scale=scale, mode="ref")
    torch.cuda.synchronize()
    err = max_err(got, want, tol)
    del want
    if control:
        must_fail(f"gama_gemm {label} M={m}: the kernel against the plain "
                  f"version of B x 1.05", got, ops.matmul(
                      a, b * 1.05, out_dtype=out_dtype, scale=scale,
                      mode="ref"), tol)
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
    path): at every weight GEMM of ``cfgs``, in its site's dtype (the
    FULL configs' bf16; the MoE router in f32),
    each row of an M-row product must be ``torch.equal`` to the same row
    computed alone (M = 1)."""
    checked = 0
    for cfg in cfgs:
        for label, (k, n, _) in cfg.gemm_shapes().items():
            dtype = cfg.gemm_dtype(label)
            gen = _gen(k + n)
            a = _rand((max(ms), k), dtype, gen)
            b = _rand((k, n), dtype, gen, scale=k ** -0.5)
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


# The rmsnorm kernel's served shapes (label, rows, d, dtype):
# SmolLM-360M's d_model at the 8 x 448 replay's decode batch (the kernels
# line), a prefill chunk and the 488 bucket; the SMOKE configs' 96 in f32;
# Qwen3-8B's qk_norm (d=128 over 3 tokens x 32 heads) and d_model (also
# Minitron-8B's and Jamba's 4096); SeamlessM4T's 1024, Phi-3-medium's 5120
# and Qwen2-VL-72B's 8192 at an 8-slot decode.  tools/norm_table.py times
# the same.
NORM_SHAPES = [("decode", LONG_REQS, 960, torch.bfloat16),
               ("chunk", CHUNK, 960, torch.bfloat16),
               ("prefill-488", LONG_LEN, 960, torch.bfloat16),
               ("smoke", 16, 96, torch.float32),
               ("qwen3-8b-qk_norm", 96, 128, torch.bfloat16),
               ("qwen3-8b", 3, 4096, torch.bfloat16),
               ("decode-4096", LONG_REQS, 4096, torch.bfloat16),
               ("seamless-1024", LONG_REQS, 1024, torch.bfloat16),
               ("phi3-medium-5120", LONG_REQS, 5120, torch.bfloat16),
               ("qwen2-vl-72b-8192", LONG_REQS, 8192, torch.bfloat16)]


def norm_inputs(m, d, dtype, seed):
    """x and r (max(m, 512) rows of d, N(0, 9) in ``dtype``) and the f32
    scale 1 + N(0, 0.01), from ``seed`` on the card."""
    gen = _gen(seed)
    x, r = ((torch.randn((max(m, 512), d), generator=gen, device=DEV) * 3
             ).to(dtype) for _ in range(2))
    return x, r, 1 + 0.1 * torch.randn((d,), generator=gen, device=DEV)


def norm_bounds(m, d, dtype):
    """(bytes, operations) of rmsnorm and of its fused form on m rows:
    x (and r) read, y (and s) written, the f32 scale read; 3 (4)
    operations an element."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return ((2 * m * d * elt + 4 * d, 3.0 * m * d),
            (4 * m * d * elt + 4 * d, 4.0 * m * d))


def norm_times(xm, rm, scale):
    """Device ms of the rmsnorm kernel, its plain version, F.rms_norm, the
    fused form, x + r then the kernel, and x + r then F.rms_norm, on the
    same rows, in that order."""
    d = xm.shape[-1]
    nbytes = norm_bounds(xm.shape[0], d, xm.dtype)[1][0]
    sc = scale.to(xm.dtype)
    calls = {
        "kernel": lambda: rmsnorm_kernel(xm, scale),
        "plain": lambda: ops.rmsnorm(xm, scale, mode="ref"),
        "library": lambda: F.rms_norm(xm, (d,), sc, 1e-6),
        "fused": lambda: add_rmsnorm_kernel(xm, rm, scale),
        "add+kernel": lambda: rmsnorm_kernel(xm + rm, scale),
        "add+library": lambda: F.rms_norm(xm + rm, (d,), sc, 1e-6)}
    return {k: device_ms(lambda c=c: c, nbytes) for k, c in calls.items()}


def check_rmsnorm(label, m, d, dtype, seed, main=False, per_step=None):
    """The rmsnorm kernel against its plain version (float64 sums): within
    1e-6 * |plain| in f32 and one bf16 ulp (2**-7 * |plain|) in bf16, the
    plain version with the scale 1% off failing it; every row equal at M
    = 1, 3, 8, 488 and 512 and computed alone.  Its fused form: s
    ``torch.equal`` to torch's x + r and y to the unfused kernel on it,
    rows alone equal to the batch.  Timed beside the bound, the plain
    version and F.rms_norm; the fused form beside x + r then the kernel,
    and x + r then F.rms_norm."""
    x, r, scale = norm_inputs(m, d, dtype, seed)
    whole = rmsnorm_kernel(x, scale)
    want = ops.rmsnorm(x, scale, mode="ref")
    torch.cuda.synchronize()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    err = max_err(whole, want, tol, 0.0)
    must_fail(f"rmsnorm {label}: the kernel against the plain version with "
              f"the scale x 1.01", whole,
              ops.rmsnorm(x, scale * 1.01, mode="ref"), tol, 0.0)
    for rows in (1, 3, 8, 488, 512):
        if not torch.equal(rmsnorm_kernel(x[:rows].contiguous(), scale),
                           whole[:rows]):
            raise AssertionError(f"rmsnorm {label}: rows of an M={rows} "
                                 f"call differ from the M=512 call")
    alone = torch.cat([rmsnorm_kernel(x[i:i + 1].contiguous(), scale)
                       for i in range(16)])
    if not torch.equal(alone, whole[:16]):
        raise AssertionError(f"rmsnorm {label}: a row alone differs")
    s, y = add_rmsnorm_kernel(x, r, scale)
    if not (torch.equal(s, x + r)
            and torch.equal(y, rmsnorm_kernel(x + r, scale))):
        raise AssertionError(f"rmsnorm {label}: the fused form differs from "
                             f"x + r then the kernel")
    for rows in (1, 3, 8, 488):
        if not torch.equal(add_rmsnorm_kernel(
                x[:rows].contiguous(), r[:rows].contiguous(), scale)[1],
                y[:rows]):
            raise AssertionError(f"rmsnorm {label}: fused rows of an "
                                 f"M={rows} call differ")
    res = RESULTS["rmsnorm"]
    res["max_abs_err"] = max(res["max_abs_err"], err)
    xm, rm = x[:m].contiguous(), r[:m].contiguous()
    t = norm_times(xm, rm, scale)
    (nb, no), (fb, fo) = norm_bounds(m, d, dtype)
    bms, by = bound(nb, no, torch.float32)
    fms, fby = bound(fb, fo, torch.float32)
    print(f"[kernel] rmsnorm {label} M={m} d={d} {str(dtype)[6:]} "
          f"plan={tuple(rms_plan(d, dtype))} max_abs_err={err:.3e} "
          f"tol={tol:g}*|plain| (scale*1.01 fails) rows torch.equal at "
          f"M=1,3,8,488,512 and alone, OK kernel_ms={t['kernel']:.5f} "
          f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} "
          f"(F.rms_norm) bound_ms={bms:.6f} ({by}) "
          f"bound/kernel={bms / t['kernel']:.4f}"
          + ("" if per_step is None else f" launches_per_decode_step="
             f"{per_step}"))
    print(f"[kernel] rmsnorm fused add {label} M={m} d={d} "
          f"{str(dtype)[6:]}: s == x + r and y == kernel(x + r) "
          f"torch.equal, rows alone == batch, OK fused_ms={t['fused']:.5f} "
          f"add_then_kernel_ms={t['add+kernel']:.5f} "
          f"add_then_library_ms={t['add+library']:.5f} (x + r, F.rms_norm) "
          f"bound_ms={fms:.6f} ({fby}) bound/fused={fms / t['fused']:.4f}")
    if main:
        res.update(ms=t["kernel"], plain_ms=t["plain"],
                   library_ms=t["library"], bound_ms=bms, bound_by=by,
                   shape=f"M={m} d={d} {str(dtype)[6:]} {label}")


def check_layernorm(label, m, d, groups, dtype, seed, main=False,
                    per_step=None):
    """The layernorm kernel (``groups`` > 1: GroupNorm) against its plain
    version (f32 sums in torch's order): within 1e-5 * (1 + |plain|) in
    f32 and 1e-2 * (1 + |plain|) in bf16 (one bf16 ulp); timed beside its
    bound, the plain version and F.layer_norm / F.group_norm.  Bit for
    bit: every row equal at M = 1, 3, 8, 448 and 512 and computed alone,
    which the batched RWKV decode's ``--verify`` needs."""
    gen = _gen(seed)
    x = (torch.randn((max(m, 512), d), generator=gen, device=DEV) * 3 + 0.5
         ).to(dtype)
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=DEV)
    bias = 0.1 * torch.randn((d,), generator=gen, device=DEV)
    eps = 1e-5 if groups == 1 else 64e-5
    whole = layernorm_kernel(x, scale, bias, eps, groups)
    want = ops.layernorm(x, scale, bias, eps=eps, groups=groups, mode="ref")
    torch.cuda.synchronize()
    err = max_err(whole, want, 1e-5 if dtype == torch.float32 else 1e-2)
    for rows in (1, 3, 8, 448, 512):
        if not torch.equal(layernorm_kernel(x[:rows].contiguous(), scale,
                                            bias, eps, groups),
                           whole[:rows]):
            raise AssertionError(f"layernorm {label}: rows of an M={rows} "
                                 f"call differ from the M=512 call")
    alone = torch.cat([layernorm_kernel(x[i:i + 1].contiguous(), scale,
                                        bias, eps, groups)
                       for i in range(16)])
    if not torch.equal(alone, whole[:16]):
        raise AssertionError(f"layernorm {label}: a row alone differs")
    r = RESULTS["layernorm"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    xm = x[:m].contiguous()
    nbytes = 2 * m * d * x.element_size() + 8 * d
    kern = device_ms(lambda: (lambda: layernorm_kernel(xm, scale, bias, eps,
                                                       groups)), nbytes)
    plain = device_ms(lambda: (lambda: ops.layernorm(
        xm, scale, bias, eps=eps, groups=groups, mode="ref")), nbytes)
    sc, bi = scale.to(dtype), bias.to(dtype)
    if groups == 1:
        lib_fn, lib_name = (lambda: F.layer_norm(xm, (d,), sc, bi, eps),
                            "F.layer_norm")
    else:
        lib_fn, lib_name = (lambda: F.group_norm(xm, groups, sc, bi, eps),
                            "F.group_norm")
    lib = device_ms(lambda: lib_fn, nbytes)
    bms, by = bound(nbytes, 6.0 * m * d, torch.float32)
    print(f"[kernel] layernorm {label} M={m} d={d} groups={groups} "
          f"{str(dtype)[6:]} max_abs_err={err:.3e} rows torch.equal at "
          f"M=1,3,8,448,512 and alone, OK kernel_ms={kern:.5f} "
          f"plain_ms={plain:.5f} library_ms={lib:.5f} ({lib_name}) "
          f"bound_ms={bms:.6f} ({by}) bound/kernel={bms / kern:.4f}"
          + ("" if per_step is None else f" launches_per_decode_step="
             f"{per_step}"))
    if main:
        r.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bms,
                 bound_by=by, shape=f"M={m} d={d} {str(dtype)[6:]} {label}")


def check_layernorm_grad(label, m, d, groups, dtype, seed):
    """``ops.layernorm`` under autograd, as training calls it (RWKV-6 3B's
    8 x 64 tokens): the kernel forward bit for bit, and the gradients of
    x, scale and bias against autograd of the plain version on the same
    inputs (the backward recomputes that expression: within 1e-5 *
    (1 + |plain|), bitwise equality printed)."""
    gen = _gen(seed)
    x = (torch.randn((m, d), generator=gen, device=DEV) * 3 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=DEV)
    bias = 0.1 * torch.randn((d,), generator=gen, device=DEV)
    gy = torch.randn((m, d), generator=gen, device=DEV).to(dtype)
    before = K.launch_counts()["layernorm"]
    got_in = [t.clone().requires_grad_() for t in (x, scale, bias)]
    got = ops.layernorm(*got_in, groups=groups)
    got.backward(gy)
    launched = K.launch_counts()["layernorm"] - before
    want_in = [t.clone().requires_grad_() for t in (x, scale, bias)]
    ops.layernorm(*want_in, groups=groups, mode="ref").backward(gy)
    torch.cuda.synchronize()
    if launched != 1 or not torch.equal(
            got.detach(), layernorm_kernel(x, scale, bias, 1e-5, groups)):
        raise AssertionError(f"layernorm grad {label}: {launched} launches, "
                             f"or the forward is not the kernel's")
    errs, same = {}, []
    for name, g, w in zip(("x", "scale", "bias"), got_in, want_in):
        errs[name] = max_err(g.grad, w.grad, 1e-5)
        same.append(torch.equal(g.grad, w.grad))
    print(f"[kernel] layernorm grad {label} M={m} d={d} groups={groups} "
          f"{str(dtype)[6:]}: forward == kernel bitwise, 1 launch; grads "
          f"max_abs_err {json.dumps(errs)} (tol 1e-5*(1+|plain|)), "
          f"bitwise equal {same}")


def check_dequant(label, q_shape, s_shape, dtype, seed, main=False,
                  per_step=None, reps=24, control=False):
    """The dequant kernel against its plain version, bit for bit (the
    product in f32, rounded once), also for a code view off the 16-byte
    boundary; timed beside its bound (each code read once, each value
    written once, the scales read once), the plain version (three passes)
    and one ``torch.mul`` into an output of ``dtype``, ``reps`` calls a
    timed graph (fewer for a tensor of gigabytes, whose outputs the graph
    holds)."""
    gen = _gen(seed)

    def inputs():
        q = torch.randint(-127, 128, q_shape, generator=gen, device=DEV,
                          dtype=torch.int8)
        return q, torch.rand(s_shape, generator=gen, device=DEV) * 0.02

    q, scale = inputs()
    got = dequant_kernel(q, scale, dtype)
    want = ops.dequantize(q, scale, dtype, mode="ref")
    odd = torch.empty(q.numel() + 1, dtype=torch.int8, device=DEV)[1:]
    odd = odd.view(q_shape).copy_(q)
    torch.cuda.synchronize()
    err = max_err(got, want, 0.0)
    if not (torch.equal(got, want)
            and torch.equal(dequant_kernel(odd, scale, dtype), got)):
        raise AssertionError(f"dequant {label}: not the plain version's bits")
    if control:
        must_fail(f"dequant {label}: the kernel against the plain version "
                  f"of scale x 1.001", got, ops.dequantize(
                      q, scale * 1.001, dtype, mode="ref"), 0.0)
    del got, want, odd
    r = RESULTS["dequant"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    elems = q.numel()
    nbytes = elems * (1 + torch.tensor([], dtype=dtype).element_size()) \
        + scale.numel() * 4
    mid = (1,) * (len(q_shape) - len(s_shape))

    def mk(fn):
        def make():     # fresh inputs per copy, rotated past the L2
            qq, ss = inputs()
            return lambda: fn(qq, ss)
        return make

    kern = device_ms(mk(lambda qq, ss: dequant_kernel(qq, ss, dtype)),
                     nbytes, reps)
    plain = device_ms(mk(lambda qq, ss: ops.dequantize(qq, ss, dtype,
                                                       mode="ref")),
                      nbytes, reps)
    lib = device_ms(mk(lambda qq, ss: torch.mul(
        qq, ss.view(*s_shape[:-1], *mid, s_shape[-1]),
        out=torch.empty(q_shape, dtype=dtype, device=DEV))), nbytes, reps)
    bms, by = bound(nbytes, float(elems), torch.float32)
    print(f"[kernel] dequant {label} q={tuple(q_shape)} scale="
          f"{tuple(s_shape)} -> {str(dtype)[6:]} vec="
          f"{dequant_mod.vec_width(*dequant_mod.groups_of(q, scale)[1:])}: "
          f"torch.equal to plain (and from a misaligned view) OK "
          f"kernel_ms={kern:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
          f"(torch.mul into {str(dtype)[6:]}) bound_ms={bms:.6f} ({by}: "
          f"{nbytes / 1e6:.3f} MB) bound/kernel={bms / kern:.3f}"
          + ("" if per_step is None else
             f" launches_per_decode_step={per_step}"))
    if main:
        r.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bms,
                 bound_by=by, shape=f"q={tuple(q_shape)} -> "
                 f"{str(dtype)[6:]} {label}")


def _attn_bound(b, hq, hkv, sq, d, elt, keys_per_row, kv_rows):
    """Bytes: q and out once, K and V rows [0, kv_rows) once per KV head;
    operations: 4 * D per (query row, key it attends to)."""
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * kv_rows * d) * elt
    return nbytes, 4.0 * d * hq * b * keys_per_row


def check_attention(label, b, hq, hkv, sq, sk, d, q_offset, dtype, tol, seed,
                    main=False, kv_len=None, causal=True, control=False):
    """flash_attention against its plain version, timed beside its bound,
    the plain version and SDPA.  ``causal=False`` (an encoder's
    self-attention, cross attention at prefill): every row sees keys
    [0, kv_len); with ``control`` the plain version of the other mask must
    fail the tolerance."""
    gen = _gen(seed)
    q = _rand((b, hq, sq, d), dtype, gen)
    k = _rand((b, hkv, sk, d), dtype, gen)
    v = _rand((b, hkv, sk, d), dtype, gen)
    kv = sk if kv_len is None else kv_len
    args = dict(causal=causal, q_offset=q_offset, kv_len=kv)
    got = flash_attention(q, k, v, **args)
    want = ops.attention(q, k, v, mode="ref", **args)
    torch.cuda.synchronize()
    err = max_err(got, want, tol)
    if control:
        must_fail(f"flash_attention {label}: the kernel against the plain "
                  f"version with causal={not causal}", got, ops.attention(
                      q, k, v, mode="ref", **{**args, "causal": not causal}),
                  tol)
    r = RESULTS["flash_attention"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    per_row = [max(0, min(kv, q_offset + i + 1)) if causal else kv
               for i in range(sq)]
    nbytes, flops = _attn_bound(b, hq, hkv, sq, d, q.element_size(),
                                sum(per_row), max(per_row))
    kern = device_ms(lambda: (lambda: flash_attention(q, k, v, **args)),
                     nbytes)
    plain = device_ms(lambda: (lambda: ops.attention(
        q, k, v, mode="ref", **args)), nbytes)
    # SDPA's causal mask is top-left aligned: query i sees keys <= i, the
    # same function as q_offset = 0; at an offset or a kv_len below Sk it
    # takes the mask as a tensor.  KV expanded to Hq up front.
    kq = k.repeat_interleave(hq // hkv, 1)
    vq = v.repeat_interleave(hq // hkv, 1)
    if q_offset == 0 and kv == sk:
        lib = device_ms(lambda: (lambda: F.scaled_dot_product_attention(
            q, kq, vq, is_causal=causal)), nbytes)
    else:
        k_pos = torch.arange(sk, device=DEV)[None, :]
        mask = ((k_pos <= torch.arange(sq, device=DEV)[:, None] + q_offset)
                & (k_pos < kv))
        lib = device_ms(lambda: (lambda: F.scaled_dot_product_attention(
            q, kq, vq, attn_mask=mask)), nbytes)
    bms, by = bound(nbytes, flops, dtype)
    p = attn_plan(b, hq, hkv, sq, sk, d, dtype)
    print(f"[kernel] flash_attention {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} "
          f"Sk={sk} D={d} q_offset={q_offset} kv_len={kv} causal={causal} "
          f"{str(dtype)[6:]} "
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
                 main=False, control=False):
    """flash_decode against its plain version, timed over copies of the
    cache that cover twice the L2 (a decode step finds its layer's cache
    in device memory) beside its bound, the plain version and SDPA on the
    same cache.  Bit for bit: every slot alone (B=1) equals its row of the
    batch, and, when no length passes Sk, so does the batch against a
    cache zero-padded to 2 * Sk (the chunks depend on key positions
    only).  With ``control`` the plain version at half the lengths must
    fail the tolerance."""
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
    if control:
        must_fail(f"flash_decode {label}: the kernel against the plain "
                  f"version at half the lengths", got, ops.decode(
                      q, k, v, length=(length + 1) // 2, mode="ref"), tol)
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
                       main=False, dtype=torch.bfloat16, control=False):
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
    if control:     # the plain version at half the lengths must fail
        must_fail(f"flash_paged_decode {label}: the kernel against the plain "
                  f"version at half the lengths", got[2], ops.decode_paged(
                      q, kp, vp, block_tables=table, length=(length + 1) // 2,
                      mode="ref", **sc), tol)
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
    # rmsnorm and its fused form at every served width (NORM_SHAPES).
    norms = 2 * cfg.n_layers + 1
    for i, (label, m, d, dtype) in enumerate(NORM_SHAPES):
        check_rmsnorm(label, m, d, dtype, seed=50 + i, main=i == 0,
                      per_step=norms if i == 0 else None)
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
    # The chunked 8 x 448 replay's last full chunk: 128 rows at q_offset
    # 384 of the 496-row scratch.
    check_attention(f"chunk-{CHUNK}", 1, hq, hkv, CHUNK, long_cache, dh,
                    3 * CHUNK, torch.bfloat16, 2e-2, seed=41)
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
        lg, caches, _ = forward(params, {"tokens": toks}, cfg,
                                caches=caches, cache_pos=0)
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
    want = sum(c for _, _, c in cfg.gemm_shapes().values())
    for kind in layouts:
        wall_ms = sum(walls[kind]) / len(walls[kind])
        traced_ms, by_name, launched, lost = _profiled(
            lambda: run(kind), f"decode step ({kind} KV)")
        if launched["gama_gemm"] != want * steps:
            raise AssertionError(f"decode step ({kind} KV): "
                                 f"{launched['gama_gemm']} gama_gemm launches "
                                 f"in {steps} steps, expected {want} a step")
        if not by_name or lost:
            print(f"[profile] decode step ({kind} KV) wall_ms={wall_ms:.3f}; "
                  f"device time not measured ({_unmeasured(lost)}); "
                  f"gama_gemm launches per step {want} (counters)")
            continue
        by_kind = _by_kind(by_name)
        device_ms = sum(us for _, us in by_name.values()) / 1e3 / steps
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        print(f"[profile] decode step (3 slots, {kind} KV, {cfg.name} FULL "
              f"width, {cfg.n_layers} layers): "
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
            print(f"[profile]   {name[:60]}: {n // steps} per step, "
                  f"{us / 1e3 / steps:.3f} ms per step")


# A profile is taken again, once for each entry here, when it saw fewer
# launches of a counted kernel than its wrapper made: the profiler does not
# always deliver every device event, and a partial profile's device time is
# not a measurement.  Late in a run it has dropped the kernels of a traced
# run's first tens of ms (the first norm and GEMMs of a replay or a decode
# step, the same ones in every attempt; every record of a shorter session).
# So each traced run starts with spin kernels spread over a margin, the
# entry of its attempt, and ends ``PROFILE_MARGIN_S`` after the card was
# idle; the spin kernels are left out of every sum.  A margin of 0.05 s
# lost records in 8 profiles of one run where 0.5 s lost none, so the
# first attempt takes 0.5 s.
PROFILE_MARGINS_S = (0.5, 2.0)
PROFILE_MARGIN_S = 0.05


def _prime(margin_s):
    """Spin kernels over ``margin_s`` seconds at the start of a traced run,
    then wait for the card."""
    end = time.perf_counter() + margin_s
    while True:
        torch.cuda._sleep(1000)
        if time.perf_counter() >= end:
            break
        time.sleep(0.01)
    torch.cuda.synchronize()


def _is_spin(name):
    return "spin_kernel" in name

# The profile's kinds that a wrapper's launch counter also counts.
_COUNTED_KINDS = {
    "GEMM (gama_gemm)": ("gama_gemm",),
    "rmsnorm (rmsnorm kernel)": ("rmsnorm",),
    "layernorm (layernorm kernel)": ("layernorm",),
    "dequantize (dequant kernel)": ("dequant",),
    "selective scan (selective_scan kernel)": ("selective_scan",),
    "prefill attention (flash_attention)": ("flash_attention",),
    "decode attention (flash_decode, flash_paged_decode)": (
        "flash_decode", "flash_paged_decode"),
}


def _profiled(fn, label, host=True):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity; CUDA only
    without ``host``, which keeps the trace to the kernels), taken again
    while the profile saw fewer kernels of a counted kind than the
    wrappers launched.  Returns (fn's result, (count, device us) by kernel
    name, the launch counters' increments over the traced run, {kind:
    [seen, launched]} of what the last profile lost: empty when it is
    complete)."""
    acts = ([torch.profiler.ProfilerActivity.CPU] if host else []) + [
        torch.profiler.ProfilerActivity.CUDA]
    for attempt, margin_s in enumerate(PROFILE_MARGINS_S, 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            _prime(margin_s)
            before = K.launch_counts()
            out = fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        launched = {n: c - before[n] for n, c in K.launch_counts().items()}
        by_name = _device_by_name(prof, raw=not host)
        lost = {}
        for kind, names in _COUNTED_KINDS.items():
            n = sum(launched[x] for x in names)
            seen = _by_kind(by_name).get(kind, (0, 0.0))[0]
            if seen < n:
                lost[kind] = [seen, n]
        if not lost or not by_name:
            return out, by_name, launched, {}
        print(f"[profile] {label}, attempt {attempt} (start margin "
              f"{margin_s} s): the profiler saw fewer kernels than the "
              f"wrappers launched (seen, launched): {json.dumps(lost)}")
    return out, by_name, launched, lost


def _by_kind(by_name):
    by_kind = {}
    for name, (n, us) in by_name.items():
        k, t = by_kind.get(_kind(name), (0, 0.0))
        by_kind[_kind(name)] = (k + n, t + us)
    return by_kind


def _unmeasured(lost):
    if lost:
        return (f"the profiler lost kernel events in each of "
                f"{len(PROFILE_MARGINS_S)} attempts: {json.dumps(lost)}")
    return "the profiler saw no CUDA events"


@contextlib.contextmanager
def eager_adds():
    """The models' fused residual adds undone for a while: ``ops.
    add_rmsnorm`` as torch's ``x + r`` then ``ops.rmsnorm`` (the kernel on
    the card), the serve path's form before the fusion."""
    orig = ops.add_rmsnorm

    def unfused(x, r, scale, *, eps=1e-6, mode="auto"):
        s = x + r
        return s, ops.rmsnorm(s, scale, eps=eps, mode=mode)
    ops.add_rmsnorm = unfused
    try:
        yield
    finally:
        ops.add_rmsnorm = orig


def profile_decode_norms(cfg, params, steps=5):
    """A decode step with its norms three ways: the eager plain rmsnorm
    (no kernel), the rmsnorm kernel after torch's residual adds, and the
    adds fused into the kernel, at the 8 x 448 replay's decode shape (8
    slots at 449-487 keys on bf16 pages of 16).  Wall per step (host
    clock, synchronised, profiler off) in turns plain, eager adds, fused,
    fused, eager adds, plain; then one profiled run each: kernels launched
    a step, device time, torch's add kernels left a step and the rmsnorm
    kernel's launches a step (2 a layer + the final norm, fused or not;
    the fused step runs 2 kernels a layer fewer)."""
    b = LONG_REQS
    max_pages = pages_for(LONG_LEN, 16)
    tok = torch.zeros(b, dtype=torch.long, device=DEV)
    pos = torch.tensor([LONG_PROMPT + 1 + (LONG_LEN - LONG_PROMPT - 2) * i
                        // 7 for i in range(b)], dtype=torch.int32,
                       device=DEV)
    caches = init_paged_cache(cfg, b * max_pages, 16, device=DEV)
    tables = torch.arange(b * max_pages, dtype=torch.int32,
                          device=DEV).view(b, max_pages)
    forms = {"ref": "eager plain rmsnorm",
             "eager": "rmsnorm kernel, eager residual adds",
             "fused": "residual adds fused into the rmsnorm kernel"}

    def run(form):
        with contextlib.ExitStack() as stack:
            if form == "ref":
                stack.enter_context(op_mode("rmsnorm", "ref"))
                stack.enter_context(op_mode("add_rmsnorm", "ref"))
            elif form == "eager":
                stack.enter_context(eager_adds())
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, _ = decode_step(params, tok, pos, cfg, caches,
                                        block_tables=tables)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps, logits

    outs = {form: run(form)[1] for form in forms}      # warm-up
    if not torch.equal(outs["fused"], outs["eager"]):
        raise AssertionError("decode step: the fused adds changed the "
                             "logits")
    walls = {form: [] for form in forms}
    for form in ("ref", "eager", "fused", "fused", "eager", "ref"):
        walls[form].append(run(form)[0])
    kernels = {}
    for form, name in forms.items():
        _, by_name, launched, lost = _profiled(
            lambda: run(form), f"decode step, 8 slots, {name}")
        per_step = launched["rmsnorm"] / steps
        wall = sum(walls[form]) / 2
        if by_name and not lost:
            busy = sum(us for _, us in by_name.values()) / 1e3 / steps
            n = sum(c for c, _ in by_name.values()) // steps
            kernels[form] = n
            norm_us = sum(us for k, (_, us) in by_name.items()
                          if k.startswith("rmsnorm")) / steps
            adds = by_name.get(TORCH_ADD, (0, 0.0))[0] / steps
            dev = (f"device_ms={busy:.3f} kernels_per_step={n} "
                   f"torch_add_kernels_per_step={adds:g} "
                   f"rmsnorm_kernel_ms_per_step={norm_us / 1e3:.4f}")
        else:
            dev = f"device time not measured ({_unmeasured(lost)})"
        print(f"[profile] decode step, 8 slots, bf16 pages, {name}: "
              f"wall_ms={wall:.3f} (profiler off, mean of 2; turns "
              f"{json.dumps(walls)}) {dev} rmsnorm_launches_per_step="
              f"{per_step:g}")
        want = 2 * cfg.n_layers + 1 if form != "ref" else 0
        if per_step != want:
            raise AssertionError(f"decode step ({name}): {per_step} rmsnorm "
                                 f"launches a step, expected {want}")
    if ("eager" in kernels and "fused" in kernels
            and kernels["eager"] - kernels["fused"] != 2 * cfg.n_layers):
        raise AssertionError(f"decode step: {kernels['eager']} kernels a "
                             f"step with eager adds, {kernels['fused']} "
                             f"fused: expected {2 * cfg.n_layers} fewer")


# The ops wrappers' route counters and the kernel launch counters they
# must equal on a path (every ``.ref`` counter reads 0 there).
ROUTES = {"ops.matmul": "gama_gemm", "ops.decode": "flash_decode",
          "ops.decode_paged": "flash_paged_decode",
          "ops.wkv_state": "wkv6_state",
          "ops.selective_scan": "selective_scan"}


def check_routes(label, metrics, counts):
    """The route counters of a run's metrics snapshot: every ``ops.*.ref``
    0 and each ``.kernel`` equal to its kernel's launches in ``counts``.
    Returns them."""
    routes = {name: metrics["counters"].get(name, 0.0)
              for op in ROUTES for name in (f"{op}.kernel", f"{op}.ref")}
    bad = {op: [routes[f"{op}.kernel"], routes[f"{op}.ref"], counts[k]]
           for op, k in ROUTES.items()
           if routes[f"{op}.ref"] or routes[f"{op}.kernel"] != counts[k]}
    if bad:
        raise AssertionError(f"{label}: route counters [kernel, ref] and "
                             f"launches disagree: {json.dumps(bad)}")
    return routes


def replay(cfg, params, trace, scfg, label, verify=True, warm=True):
    """One path of the main run: a warm-up replay (``warm``; without it the
    engine is cold, as a prefix cache must be to count its first hits),
    then the measured replay with every launch count, the metrics registry
    and the tracer set to 0 just before and read just after, its outputs
    checked, the route counters held to the launch counts (no ``.ref``
    route taken), and (``verify``) ``--verify``'s bit-identity check
    against a one-shot engine.  A trace with ``arrival_s`` replays on the
    wall clock.  Returns the measured replay's launch counts
    (``flash_attention`` launches at q_offset > 0 under
    ``"flash_attention@q_offset>0"``), its report (the registry's snapshot
    under ``"metrics"``) and the closed engine."""
    engine = ServeEngine(cfg, params, scfg)
    bundle = obs.get_obs()
    try:
        if warm:
            S.run_trace(engine, trace, log=None)     # warm-up replay
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        fa_mod.offset_launches = 0
        bundle.registry.reset_values()
        bundle.tracer.clear()
        rep = S.run_trace(engine, trace, log=None)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        offset = fa_mod.offset_launches
        rep["metrics"] = bundle.registry.snapshot()
    finally:
        engine.close()
    routes = check_routes(label, rep["metrics"], counts)
    peak = torch.cuda.max_memory_allocated()
    if len(rep["results"]) != len(trace):
        raise AssertionError(f"{label}: {len(rep['results'])}/{len(trace)} "
                             f"requests completed")
    for tid, toks in rep["results"].items():
        t = next(x for x in trace if x["id"] == tid)
        if toks.shape != (t["max_new"],) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label} request {tid}: bad tokens {toks}")
    paged = f" kv_mode={engine.kv_mode}"
    if engine.quant_stats is not None:
        paged += (" int8_weights=" + json.dumps(engine.quant_stats)
                  .replace(" ", ""))
    if engine.kv_mode == "paged":
        paged += (f" page_size={scfg.page_size} kv_dtype="
                 f"{scfg.kv_dtype or cfg.cache_dtype} "
                 f"pool_pages={engine.pool.num_pages}"
                 f" preemptions={rep['preemptions']} pages_hwm="
                 f"{rep['pages_hwm']} "
                 f"pages_reclaimed={rep['pages_reclaimed']}")
    if engine.prefill_chunk:
        paged += (f" prefill_chunk={engine.prefill_chunk} token_budget="
                  f"{scfg.token_budget} prefill_chunks={rep['prefill_chunks']}"
                  f" flash_attention_at_q_offset>0={offset}")
    if engine.prefix is not None:
        paged += (f" prefix_hit_rate={rep['prefix_hit_rate']} "
                  f"prefix_hit_tokens={rep['prefix_hit_tokens']} "
                  f"cow_copies={rep['cow_copies']} pages_resident="
                  f"{engine.pool.pages_resident}")
    print(f"[serve] {label}: arch={cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} dtype={cfg.compute_dtype} kv={scfg.kv} slots="
          f"{scfg.batch_slots} max_len={scfg.max_len}{paged} "
          f"requests={len(rep['results'])} tokens={rep['tokens']} "
          f"wall_s={rep['wall_s']:.4f} tok_s={rep['tok_s']:.2f} "
          f"itl_p50_ms={rep['p50_ms']:.3f} itl_p99_ms={rep['p99_ms']:.3f} "
          f"ttft_p50_ms={rep['ttft_p50_ms']:.3f} "
          f"ttft_p99_ms={rep['ttft_p99_ms']:.3f} "
          f"starved_steps={rep['starved_steps']} "
          f"prefill_ms={rep['prefill_ms']:.3f} "
          f"decode_ms={rep['decode_ms']:.3f} "
          f"decode_steps={rep['decode_steps']} "
          f"shared_steps={rep['shared_steps']} "
          f"bubble_fraction={rep['bubble_fraction']:.4f} "
          f"slo_breaches={rep['slo_breaches']} "
          f"kv_bytes_high_water={rep['kv_bytes_hwm']} "
          f"kv_bytes_reserved={rep['kv_bytes_reserved']} "
          f"max_memory_allocated={peak}")
    print(f"[serve] {label}: launches {json.dumps(counts)} routes "
          f"{json.dumps(routes)}")
    # Every attention path runs the GEMM, prefill attention and the norms;
    # decode goes through the dense kernel on the dense cache and the paged
    # one on the pool; a chunked path runs attention at q_offset > 0.  An
    # RWKV path runs the GEMM and the state-carrying wkv6 (prefill and
    # decode), and no attention.
    if any(spec.mixer == "rwkv" for spec in cfg.pattern):
        must = ["gama_gemm", "wkv6_state", "layernorm"]
        if any(counts[n] for n in ATTENTION_KERNELS):
            raise AssertionError(f"{label}: an RWKV path launched attention "
                                 f"or rmsnorm kernels")
    else:
        must = ["gama_gemm", "flash_attention", "rmsnorm",
                "flash_paged_decode" if engine.kv_mode == "paged"
                else "flash_decode"]
    if any(spec.mixer == "mamba" for spec in cfg.pattern):
        must.append("selective_scan")
    if engine.quant_stats is not None:
        must.append("dequant")
    missing = [n for n in must if counts[n] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on this "
                             f"path: {missing}")
    if engine.kv_mode == "paged" and counts["flash_decode"]:
        raise AssertionError(f"{label}: the paged path launched the dense "
                             f"flash_decode {counts['flash_decode']} times")
    if engine.prefill_chunk and not offset:
        raise AssertionError(f"{label}: no flash_attention launch at "
                             f"q_offset > 0 on a chunked path")
    if verify:
        S._verify(cfg, params, trace, rep["results"], scfg)
    counts["flash_attention@q_offset>0"] = offset
    return counts, rep, engine


@contextlib.contextmanager
def op_mode(name, mode):
    """Route the models' ``ops.<name>`` calls through ``mode`` for a while
    (``"ref"``: the plain version, no kernel), whatever mode the caller
    names (``ops.add_rmsnorm`` under grad passes its own to
    ``ops.rmsnorm``)."""
    orig = getattr(ops, name)

    def routed(*args, **kwargs):
        return orig(*args, **{**kwargs, "mode": mode})
    setattr(ops, name, routed)
    try:
        yield
    finally:
        setattr(ops, name, orig)


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
        with op_mode("attention", mode):
            lg, _, _ = forward(params, {"tokens": toks}, cfg,
                               caches=caches, cache_pos=0)
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


def _device_by_name(prof, raw=False):
    """(count, device us) of every CUDA kernel a profile saw, by name;
    ``raw`` reads the profiler's device records directly, without building
    its event tree (minutes for a long replay's host events)."""
    cuda = torch.autograd.DeviceType.CUDA
    if raw:
        events = ((e.name(), e.duration_ns() / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda and not e.is_user_annotation())
    else:
        events = ((e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == cuda)
    by_name = {}
    for name, us in events:
        name = _clean_name(name)
        if _is_spin(name):
            continue
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    return by_name


def profile_replay(cfg, params, trace, scfg, label):
    """Where the long replay's device time goes: one more replay (after a
    warm-up) under ``torch.profiler``, its wall (host clock, synchronised)
    beside the device time by kind, and the prefill attention's launches
    and device time."""
    engine = ServeEngine(cfg, params, scfg)

    def traced():
        t0 = time.perf_counter()
        S.run_trace(engine, trace, log=None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    try:
        S.run_trace(engine, trace, log=None)
        wall_ms, by_name, launched, lost = _profiled(traced, label)
    finally:
        engine.close()
    for n in ("flash_attention", "flash_paged_decode"):
        if not launched[n]:
            raise AssertionError(f"{label}: the profiled replay launched no "
                                 f"{n}")
    if not by_name or lost:
        print(f"[profile] {label}: wall_ms={wall_ms:.3f}; device time not "
              f"measured ({_unmeasured(lost)})")
        return
    by_kind = _by_kind(by_name)
    busy = sum(us for _, us in by_name.values()) / 1e3
    print(f"[profile] {label} replay (traced): wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy:.3f} device_idle_share="
          f"{1 - busy / wall_ms:.3f} kernels="
          f"{sum(n for n, _ in by_name.values())}")
    for kind, (n, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        print(f"[profile]   by kind: {kind}: {n} launches, {us / 1e3:.3f} ms")
    for name, (n, us) in by_name.items():
        if name.startswith("flash_attention"):
            print(f"[profile]   prefill attention {name}: {n} launches, "
                  f"{us / 1e3:.3f} ms, {us / n:.2f} us each")
        if name.startswith("paged_decode"):
            print(f"[profile]   flash_paged_decode {name}: {n} launches, "
                  f"{us / 1e3:.3f} ms, {us / n:.2f} us each")


def smoke_serve_phase(cfg, trace, max_len):
    """The SMOKE config (f32, heads of 16) on the card: smoke6 replayed on
    dense KV, on f32 pages of 16 and on int8 pages, each through
    ``replay`` (launch counts per path, ``--verify``'s check); an SLO trip;
    then the serve launcher itself with its defaults (SMOKE, a synthetic
    trace, the card), dense and paged, shared16 with the prefix cache,
    smoke6 chunked and bursty24 on the wall clock, chunked, all under
    ``--verify``, and a Pareto trace dumped and read back.  Returns the
    replays' launch counts."""
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
        counts, _, _ = replay(cfg, params, trace, scfg, label)
        for n in total:
            total[n] += counts[n]
    slo_trip(cfg, params, trace, max_len)
    for argv in (["--verify"],
                 ["--kv", "paged", "--page_size", "16", "--verify"],
                 ["--trace", "shared16", "--kv", "paged", "--page_size", "16",
                  "--prefix-cache", "--verify"],
                 ["--trace", "smoke6", "--prefill-chunk", "16",
                  "--token-budget", "12", "--verify"],
                 ["--trace", "bursty24", "--kv", "paged", "--page_size", "16",
                  "--prefill-chunk", "16", "--verify"]):
        argv = ["--arch", "smollm_360m"] + argv
        K.reset_launch_counts()
        S.main(argv)                 # raises unless it prints "verify OK"
        torch.cuda.synchronize()
        counts = K.launch_counts()
        print(f"[serve] launcher {' '.join(argv)}: launches "
              f"{json.dumps(counts)}")
        decode = "flash_paged_decode" if "paged" in argv else "flash_decode"
        missing = [n for n in ("gama_gemm", "flash_attention", "rmsnorm",
                               decode) if counts[n] == 0]
        if missing:
            raise AssertionError(f"launcher {argv}: kernels never launched: "
                                 f"{missing}")
    launcher_dump_trace(cfg)
    del params
    return total


def slo_trip(cfg, params, trace, max_len):
    """An impossible ITL target (1e-6 ms) armed on a smoke6 replay: the
    SLO monitor must fire and its first breach trip the flight recorder,
    which writes its file with ``reason == "slo_breach"``."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slo_")
    engine = ServeEngine(cfg, params, ServeConfig(batch_slots=3,
                                                  max_len=max_len))
    try:
        engine.slo.set_targets(itl_ms=1e-6)
        engine.flight.path = os.path.join(tmp, "flight.json")
        rep = S.run_trace(engine, trace, log=None)
        with open(engine.flight.path) as f:
            doc = json.load(f)
        breaches = engine.slo.breaches("itl")
    finally:
        engine.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[serve] SLO trip (SMOKE smoke6, itl target 1e-6 ms): "
          f"itl_breaches={breaches} slo_breaches={rep['slo_breaches']} "
          f"flight reason={doc['reason']} trips={len(doc['trips'])} "
          f"steps={len(doc['steps'])} requests={len(doc['requests'])}")
    if not breaches or doc["reason"] != "slo_breach" or not doc["trips"]:
        raise AssertionError("an impossible ITL target did not trip the "
                             "flight recorder")


def launcher_dump_trace(cfg):
    """``--arrivals pareto --rate 16 --dump-trace``: the launcher replays
    a synthesized wall-clock trace and writes it, and ``load_trace`` reads
    back the same requests (ids, arrivals, sizes and prompt tokens)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dump_")
    path = os.path.join(tmp, "pareto.jsonl")
    try:
        S.main(["--arch", "smollm_360m", "--arrivals", "pareto", "--rate",
                "16", "--dump-trace", path])
        back = S.load_trace(path, cfg.vocab_size)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = S.bursty_trace(8, 16, 24, "pareto", 16.0, cfg.vocab_size)
    same = [(b["id"], b["arrival_s"], b["max_new"]) == (
        w["id"], w["arrival_s"], w["max_new"]) and
        b["prompt"].tolist() == w["prompt"].tolist()
        for b, w in zip(back, want)]
    print(f"[serve] launcher --arrivals pareto --rate 16 --dump-trace: "
          f"{len(back)} requests read back, equal={all(same)}, arrival_s "
          f"{[b['arrival_s'] for b in back]}")
    if len(back) != len(want) or not all(same):
        raise AssertionError("the dumped trace does not read back")


def same_streams(label, rep, want, want_label):
    """Every stream of ``rep`` equal to ``want``'s, token for token."""
    bad = sorted(tid for tid, toks in want["results"].items()
                 if tid not in rep["results"]
                 or rep["results"][tid].tolist() != toks.tolist())
    if bad or set(rep["results"]) != set(want["results"]):
        raise AssertionError(f"{label}: streams {bad} differ from "
                             f"{want_label}")
    print(f"[serve] {label}: all {len(want['results'])} streams equal "
          f"{want_label} token for token")


def latency_in_turns(cfg, params, trace, configs, order):
    """Host-clock latency of replays that differ in one option, taken in
    turns in one process (a replay's wall moves by tens of percent from
    one replay to the next on the same card): one warm engine per config,
    then measured replays in ``order``.  Prints each config's values in
    the order taken and their mean."""
    engines = {name: ServeEngine(cfg, params, scfg)
               for name, scfg in configs.items()}
    reps = {name: [] for name in configs}
    try:
        for eng in engines.values():
            S.run_trace(eng, trace, log=None)
        for name in order:
            torch.cuda.synchronize()
            reps[name].append(S.run_trace(engines[name], trace, log=None))
    finally:
        for eng in engines.values():
            eng.close()
    keys = ("ttft_p50_ms", "ttft_p99_ms", "p50_ms", "p99_ms",
            "starved_steps", "prefill_ms", "decode_ms", "wall_s")
    print(f"[serve] in turns {' '.join(order)}: {trace[0]['prompt'].size}"
          f"-token prompts, {len(trace)} requests")
    for name, rs in reps.items():
        cols = " ".join(
            f"{k}={sum(r[k] for r in rs) / len(rs):.3f} "
            f"{[round(r[k], 3) for r in rs]}" for k in keys)
        print(f"[serve] in turns {name}: {cols}")


def chunked_serve_phase(cfg, params, long8, mono):
    """Chunked prefill and the prefix cache at full width, SmolLM-360M's
    (at ``SERVE_LAYERS`` layers) on the kernels.  (a) The 8 x 448 trace on bf16 pages of 16, in chunks
    of 128 under a budget of 8 decode tokens plus two chunks, and
    unbudgeted: every stream equal to the monolithic replay ``mono``, 32
    chunks, attention at q_offset > 0; then the three replayed in turns
    for their latency.  (b) The same on dense KV and (c) on int8 pages,
    each against its own monolithic replay.  (d) shared16 on 4 slots
    with the prefix cache off and on, bf16 and int8 pages, cold engines:
    cached streams equal uncached ones, and the hit rate and the live page
    high-waters equal the JAX engine's.  Returns the replays' launch
    counts."""
    total = {n: 0 for n in SERVE_KERNELS}

    def run(label, trace, scfg, **kw):
        counts, rep, eng = replay(cfg, params, trace, scfg, label, **kw)
        for n in total:
            total[n] += counts[n]
        return rep, eng

    paged = dict(kv="paged", page_size=16)
    long_cfg = dict(batch_slots=LONG_REQS, max_len=LONG_LEN)
    chunks = LONG_REQS * -(-LONG_PROMPT // CHUNK)
    mono_label = "paged-bf16 synth 8x448+32"
    for tag, kw in ((f"budget={CHUNK_BUDGET}", dict(token_budget=CHUNK_BUDGET)),
                    ("unbudgeted", {})):
        label = f"{mono_label} chunk={CHUNK} {tag}"
        rep, _ = run(label, long8, ServeConfig(
            **long_cfg, **paged, prefill_chunk=CHUNK, **kw), verify=False)
        if rep["prefill_chunks"] != chunks:
            raise AssertionError(f"{label}: {rep['prefill_chunks']} chunks, "
                                 f"expected {chunks}")
        same_streams(label, rep, mono, "the monolithic replay")
    latency_in_turns(cfg, params, long8, {
        "monolithic": ServeConfig(**long_cfg, **paged),
        "budget": ServeConfig(**long_cfg, **paged, prefill_chunk=CHUNK,
                              token_budget=CHUNK_BUDGET),
        "unbudgeted": ServeConfig(**long_cfg, **paged, prefill_chunk=CHUNK),
    }, ("monolithic", "budget", "unbudgeted", "unbudgeted", "budget",
        "monolithic"))
    for label, kw in (("dense synth 8x448+32", dict(kv="dense")),
                      ("paged-int8 synth 8x448+32",
                       dict(kv_dtype="int8", **paged))):
        whole, _ = run(label, long8, ServeConfig(**long_cfg, **kw))
        rep, _ = run(f"{label} chunk={CHUNK}", long8, ServeConfig(
            **long_cfg, prefill_chunk=CHUNK, **kw), verify=False)
        if rep["prefill_chunks"] != chunks:
            raise AssertionError(f"{label}: {rep['prefill_chunks']} chunks")
        same_streams(f"{label} chunk={CHUNK}", rep, whole,
                     "its monolithic replay")
    shared16 = S.load_trace(S.resolve_trace_path("shared16"), cfg.vocab_size)
    for kv_dtype in (None, "int8"):
        reps = {}
        for cached in (False, True):
            label = (f"paged-{kv_dtype or 'bf16'} shared16 prefix_cache="
                     f"{cached}")
            rep, eng = run(label, shared16, ServeConfig(
                batch_slots=4, max_len=128, kv_dtype=kv_dtype,
                prefix_cache=cached, **paged), verify=not cached, warm=False)
            if eng.pool.pages_in_use != 0:
                raise AssertionError(f"{label}: {eng.pool.pages_in_use} "
                                     f"pages still in use")
            eng.pool.check()
            if eng.pool.high_water != SHARED16_HWM[cached]:
                raise AssertionError(
                    f"{label}: live page high-water {eng.pool.high_water}, "
                    f"the JAX engine's is {SHARED16_HWM[cached]}")
            reps[cached] = rep
        if reps[True]["prefix_hit_rate"] != SHARED16_HIT_RATE:
            raise AssertionError(f"shared16: hit rate "
                                 f"{reps[True]['prefix_hit_rate']}, the JAX "
                                 f"engine's is {SHARED16_HIT_RATE}")
        same_streams(f"paged-{kv_dtype or 'bf16'} shared16 cached",
                     reps[True], reps[False], "the uncached replay")
        print(f"[serve] shared16 ({kv_dtype or 'bf16'} pages): prefix hit "
              f"rate {reps[True]['prefix_hit_rate']} and live page "
              f"high-water {SHARED16_HWM[True]} cached / "
              f"{SHARED16_HWM[False]} uncached, equal to the JAX engine's")
    return total


# bursty24 at full width: bf16 pages of 16, chunks of 32 under a budget of
# the 8 decoding slots plus two chunks; 128-token prompts + 12 new + 8.
BURSTY_SLOTS, BURSTY_CHUNK = 8, 32
BURSTY_BUDGET = BURSTY_SLOTS + 2 * BURSTY_CHUNK
# The series an instrumented replay's snapshot must hold.
ENGINE_SERIES = dict(
    required_counters=("serve.tokens_out", "sched.submitted",
                       "kvpool.pages_reclaimed", "prefix.lookup",
                       "ops.matmul.kernel", "ops.decode_paged.kernel"),
    required_gauges=("kvpool.pages_in_use", "serve.kv_tokens",
                     "serve.active_slots", "serve.bubble_fraction",
                     "serve.efficiency", "sched.queue_depth",
                     "prefix.hit_rate"),
    required_histograms=("serve.ttft_ms", "serve.inter_token_ms",
                         "step.device_ms", "step.bubble_ms"))


def obs_serve_phase(cfg, params, long8, quiet):
    """The observability layer at full width, SmolLM-360M's (at
    ``SERVE_LAYERS`` layers) on the kernels.  (a) bursty24 on the wall clock (speed 1: Pareto arrivals at
    12 req/s), chunked under a budget, every stream equal to its one-shot
    engine's.  (b) The 8 x 448 paged replay with the tracer on: the
    snapshot, trace and flight record written as ``--metrics-out``,
    ``--trace-out`` and ``--flight-out`` write them, validated, rendered by
    ``tools/obs_report.py``; the profiler's kernel table placing
    ``flash_paged_decode`` on the H100's roofline; every stream equal to
    ``quiet``, the same replay with the tracer off.  Returns the replays'
    launch counts."""
    total = {n: 0 for n in SERVE_KERNELS}
    bursty = S.load_trace(S.resolve_trace_path("bursty24"), cfg.vocab_size)
    label = (f"paged-bf16 bursty24 wall-clock chunk={BURSTY_CHUNK} "
             f"budget={BURSTY_BUDGET}")
    counts, rep, _ = replay(cfg, params, bursty, ServeConfig(
        batch_slots=BURSTY_SLOTS,
        max_len=max(len(t["prompt"]) + t["max_new"] for t in bursty) + 8,
        kv="paged", page_size=16, prefill_chunk=BURSTY_CHUNK,
        token_budget=BURSTY_BUDGET), label)
    for n in total:
        total[n] += counts[n]
    print(f"[serve] {label}: ttft_p50_ms={rep['ttft_p50_ms']:.3f} "
          f"ttft_p99_ms={rep['ttft_p99_ms']:.3f} itl_p50_ms="
          f"{rep['p50_ms']:.3f} itl_p99_ms={rep['p99_ms']:.3f} "
          f"bubble_fraction={rep['bubble_fraction']:.4f} starved_steps="
          f"{rep['starved_steps']} prefill_chunks={rep['prefill_chunks']}")

    bundle = obs.configure(registry=obs.Registry(),
                           tracer=obs.Tracer(enabled=True))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    files = {k: os.path.join(tmp, f"{k}.json")
             for k in ("metrics", "trace", "flight")}
    label = "paged-bf16 synth 8x448+32 traced"
    try:
        counts, rep, eng = replay(cfg, params, long8, ServeConfig(
            batch_slots=LONG_REQS, max_len=LONG_LEN, kv="paged",
            page_size=16), label, verify=False)
        for n in total:
            total[n] += counts[n]
        same_streams(label, rep, quiet, "the replay with the tracer off")
        bundle.registry.gauge(
            "serve.efficiency",
            "achieved decode throughput / analytic peak").set(
                obs.efficiency.serve_efficiency(cfg, rep["tok_s"], "cuda"))
        run = {k: v for k, v in rep.items()
               if k not in ("results", "metrics")}
        run.update(arch=cfg.name, kv_mode="paged", prefill_chunk=0,
                   device=torch.cuda.get_device_name(0))
        obs.write_metrics(files["metrics"], bundle.registry,
                          extra={"run": run}, **ENGINE_SERIES)
        n_events = bundle.tracer.write(files["trace"])
        with open(files["trace"]) as f:
            obs.validate_chrome_trace(json.load(f))
        flight = eng.flight.write(files["flight"], reason="end_of_run")
        report = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "obs_report.py"),
             "--metrics", files["metrics"], "--trace", files["trace"],
             "--flight", files["flight"]], capture_output=True, text=True,
            timeout=120)
    finally:
        obs.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    if report.returncode != 0:
        raise AssertionError(f"tools/obs_report.py exited "
                             f"{report.returncode}: {report.stderr}")
    table = {k.name: k for k in eng.profiler.kernel_table()}
    row = table.get("flash_paged_decode")
    ridge = obs.ridge_intensity(cfg.compute_dtype, "cuda")
    if (row is None or eng.profiler.backend != "cuda"
            or row.ridge != ridge):
        raise AssertionError(f"{label}: no flash_paged_decode row on the "
                             f"H100 roofline: {list(table)}")
    print(f"[serve] {label}: {n_events} trace events, flight steps="
          f"{len(flight['steps'])} requests={len(flight['requests'])}; "
          f"wall_s={rep['wall_s']:.4f} traced vs {quiet['wall_s']:.4f} "
          f"untraced; flash_paged_decode on the H100 roofline: "
          f"{json.dumps(row.as_dict())}; tools/obs_report.py exit 0:")
    for line in report.stdout.strip().splitlines():
        print(f"[obs_report] {line}")
    return total


def attribution_vs_profiler(cfg, params, steps=5, turn=3):
    """The engine's step attribution beside ``torch.profiler`` for the
    8 x 448 replay's decode step (8 slots at 449-487 keys on bf16 pages of
    16), and the metrics registry's cost.  One engine on an enabled
    registry and one on ``Registry(enabled=False)`` each hold 8 decoding
    requests.  ``steps`` decode steps of the first give the engine's
    ``device_ms`` (its section probes: CUDA event spans), ``bubble_ms``
    and ``bubble_fraction``; then both engines' walls, ``turn`` steps a
    turn, in turns on, off, off, on, on, off, off, on; then ``steps``
    more steps under the profiler, whose device-busy time and idle share
    stand beside the engine's own figures for the same steps.  Last, the
    host time of one route-counter tick, on and off, beside the ticks a
    step.  The bubble is host time outside the probed sections, the idle
    share is device time without a kernel: two metrics, printed under
    their own names."""
    prompts = S.synth_trace(LONG_REQS, LONG_PROMPT, 1, 0, cfg.vocab_size)
    max_new = LONG_LEN - LONG_PROMPT
    regs = {"on": obs.Registry(), "off": obs.Registry(enabled=False)}
    engines = {}
    try:
        for name, reg in regs.items():
            obs.configure(registry=reg)
            eng = engines[name] = ServeEngine(cfg, params, ServeConfig(
                batch_slots=LONG_REQS, max_len=LONG_LEN, kv="paged",
                page_size=16))
            for t in prompts:
                eng.submit(t["prompt"], max_new)
            for _ in range(3):                    # admit all 8, warm up
                eng.step()

        def run(name, n):
            obs.configure(registry=regs[name])
            eng = engines[name]
            profs = []
            t0 = time.perf_counter()
            for _ in range(n):
                ev = eng.step()
                if len(ev["decoded"]) != LONG_REQS:
                    raise AssertionError(f"decode step of {len(ev['decoded'])}"
                                         f" slots, expected {LONG_REQS}")
                profs.append(ev["profile"])
            return (time.perf_counter() - t0) * 1e3 / n, profs

        def attribution(profs):
            dev = sum(p["device_ms"] for p in profs) / len(profs)
            bub = sum(p["bubble_ms"] for p in profs) / len(profs)
            return (f"device_ms={dev:.3f} bubble_ms={bub:.3f} "
                    f"bubble_fraction={bub / (dev + bub):.4f}")
        counters = regs["on"].counters
        before = sum(counters[f"{op}.kernel"].value
                     for op in ("ops.matmul", "ops.decode_paged"))
        wall, profs = run("on", steps)
        ticks = (sum(counters[f"{op}.kernel"].value
                     for op in ("ops.matmul", "ops.decode_paged"))
                 - before) / steps
        walls = {"on": [], "off": []}
        for name in ("on", "off", "off", "on") * 2:
            walls[name].append(run(name, turn)[0])
        (traced, tprofs), by_name, launched, lost = _profiled(
            lambda: run("on", steps), "decode step, 8 slots, engine")
        if by_name and not lost:
            busy = sum(us for _, us in by_name.values()) / 1e3 / steps
            prof_line = (f"device_busy_ms={busy:.3f} device_idle_share="
                         f"{1 - busy / traced:.4f}")
        else:
            prof_line = f"device time not measured ({_unmeasured(lost)})"
        tick_us = {}
        for name in ("on", "off"):
            obs.configure(registry=regs[name])
            t0 = time.perf_counter()
            for _ in range(100000):
                ops._count("ops.matmul.kernel")
            tick_us[name] = (time.perf_counter() - t0) * 1e6 / 100000
    finally:
        obs.reset()
        for eng in engines.values():
            eng.close()
    print(f"[attribution] decode step, {LONG_REQS} slots, bf16 pages, "
          f"{cfg.name}: engine wall_ms={wall:.3f} {attribution(profs)} "
          f"(mean of {steps} steps, profiler off); same engine under "
          f"torch.profiler: wall_ms={traced:.3f} engine "
          f"{attribution(tprofs)} | profiler {prof_line}")
    on, off = (sum(walls[k]) / len(walls[k]) for k in ("on", "off"))
    print(f"[attribution] registry on vs Registry(enabled=False), wall_ms "
          f"per decode step ({turn} steps a turn) in turns on, off, off, on "
          f"x2: {json.dumps(walls)} mean on={on:.4f} off={off:.4f} (on - "
          f"off = {(on - off) * 1e3:.1f} us a step); one route-counter tick "
          f"{tick_us['on']:.4f} us on, {tick_us['off']:.4f} us off, "
          f"{ticks:g} ticks a step")


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
    reps = {}
    for label, trace, scfg in paths:
        counts, rep, _ = replay(cfg, params, trace, scfg, label)
        if "pool_pages=4" in label and rep["preemptions"] < 1:
            raise AssertionError(f"{label}: no preemption in a 4-page pool")
        for n in total:
            total[n] += counts[n]
        reps[label] = rep
    for n, c in chunked_serve_phase(cfg, params, long8,
                                    reps[paths[-1][0]]).items():
        total[n] += c
    for n, c in obs_serve_phase(cfg, params, long8,
                                reps[paths[-1][0]]).items():
        total[n] += c

    kern, ref_lg, per_prefill, per_decode = logits_kernel_vs_ref(
        cfg, params, smoke6[0]["prompt"], max_len)
    if not torch.isfinite(kern).all():
        raise AssertionError("non-finite logits")
    diff = (kern - ref_lg).abs().max().item()
    same = (kern.argmax(-1) == ref_lg.argmax(-1)).float().mean().item()
    # Each GEMM path rounds its f32 sum to bf16 (<= 1 ulp apart); the
    # differences compound over the layers of random weights.
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
    profile_decode_norms(cfg, params)
    attribution_vs_profiler(cfg, params)
    profile_replay(cfg, params, long8, paths[-1][2], paths[-1][0])
    return total


# ---------------------------------------------------------------------------
# 4b. Tune: the autotuner's measured plans on the serve path
# ---------------------------------------------------------------------------


def _plan_str(cls, config):
    return "(" + ",".join(str(x) for x in cls.from_json(config).plan) + ")"


def _report_tune(op, label, res, cls=None):
    """Print one tune: the space, the number measured, the analytic plan
    (the prior's first candidate) against the winner in ms, and whether
    every measured candidate gave the analytic plan's bits; raise unless
    all did.  Returns (analytic us, winner us)."""
    trials = res.trials
    if res.best is None or not trials:
        raise AssertionError(f"tune {op} {label}: no winner {trials}")
    bad = [t for t in trials if not (t.get("ok") and t.get("bits_equal"))]
    if bad:
        raise AssertionError(f"tune {op} {label}: candidates failed the "
                             f"bits/tolerance gate: {json.dumps(bad)}")
    first, best = trials[0]["us"], res.best_us
    show = ((lambda c: _plan_str(cls, c)) if cls is not None
            else (lambda c: json.dumps(c, sort_keys=True)))
    print(f"[tune] {op} {label}: space {res.space_size}, measured "
          f"{len(trials)}, analytic {show(trials[0]['config'])} "
          f"{first / 1e3:.5f} ms, winner {show(res.best)} {best / 1e3:.5f} "
          f"ms (x{best / first:.3f}), bits equal to the analytic plan in "
          f"{len(trials)}/{len(trials)}, max_err {max(t['max_err'] for t in trials):.3e}")
    return first, best


def _tunes(cfg):
    """The phase's kernel tunes as (op, label, thunk, candidate class):
    gemm at SmolLM-360M FULL's decode (M = 8) and prefill (M = 488) weight
    GEMMs, attention at the 8 x 448 prefill (Sq 488 against the 496-row
    scratch cache, 15/5 heads of 64) and Qwen3-8B's 512 x 512 at D = 128
    (32/8 heads), decode at the replay's decode shape, wkv at the training
    shape."""
    out = []
    for m in (8, LONG_LEN):
        for k, n in sorted({(k, n) for k, n, _ in
                            cfg.gemm_shapes().values()}):
            out.append(("gemm", f"M={m} K={k} N={n}", functools.partial(
                dispatch.tune_gemm, m, k, n, torch.bfloat16),
                GemmCandidate))
    cache_rows = pages_for(LONG_LEN, 16) * 16
    qwen = C.get("qwen3_8b")
    for sq, sk, d, hq, hkv in ((LONG_LEN, cache_rows, 64, cfg.n_heads,
                                cfg.n_kv_heads),
                               (512, 512, qwen.d_head, qwen.n_heads,
                                qwen.n_kv_heads)):
        out.append(("attention", f"Sq={sq} Sk={sk} D={d} heads {hq}/{hkv}",
                    functools.partial(dispatch.tune_attention, sq, sk, d,
                                      torch.bfloat16, hq=hq, hkv=hkv),
                    AttentionCandidate))
    out.append(("decode", f"B={LONG_REQS} heads {cfg.n_heads}/"
                f"{cfg.n_kv_heads} Sk={cache_rows} D={cfg.d_head}",
                functools.partial(dispatch.tune_decode, cache_rows,
                                  cfg.d_head, torch.bfloat16, b=LONG_REQS,
                                  hq=cfg.n_heads, hkv=cfg.n_kv_heads), None))
    out.append(("wkv", "B=8 H=40 T=64 N=64", functools.partial(
        dispatch.tune_wkv, 64, 64, torch.bfloat16, b=8, h=40), None))
    return out


def _gemm_replay(engine, trace, label):
    """One measured replay under ``torch.profiler`` (CUDA activity): its
    results, launch counts and ``gama_gemm`` device ms; every ``ops.*.ref``
    route counter 0 and each ``.kernel`` counter its launches."""
    bundle = obs.get_obs()

    def run():
        bundle.registry.reset_values()     # each profiler attempt afresh
        return S.run_trace(engine, trace, log=None)

    rep, by_name, launched, lost = _profiled(run, label, host=False)
    check_routes(label, bundle.registry.snapshot(), launched)
    if not by_name or lost:
        raise AssertionError(f"{label}: gama_gemm device time not measured "
                             f"({_unmeasured(lost)})")
    n, us = _by_kind(by_name)["GEMM (gama_gemm)"]
    if n != launched["gama_gemm"]:
        raise AssertionError(f"{label}: profiled {n} gama_gemm kernels of "
                             f"{launched['gama_gemm']} launched")
    return rep, launched, us / 1e3


def tune_phase(cfg):
    """The autotuner on the card against a cache in a temporary directory
    (nothing under ``~/.cache``): gemm, attention, decode and wkv tuned at
    the served shapes (every measured candidate's output ``torch.equal``
    to the analytic plan's, the winner against the analytic plan), the
    same tunes again as cache hits, ``tune_serve`` on ``cfg`` (SmolLM-360M
    at full width and ``SERVE_LAYERS`` layers),
    the 8 x 448 replay with the tuned cache in turns with the untuned one
    (streams equal token for token, ``gama_gemm`` device time of each,
    every ``ops.*.ref`` 0), the serve launcher with ``--batch_slots 0 --kv
    paged --page_size 0 --prefill-chunk -1 --verify``, and the host time
    of a dispatch memo hit.  Returns the replays' launch counts."""
    set_gemm_mode("kernel")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    tuned_path = os.path.join(tmp, "tuned.json")
    untuned_path = os.path.join(tmp, "untuned.json")    # never written
    total = {n: 0 for n in SERVE_KERNELS}
    try:
        dispatch.set_cache_path(tuned_path)
        tunes = _tunes(cfg)
        t0 = time.perf_counter()
        for op, label, tune, cls in tunes:
            _report_tune(op, label, tune(keep=8, reps=5), cls)
        print(f"[tune] {len(tunes)} tunes in "
              f"{time.perf_counter() - t0:.1f} s -> {tuned_path}")
        hits = [tune().cache_hit for _, _, tune, _ in tunes]
        print(f"[tune] the same {len(tunes)} tunes again: "
              f"{sum(hits)} cache hit")
        if not all(hits):
            raise AssertionError("a second tune measured again instead of a "
                                 "cache hit")

        t0 = time.perf_counter()
        res = dispatch.tune_serve(cfg, max_len=64, keep=3)
        for t in res.trials:
            if not t.get("ok"):
                raise AssertionError(f"tune_serve: a candidate did not "
                                     f"finish its trace: {json.dumps(t)}")
            print(f"[tune] serve candidate {json.dumps(t['config'])}: "
                  f"{t['us']:.1f} us a token")
        print(f"[tune] serve {cfg.name} FULL width, {cfg.n_layers} layers, "
              f"max_len=64 keep=3: space "
              f"{res.space_size}, winner {json.dumps(res.best)} "
              f"{res.best_us:.1f} us a token "
              f"({time.perf_counter() - t0:.1f} s)")
        if not dispatch.tune_serve(cfg, max_len=64, keep=3).cache_hit:
            raise AssertionError("a second tune_serve was no cache hit")
        t0 = time.perf_counter()

        params = init_params(cfg, seed=1, device=DEV)
        long8 = S.synth_trace(LONG_REQS, LONG_PROMPT, LONG_NEW, 3,
                              cfg.vocab_size, seed=0)
        engine = ServeEngine(cfg, params, ServeConfig(
            batch_slots=LONG_REQS, max_len=LONG_LEN, kv="paged",
            page_size=16))
        runs = {"untuned": [], "tuned": []}
        try:
            dispatch.set_cache_path(untuned_path)
            S.run_trace(engine, long8, log=None)          # warm-up
            for name in ("untuned", "tuned", "tuned", "untuned"):
                dispatch.set_cache_path(tuned_path if name == "tuned"
                                        else untuned_path)
                hits = dispatch.warm_gemm_shapes(
                    engine._all_gemm_shapes(), cfg.cdtype, 0)
                label = f"paged-bf16 synth 8x448+32 {name}"
                rep, launched, ms = _gemm_replay(engine, long8, label)
                runs[name].append((rep, ms))
                for n in total:
                    total[n] += launched[n]
                print(f"[tune] {label}: gama_gemm device_ms={ms:.3f} "
                      f"({launched['gama_gemm']} launches, plans from the "
                      f"cache for {hits} of the engine's GEMM sites) "
                      f"wall_s={rep['wall_s']:.4f}")
        finally:
            engine.close()
        want = runs["untuned"][0][0]
        for name, rs in runs.items():
            for i, (rep, _) in enumerate(rs):
                same_streams(f"8x448 {name} replay {i}", rep, want,
                             "the first untuned replay")
        print(f"[tune] 8x448 gama_gemm device ms in turns (untuned, tuned, "
              f"tuned, untuned): untuned "
              f"{[round(ms, 3) for _, ms in runs['untuned']]} tuned "
              f"{[round(ms, 3) for _, ms in runs['tuned']]} "
              f"({time.perf_counter() - t0:.1f} s)")
        del params
        t0 = time.perf_counter()

        dispatch.set_cache_path(tuned_path)
        argv = ["--arch", "smollm_360m", "--full", "--prompt_len", "32",
                "--max_new", "24",
                "--batch_slots", "0", "--kv", "paged", "--page_size", "0",
                "--prefill-chunk", "-1", "--verify"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            S.main(argv)             # raises unless it prints "verify OK"
        text = out.getvalue()
        lines = [ln for ln in text.splitlines()
                 if "tuner-resolved" in ln or "verify OK" in ln
                 or "paged kv:" in ln or "tok/s" in ln]
        for ln in lines:
            print(f"[tune] launcher {' '.join(argv)}: {ln}")
        best = res.best
        want_line = (f"tuner-resolved: batch_slots={best['slots']} "
                     f"page_size={best['page_size'] or 32} prefill_chunk="
                     f"{best['prefill_chunk']}")
        if want_line not in text or "verify OK" not in text:
            raise AssertionError(f"launcher {argv}: expected '{want_line}' "
                                 f"and 'verify OK' in:\n{text}")
        print(f"[tune] launcher: {time.perf_counter() - t0:.1f} s")

        m, k, n = 8, cfg.d_model, cfg.d_ff
        dispatch.gemm_config(m, k, n, torch.bfloat16, 0)
        reps = 200000
        t0 = time.perf_counter()
        for _ in range(reps):
            dispatch.gemm_config(m, k, n, torch.bfloat16, 0)
        hit_us = (time.perf_counter() - t0) / reps * 1e6
        print(f"[tune] dispatch memo hit (gemm_config {m}x{k}x{n} bf16): "
              f"{hit_us:.4f} us of host time, mean of {reps}")
    finally:
        dispatch.reset()
        shutil.rmtree(tmp, ignore_errors=True)
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


# torch's elementwise add kernel (its functor named, the template cut).
TORCH_ADD = "torch add (elementwise)"


def _clean_name(name):
    if "Functor_add" in name:
        return TORCH_ADD
    return name.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("<")[0].split("(")[0][:70]


def _kernel_name(e):
    return _clean_name(e.name)


def _kind(name):
    low = name.lower()
    if "wkv6" in low:
        return name
    if low.startswith("gemm_"):      # csrc/gemm.cu's kernels
        return "GEMM (gama_gemm)"
    if low.startswith("rmsnorm"):
        return "rmsnorm (rmsnorm kernel)"
    if low.startswith("layernorm"):
        return "layernorm (layernorm kernel)"
    if low.startswith("dequant"):
        return "dequantize (dequant kernel)"
    if low.startswith("selective_scan"):
        return "selective scan (selective_scan kernel)"
    if low.startswith("flash_attention"):
        return "prefill attention (flash_attention)"
    if low.startswith("attn_bwd"):
        return "attention backward (flash_attention_bwd)"
    if low.startswith(("flash_decode", "paged_decode")):
        return "decode attention (flash_decode, flash_paged_decode)"
    if any(x in low for x in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "GEMM (torch.matmul)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "AdamW (torch._foreach_*)"
    if "reduce" in low or "norm" in low:
        return "reductions"
    return "elementwise and other torch"


def timed_steps(step_fn, params, opt, data, steps, want, tokens, label):
    """``steps`` training steps of ``step_fn`` on ``data``'s batches, the
    first a warm-up, each between CUDA events with the launch counts reset
    just before and read just after it: each step must launch exactly
    ``want`` and give a finite loss.  Returns (params, opt, the measured
    steps' ms, their launches summed, every step's loss)."""
    total = {n: 0 for n in want}
    step_ms, losses = [], []
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
        losses.append(loss)
        print(f"[train] {label} step {i}{' (warm-up)' if i == 0 else ''}: "
              f"loss={loss:.5f} grad_norm={float(m['grad_norm']):.5f} "
              f"lr={m['lr']:.3e} step_ms={ms:.3f} tok_s={tokens / ms * 1e3:.1f}"
              f" max_memory_allocated={torch.cuda.max_memory_allocated()} "
              f"launches={json.dumps({n: counts[n] for n in want})}")
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss at step {i}")
        bad = {n: counts[n] for n in want if counts[n] != want[n]}
        if bad:
            raise AssertionError(f"expected {json.dumps(want)} launches a "
                                 f"step, got {bad}")
        if i:
            step_ms.append(ms)
            for n in want:
                total[n] += counts[n]
    return params, opt, step_ms, total, losses


def profile_step(step_fn, params, opt, batch, label, mean_ms):
    """One more step under ``torch.profiler``: its device time by kernel
    and by kind, and the device's idle share against the traced wall and
    against ``mean_ms``, the measured steps' mean with the profiler off.
    Returns (params, opt)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _prime(PROFILE_MARGINS_S[0])
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_kind = {}, {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not _is_spin(_kernel_name(e))):
            name = _kernel_name(e)
            us = e.time_range.elapsed_us()
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + us)
            n, t = by_kind.get(_kind(name), (0, 0.0))
            by_kind[_kind(name)] = (n + 1, t + us)
    if not by_name:
        print(f"[profile] train step {label} wall_ms={wall_ms:.3f}; device "
              f"time not measured (the profiler saw no CUDA events)")
        return params, opt
    busy = sum(t for _, t in by_name.values()) / 1e3
    print(f"[profile] train step ({label}): traced "
          f"wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_idle_share={1 - busy / wall_ms:.3f} (traced); "
          f"against the measured steps' mean {mean_ms:.3f} ms "
          f"(profiler off) {1 - busy / mean_ms:.3f}; kernels="
          f"{sum(n for n, _ in by_name.values())}")
    for kind, (n, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        print(f"[profile]   by kind: {kind}: {n} launches, "
              f"{us / 1e3:.3f} ms ({us / 1e3 / busy:.3f} of busy)")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:15]:
        print(f"[profile]   {name}: {n} launches, {us / 1e3:.3f} ms")
    return params, opt


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
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} heads={cfg.d_model // cfg.rwkv.head_size}x"
          f"{cfg.rwkv.head_size} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"params={n_params} (f32) compute={cfg.compute_dtype} "
          f"global_batch=8 seq_len=64 remat=off gemm=torch.matmul")
    # Forward launches a step: each wkv kernel once a layer; layernorm
    # (LayerNorm's kernel forward; its backward is the plain expression's)
    # for ln0, two norms and the GroupNorm a layer, and the final norm.
    want = dict({n: cfg.n_layers for n in TRAIN_KERNELS},
                layernorm=3 * cfg.n_layers + 2)
    params, opt, step_ms, total, _ = timed_steps(
        step_fn, params, opt, data, steps, want, 8 * 64, cfg.name)
    params, opt = profile_step(step_fn, params, opt, data.batch_at(steps),
                               "rwkv6-3b FULL, 8x64 tokens",
                               sum(step_ms) / len(step_ms))
    del params, opt
    torch.cuda.empty_cache()
    return total


def _grads(cfg, params, batch, mode, scale=1.0, router=None,
           kernels=TRAIN_KERNELS):
    """Loss and the gradient of every leaf with the recurrence routed by
    ``router(mode, scale)`` (default ``wkv_mode``: ``ops.wkv`` in ``mode``
    with u scaled).  A ``ref`` run must launch none of ``kernels``: the
    counts may not move."""
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    before = K.launch_counts()
    with (router or wkv_mode)(mode, scale):
        loss, _ = loss_fn(params, batch, cfg, remat=False)
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    moved = {n: K.launch_counts()[n] - before[n] for n in kernels}
    if mode == "ref" and any(moved.values()):
        raise AssertionError(f"the plain run launched {kernels}: {moved}")
    return loss.item(), grads, moved


def _grad_diff(names, g_a, g_b):
    """Per leaf: max |a - b| over the largest |b| of that leaf."""
    return {n: (a - b_).abs().max().item() / max(b_.abs().max().item(), 1e-30)
            for n, a, b_ in zip(names, g_a, g_b)}


def _worst(rel, n=5):
    return json.dumps({k: float(f"{v:.3e}") for k, v in
                       sorted(rel.items(), key=lambda kv: -kv[1])[:n]})


def train_kernel_vs_plain():
    """RWKV-6 3B at FULL width and 2 layers: :func:`kernel_vs_plain` with
    the wkv6 kernels (``ops.wkv`` auto) against the plain recurrence
    (``ref``, torch autograd of the loop); the control scales u."""
    base = dataclasses.replace(C.get("rwkv6_3b"), n_layers=2)
    kernel_vs_plain(base, "rwkv6-3b width, 2 layers", wkv_mode, "u",
                    TRAIN_KERNELS, {"wkv6": 2, "wkv6_bwd": 2}, seed=3)


def kernel_vs_plain(base, label, router, knob, kernels, want, seed):
    """One step's loss and gradients of ``base`` at 8 x 64 tokens, with
    the recurrence's kernels (``router("auto")``) and with its plain version
    (``router("ref")``, torch autograd of the loop), same parameters and
    batch, twice:

    * f32 compute: the two differ only in the f32 summation order inside
      the recurrence.  Bounds: the loss within 1e-5, every leaf's gradient
      within 1e-4 of its largest element.  Control: the plain run with
      ``knob`` 1% off must break the gradient bound, so a wrong kernel
      would.
    * bf16 compute (the FULL config's): the recurrence's outputs round to
      bf16, and a last-bit difference before rounding flips a bf16 ulp
      (2**-8).  Control: the plain run with ``knob`` scaled by 1 + 1e-6, a
      change of the size of a summation-order difference, gives the
      rounding floor.  Bounds, as a witness that the step stays finite and
      close: the loss within 1e-2, every leaf within 5e-2 of its largest
      element.  The kernel run must launch ``want``."""
    params = init_params(base, seed=seed, device=DEV, dtype=torch.float32)
    names = [n for n, _ in _leaf_names(params)]
    batch = {k: torch.as_tensor(v, device=DEV)
             for k, v in _batches(base, 8, 64, seed=1).batch_at(0).items()}
    for compute, loss_tol, grad_tol, scale in (
            ("float32", 1e-5, 1e-4, 1.01), ("bfloat16", 1e-2, 5e-2, 1 + 1e-6)):
        cfg = dataclasses.replace(base, compute_dtype=compute)
        run = functools.partial(_grads, cfg, params, batch, router=router,
                                kernels=kernels)
        loss_k, g_k, counts = run("auto")
        loss_p, g_p, _ = run("ref")
        rel = _grad_diff(names, g_k, g_p)
        del g_k
        loss_c, g_c, _ = run("ref", scale)
        rel_c = _grad_diff(names, g_c, g_p)
        del g_c, g_p
        print(f"[train] kernel vs plain ({label}, 8x64 tokens, compute="
              f"{compute}): loss {loss_k:.7f} vs {loss_p:.7f} (|diff| "
              f"{abs(loss_k - loss_p):.3e}, bound {loss_tol:g}); gradient "
              f"max rel diff {max(rel.values()):.3e} over {len(rel)} leaves "
              f"(bound {grad_tol:g}), largest: {_worst(rel)}; launches "
              f"{json.dumps(counts)}")
        print(f"[train]   control, plain with {knob} x {scale!r} vs plain "
              f"({'must break the bound' if compute == 'float32' else 'the bf16 rounding floor'}): "
              f"loss |diff| {abs(loss_c - loss_p):.3e}, gradient max rel diff "
              f"{max(rel_c.values()):.3e}, largest: {_worst(rel_c)}")
        if counts != want:
            raise AssertionError(f"kernel path launched {counts}")
        if abs(loss_k - loss_p) > loss_tol or max(rel.values()) > grad_tol:
            raise AssertionError(f"kernel and plain training steps differ "
                                 f"({label}, {compute})")
        if compute == "float32" and max(rel_c.values()) <= grad_tol:
            raise AssertionError(f"the f32 bound does not catch {knob} 1% "
                                 f"off")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 5b. Train the attention decoders: flash_attention_bwd, then SmolLM-360M
# ---------------------------------------------------------------------------


def _attn_bwd_bound(b, hq, hkv, s, d, elt):
    """Bytes: q, o, dO and dQ (B Hq S D), k, v, dK and dV (B Hkv S D) once
    each, and lse; operations: 5 products of 2 D a (query, key) pair the
    causal mask keeps (S (S + 1) / 2 a head)."""
    nbytes = (4 * b * hq + 4 * b * hkv) * s * d * elt + 4 * b * hq * s
    return nbytes, 10.0 * d * b * hq * s * (s + 1) / 2


def check_attention_bwd(label, b, hq, hkv, s, d, dtype, seed, main=False):
    """flash_attention_bwd against ref.attention_bwd on the same q, k, v,
    dO and the forward kernel's o and lse, causal at q_offset 0.

    * f32: every gradient within 1e-4 of its largest element (sums in
      another order).
    * bf16: the kernel rounds P and dS to bf16 for the tensor cores and
      its outputs once.  The rounding floor, a control: the plain version
      from the f32 draws against the plain version from their bf16
      roundings, per output (what rounding the inputs alone moves).
      Bound: each output within 4 x its floor + half a bf16 ulp of its
      largest element (2**-9) of the plain one from the same bf16 inputs.

    Also: lse against the plain forward's (1e-4 (1 + |lse|)); the forward's
    o with lse equal to serving's without (``torch.equal``); two backward
    calls bit-identical, and each batch element's gradients computed alone
    (B = 1) equal to its slice of the batched call; a control with lse +
    0.1 that must fail the bound.  Timed beside its bound, the plain
    version and SDPA's backward (K/V expanded to Hq heads beforehand, so
    its dK/dV are per query head; the forward and backward captured
    together, less the forward).  The shape is left in
    :data:`BWD_PASSES` for :func:`bwd_pass_phase` to time its dQ and
    dK/dV passes apart."""
    gen = _gen(seed)
    f32 = dtype == torch.float32

    def draw():
        src = [torch.randn(shape, generator=gen, device=DEV) for shape in
               ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))]
        return src, [x.to(dtype) for x in src]
    src, (q, k, v, dout) = draw()
    o_serve = flash_attention(q, k, v, causal=True)
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    want_o, want_lse = ref.ref_attention(q, k, v, causal=True,
                                         return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, dout)
    again = flash_attention_bwd(q, k, v, o, lse, dout)
    torch.cuda.synchronize()
    if not torch.equal(o, o_serve):
        raise AssertionError(f"flash_attention {label}: o with lse differs "
                             f"from serving's o")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {label}: two calls differ")
    for i in range(b if b > 1 else 0):
        alone = flash_attention_bwd(*(t[i:i + 1].contiguous() for t in
                                      (q, k, v, o, lse, dout)))
        if not all(torch.equal(x[0], y[i]) for x, y in zip(alone, got)):
            raise AssertionError(f"flash_attention_bwd {label}: batch element "
                                 f"{i} alone differs from its slice of B={b}")
    lse_err = max_err(lse, want_lse, 1e-4)
    names = ("dq", "dk", "dv")
    want = ref.attention_bwd(q.float(), k.float(), v.float(), o.float(), lse,
                             dout.float())
    if f32:
        limits = {n: 1e-4 * w.abs().max().item() for n, w in zip(names, want)}
        floor = {}
        form = "1e-4 * max|plain|"
    else:
        o_src, lse_src = ref.ref_attention(*src[:3], causal=True,
                                           return_lse=True)
        exact = ref.attention_bwd(*src[:3], o_src, lse_src, src[3])
        floor = {n: (w - x).abs().max().item()
                 for n, w, x in zip(names, want, exact)}
        limits = {n: 4 * floor[n] + 2 ** -9 * w.abs().max().item()
                  for n, w in zip(names, want)}
        form = "4 * floor + 2**-9 * max|plain|"
        del exact, o_src, lse_src
    errs = {}
    for n, g_, w in zip(names, got, want):
        if not torch.isfinite(g_.float()).all():
            raise AssertionError(f"flash_attention_bwd {label}: non-finite "
                                 f"{n}")
        errs[n] = (g_.double() - w.double()).abs().max().item()
        if errs[n] > limits[n]:
            raise AssertionError(f"flash_attention_bwd {label}: {n} max abs "
                                 f"err {errs[n]:.3e} over {limits[n]:.3e} "
                                 f"({form})")
    broken = ref.attention_bwd(q.float(), k.float(), v.float(), o.float(),
                               lse + 0.1, dout.float())
    bad = {n: (g_.double() - w.double()).abs().max().item()
           for n, g_, w in zip(names, got, broken)}
    if all(bad[n] <= limits[n] for n in names):
        raise AssertionError(f"control flash_attention_bwd {label}: lse + 0.1 "
                             f"passed the bound {json.dumps(bad)}")
    print(f"[control] flash_attention_bwd {label}: plain with lse + 0.1 fails "
          f"as it must: max abs err "
          f"{json.dumps({n: float(f'{x:.3e}') for n, x in bad.items()})} "
          f"against bounds "
          f"{json.dumps({n: float(f'{x:.3e}') for n, x in limits.items()})}")
    del want, broken, again, want_o
    r = RESULTS["flash_attention_bwd"]
    r["max_abs_err"] = max(r["max_abs_err"], max(errs.values()))
    nbytes, flops = _attn_bwd_bound(b, hq, hkv, s, d, q.element_size())

    def mk(fn):
        def make():     # fresh inputs per copy, rotated past the L2
            _, (q_, k_, v_, d_) = draw()
            o_, l_ = flash_attention(q_, k_, v_, causal=True,
                                     return_lse=True)
            return lambda: fn(q_, k_, v_, o_, l_, d_)
        return make
    kern = device_ms(mk(flash_attention_bwd), nbytes)
    plain = device_ms(mk(ref.attention_bwd), nbytes,
                      reps=24 if s * s * b * hq < 1 << 24 else 2)
    BWD_PASSES.append((f"{label} B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
                       f"{str(dtype)[6:]}", mk(flash_attention_bwd)))

    def make_lib(backward):
        def make():
            _, (q_, k_, v_, d_) = draw()
            group = hq // hkv
            leaves = [q_.requires_grad_(), k_.repeat_interleave(group, 1)
                      .requires_grad_(), v_.repeat_interleave(group, 1)
                      .requires_grad_()]

            def call():
                out = F.scaled_dot_product_attention(*leaves, is_causal=True)
                if backward:
                    torch.autograd.grad(out, leaves, d_)
            return call
        return make
    # A backward runs on its forward's stream, so the graph holds both:
    # SDPA's backward is the pair's time less the forward's.
    lib = (device_ms(make_lib(True), nbytes, reps=8)
           - device_ms(make_lib(False), nbytes, reps=8))
    bms, by = bound(nbytes, flops, dtype)
    print(f"[kernel] flash_attention_bwd {label} B={b} Hq={hq} Hkv={hkv} "
          f"S={s} D={d} causal {str(dtype)[6:]} max_abs_err "
          f"{json.dumps({n: float(f'{x:.3e}') for n, x in errs.items()})} "
          f"bound {json.dumps({n: float(f'{x:.3e}') for n, x in limits.items()})}"
          f" ({form}; floor "
          f"{json.dumps({n: float(f'{x:.3e}') for n, x in floor.items()})})"
          f" lse_err={lse_err:.3e} repeatable=True o_with_lse==o=True "
          f"kernel_ms={kern:.5f} plain_ms={plain:.5f} library_ms={lib:.5f} "
          f"(SDPA backward) bound_ms={bms:.6f} ({by}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP) kernel/library={kern / lib:.2f} "
          f"bound/kernel={bms / kern:.4f}")
    if main:
        r.update(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bms,
                 bound_by=by, shape=f"B={b} Hq={hq} Hkv={hkv} S={s} D={d}")


# (label, input maker) of each attention backward shape checked, for
# bwd_pass_phase.
BWD_PASSES = []


def _pass_ms(call, reps=8, warm=8):
    """(records seen, device ms a call) of each kernel that ``call``
    launches: ``warm`` + ``reps`` calls under ``torch.profiler`` (CUDA
    activity only), each kernel's last ``reps`` records by start time
    averaged, since the profiler may drop a session's first records.
    The backward's two passes are one wrapper call.  A kernel seen fewer
    than ``reps`` times has no time (None)."""
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _prime(PROFILE_MARGINS_S[0])
        for _ in range(warm + reps):
            call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    records = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == cuda and not e.is_user_annotation()
                and not _is_spin(_clean_name(e.name()))):
            records.setdefault(_clean_name(e.name()), []).append(
                (e.start_ns(), e.duration_ns()))
    out = {}
    for name, recs in records.items():
        last = sorted(recs)[-reps:]
        out[name] = (len(recs), sum(d for _, d in last) / 1e6 / reps
                     if len(recs) >= reps else None)
    return out


def bwd_pass_phase(reps=8):
    """The dQ and dK/dV passes of each attention backward shape checked,
    timed apart by ``torch.profiler`` (one wrapper call launches both).
    Last of the run, after the phases whose profiles count kernel
    records: once, with this timing run earlier, a later session missed
    one or two of its first records.  That this timing caused it is not
    established (a check of profiler sessions in turns saw no record
    missing), but here it can touch no count.  A pass the profiler saw
    fewer than ``reps`` times is printed as not measured."""
    for label, make in BWD_PASSES:
        got = _pass_ms(make(), reps)
        shown = {name: (round(ms, 5) if ms is not None else
                        f"not measured ({n} records seen)")
                 for name, (n, ms) in got.items()}
        shown = shown or "not measured (no records)"
        print(f"[kernel] flash_attention_bwd {label} passes (profiler, last "
              f"{reps} of {reps + 8} calls): {json.dumps(shown)}")


def attention_bwd_phase():
    # SmolLM-360M FULL at its context (4 x 2048) and the launcher's 8 x 64;
    # Qwen3-8B's 32/8 heads of 128; ragged lengths; the SMOKE configs' f32
    # heads of 16 at the SMOKE launcher's 8 x 64; f32 at D = 64 and 128.
    check_attention_bwd("smollm-4x2048", 4, 15, 5, 2048, 64, torch.bfloat16,
                        seed=71, main=True)
    check_attention_bwd("smollm-8x64", 8, 15, 5, 64, 64, torch.bfloat16,
                        seed=72)
    check_attention_bwd("qwen3-1x2048", 1, 32, 8, 2048, 128, torch.bfloat16,
                        seed=73)
    check_attention_bwd("ragged-100", 2, 15, 5, 100, 64, torch.bfloat16,
                        seed=74)
    check_attention_bwd("ragged-77-d128", 1, 8, 2, 77, 128, torch.bfloat16,
                        seed=75)
    check_attention_bwd("smoke-8x64", 8, 6, 2, 64, 16, torch.float32,
                        seed=76)
    check_attention_bwd("f32-ragged-37", 2, 6, 2, 37, 16, torch.float32,
                        seed=77)
    check_attention_bwd("f32-d64", 2, 15, 5, 100, 64, torch.float32, seed=78)
    check_attention_bwd("f32-d128", 1, 8, 2, 77, 128, torch.float32, seed=79)


@contextlib.contextmanager
def attention_mode(mode, scale_mult=1.0):
    """Route the models' ``ops.attention`` and ``ops.rmsnorm`` calls through
    ``mode`` for a while (whatever mode the caller names), attention's
    softmax scale multiplied by ``scale_mult`` (the controls'
    perturbation)."""
    orig_attn, orig_norm = ops.attention, ops.rmsnorm

    def attn(q, k, v, *, scale=None, **kw):
        if scale_mult != 1.0:
            scale = (q.shape[-1] ** -0.5 if scale is None
                     else scale) * scale_mult
        return orig_attn(q, k, v, scale=scale, mode=mode, **kw)

    route = mode

    def norm(x, scale, *, eps=1e-6, mode=None):
        return orig_norm(x, scale, eps=eps, mode=route)
    ops.attention, ops.rmsnorm = attn, norm
    try:
        yield
    finally:
        ops.attention, ops.rmsnorm = orig_attn, orig_norm


def _attn_grads(cfg, params, batch, mode, scale_mult=1.0):
    """Loss and every leaf's gradient with attention and the norms in
    ``mode`` (no remat).  A ``ref`` run must launch none of their kernels."""
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    before = K.launch_counts()
    with attention_mode(mode, scale_mult):
        loss, _ = loss_fn(params, batch, cfg, remat=False)
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    moved = {n: K.launch_counts()[n] - before[n] for n in ATTN_TRAIN_KERNELS}
    if mode == "ref" and any(moved.values()):
        raise AssertionError(f"the plain run launched kernels: {moved}")
    return loss.item(), grads, moved


def attention_kernel_vs_plain():
    """One step's loss and gradients of SmolLM-360M at FULL width and 2
    layers (4 x 256 tokens), with attention and the norms on their kernels
    (flash_attention with its backward, rmsnorm) and on their plain
    versions (torch autograd of the plain attention and norm), same
    parameters and batch:

    * f32 compute: the two differ in summation order only.  Bounds: the
      loss within 1e-5, every leaf's gradient within 1e-4 of its largest
      element.  Control: the plain run with the softmax scale 1% off must
      break the gradient bound.
    * bf16 compute (the FULL config's): P and dS round to bf16 inside the
      kernels, outputs round once.  Control: the plain run with the scale
      times 1 + 1e-6 gives the rounding floor.  Bounds, a witness that the
      step stays finite and close: the loss within 1e-2, every leaf within
      5e-2 of its largest element."""
    base = dataclasses.replace(C.get("smollm_360m"), n_layers=2)
    params = train_tree(init_params(base, seed=5, device=DEV,
                                    dtype=torch.float32))
    names = [n for n, _ in _leaf_names(params)]
    batch = {k: torch.as_tensor(v, device=DEV)
             for k, v in _batches(base, 4, 256, seed=2).batch_at(0).items()}
    want = {"flash_attention": 2, "flash_attention_bwd": 2, "rmsnorm": 5}
    for compute, loss_tol, grad_tol, mult in (
            ("float32", 1e-5, 1e-4, 1.01), ("bfloat16", 1e-2, 5e-2, 1 + 1e-6)):
        cfg = dataclasses.replace(base, compute_dtype=compute)
        loss_k, g_k, counts = _attn_grads(cfg, params, batch, "auto")
        loss_p, g_p, _ = _attn_grads(cfg, params, batch, "ref")
        rel = _grad_diff(names, g_k, g_p)
        del g_k
        loss_c, g_c, _ = _attn_grads(cfg, params, batch, "ref", mult)
        rel_c = _grad_diff(names, g_c, g_p)
        del g_c, g_p
        print(f"[train] attention kernels vs plain (smollm-360m width, 2 "
              f"layers, 4x256 tokens, compute={compute}): loss "
              f"{loss_k:.7f} vs {loss_p:.7f} (|diff| "
              f"{abs(loss_k - loss_p):.3e}, bound {loss_tol:g}); gradient "
              f"max rel diff {max(rel.values()):.3e} over {len(rel)} leaves "
              f"(bound {grad_tol:g}), largest: {_worst(rel)}; launches "
              f"{json.dumps(counts)}")
        print(f"[train]   control, plain with the softmax scale x {mult!r} "
              f"vs plain ({'must break the bound' if compute == 'float32' else 'the bf16 rounding floor'}): "
              f"loss |diff| {abs(loss_c - loss_p):.3e}, gradient max rel diff "
              f"{max(rel_c.values()):.3e}, largest: {_worst(rel_c)}")
        if counts != want:
            raise AssertionError(f"kernel path launched {counts}, not {want}")
        if abs(loss_k - loss_p) > loss_tol or max(rel.values()) > grad_tol:
            raise AssertionError(f"kernel and plain training steps differ "
                                 f"({compute})")
        if compute == "float32" and max(rel_c.values()) <= grad_tol:
            raise AssertionError("the f32 bound does not catch the scale 1% "
                                 "off")
    del params
    torch.cuda.empty_cache()


def train_attention_phase():
    """SmolLM-360M FULL (32 layers, d_model 960, 15/5 heads of 64, tied
    vocab 49152; f32 parameters, bf16 compute, AdamW) through
    make_train_step with the launcher's remat (``tp_outs``: each mixer and
    FFN recomputed in the backward): 5 steps at the launcher's 8 x 64
    tokens, then 4 at SmolLM's context, 4 x 2048, each shape's first a
    warm-up and one more profiled; the losses must be finite and fall.
    Launches a step: flash_attention twice a layer (forward and the
    recomputation), flash_attention_bwd once, rmsnorm twice for each of a
    layer's two norms and once for the final norm.  The route counters:
    ``ops.attention.ref`` 0, ``.kernel`` the forward's launches.  Then the
    2-layer kernel-vs-plain step."""
    set_gemm_mode("ref")
    cfg = C.get("smollm_360m")
    gc.collect()
    torch.cuda.empty_cache()
    params = train_tree(init_params(cfg, seed=4, device=DEV,
                                    dtype=torch.float32))
    n_params = sum(p.numel() for p in adamw.leaves(params))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    opt = adamw.init(params)
    step_fn = make_train_step(cfg, opt_cfg, remat=True,
                              remat_policy="tp_outs")
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers,
            "rmsnorm": 4 * cfg.n_layers + 1}
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.d_head} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} tied params={n_params} "
          f"(f32, {len(adamw.leaves(params))} leaves) compute="
          f"{cfg.compute_dtype} remat=tp_outs gemm=torch.matmul")
    total = {n: 0 for n in want}
    reg = obs.get_obs().registry
    for batch, seq, steps in ((8, 64, 5), (4, 2048, 4)):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reg.reset_values()
        data = _batches(cfg, batch, seq, seed=3)
        label = f"{cfg.name} FULL {batch}x{seq}"
        params, opt, step_ms, counts, losses = timed_steps(
            step_fn, params, opt, data, steps, want, batch * seq, label)
        routes = {k: v for k, v in reg.snapshot()["counters"].items()
                  if k.startswith("ops.attention")}
        mean = sum(step_ms) / len(step_ms)
        print(f"[train] {label}: steps 1-{steps - 1} mean step_ms="
              f"{mean:.3f} tok_s={batch * seq / mean * 1e3:.1f} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
              f"losses {losses} routes {json.dumps(routes)} "
              f"flash_attention_bwd launches a step "
              f"{want['flash_attention_bwd']} (2 kernels each)")
        if routes.get("ops.attention.ref", 0) or routes.get(
                "ops.attention.kernel") != steps * want["flash_attention"]:
            raise AssertionError(f"{label}: attention routes {routes}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: the loss did not fall: {losses}")
        for n in want:
            total[n] += counts[n]
        params, opt = profile_step(step_fn, params, opt,
                                   data.batch_at(steps), label, mean)
    del params, opt
    torch.cuda.empty_cache()
    attention_kernel_vs_plain()
    return total


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
    checkpoint and must log the uninterrupted run's losses exactly.  For
    RWKV-6 (the wkv6 kernels), for the launcher's default arch,
    SmolLM-360M (attention and its backward kernel, one tied leaf), and for
    Jamba (the selective scan and its backward kernel, with an attention
    layer and MoE FFNs).  The Trainers' GEMMs are plain matrix products,
    as the launcher's (``gemm_mode("ref")``), whatever phase ran before."""
    set_gemm_mode("ref")
    ckpt_root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        for arch, kernels, argv in (
                ("rwkv6_3b", TRAIN_KERNELS, ["--arch", "rwkv6_3b"]),
                ("smollm_360m", ATTN_TRAIN_KERNELS, []),
                ("jamba_v01_52b", SCAN_TRAIN_KERNELS,
                 ["--arch", "jamba_v01_52b"])):
            trainer_check(arch, kernels, argv, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def trainer_check(arch, kernels, argv, ckpt_root):
    K.reset_launch_counts()
    res = TL.main(argv + ["--smoke", "--steps", "6", "--device", DEV,
                          "--ckpt_every", "2", "--ckpt_dir",
                          os.path.join(ckpt_root, arch, "launcher")])
    counts = K.launch_counts()
    if res["restarts"] != 0 or res["final_step"] != 6:
        raise AssertionError(f"launcher: {res}")
    print(f"[train] launcher {' '.join(argv) or '(default arch)'} --smoke "
          f"--steps 6 --ckpt_every 2: final_step={res['final_step']} "
          f"restarts={res['restarts']} "
          f"losses={[round(m['loss'], 5) for m in res['metrics']]} "
          f"launches={json.dumps({n: counts[n] for n in kernels})}")
    if not all(counts[n] for n in kernels):
        raise AssertionError(f"the launcher's steps ran no {kernels} kernel")

    cfg = C.get_smoke(arch)

    def run(tag, hook=None):
        params = train_tree(init_params(cfg, seed=0, device=DEV,
                                        dtype=torch.float32))
        opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
        data = _batches(cfg, 8, 64, seed=0)
        t = Trainer(cfg, TrainConfig(
            steps=6, ckpt_every=2, log_every=1,
            ckpt_dir=os.path.join(ckpt_root, arch, tag)), opt_cfg, params,
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
    print(f"[train] {cfg.name} restart: uninterrupted losses "
          f"{[want[s] for s in sorted(want)]}; with a failure at step 3 "
          f"steps {[m['step'] for m in hurt['metrics']]} restarts="
          f"{hurt['restarts']} final losses {[got[s] for s in sorted(got)]}"
          f" equal={got == want}")
    if clean["restarts"] != 0 or hurt["restarts"] != 1 or got != want:
        raise AssertionError("restart did not resume the uninterrupted "
                             "run's losses")
    if [m["step"] for m in hurt["metrics"]] != [0, 1, 2, 2, 3, 4, 5]:
        raise AssertionError("restart did not resume from step 2")


# ---------------------------------------------------------------------------
# 5c. Train Jamba: selective_scan_bwd, then Jamba-v0.1 at full width
# ---------------------------------------------------------------------------

SCAN_GRADS = ("gdt", "gx", "gbm", "gc", "ga", "gh0")
# Operations a state a step in selective_scan_bwd's formula: the tile's
# recomputation 5 (dt A, its exp, dtx B, and the update's product and sum),
# the reverse walk 15 (g's product and sum, gbm's and gc's terms and their
# sums over channels, gdtx's product and sum, v's two products, sA's
# product and sum, ga's product and sum, the carry's product).
SCAN_BWD_OPS = 20


def _scan_bwd_inputs(gen, b, t, di, n, dtype):
    """``_scan_inputs`` (a nonzero state), the output gradient gy ~ N(0, 1)
    in ``dtype`` and the final state's ght ~ N(0, 1) f32."""
    args = _scan_inputs(gen, b, t, di, n, dtype)
    gy = torch.randn((b, t, di), generator=gen, device=DEV).to(dtype)
    ght = torch.randn((b, di, n), generator=gen, device=DEV)
    return args, gy, ght


def _scan_bwd_errs(got, want):
    """Per output, max |got - want| over tol * max(1, max|want|): 1e-4 for
    the f32 outputs (ga, gh0, and all six in f32: sums over di, over
    (b, t) and over N in another order), 1e-2 for bf16 ones (one bf16 ulp
    is 2**-8 of a value).  Returns (errors, the outputs that fail)."""
    errs, bad = {}, []
    for name, g, w in zip(SCAN_GRADS, got, want):
        try:
            errs[name] = _err_to_max(
                g, w, 1e-2 if g.dtype == torch.bfloat16 else 1e-4)
        except AssertionError as e:
            bad.append(f"{name}: {e}")
    return errs, bad


def check_selective_scan_bwd(label, b, t, di, n, dtype, seed, main=False):
    """selective_scan_bwd against ``ref.selective_scan_bwd`` from a nonzero
    state with a final-state gradient, at :func:`_scan_bwd_errs`'s
    tolerances; a control, the plain backward with A x 1.01, must fail
    them.  The forward that saves the states must give y and hT bit for bit
    as the forward that does not; two backward calls repeat their bits;
    each sequence alone gives its gdt, gx, gbm and gc rows of the batch bit
    for bit.  Timed beside its bound (the VJP's inputs dt, x, gy, B, C, A,
    h0 and ght read once, gdt, gx, gbm, gc, ga and gh0 written once, as
    wkv6_bwd's bound counts them: the saved states are this design's
    choice, not the function's; SCAN_BWD_OPS f32 operations a state a
    step) and the plain backward (a Python loop over T, twice)."""
    gen = _gen(seed)
    (dt, x, bm, c, a, h0), gy, ght = _scan_bwd_inputs(gen, b, t, di, n,
                                                      dtype)
    y, h, states = scan_fwd(dt, x, bm, c, a, h0)
    y0, h_0 = scan_kernel(dt, x, bm, c, a, h0)
    if not (torch.equal(y, y0) and torch.equal(h, h_0)):
        raise AssertionError(f"selective_scan {label}: the forward that "
                             f"saves its states changed y or hT")
    args = (dt, x, bm, c, a, h0, gy)
    got = scan_bwd(*args, states, ght)
    again = scan_bwd(*args, states, ght)
    want = ref.selective_scan_bwd(*args, ght)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"selective_scan_bwd {label}: two calls differ")
    errs, bad = _scan_bwd_errs(got, want)
    if bad:
        raise AssertionError(f"selective_scan_bwd {label}: {bad}")
    _, caught = _scan_bwd_errs(got, ref.selective_scan_bwd(
        dt, x, bm, c, a * 1.01, h0, gy, ght))
    if not caught:
        raise AssertionError(f"selective_scan_bwd {label}: A x 1.01 passed "
                             f"the tolerance: the check cannot see A")
    del want, again
    for i in range(b if b > 1 else 0):
        one = [v[i:i + 1] for v in (dt, x, bm, c)]
        _, _, st = scan_fwd(*one, a, h0[i:i + 1])
        alone = scan_bwd(*one, a, h0[i:i + 1], gy[i:i + 1], st,
                         ght[i:i + 1])
        if not all(torch.equal(p, q[i:i + 1])
                   for p, q in zip(alone[:4], got[:4])):
            raise AssertionError(f"selective_scan_bwd {label}: sequence {i} "
                                 f"alone differs from its rows of the batch")
    del got, states
    e = dt.element_size()
    nbytes = ((5 * b * t * di + 4 * b * t * n) * e + 2 * di * n * 4
              + 3 * b * di * n * 4)
    flops = float(SCAN_BWD_OPS) * b * t * di * n

    def mk(plain):
        def make():     # fresh inputs per copy, rotated past the L2
            f_args, f_gy, f_ght = _scan_bwd_inputs(gen, b, t, di, n, dtype)
            if plain:
                return lambda: ref.selective_scan_bwd(*f_args, f_gy, f_ght)
            _, _, f_st = scan_fwd(*f_args)
            return lambda: scan_bwd(*f_args, f_gy, f_st, f_ght)
        return make

    kern = device_ms(mk(False), nbytes)
    plain = device_ms(mk(True), nbytes, reps=24 if t <= 16 else 1)
    bms, by = bound(nbytes, flops, torch.float32)
    res = RESULTS["selective_scan_bwd"]
    err = max(errs.values())
    res["max_abs_err"] = max(res["max_abs_err"], err)
    plan = scan_plan(di, n, dtype)
    f32 = dtype == torch.float32
    print(f"[kernel] selective_scan_bwd {label} B={b} T={t} di={di} N={n} "
          f"{'f32' if f32 else 'bf16'} from h0 with ght max_abs_err "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
          f"(tol {'1e-4' if f32 else '1e-2 (bf16) / 1e-4 (f32 ga, gh0)'}"
          f"*max(1,max|plain|)) control: A*1.01 fails on "
          f"{'+'.join(x.split(':')[0] for x in caught)}; repeat bits OK; "
          + ("alone == batch rows bitwise (gdt, gx, gbm, gc); " if b > 1
             else "")
          + f"forward with states == without bitwise; "
          f"plan={json.dumps(plan._asdict())} kernel_ms={kern:.5f} "
          f"plain_ms={plain:.5f} bound_ms={bms:.6f} ({by}: "
          f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP f32) "
          f"library_ms=null (none: no single PyTorch call computes the "
          f"scan's VJP) bound/kernel={bms / kern:.3f} scratch_bytes="
          f"{4 * scan_mod.scratch_floats(b, t, di, n)} states_bytes="
          f"{4 * b * scan_mod.saved_states(t) * di * n}")
    if main:
        res.update(ms=kern, plain_ms=plain, library_ms=None, bound_ms=bms,
                   bound_by=by, shape=f"B={b} T={t} di={di} N={n} "
                   f"{'f32' if f32 else 'bf16'} from h0 ({label})")


# selective_scan_bwd's shapes (label, B, T, di, N, dtype): Jamba-v0.1
# 52B's training step (8 x 64 tokens, d_inner 8192, 16 states) in bf16
# (the kernels line) and f32, a 448-token prompt, a length that is not a
# multiple of 8, a ragged width on plain loads, and the SMOKE launcher's
# f32 shape.  tools/scan_table.py times the same.
SCAN_BWD_SHAPES = [("train-bf16", 8, 64, 8192, 16, torch.bfloat16),
                   ("train-f32", 8, 64, 8192, 16, torch.float32),
                   ("prompt-448", 1, LONG_PROMPT, 8192, 16, torch.bfloat16),
                   ("ragged-T11", 2, 11, 8192, 16, torch.bfloat16),
                   ("ragged-width", 3, 21, 100, 12, torch.bfloat16),
                   ("smoke-f32", 8, 64, 128, 8, torch.float32)]


def scan_bwd_phase():
    """selective_scan_bwd at SCAN_BWD_SHAPES (their widths those of
    Jamba-v0.1 52B's config and of its SMOKE config)."""
    jamba, smoke = C.get("jamba_v01_52b"), C.get_smoke("jamba_v01_52b")
    widths = {(m.mamba.expand * m.d_model, m.mamba.d_state)
              for m in (jamba, smoke)}
    for i, (label, b, t, di, n, dtype) in enumerate(SCAN_BWD_SHAPES):
        if label != "ragged-width" and (di, n) not in widths:
            raise AssertionError(f"scan bwd {label}: ({di}, {n}) is no "
                                 f"served width {sorted(widths)}")
        check_selective_scan_bwd(label, b, t, di, n, dtype, seed=101 + i,
                                 main=i == 0)


@contextlib.contextmanager
def scan_mode(mode, a_scale=1.0):
    """Route the Mamba mixers' ``ops.selective_scan`` calls through
    ``mode`` for a while, with A scaled by ``a_scale`` (the controls'
    perturbation)."""
    orig = ops.selective_scan

    def routed(dt, x, bm, c, a, h0):
        return orig(dt, x, bm, c, a * a_scale if a_scale != 1.0 else a, h0,
                    mode=mode)
    ops.selective_scan = routed
    try:
        yield
    finally:
        ops.selective_scan = orig


def train_jamba_phase(steps=4):
    """Jamba-v0.1 52B at its published widths (d_model 4096, d_inner 8192,
    16 states, 16 experts top-2 at d_ff 14336, vocab 65536), cut in depth
    to the first two blocks of its period: Mamba with a dense FFN, then
    Mamba with the MoE FFN.  f32 parameters, bf16 compute, AdamW, the
    launcher's ``tp_outs`` remat; ``steps`` steps at 8 x 64 tokens, the
    first a warm-up, then one profiled.  Launches a step: selective_scan
    twice a Mamba layer (the forward and the recomputation),
    selective_scan_bwd once, rmsnorm twice for each of a layer's two norms
    and once for the final norm; the route counters ``ops.selective_scan
    .ref`` 0 and ``.kernel`` the forward's launches.  Then the 1-layer
    kernel-vs-plain step."""
    set_gemm_mode("ref")
    full = C.get("jamba_v01_52b")
    cfg = dataclasses.replace(full, n_layers=2, pattern=full.pattern[:2])
    _free()
    torch.cuda.reset_peak_memory_stats()
    params = train_tree(init_params(cfg, seed=6, device=DEV,
                                    dtype=torch.float32))
    n_params = sum(p.numel() for p in adamw.leaves(params))
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    opt = adamw.init(params)
    step_fn = make_train_step(cfg, opt_cfg, remat=True,
                              remat_policy="tp_outs")
    n_mamba = sum(spec.mixer == "mamba" for spec in cfg.pattern)
    want = {"selective_scan": 2 * n_mamba, "selective_scan_bwd": n_mamba,
            "rmsnorm": 4 * cfg.n_layers + 1}
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} (blocks "
          f"{[(s.mixer, s.ffn) for s in cfg.pattern]}) d_model={cfg.d_model}"
          f" d_inner={full.mamba.expand * cfg.d_model} N="
          f"{full.mamba.d_state} experts={cfg.moe.num_experts} top-"
          f"{cfg.moe.top_k} d_ff={cfg.d_ff} vocab={cfg.vocab_size} params="
          f"{n_params} (f32; 16 bytes a parameter with gradients and AdamW "
          f"= {16 * n_params} bytes) compute={cfg.compute_dtype} "
          f"remat=tp_outs gemm=torch.matmul")
    reg = obs.get_obs().registry
    reg.reset_values()
    data = _batches(cfg, 8, 64, seed=5)
    label = f"{cfg.name} FULL width, 2 layers, 8x64"
    params, opt, step_ms, total, losses = timed_steps(
        step_fn, params, opt, data, steps, want, 8 * 64, label)
    routes = {k: v for k, v in reg.snapshot()["counters"].items()
              if k.startswith("ops.selective_scan")}
    mean = sum(step_ms) / len(step_ms)
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {label}: steps 1-{steps - 1} mean step_ms={mean:.3f} "
          f"tok_s={8 * 64 / mean * 1e3:.1f} max_memory_allocated={peak} "
          f"({peak / (16 * n_params):.3f}x the 16-byte reckoning) losses "
          f"{losses} routes {json.dumps(routes)} launches a step "
          f"{json.dumps(want)}")
    if routes.get("ops.selective_scan.ref", 0) or routes.get(
            "ops.selective_scan.kernel") != steps * want["selective_scan"]:
        raise AssertionError(f"{label}: selective_scan routes {routes}")
    params, opt = profile_step(step_fn, params, opt, data.batch_at(steps),
                               label, mean)
    del params, opt
    _free()
    base = dataclasses.replace(full, n_layers=1, pattern=full.pattern[:1])
    kernel_vs_plain(base, "jamba-v0.1 width, 1 layer", scan_mode, "A",
                    SCAN_TRAIN_KERNELS,
                    {"selective_scan": 1, "selective_scan_bwd": 1}, seed=7)
    return total


# ---------------------------------------------------------------------------
# 4c. Serve the other archs: Qwen3-8B, Phi-3-medium, Minitron-8B and RWKV-6
#     3B at full width, int8 weights, and the state-carrying wkv6
# ---------------------------------------------------------------------------


def check_wkv_state(label, b, h, t, n, seed, dtype=torch.bfloat16,
                    main=False, per_step=None):
    """wkv6_state against ref_wkv_state from a nonzero state s0: y and the
    final state sT.  With f32 r/k/v both at the f32 tolerance (1e-4 of the
    largest value: sums in another order, and the state's update fused),
    and a control: s0 scaled by 1.01 must fail it; with bf16 r/k/v (the
    served dtype) y, rounded once to bf16, at 1e-2 and sT at 1e-4.  At
    s0 = 0 its y must equal wkv6's bit for bit, and two calls must repeat
    their bits.  Timed beside its bound (4 N^2 f32 operations per (b, h,
    t); r, k, v, w read once, u, s0 read and y, sT written once) and its
    plain version."""
    gen = _gen(seed)
    r, k, v, w, u, _ = _wkv_inputs(gen, b, h, t, n, dtype)
    s0 = torch.randn((b, h, n, n), generator=gen, device=DEV) * 0.5
    y, s_end = wkv6_state(r, k, v, w, u, s0)
    y2, s2 = wkv6_state(r, k, v, w, u, s0)
    want_y, want_s = ref.ref_wkv_state(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    tol_y = 1e-4 if f32 else 1e-2
    err_y = _err_to_max(y, want_y, tol_y)
    err_s = _err_to_max(s_end, want_s, 1e-4)
    if not (torch.equal(y, y2) and torch.equal(s_end, s2)):
        raise AssertionError(f"wkv6_state {label}: two runs differ")
    control = "not run (bf16: y rounds to bf16)"
    if f32:
        yc, sc = wkv6_state(r, k, v, w, u, s0 * 1.01)
        caught = []
        for name, got, want in (("y", yc, want_y), ("sT", sc, want_s)):
            try:
                _err_to_max(got, want, 1e-4)
            except AssertionError:
                caught.append(name)
        if not caught:
            raise AssertionError(f"wkv6_state {label}: s0 * 1.01 passed the "
                                 f"tolerance: the check cannot see s0")
        control = f"s0*1.01 fails on {'+'.join(caught)}"
    y0, _ = wkv6_state(r, k, v, w, u, torch.zeros_like(s0))
    if not torch.equal(y0, wkv6(r, k, v, w, u)):
        raise AssertionError(f"wkv6_state {label}: at s0 = 0 its y is not "
                             f"wkv6's bit for bit")
    del want_y, want_s, y2, s2
    e = r.element_size()
    elems = b * h * t * n
    nbytes = elems * (3 * e + 4 + e) + h * n * 4 + 2 * b * h * n * n * 4
    flops = 4.0 * n * n * b * h * t

    def mk(fn):
        def make():     # fresh inputs per copy, rotated past the L2
            args = _wkv_inputs(gen, b, h, t, n, dtype)[:5]
            st = torch.randn((b, h, n, n), generator=gen, device=DEV)
            return lambda: fn(*args, st)
        return make

    kern = device_ms(mk(wkv6_state), nbytes)
    plain = device_ms(mk(ref.ref_wkv_state), nbytes,
                      reps=24 if t <= 128 else 1)
    bms, by = bound(nbytes, flops, torch.float32)
    chunk = wkv_mod.wkv_chunk(t, n, dtype)
    grid = wkv_mod.blocks(b, h, t, n, chunk, False)
    res = RESULTS["wkv6_state"]
    res["max_abs_err"] = max(res["max_abs_err"], err_y, err_s)
    print(f"[kernel] wkv6_state {label} B={b} H={h} T={t} N={n} "
          f"r/k/v={'f32' if f32 else 'bf16'} s0=N(0,0.25) max_abs_err y="
          f"{err_y:.3e} (tol {tol_y:g}) sT={err_s:.3e} (tol 1e-4) "
          f"*max(1,max|plain|) control: {control}; s0=0 y == wkv6 bitwise; "
          f"kernel_ms={kern:.5f} plain_ms={plain:.5f} bound_ms={bms:.6f} "
          f"({by}: {nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP f32) "
          f"library_ms=null bound/kernel={bms / kern:.3f} chunk={chunk} "
          f"chunks={wkv_mod.n_chunks(t, chunk)} blocks={sum(grid.values())}"
          + ("" if per_step is None else
             f" launches_per_decode_step={per_step}"))
    if main:
        res.update(ms=kern, plain_ms=plain, library_ms=None, bound_ms=bms,
                   bound_by=by, shape=f"B={b} H={h} T={t} N={n} bf16 from s0")


def archs_kernel_phase():
    """The kernels at the shapes the other archs serve: wkv6_state at
    RWKV-6 3B's decode (B = 8 slots, 40 heads of 64, T = 1; the kernels
    line), a serial prompt (T = 11) and a multi-chunk one (T = 448), in
    bf16 and f32, and the SMOKE config's heads of 16 in f32; gama_gemm at
    every weight GEMM of RWKV-6 3B (M = 3, 8, 448), Phi-3-medium and
    Minitron-8B (M = 3, 16), their lm heads of 100352 and 256000 columns
    included, and the SMOKE configs' f32 GEMMs (M = 3, 12)."""
    rwkv = C.get("rwkv6_3b")
    heads = rwkv.d_model // rwkv.rwkv.head_size
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        check_wkv_state(f"decode-{tag}", LONG_REQS, heads, 1, 64, seed=60,
                        dtype=dtype, main=dtype == torch.bfloat16,
                        per_step=rwkv.n_layers)
        check_wkv_state(f"serial-{tag}", LONG_REQS, heads, 11, 64, seed=61,
                        dtype=dtype)
        check_wkv_state(f"prompt-448-{tag}", 1, heads, LONG_PROMPT, 64,
                        seed=62, dtype=dtype)
    check_wkv_state("smoke-decode", 3, 4, 1, 16, seed=63, dtype=torch.float32)
    check_wkv_state("smoke-prompt", 1, 4, 12, 16, seed=64,
                    dtype=torch.float32)
    check_wkv_state("smoke-long", 1, 4, 37, 16, seed=65, dtype=torch.float32)
    # RWKV-6's norms: LayerNorm (ln0, two a layer, the final norm) and the
    # wkv output's GroupNorm (one group a head), at 3B's decode batch of 8
    # (the kernels line) and its 448-token prompt, and the SMOKE config's
    # in f32.
    norms = 2 * rwkv.n_layers + 2
    check_layernorm("decode", LONG_REQS, rwkv.d_model, 1, torch.bfloat16,
                    seed=72, main=True, per_step=norms + rwkv.n_layers)
    check_layernorm("prompt-448", LONG_PROMPT, rwkv.d_model, 1,
                    torch.bfloat16, seed=73)
    check_layernorm("groupnorm-decode", LONG_REQS, rwkv.d_model, heads,
                    torch.bfloat16, seed=74)
    check_layernorm("smoke", 3, 64, 1, torch.float32, seed=75)
    check_layernorm("smoke-groupnorm", 12, 64, 4, torch.float32, seed=76)
    # A row wider than the registers hold (2561 bf16 values: not a whole
    # number of 16-byte vectors, so 2561 of one value, 11 a thread), which
    # the kernel walks in chunks.
    check_layernorm("wide-row", LONG_REQS, 2561, 1, torch.bfloat16, seed=77)
    # RWKV-6 3B training's 8 x 64 tokens (the grad check below runs them).
    check_layernorm("train-512", 512, rwkv.d_model, 1, torch.bfloat16,
                    seed=70)
    check_layernorm("train-512-groupnorm", 512, rwkv.d_model, heads,
                    torch.bfloat16, seed=71)
    # The int8 weights' dequantize at the quantized replays' shapes:
    # Phi-3-medium's (the kernels line: its FFN down weight) and lm head,
    # SmolLM-360M's tied head (a scale a row) and embedding rows, and a
    # width off the 16-code path.
    phi3, smol = C.get("phi3_medium_14b"), C.get("smollm_360m")
    check_dequant("phi3-medium-14b down", (phi3.d_ff, phi3.d_model),
                  (phi3.d_model,), torch.bfloat16, seed=80, main=True,
                  per_step=sum(c for _, _, c in phi3.gemm_shapes().values())
                  + 1)
    check_dequant("phi3-medium-14b lm head", (phi3.d_model, phi3.vocab_size),
                  (phi3.vocab_size,), torch.bfloat16, seed=81)
    check_dequant("smollm-360m tied head", (smol.d_model, smol.vocab_size, 1),
                  (smol.d_model, 1), torch.bfloat16, seed=82)
    check_dequant("smollm-360m embedding rows", (3, 1, smol.d_model),
                  (smol.d_model,), torch.bfloat16, seed=83)
    check_dequant("odd width f32", (3, 7, 10), (3, 10), torch.float32,
                  seed=84)
    for groups in (1, heads):     # training: autograd through the kernel
        check_layernorm_grad("train-8x64", 512, rwkv.d_model, groups,
                             torch.bfloat16, seed=77 + groups)
    # Phi-3-medium's 40/10 heads of 128 (Minitron-8B's 32/8 are Qwen3-8B's,
    # checked above) at smoke6's prefill and decode shapes, and the Phi-3
    # SMOKE config's 10/5 heads of 16 in f32.
    check_attention("phi3-prefill-paged", 1, 40, 10, 16, 48, 128, 0,
                    torch.bfloat16, 2e-2, seed=66)
    check_attention("phi3-smoke-d16-prefill", 1, 10, 5, 16, 36, 16, 0,
                    torch.float32, 2e-5, seed=67)
    check_decode("phi3", 40, 10, 36, 128, [28, 20, 13], torch.bfloat16,
                 2e-2, seed=68)
    check_decode("phi3-smoke-d16", 10, 5, 36, 16, [28, 20, 13],
                 torch.float32, 2e-5, seed=69)
    check_paged_decode("phi3", 40, 10, 128, 16, [28, 20, 13], "float", 2e-2,
                       seed=70)
    check_paged_decode("phi3-smoke-d16", 10, 5, 16, 16, [28, 20, 13],
                       "float", 2e-5, seed=71, dtype=torch.float32)
    bf16_tol, f32_tol = 1e-2, 1e-4
    for arch, ms in ((rwkv, (3, 8, LONG_PROMPT)),
                     (C.get("phi3_medium_14b"), (3, 16)),
                     (C.get("minitron_8b"), (3, 16))):
        for m in ms:
            for label, (k, n, per_step) in arch.gemm_shapes().items():
                check_gemm(f"{arch.name}:{label}", m, k, n, torch.bfloat16,
                           torch.bfloat16, 1.0, bf16_tol, seed=m + k + n,
                           per_step=per_step if m <= 16 else None)
    for name in ("rwkv6_3b", "phi3_medium_14b", "minitron_8b", "qwen3_8b"):
        arch = C.get_smoke(name)
        for m in (3, 12):
            for label, (k, n, _) in arch.gemm_shapes().items():
                check_gemm(f"{arch.name}:{label}", m, k, n, torch.float32,
                           torch.float32, 1.0, f32_tol, seed=m + k + n + 1)


def _launcher(argv):
    """Run the serve launcher, print its result lines, return its stdout
    and the launch counts of the run."""
    K.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        S.main(argv)                 # raises unless it prints "verify OK"
    torch.cuda.synchronize()
    counts = K.launch_counts()
    text = out.getvalue()
    for ln in text.splitlines():
        if any(x in ln for x in ("tok/s", "verify OK", "int8 weights",
                                 "paged kv:")):
            print(f"[archs] launcher {' '.join(argv)}: {ln}")
    print(f"[archs] launcher {' '.join(argv)}: launches "
          f"{json.dumps(counts)}")
    return text, counts


SHORT_POS = (20, 14, 7)                               # smoke6's first steps
LONG_POS = (449, 454, 459, 465, 470, 476, 481, 487)   # 8 x 448's last steps


def decode_step_times(cfg, params, label, positions=SHORT_POS,
                      max_len=48, steps=5, enc_len=0):
    """A decode step of one slot per entry of ``positions`` on a dense
    cache, each slot at its position (smoke6's first decode steps by
    default; ``LONG_POS``, at max_len ``LONG_LEN``, is the last steps of
    the 8 x 448 replays): the wall per step (host clock, synchronised,
    profiler off, mean of two runs) and the device time of its kernels
    (``torch.profiler``), and the launches of one step.  An enc-dec model
    reads a cross cache of ``enc_len`` rows.  Returns (wall_ms, device_ms
    or None, launches per step)."""
    slots = len(positions)
    tok = torch.zeros(slots, dtype=torch.long, device=DEV)
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    caches = init_cache(cfg, slots, max_len, DEV, enc_len=enc_len)

    def run():
        t0 = time.perf_counter()
        for _ in range(steps):
            decode_step(params, tok, pos, cfg, caches)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    run()                                  # warm-up
    c0 = K.launch_counts()
    decode_step(params, tok, pos, cfg, caches)
    torch.cuda.synchronize()
    per_step = {n: c - c0[n] for n, c in K.launch_counts().items()
                if c - c0[n]}
    wall = (run() + run()) / 2

    _, by_name, launched, lost = _profiled(run, f"{label} decode step",
                                           host=False)
    device = None
    if by_name and not lost:
        device = sum(us for _, us in by_name.values()) / 1e3 / steps
        n_kernels = sum(c for c, _ in by_name.values()) // steps
        kinds = {k: round(us / 1e3 / steps, 3)
                 for k, (_, us) in sorted(_by_kind(by_name).items(),
                                          key=lambda kv: -kv[1][1])}
        dev = (f"device_ms={device:.3f} device_idle_share="
               f"{1 - device / wall:.3f} kernels_per_step={n_kernels} "
               f"device_ms_by_kind {json.dumps(kinds)}")
    else:
        dev = f"device time not measured ({_unmeasured(lost)})"
    print(f"[archs] {label} decode step ({slots} slots at positions "
          f"{min(positions)}-{max(positions)}, dense): wall_ms="
          f"{wall:.3f} (profiler off, mean of 2) {dev} launches_per_step "
          f"{json.dumps(per_step)} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()}")
    return wall, device, per_step


def dequant_bytes(params):
    """The bytes a decode step's weight dequantization must move: each
    int8 code and f32 scale read once, each value written once in the
    compute dtype (the tied head's transpose counted once, the table's
    gathered rows not at all), and that traffic's time at the card's
    memory rate."""
    nbytes = 0

    def walk(node, key=None):
        nonlocal nbytes
        if isinstance(node, dict) and ("q" in node or "q_t" in node):
            if key == "table":      # gathered rows only, not a weight GEMM
                return
            q = node.get("q", node.get("q_t"))
            nbytes += q.numel() * 3 + node["scale"].numel() * 4
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params)
    return (f"dequantize moves {nbytes} bytes a decode step (int8 read, "
            f"bf16 written): {nbytes / HBM_BYTES_S * 1e3:.3f} ms at "
            f"{HBM_BYTES_S / 1e12:.2f} TB/s")


def quantized_leaves(params):
    """The int8 leaves a decode step dequantizes, one ``dequant`` launch
    each: every weight and expert stack, and the table's gathered rows
    (at FULL width every GEMM weight is int8: Jamba's 193, its 48 expert
    stacks and the rows, 242)."""
    if isinstance(params, dict):
        if "q" in params or "q_t" in params:
            return 1
        return sum(quantized_leaves(v) for v in params.values())
    if isinstance(params, list):
        return sum(quantized_leaves(v) for v in params)
    return 0


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def archs_phase():
    """The archs served beyond SmolLM-360M.  SMOKE: the serve launcher's
    bare ``--verify`` (its default arch, qwen3_8b) and smoke6 on
    phi3_medium_14b, minitron_8b and rwkv6_3b (``--kv paged`` asked: the
    recurrent state stays dense).  FULL width, one model at a time, freed
    before the next, at ``SERVE_LAYERS`` layers but RWKV-6 3B (all 32: the
    layernorm kernel's served path), each replay through ``replay`` (launch counts, routes, a
    one-shot engine's bit-identity) and each model's decode step timed
    (3 slots at smoke6's positions; the attention decoders also 8 slots
    at 8 x 448's last positions): Qwen3-8B smoke6 dense and on bf16 pages
    of 16; Phi-3-medium smoke6 on bf16 pages; Minitron-8B smoke6 dense
    (6 gama_gemm launches a layer and the head's a step); the three attention decoders 8 x 448
    on bf16 pages; RWKV-6 3B smoke6 and 8 x 448 with ``kv="paged"`` asked
    (32 wkv6_state launches a step); SmolLM-360M and Phi-3-medium smoke6
    with int8 weights (the bytes their dequantization moves a step
    printed), SmolLM-360M's decode step with and without them in turns.
    Returns the launch counts of the replays."""
    set_gemm_mode("kernel")
    total = {n: 0 for n in K.KERNEL_COUNTERS}

    def add(counts):
        for n in total:
            total[n] += counts.get(n, 0)

    text, counts = _launcher(["--verify"])
    if "arch=qwen3-smoke" not in text:
        raise AssertionError("the bare launcher did not serve qwen3 SMOKE")
    for arch in ("phi3_medium_14b", "minitron_8b", "rwkv6_3b"):
        argv = ["--arch", arch, "--trace", "smoke6", "--batch_slots", "3",
                "--kv", "paged", "--page_size", "16", "--verify"]
        text, counts = _launcher(argv)
        rwkv = arch == "rwkv6_3b"
        must = (("gama_gemm", "wkv6_state") if rwkv else
                ("gama_gemm", "flash_attention", "rmsnorm",
                 "flash_paged_decode"))
        missing = [n for n in must if counts[n] == 0]
        if missing or (rwkv and "paged kv:" in text):
            raise AssertionError(f"launcher {argv}: kernels never launched "
                                 f"{missing}, or RWKV took the page pool")

    smoke6 = {}

    def trace_for(cfg):
        if cfg.vocab_size not in smoke6:
            smoke6[cfg.vocab_size] = S.load_trace(
                S.resolve_trace_path("smoke6"), cfg.vocab_size, seed=0)
        return smoke6[cfg.vocab_size]

    max_len = 36        # smoke6: 12-token prompts + 16 new + 8
    paged = dict(kv="paged", page_size=16)
    plans = (
        ("qwen3_8b", False, [("dense", ServeConfig(batch_slots=3,
                                                   max_len=max_len)),
                             ("paged-bf16", ServeConfig(
                                 batch_slots=3, max_len=max_len, **paged))]),
        ("phi3_medium_14b", False, [("paged-bf16", ServeConfig(
            batch_slots=3, max_len=max_len, **paged))]),
        ("minitron_8b", False, [("dense", ServeConfig(batch_slots=3,
                                                      max_len=max_len))]),
        ("rwkv6_3b", False, [("kv=paged asked", ServeConfig(
            batch_slots=3, max_len=max_len, **paged))]),
        ("phi3_medium_14b", True, [("int8 weights, paged-bf16", ServeConfig(
            batch_slots=3, max_len=max_len, quantize=True, **paged))]),
    )
    for name, quantize, paths in plans:
        t_model = time.perf_counter()
        # RWKV-6 3B at full depth: it is the layernorm kernel's served path.
        cfg = C.get(name) if name == "rwkv6_3b" else served(C.get(name))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=1, device=DEV, quantize=quantize)
        torch.cuda.synchronize()
        print(f"[archs] {cfg.name} FULL: layers={cfg.n_layers} d_model="
              f"{cfg.d_model} params={cfg.n_params()} int8_weights="
              f"{quantize} init_s={time.perf_counter() - t0:.1f} "
              f"memory_allocated={torch.cuda.memory_allocated()} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        for label, scfg in paths:
            counts, _, engine = replay(cfg, params, trace_for(cfg), scfg,
                                       f"{cfg.name} FULL {label} smoke6",
                                       warm=False)
            add(counts)
            kv_mode = engine.kv_mode
            del engine                  # it holds the parameters
            if name == "rwkv6_3b" and kv_mode != "dense":
                raise AssertionError("RWKV took the page pool")
        if not quantize:
            long8 = S.synth_trace(LONG_REQS, LONG_PROMPT, LONG_NEW, 3,
                                  cfg.vocab_size, seed=0)
            counts, _, _ = replay(cfg, params, long8, ServeConfig(
                batch_slots=LONG_REQS, max_len=LONG_LEN, **paged),
                f"{cfg.name} FULL "
                f"{'kv=paged asked' if name == 'rwkv6_3b' else 'paged-bf16'}"
                f" synth 8x448+32", warm=False)
            add(counts)
        _, _, per_step = decode_step_times(
            cfg, params, f"{cfg.name} FULL"
            + (" int8 weights" if quantize else ""))
        if quantize:
            print(f"[archs] {cfg.name} FULL int8 weights: "
                  + dequant_bytes(params))
        elif name != "rwkv6_3b":      # RWKV's state does not grow
            decode_step_times(cfg, params, f"{cfg.name} FULL", LONG_POS,
                              max_len=LONG_LEN)
        want = sum(c for _, _, c in cfg.gemm_shapes().values())
        if per_step.get("gama_gemm") != want:
            raise AssertionError(f"{cfg.name}: {per_step.get('gama_gemm')} "
                                 f"gama_gemm launches a decode step, "
                                 f"expected {want}")
        if per_step.get("dequant", 0) != (want + 1 if quantize else 0):
            raise AssertionError(f"{cfg.name}: {per_step.get('dequant')} "
                                 f"dequant launches a decode step, expected "
                                 f"one a GEMM weight and one for the "
                                 f"embedding rows ({want + 1}) with int8 "
                                 f"weights, else none")
        if name == "minitron_8b" and want != 6 * cfg.n_layers + 1:
            raise AssertionError(f"minitron-8b: {want} GEMM sites, not 6 a "
                                 f"layer (no gate) and the head")
        if name == "rwkv6_3b" and (
                per_step.get("wkv6_state") != cfg.n_layers
                or per_step.get("layernorm") != 3 * cfg.n_layers + 2):
            raise AssertionError(f"rwkv6-3b: {json.dumps(per_step)} a "
                                 f"decode step, expected {cfg.n_layers} "
                                 f"wkv6_state and {3 * cfg.n_layers + 2} "
                                 f"layernorm launches")
        del params
        _free()
        print(f"[archs] {cfg.name} FULL{' int8 weights' if quantize else ''}"
              f": {time.perf_counter() - t_model:.1f} s")

    # SmolLM-360M FULL with int8 weights: smoke6, then its decode step with
    # and without them, in turns.
    cfg = served(C.get("smollm_360m"))
    plain = init_params(cfg, seed=1, device=DEV)
    q = init_params(cfg, seed=1, device=DEV, quantize=True)
    counts, _, engine = replay(cfg, q, trace_for(cfg), ServeConfig(
        batch_slots=3, max_len=max_len, quantize=True),
        f"{cfg.name} FULL int8 weights dense smoke6", warm=False)
    add(counts)
    stats = engine.quant_stats
    del engine
    print(f"[archs] {cfg.name} FULL int8 weights: " + dequant_bytes(q))
    turns = {"bf16": [], "int8": []}
    for kind in ("bf16", "int8", "int8", "bf16"):
        wall, device, per_step = decode_step_times(
            cfg, plain if kind == "bf16" else q,
            f"{cfg.name} FULL {kind} weights (turn)")
        want = sum(c for _, _, c in cfg.gemm_shapes().values()) + 1
        if per_step.get("dequant", 0) != (want if kind == "int8" else 0):
            raise AssertionError(f"{cfg.name} {kind}: {json.dumps(per_step)}"
                                 f" a decode step, expected {want} dequant "
                                 f"launches with int8 weights, else none")
        turns[kind].append((round(wall, 3), None if device is None
                            else round(device, 3)))
    print(f"[archs] {cfg.name} FULL decode step (wall_ms, device_ms) in turns "
          f"bf16, int8, int8, bf16: {json.dumps(turns)}; int8 weights "
          f"{json.dumps(stats)}")
    del plain, q
    _free()
    return total


# ---------------------------------------------------------------------------
# MoE and Mamba: selective_scan, Jamba's GEMMs, the MoE archs served
# ---------------------------------------------------------------------------


def _scan_inputs(gen, b, t, di, n, dtype):
    """Mamba-like inputs: dt in the softplus'd bias range, A = -(1..N) per
    channel (the S4D-real init), a nonzero state."""
    dt = (torch.rand((b, t, di), generator=gen, device=DEV) * 0.099
          + 0.001).to(dtype)
    x, bm, c = (torch.randn(shape, generator=gen, device=DEV).to(dtype)
                for shape in ((b, t, di), (b, t, n), (b, t, n)))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=DEV)[None].repeat(
        di, 1)
    h0 = torch.randn((b, di, n), generator=gen, device=DEV) * 0.5
    return dt, x, bm, c, a, h0


def check_selective_scan(label, b, t, di, n, dtype, seed, main=False,
                         per_step=None, split=None):
    """selective_scan against its plain version (the per-token loop) from
    a nonzero state: in f32, y and the final state within 1e-5 * (1 +
    |plain|) (the same f32 operations, the contraction over N summed in
    another order); in bf16, y within one bf16 ulp, 2**-7 * |plain| +
    2**-16 (the floor covers the two f32 contractions' difference before
    the cast, the same sum over N in another order: the f32 cases measure
    it, about 1e-6 at these inputs, a tenth of the floor), and the f32 state
    within 1e-5 * (1 + |plain|).  A control in either dtype: h0 x 1.01
    must break those bounds.  Two calls repeat their bits, each
    sequence alone gives its rows of the batch bit for bit, and, given
    ``split``, the prompt as steps [0, split) then [split, T) with the
    state carried gives the whole call's y and state bit for bit.  The
    kernel's plan (``scan_plan``) is printed.  Timed beside
    its bound (dt, x, B, C, A and h0 read once, y and the state written
    once; 7 f32 operations a state a step) and the plain loop."""
    gen = _gen(seed)
    args = _scan_inputs(gen, b, t, di, n, dtype)
    y, h = scan_kernel(*args)
    y2, h2 = scan_kernel(*args)
    want_y, want_h = ops.selective_scan(*args, mode="ref")
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    tol_y, floor_y = (1e-5, None) if f32 else (2.0 ** -7, 2.0 ** -16)
    err_y = max_err(y, want_y, tol_y, floor_y)
    err_h = max_err(h, want_h, 1e-5)
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise AssertionError(f"selective_scan {label}: two runs differ")
    yc, hc = scan_kernel(*args[:5], args[5] * 1.01)
    caught = []
    for name, got, want, tol, floor in (("y", yc, want_y, tol_y, floor_y),
                                        ("hT", hc, want_h, 1e-5, None)):
        try:
            max_err(got, want, tol, floor)
        except AssertionError:
            caught.append(name)
    if not caught:
        raise AssertionError(f"selective_scan {label}: h0 * 1.01 passed "
                             f"the tolerance: the check cannot see h0")
    del yc, hc
    for i in range(b if b > 1 else 0):
        yi, hi = scan_kernel(*(v[i:i + 1] for v in args[:4]), args[4],
                             args[5][i:i + 1])
        if not (torch.equal(yi, y[i:i + 1]) and torch.equal(hi, h[i:i + 1])):
            raise AssertionError(f"selective_scan {label}: sequence {i} "
                                 f"alone differs from its rows of the batch")
    if split is not None:
        ya, ha = scan_kernel(*(v[:, :split] for v in args[:4]), *args[4:])
        yb, hb = scan_kernel(*(v[:, split:] for v in args[:4]), args[4], ha)
        if not (torch.equal(torch.cat([ya, yb], 1), y)
                and torch.equal(hb, h)):
            raise AssertionError(f"selective_scan {label}: the prompt split "
                                 f"at {split} differs from the whole")
        del ya, ha, yb, hb
    plan = scan_plan(di, n, dtype)
    del want_y, want_h, y2, h2
    e = y.element_size()
    nbytes = ((3 * b * t * di + 2 * b * t * n) * e + di * n * 4
              + 2 * b * di * n * 4)
    flops = 7.0 * b * t * di * n

    def mk(fn):
        def make():     # fresh inputs per copy, rotated past the L2
            fresh = _scan_inputs(gen, b, t, di, n, dtype)
            return lambda: fn(*fresh)
        return make

    kern = device_ms(mk(scan_kernel), nbytes)
    plain = device_ms(mk(ref.selective_scan), nbytes,
                      reps=24 if t <= 16 else 1)
    bms, by = bound(nbytes, flops, torch.float32)
    res = RESULTS["selective_scan"]
    res["max_abs_err"] = max(res["max_abs_err"], err_y, err_h)
    print(f"[kernel] selective_scan {label} B={b} T={t} di={di} N={n} "
          f"{'f32' if f32 else 'bf16'} h0=N(0,0.25) max_abs_err y="
          f"{err_y:.3e} (tol "
          + (f"{tol_y:g}*(1+|plain|)" if f32 else
             f"2^-7*|plain|+2^-16, one bf16 ulp")
          + f") hT={err_h:.3e} (tol 1e-5*(1+|plain|)) control: h0*1.01 "
          f"fails on {'+'.join(caught)}; repeat bits OK; "
          f"{'alone == batch rows bitwise; ' if b > 1 else ''}"
          + ("" if split is None else
             f"split {split}+{t - split} == whole bitwise; ")
          + f"plan={json.dumps(plan._asdict())} "
          f"kernel_ms={kern:.5f} plain_ms={plain:.5f} bound_ms={bms:.6f} "
          f"({by}: {nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP f32) "
          f"library_ms=null bound/kernel={bms / kern:.3f}"
          + ("" if per_step is None else
             f" launches_per_decode_step={per_step}"))
    if main:
        res.update(ms=kern, plain_ms=plain, library_ms=None, bound_ms=bms,
                   bound_by=by, shape=f"B={b} T={t} di={di} N={n} "
                   f"{'f32' if f32 else 'bf16'} from h0 ({label})")


def hybrid_kernel_phase():
    """The kernels at the shapes the MoE and Mamba archs serve: dequant
    at Jamba-v0.1 52B's int8 expert stacks (a scale per expert and
    column) into bf16 and at its router into f32; selective_scan at
    Jamba-v0.1 52B's decode (8 slots, d_inner 8192, 16
    states; the kernels line), a serial prompt (T = 11) and a 448-token
    one, in bf16 and f32, and the SMOKE config's 128 x 8 in f32;
    gama_gemm at every Jamba weight GEMM (in_proj, x_proj N = 288,
    dt_proj K = 256, out_proj, attention, the f32 router N = 16, the
    dense FFN, the head) at M = 2, 8 and 448 with its rows bitwise
    independent of M, and at the three SMOKE configs' f32 GEMMs."""
    jamba = C.get("jamba_v01_52b")
    mc = jamba.mamba
    di, n = mc.expand * jamba.d_model, mc.d_state
    n_mamba = sum(s.mixer == "mamba" for s in jamba.pattern) * jamba.n_groups
    n_moe = sum(s.ffn == "moe" for s in jamba.pattern) * jamba.n_groups
    e, f, d = jamba.moe.num_experts, jamba.moe.d_ff, jamba.d_model
    check_dequant(f"{jamba.name} expert gate/up", (e, d, f), (e, f),
                  torch.bfloat16, seed=95, per_step=2 * n_moe, reps=2)
    check_dequant(f"{jamba.name} expert down", (e, f, d), (e, d),
                  torch.bfloat16, seed=96, per_step=n_moe, reps=2)
    check_dequant(f"{jamba.name} router", (d, e), (e,), torch.float32,
                  seed=97, per_step=n_moe)
    _free()
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        check_selective_scan(f"decode-{tag}", LONG_REQS, 1, di, n, dtype,
                             seed=90, main=dtype == torch.bfloat16,
                             per_step=n_mamba)
        check_selective_scan(f"prompt-11-{tag}", 1, 11, di, n, dtype,
                             seed=91, split=5)
        check_selective_scan(f"prompt-448-{tag}", 1, LONG_PROMPT, di, n,
                             dtype, seed=92, split=200)
    smoke = C.get_smoke("jamba_v01_52b")
    sdi, sn = smoke.mamba.expand * smoke.d_model, smoke.mamba.d_state
    check_selective_scan("smoke-decode", 3, 1, sdi, sn, torch.float32,
                         seed=93)
    check_selective_scan("smoke-prompt", 1, 12, sdi, sn, torch.float32,
                         seed=94)
    for m in (2, LONG_REQS, LONG_PROMPT):
        for label, (k, n_, per_step) in jamba.gemm_shapes().items():
            dtype = jamba.gemm_dtype(label)
            check_gemm(f"{jamba.name}:{label}", m, k, n_, dtype, dtype, 1.0,
                       1e-4 if dtype == torch.float32 else 1e-2,
                       seed=m + k + n_ + 2,
                       per_step=per_step if m <= 16 else None)
    gemm_rows_independent([jamba], (2, LONG_REQS, LONG_PROMPT))
    for name in ("jamba_v01_52b", "kimi_k2_1t_a32b",
                 "llama4_maverick_400b_a17b"):
        arch = C.get_smoke(name)
        for m in (3, 12):
            for label, (k, n_, _) in arch.gemm_shapes().items():
                check_gemm(f"{arch.name}:{label}", m, k, n_, torch.float32,
                           torch.float32, 1.0, 1e-4, seed=m + k + n_ + 3)


@contextlib.contextmanager
def counting_drops(slots):
    """Count the MoE's dropped (token, expert) assignments while the block
    runs: ``moe.moe_ffn`` wrapped to tag each call by its input, (slots, 1,
    d) a decode step's and any other a prefill's (one slot's prompt, or
    a smaller batch), and ``moe.route`` wrapped so each call adds its
    drops to that kind's device tally (no host sync on the served path).
    Yields {"decode": [dropped, assigned], "prefill": [...]}, read
    (synchronised) after the block."""
    orig_ffn, orig_route = moe_mod.moe_ffn, moe_mod.route
    tally = {kind: [torch.zeros((), dtype=torch.long, device=DEV), 0]
             for kind in ("decode", "prefill")}
    kind = []

    def tagged(p, x, cfg, **kw):
        kind.append("decode" if tuple(x.shape[:2]) == (slots, 1)
                    else "prefill")
        try:
            return orig_ffn(p, x, cfg, **kw)
        finally:
            kind.pop()

    def counted(p, xg, cfg):
        r = orig_route(p, xg, cfg)
        t = tally[kind[-1]]
        t[0] += (~r.keep).sum()
        t[1] += r.keep.numel()
        return r

    moe_mod.moe_ffn, moe_mod.route = tagged, counted
    try:
        yield tally
    finally:
        moe_mod.moe_ffn, moe_mod.route = orig_ffn, orig_route
        for t in tally.values():
            t[0] = int(t[0])


def moe_rows_alone_equal_batch(cfg, params):
    """With the served weights of the first MoE layer: an 8-token decode
    batch whose routing drops nothing (the first of ten seeded draws that
    does not), each token's ``moe_ffn`` output alone ``torch.equal`` to
    its row of the batch (capacity 4 either way, so the expert products
    have one shape)."""
    specs = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    layer = next(i for i, s in enumerate(specs) if s.ffn == "moe")
    p = params["blocks"][layer]["moe"]
    for seed in range(10):
        x = torch.randn((LONG_REQS, 1, cfg.d_model), generator=_gen(100 + seed),
                        device=DEV).to(cfg.cdtype)
        if bool(moe_mod.route(p, x.reshape(1, LONG_REQS, -1),
                              cfg.moe).keep.all()):
            break
    else:
        raise AssertionError("no drop-free 8-token batch in ten draws")
    batch, _ = moe_mod.moe_ffn(p, x, cfg.moe, with_aux=False)
    for i in range(LONG_REQS):
        alone, _ = moe_mod.moe_ffn(p, x[i:i + 1], cfg.moe, with_aux=False)
        if not torch.equal(alone, batch[i:i + 1]):
            raise AssertionError(f"{cfg.name} layer {layer}: token {i}'s MoE "
                                 f"output alone differs from its batch row")
    print(f"[hybrid] {cfg.name} FULL int8 layer {layer} moe_ffn: each of "
          f"{LONG_REQS} tokens alone torch.equal to its row of the "
          f"drop-free batch (draw {seed}, capacity "
          f"{moe_mod.capacity(LONG_REQS, cfg.moe)} = "
          f"{moe_mod.capacity(1, cfg.moe)} alone) OK")


def hybrid_phase():
    """The MoE and Mamba archs served.  SMOKE through the serve launcher,
    each under ``--verify``: Jamba smoke6 dense and with ``--kv paged``
    asked (its state stays dense: no ``paged kv:`` line), Kimi-K2 and
    Llama-4 Maverick.  Jamba-v0.1 52B FULL (32 layers, int8 weights drawn
    from seed 1 and quantized layer by layer): its resident bytes and
    peak memory; the MoE rows check; smoke6 on 2 slots (4 assignments a
    decode step, never over capacity 4) under ``--verify``'s bit-identity
    check; the 8 x 448 trace on 8 slots twice, the two runs' tokens equal
    and the dropped assignments counted; one 8-slot decode step at 449-487
    positions (wall, device time, launches by kernel: 28 selective_scan,
    193 gama_gemm, 242 dequant, 4 flash_decode, 65 rmsnorm) with every
    route counter held to the launches.  Returns the replays' launch
    counts."""
    set_gemm_mode("kernel")
    total = {n: 0 for n in K.KERNEL_COUNTERS}

    def add(counts):
        for n in total:
            total[n] += counts.get(n, 0)

    for arch, kv in (("jamba_v01_52b", []),
                     ("jamba_v01_52b", ["--kv", "paged", "--page_size", "16"]),
                     ("kimi_k2_1t_a32b", []),
                     ("llama4_maverick_400b_a17b", [])):
        argv = ["--arch", arch, "--trace", "smoke6", "--batch_slots", "3",
                *kv, "--verify"]
        text, counts = _launcher(argv)
        must = ["gama_gemm", "flash_attention", "flash_decode", "rmsnorm"]
        if arch == "jamba_v01_52b":
            must.append("selective_scan")
        missing = [n for n in must if counts[n] == 0]
        if (missing or "paged kv:" in text or counts["flash_paged_decode"]
                or (arch != "jamba_v01_52b" and counts["selective_scan"])):
            raise AssertionError(f"launcher {argv}: kernels never launched "
                                 f"{missing}, or Jamba took the page pool")

    cfg = C.get("jamba_v01_52b")
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=1, device=DEV, quantize=True)
    torch.cuda.synchronize()
    print(f"[hybrid] {cfg.name} FULL: layers={cfg.n_layers} d_model="
          f"{cfg.d_model} params={cfg.n_params()} active_params="
          f"{cfg.n_active_params()} int8_weights=True init_s="
          f"{time.perf_counter() - t_model:.1f} resident_bytes="
          f"{torch.cuda.memory_allocated()} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} ({dequant_bytes(params)})")
    moe_rows_alone_equal_batch(cfg, params)
    smoke6 = S.load_trace(S.resolve_trace_path("smoke6"), cfg.vocab_size,
                          seed=0)
    with counting_drops(2) as drops:
        counts, _, _ = replay(cfg, params, smoke6, ServeConfig(
            batch_slots=2, max_len=36, quantize=True),
            f"{cfg.name} FULL int8 weights dense smoke6 (2 slots)",
            warm=False)
    add(counts)
    print(f"[hybrid] {cfg.name} FULL smoke6 on 2 slots: dropped / assigned "
          f"(token, expert) pairs {json.dumps(drops)}")
    if drops["decode"][0]:
        raise AssertionError("2 slots dropped at decode: 4 assignments "
                             "cannot exceed a capacity of 4")
    long8 = S.synth_trace(LONG_REQS, LONG_PROMPT, LONG_NEW, 3,
                          cfg.vocab_size, seed=0)
    scfg = ServeConfig(batch_slots=LONG_REQS, max_len=LONG_LEN, quantize=True)
    runs = []
    for i in range(2):
        with counting_drops(LONG_REQS) as drops:
            counts, rep, _ = replay(cfg, params, long8, scfg,
                                    f"{cfg.name} FULL int8 weights dense "
                                    f"synth 8x448+32 (run {i + 1})",
                                    verify=False, warm=False)
        add(counts)
        runs.append(rep["results"])
        print(f"[hybrid] {cfg.name} FULL 8x448 run {i + 1}: dropped / "
              f"assigned (token, expert) pairs {json.dumps(drops)}")
    if any(not (runs[0][k] == runs[1][k]).all() for k in runs[0]):
        raise AssertionError(f"{cfg.name} 8x448: the two runs' tokens differ")
    print(f"[hybrid] {cfg.name} FULL 8x448: both runs' tokens equal "
          f"({len(runs[0])} requests)")
    if drops["decode"][0] + drops["prefill"][0] == 0:
        S._verify(cfg, params, long8, runs[1], scfg)
    else:
        print(f"[hybrid] {cfg.name} FULL 8x448: the MoE dropped "
              f"assignments, so a batched stream may differ from its "
              f"one-slot stream by the reference's design (ROADMAP Queue "
              f"C); held by the two runs' equality instead of --verify")
    reg = obs.get_obs().registry
    reg.reset_values()
    K.reset_launch_counts()
    _, _, per_step = decode_step_times(cfg, params, f"{cfg.name} FULL int8",
                                       LONG_POS, max_len=LONG_LEN)
    torch.cuda.synchronize()
    check_routes(f"{cfg.name} decode steps", reg.snapshot(),
                 K.launch_counts())
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.n_groups
    gemms = sum(c for _, _, c in cfg.gemm_shapes().values())
    want = {"selective_scan": n_mamba, "gama_gemm": gemms,
            "dequant": quantized_leaves(params),
            "flash_decode": cfg.n_layers - n_mamba,
            "rmsnorm": 2 * cfg.n_layers + 1}
    got = {k: per_step.get(k, 0) for k in want}
    if got != want or set(per_step) - set(want):
        raise AssertionError(f"{cfg.name}: launches a decode step "
                             f"{json.dumps(per_step)}, expected "
                             f"{json.dumps(want)}")
    print(f"[hybrid] {cfg.name} FULL decode step launches by kernel "
          f"{json.dumps(per_step)} as expected; every ops.*.ref 0")
    del params
    _free()
    print(f"[hybrid] {cfg.name} FULL int8: {time.perf_counter() - t_model:.1f}"
          f" s")
    return total


# ---------------------------------------------------------------------------
# Enc-dec (SeamlessM4T-large-v2) and M-RoPE (Qwen2-VL-72B)
# ---------------------------------------------------------------------------

# SeamlessM4T-large-v2's encoder input: 448 frames of d_model a request
# (the speech frontend is a stub), drawn by numpy from a seed; the engine's
# cross cache holds ENC_LEN rows a slot.
ENC_LEN = 448
# The last decode steps of the 8 x 448 replay: lengths 449-487 against a
# LONG_LEN-row dense cache (the kernel phase's long_lens).
LONG_LENS = [LONG_PROMPT + 1 + (LONG_LEN - LONG_PROMPT - 2) * i // 7
             for i in range(8)]


def noncausal_rows_independent(hq, hkv, d, sq, sk, cut, seed):
    """Non-causal attention (an encoder, cross attention at prefill): a
    row's bits do not depend on the rows beside it.  The ``sq`` rows whole
    must equal, under torch.equal, rows [0, cut) and [cut, sq) computed
    apart against the same keys, and every row of a B=2 call the same row
    of each B=1 call."""
    gen = _gen(seed)
    q = _rand((2, hq, sq, d), torch.bfloat16, gen)
    k = _rand((2, hkv, sk, d), torch.bfloat16, gen)
    v = _rand((2, hkv, sk, d), torch.bfloat16, gen)
    whole = flash_attention(q, k, v, causal=False)
    parts = [flash_attention(q[:, :, lo:hi].contiguous(), k, v, causal=False)
             for lo, hi in ((0, cut), (cut, sq))]
    alone = [flash_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                             v[i:i + 1].contiguous(), causal=False)
             for i in range(2)]
    torch.cuda.synchronize()
    if not (torch.equal(torch.cat(parts, dim=2), whole)
            and all(torch.equal(a, whole[i:i + 1])
                    for i, a in enumerate(alone))):
        raise AssertionError(f"flash_attention causal=False: rows depend on "
                             f"the rows beside them (Hq={hq} D={d})")
    print(f"[kernel] flash_attention causal=False rows independent: Hq={hq} "
          f"Hkv={hkv} D={d} Sq={sq} Sk={sk}: whole == [0, {cut}) + "
          f"[{cut}, {sq}) and B=2 == B=1, torch.equal, OK")


def encdec_kernel_phase():
    """The kernels at the shapes SeamlessM4T-large-v2 (16 query heads over
    16 KV heads of 64: GQA group 1) and Qwen2-VL-72B (64 over 8 heads of
    128: group 8) serve, each against its plain version within the
    tolerance the earlier checks use, beside a control that must fail it,
    its bound and its library call: flash_attention without the causal
    mask at Seamless's encoder (448 x 448) and its cross attention at
    prefill (smoke6's 16-token and the 8 x 448 replay's 488-token bucket
    against 448 encoder rows), rows independent of their neighbours;
    Seamless's causal decoder prefill at group 1 and Qwen2-VL's 488 x 496
    at group 8; flash_decode at the cross attention's 8 slots of 448 rows
    and the self-attention's 449-487, both archs; flash_paged_decode at
    Qwen2-VL's 8 slots on bf16 pages of 16; gama_gemm at every decode and
    prefill GEMM of both (Seamless's lm head N = 256206, not a multiple of
    8, on the unaligned-B path; Qwen2-VL's K = 8192 x N = 29568 and
    152064) at M = 8 and the prefill Ms, rows independent of M; dequant at
    Qwen2-VL's int8 weights; and the SMOKE configs' f32 forms (D = 16,
    group 1 and group 4)."""
    sm, vl = C.get("seamless_m4t_large_v2"), C.get("qwen2_vl_72b")
    sms, vls = C.get_smoke("seamless_m4t_large_v2"), C.get_smoke(
        "qwen2_vl_72b")
    bf, f32 = torch.bfloat16, torch.float32
    hd = sm.d_head
    for label, sq, sk, causal, seed in (
            ("seamless-encoder", ENC_LEN, ENC_LEN, False, 90),
            ("seamless-cross-prefill-16", 16, ENC_LEN, False, 91),
            (f"seamless-cross-prefill-{LONG_LEN}", LONG_LEN, ENC_LEN, False,
             92),
            (f"seamless-self-prefill-{LONG_LEN}", LONG_LEN, LONG_LEN, True,
             93)):
        check_attention(label, 1, sm.n_heads, sm.n_kv_heads, sq, sk, hd, 0,
                        bf, 2e-2, seed=seed, causal=causal, control=True)
    noncausal_rows_independent(sm.n_heads, sm.n_kv_heads, hd, LONG_LEN,
                               ENC_LEN, 200, seed=94)
    long_cache = pages_for(LONG_LEN, 16) * 16
    check_attention(f"qwen2-vl-prefill-{LONG_LEN}", 1, vl.n_heads,
                    vl.n_kv_heads, LONG_LEN, long_cache, vl.d_head, 0, bf,
                    2e-2, seed=95, control=True)
    check_attention("qwen2-vl-prefill-16", 1, vl.n_heads, vl.n_kv_heads, 16,
                    36, vl.d_head, 0, bf, 2e-2, seed=96)
    check_attention("seamless-smoke-encoder", 1, sms.n_heads, sms.n_kv_heads,
                    12, 12, sms.d_head, 0, f32, 2e-5, seed=97, causal=False,
                    control=True)
    check_attention("seamless-smoke-cross", 1, sms.n_heads, sms.n_kv_heads,
                    16, 12, sms.d_head, 0, f32, 2e-5, seed=98, causal=False)
    check_attention("qwen2-vl-smoke-prefill", 1, vls.n_heads, vls.n_kv_heads,
                    16, 36, vls.d_head, 0, f32, 2e-5, seed=99, control=True)
    # Decode: the cross attention reads all 448 rows of every slot.
    check_decode("seamless-cross", sm.n_heads, sm.n_kv_heads, ENC_LEN, hd,
                 [ENC_LEN] * LONG_REQS, bf, 2e-2, seed=100, control=True)
    check_decode("seamless-self", sm.n_heads, sm.n_kv_heads, LONG_LEN, hd,
                 LONG_LENS, bf, 2e-2, seed=101, control=True)
    check_decode("qwen2-vl", vl.n_heads, vl.n_kv_heads, LONG_LEN, vl.d_head,
                 LONG_LENS, bf, 2e-2, seed=102, control=True)
    check_decode("seamless-smoke-cross", sms.n_heads, sms.n_kv_heads, 12,
                 sms.d_head, [12, 12, 12], f32, 2e-5, seed=103, control=True)
    check_decode("qwen2-vl-smoke", vls.n_heads, vls.n_kv_heads, 36,
                 vls.d_head, [28, 20, 13], f32, 2e-5, seed=104, control=True)
    check_paged_decode("qwen2-vl", vl.n_heads, vl.n_kv_heads, vl.d_head, 16,
                       LONG_LENS, "float", 2e-2, seed=105, control=True)
    check_paged_decode("qwen2-vl-smoke", vls.n_heads, vls.n_kv_heads,
                       vls.d_head, 16, [28, 20, 13], "float", 2e-5, seed=106,
                       dtype=f32, control=True)
    # GEMMs: every decode-step site at M = 8 (the kernels line's shapes),
    # the prefill sites at the prefill Ms (Seamless's encoder and cross K/V
    # at its 448 encoder rows), each lm head with a control.
    for arch, ms in ((sm, (8, 16, LONG_LEN)), (vl, (8, LONG_LEN))):
        decode = arch.gemm_shapes()
        for label, (k, n, per_step) in arch.gemm_shapes("prefill").items():
            for m in ((ENC_LEN,) if label not in decode else ms):
                check_gemm(f"{arch.name}:{label}", m, k, n, bf, bf, 1.0,
                           1e-2, seed=m + k + n + 2,
                           per_step=per_step if label in decode and m == 8
                           else None,
                           control=label == "lm_head" and m == 8)
    gemm_rows_independent([sm, vl], (8, 16, LONG_LEN))
    for arch in (sms, vls):
        for label, (k, n, _) in arch.gemm_shapes("prefill").items():
            check_gemm(f"{arch.name}:{label}", 3, k, n, f32, f32, 1.0, 1e-4,
                       seed=k + n + 3, control=label == "lm_head")
    # Qwen2-VL's int8 weights: the FFN's gate/up and down, the lm head (a
    # scale a column) and the table's gathered rows of a decode step.
    check_dequant("qwen2-vl-72b gate/up", (vl.d_model, vl.d_ff), (vl.d_ff,),
                  bf, seed=107, reps=4, control=True)
    check_dequant("qwen2-vl-72b down", (vl.d_ff, vl.d_model), (vl.d_model,),
                  bf, seed=108, reps=4)
    check_dequant("qwen2-vl-72b lm head", (vl.d_model, vl.vocab_size),
                  (vl.vocab_size,), bf, seed=109, reps=2)
    check_dequant("qwen2-vl-72b embedding rows", (LONG_REQS, 1, vl.d_model),
                  (vl.d_model,), bf, seed=110)


def encdec_replay(cfg, params, trace, encs, scfg, label):
    """One replay of an enc-dec model through the engine API (the launcher
    builds no encoder inputs, as the reference's): every request submitted
    at its step arrival with its encoder input ``encs[id]``, launch counts,
    the metrics registry and the tracer set to 0 just before and read just
    after, tokens checked, the route counters held to the launches, every
    stream then held bit for bit to a one-slot one-shot engine's
    ``generate(..., enc_embeds=)`` (``--verify``'s check).  Returns the
    launch counts."""
    engine = ServeEngine(cfg, params, scfg)
    bundle = obs.get_obs()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        bundle.registry.reset_values()
        bundle.tracer.clear()
        t0 = time.perf_counter()
        rids = {engine.submit(t["prompt"], t["max_new"], arrival=t["arrival"],
                              enc_embeds=encs[t["id"]]): t["id"]
                for t in trace}
        out = engine.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        metrics = bundle.registry.snapshot()
        stats = dict(engine.stats)
    finally:
        engine.close()
    routes = check_routes(label, metrics, counts)
    results = {rids[r]: toks for r, toks in out.items()}
    for t in trace:
        toks = results.get(t["id"])
        if toks is None or toks.shape != (t["max_new"],) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label} request {t['id']}: bad tokens "
                                 f"{toks}")
    missing = [n for n in ("gama_gemm", "flash_attention", "flash_decode",
                           "rmsnorm") if counts[n] == 0]
    if missing or counts["flash_paged_decode"] or engine.kv_mode != "dense":
        raise AssertionError(f"{label}: kernels never launched {missing}, or "
                             f"the cross cache took the page pool")
    hist = metrics["histograms"]
    tokens = sum(len(v) for v in results.values())
    print(f"[encdec] {label}: arch={cfg.name} layers={cfg.n_layers}+"
          f"{cfg.n_encoder_layers} d_model={cfg.d_model} dtype="
          f"{cfg.compute_dtype} slots={scfg.batch_slots} max_len="
          f"{scfg.max_len} enc_len={scfg.enc_len} kv_mode={engine.kv_mode} "
          f"requests={len(results)} tokens={tokens} wall_s={wall:.4f} "
          f"tok_s={tokens / wall:.2f} itl_p50_ms="
          f"{hist['serve.inter_token_ms']['p50']:.3f} itl_p99_ms="
          f"{hist['serve.inter_token_ms']['p99']:.3f} ttft_p50_ms="
          f"{hist['serve.ttft_ms']['p50']:.3f} prefills={stats['prefills']} "
          f"decode_steps={stats['decode_steps']} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()}")
    print(f"[encdec] {label}: launches {json.dumps(counts)} routes "
          f"{json.dumps(routes)}")
    one = ServeEngine(cfg, params, dataclasses.replace(
        scfg, batch_slots=1, kv="dense", prefill_chunk=0))
    try:
        bad = [t["id"] for t in trace if not np.array_equal(
            one.generate(t["prompt"][None, :], t["max_new"],
                         enc_embeds=encs[t["id"]])[0], results[t["id"]])]
    finally:
        one.close()
    if bad:
        raise AssertionError(f"{label}: VERIFY FAILED for ids {bad}")
    print(f"[encdec] {label}: verify OK: {len(trace)} requests bit-identical "
          f"to one-shot dense generate(enc_embeds=)")
    return counts


def encoder_device_ms(cfg, params, enc):
    """Device time of one request's encoder pass (24 layers over its
    ``enc`` frames, no causal mask), from ``torch.profiler``'s kernels,
    with its launches."""
    from repro_torch.models.model import _encode
    x = torch.from_numpy(enc).to(DEV)
    _encode(params, {"enc_embeds": x}, cfg)           # warm-up
    _, by_name, launched, lost = _profiled(
        lambda: _encode(params, {"enc_embeds": x}, cfg), "encoder",
        host=False)
    if not by_name or lost:
        return f"device time not measured ({_unmeasured(lost)})"
    ms = sum(us for _, us in by_name.values()) / 1e3
    return (f"device_ms={ms:.3f} launches "
            f"{json.dumps({k: v for k, v in launched.items() if v})}")


def encdec_phase():
    """SeamlessM4T-large-v2 FULL (24 encoder and 24 decoder layers, d_model
    1024, 16/16 heads of 64, vocab 256206, bf16, seed 1) through the
    engine API with ``enc_len = 448`` and each request's encoder input
    (1, 448, 1024) drawn by numpy from a seed: smoke6 on 3 slots and the
    8 x 448 trace on 8 slots, dense, each replay's routes held to its
    launches and every stream to a one-slot one-shot engine's; ``kv =
    "paged"`` asked (the cross cache bypasses the pool to dense, as the
    reference's); the 8-slot decode step at 449-487 (wall, device time,
    launches by kernel: 217 gama_gemm, 48 flash_decode (self and cross),
    73 rmsnorm); the encoder's device time a request.  Returns the replays'
    launch counts."""
    set_gemm_mode("kernel")
    total = {n: 0 for n in K.KERNEL_COUNTERS}
    cfg = C.get("seamless_m4t_large_v2")
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=1, device=DEV)
    torch.cuda.synchronize()
    print(f"[encdec] {cfg.name} FULL: layers={cfg.n_layers}+"
          f"{cfg.n_encoder_layers} d_model={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.d_head} vocab="
          f"{cfg.vocab_size} params={cfg.n_params()} init_s="
          f"{time.perf_counter() - t_model:.1f} resident_bytes="
          f"{torch.cuda.memory_allocated()} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()}")
    rng = np.random.default_rng(7)

    def encs(trace):
        return {t["id"]: rng.standard_normal(
            (1, ENC_LEN, cfg.d_model)).astype(np.float32) for t in trace}

    smoke6 = S.load_trace(S.resolve_trace_path("smoke6"), cfg.vocab_size,
                          seed=0)
    long8 = S.synth_trace(LONG_REQS, LONG_PROMPT, LONG_NEW, 3,
                          cfg.vocab_size, seed=0)
    for trace, scfg, label in (
            (smoke6, ServeConfig(batch_slots=3, max_len=36, enc_len=ENC_LEN),
             f"{cfg.name} FULL dense smoke6"),
            (long8, ServeConfig(batch_slots=LONG_REQS, max_len=LONG_LEN,
                                enc_len=ENC_LEN),
             f"{cfg.name} FULL dense synth 8x448+32")):
        counts = encdec_replay(cfg, params, trace, encs(trace), scfg, label)
        for n in total:
            total[n] += counts[n]
        _free()
    engine = ServeEngine(cfg, params, ServeConfig(
        batch_slots=3, max_len=36, enc_len=ENC_LEN, kv="paged",
        page_size=16))
    engine.close()
    if engine.kv_mode != "dense" or engine.pool is not None:
        raise AssertionError(f"{cfg.name}: kv='paged' took the page pool")
    print(f"[encdec] {cfg.name} kv='paged' asked: kv_mode={engine.kv_mode}; "
          f"[serve] paged kv bypassed: arch {cfg.name} has non-attention "
          f"state — dense layout in effect")
    reg = obs.get_obs().registry
    reg.reset_values()
    K.reset_launch_counts()
    _, _, per_step = decode_step_times(cfg, params, f"{cfg.name} FULL",
                                       LONG_POS, max_len=LONG_LEN,
                                       enc_len=ENC_LEN)
    torch.cuda.synchronize()
    check_routes(f"{cfg.name} decode steps", reg.snapshot(),
                 K.launch_counts())
    want = {"gama_gemm": sum(c for _, _, c in cfg.gemm_shapes().values()),
            "flash_decode": 2 * cfg.n_layers,
            "rmsnorm": 3 * cfg.n_layers + 1}
    if per_step != want:
        raise AssertionError(f"{cfg.name}: launches a decode step "
                             f"{json.dumps(per_step)}, expected "
                             f"{json.dumps(want)}")
    print(f"[encdec] {cfg.name} FULL decode step launches by kernel "
          f"{json.dumps(per_step)} as expected; every ops.*.ref 0")
    print(f"[encdec] {cfg.name} FULL encoder, one request of {ENC_LEN} "
          f"frames: {encoder_device_ms(cfg, params, encs(smoke6[:1])[0])}")
    del params
    _free()
    print(f"[encdec] {cfg.name} FULL: {time.perf_counter() - t_model:.1f} s")
    return total


@contextlib.contextmanager
def plain_route():
    """Every op of the models through its plain version on the card: the
    GEMMs as ``x @ w`` (gemm mode "ref"), attention, decode and the norms
    through ``ops.*(mode="ref")``."""
    with contextlib.ExitStack() as stack:
        for name in ("attention", "decode", "decode_paged", "rmsnorm",
                     "add_rmsnorm"):
            stack.enter_context(op_mode(name, "ref"))
        set_gemm_mode("ref")
        try:
            yield
        finally:
            set_gemm_mode("kernel")


def mrope_smoke_kernel_vs_plain():
    """Qwen2-VL SMOKE (f32, M-RoPE sections (4, 2, 2)) served from patch
    embeddings at the (t, h, w) positions of a 2-D patch grid (4 wide, 2
    high, a frame of 8), which the engine's text path (t == h == w) never
    runs: a prefill of 16 patches and 8 one-patch decode steps at their
    cache offsets, through the kernels, against the same calls through the
    plain route on the card, within 1e-4 (1 + |plain|); a control with the
    text positions (t, t, t) must fail it."""
    cfg = C.get_smoke("qwen2_vl_72b")
    params = init_params(cfg, seed=1, device=DEV)
    b, s, p_len = 2, 24, 16
    rng = np.random.default_rng(12)
    emb = torch.from_numpy(rng.standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)).to(DEV)
    i = np.arange(s)
    grid = np.stack([i // 8, (i // 4) % 2, i % 4], axis=-1)
    text = np.repeat(i[:, None], 3, axis=-1)

    def run(pos_np, plain):
        pos = torch.from_numpy(np.broadcast_to(pos_np, (b, s, 3)).astype(
            np.int32).copy()).to(DEV)
        caches = init_cache(cfg, b, s + 8, DEV)
        c0 = K.launch_counts()
        with plain_route() if plain else contextlib.nullcontext():
            outs = [forward(params, {"embeds": emb[:, :p_len],
                                     "positions": pos[:, :p_len]}, cfg,
                            caches=caches, cache_pos=0)[0]]
            for t in range(p_len, s):
                outs.append(forward(params, {"embeds": emb[:, t:t + 1],
                                             "positions": pos[:, t:t + 1]},
                                    cfg, caches=caches, cache_pos=t)[0])
        torch.cuda.synchronize()
        return (torch.cat(outs, dim=1),
                {n: c - c0[n] for n, c in K.launch_counts().items()
                 if c - c0[n]})

    kern, launched = run(grid, False)
    plain, plain_launched = run(grid, True)
    err = max_err(kern, plain, 1e-4)
    must_fail(f"{cfg.name} M-RoPE: the kernels at the grid positions against "
              f"the plain route at the text positions (t, t, t)", kern,
              run(text, True)[0], 1e-4)
    steps = s - p_len
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * steps}
    if (plain_launched or any(launched.get(k) != v for k, v in want.items())
            or not launched.get("gama_gemm") or not launched.get("rmsnorm")):
        raise AssertionError(f"{cfg.name} M-RoPE check: launches {launched} "
                             f"(kernels), {plain_launched} (plain route)")
    print(f"[vl] {cfg.name} SMOKE M-RoPE (t, h, w) grid positions, prefill "
          f"{p_len} patches + {steps} decode steps from embeds: kernels vs "
          f"plain route max_abs_err={err:.3e} tol=1e-4*(1+|plain|) OK; "
          f"launches {json.dumps(launched)} (plain route: none)")


def vl_phase():
    """The serve launcher's SMOKE runs of both ids (``launcher_encdec_vl``),
    then Qwen2-VL-72B FULL (80 layers, d_model 8192, 64/8 heads of 128,
    M-RoPE sections (16, 24, 24), vocab 152064) with int8 weights drawn
    from seed 1 and quantized leaf by leaf as they are drawn: its resident
    bytes and init peak first; the 8-slot decode step at 449-487 (wall,
    device time, launches by kernel: 561 gama_gemm, 562 dequant, 80
    flash_decode, 161 rmsnorm) with every route counter held to the
    launches; then, at full width and ``SERVE_LAYERS`` layers, smoke6 on
    3 slots under ``--verify``'s check and the 8 x 448 trace on 8 slots
    on dense KV and on bf16 pages of 16, the two runs' tokens equal; then
    the SMOKE config from patch embeddings at distinct (t, h, w)
    positions, kernels against the plain route.  Returns the replays'
    launch counts."""
    set_gemm_mode("kernel")
    total = {n: 0 for n in K.KERNEL_COUNTERS}

    def add(counts):
        for n in total:
            total[n] += counts.get(n, 0)

    launcher_encdec_vl()
    cfg = C.get("qwen2_vl_72b")
    _free()
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=1, device=DEV, quantize=True)
    torch.cuda.synchronize()
    free, card = torch.cuda.mem_get_info()
    print(f"[vl] {cfg.name} FULL: layers={cfg.n_layers} d_model="
          f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.d_head} "
          f"mrope_sections={cfg.mrope_sections} params={cfg.n_params()} "
          f"int8_weights=True init_s={time.perf_counter() - t_model:.1f} "
          f"resident_bytes={torch.cuda.memory_allocated() - base} "
          f"init_peak_bytes={torch.cuda.max_memory_allocated() - base} "
          f"card_bytes={card} free_bytes={free} ({dequant_bytes(params)})")
    _free()
    reg = obs.get_obs().registry
    reg.reset_values()
    K.reset_launch_counts()
    keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    before = torch.cuda.memory_stats()
    _, _, per_step = decode_step_times(cfg, params, f"{cfg.name} FULL int8",
                                       LONG_POS, max_len=LONG_LEN)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    # Near the card's capacity the caching allocator may free and allocate
    # device memory again inside a step (cudaFree waits for the device).
    print(f"[vl] {cfg.name} FULL decode steps timed above: allocator "
          + " ".join(f"{k}={after.get(k, 0) - before.get(k, 0)}"
                     for k in keys))
    check_routes(f"{cfg.name} decode steps", reg.snapshot(),
                 K.launch_counts())
    want = {"gama_gemm": sum(c for _, _, c in cfg.gemm_shapes().values()),
            "dequant": quantized_leaves(params),
            "flash_decode": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1}
    if per_step != want:
        raise AssertionError(f"{cfg.name}: launches a decode step "
                             f"{json.dumps(per_step)}, expected "
                             f"{json.dumps(want)}")
    print(f"[vl] {cfg.name} FULL decode step launches by kernel "
          f"{json.dumps(per_step)} as expected; every ops.*.ref 0")
    del params
    _free()

    # The replays at full width and SERVE_LAYERS layers.
    cfg = served(cfg)
    params = init_params(cfg, seed=1, device=DEV, quantize=True)
    smoke6 = S.load_trace(S.resolve_trace_path("smoke6"), cfg.vocab_size,
                          seed=0)
    counts, _, _ = replay(cfg, params, smoke6, ServeConfig(
        batch_slots=3, max_len=36, quantize=True),
        f"{cfg.name} FULL int8 weights dense smoke6", warm=False)
    add(counts)
    _free()
    long8 = S.synth_trace(LONG_REQS, LONG_PROMPT, LONG_NEW, 3,
                          cfg.vocab_size, seed=0)
    runs = {}
    for kv in ("dense", "paged"):
        counts, rep, _ = replay(
            cfg, params, long8, ServeConfig(
                batch_slots=LONG_REQS, max_len=LONG_LEN, quantize=True,
                kv=kv, page_size=16),
            f"{cfg.name} FULL int8 weights {kv} synth 8x448+32",
            verify=False, warm=False)
        add(counts)
        runs[kv] = rep["results"]
        del rep
        _free()
    if any(not np.array_equal(runs["dense"][k], runs["paged"][k])
           for k in runs["dense"]):
        raise AssertionError(f"{cfg.name} 8x448: paged tokens differ from "
                             f"dense")
    print(f"[vl] {cfg.name} FULL width, {cfg.n_layers} layers, 8x448: "
          f"bf16-paged tokens equal dense ({len(runs['dense'])} requests)")
    del params
    _free()
    print(f"[vl] {cfg.name} FULL int8: {time.perf_counter() - t_model:.1f} s")
    mrope_smoke_kernel_vs_plain()
    return total


def launcher_encdec_vl():
    """The serve launcher's SMOKE runs of both ids, as the reference
    launcher behaves: Qwen2-VL (text tokens at (t, t, t)) ends in ``verify
    OK``; SeamlessM4T builds no encoder inputs and fails at its first
    prefill with KeyError 'enc_embeds'."""
    text, counts = _launcher(["--arch", "qwen2_vl_72b", "--trace", "smoke6",
                              "--batch_slots", "3", "--verify"])
    if "verify OK" not in text or not counts["flash_decode"]:
        raise AssertionError("launcher qwen2_vl_72b SMOKE: no verify OK")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            S.main(["--arch", "seamless_m4t_large_v2", "--smoke", "--trace",
                    "smoke6", "--batch_slots", "3"])
    except KeyError as e:
        if e.args != ("enc_embeds",):
            raise
        print(f"[archs] launcher --arch seamless_m4t_large_v2 --smoke: "
              f"KeyError {e} at the first prefill, as the reference "
              f"launcher's")
    else:
        raise AssertionError("launcher seamless_m4t_large_v2 SMOKE served "
                             "without encoder inputs")


def main(argv=None) -> int:
    """No arguments: every phase (the full check).  ``--phases A,B``
    runs only the named phases (a partial run for development: it prints
    no kernels line and no ``ok`` line)."""
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--phases":
            print("usage: chip_smoke.py [--phases NAME,NAME,...]",
                  file=sys.stderr)
            return 2
        only = set(argv[1].split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    # Every phase but the Tune phase runs untuned, from an empty tuning
    # cache in a temporary directory: nothing reads or writes ~/.cache.
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["REPRO_TORCH_TUNING_CACHE"] = os.path.join(cache_dir,
                                                          "untuned.json")
    try:
        return _main(card, kind, only)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def ptxas_summary(logs, names):
    """One line per compiled kernel whose name holds one of ``names``:
    its registers a thread and spill bytes, from ``-Xptxas -v``."""
    out = []
    for log in logs.values():
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel, spill = m.group(1), ""
                continue
            if kernel and "spill" in line:
                spill = line.strip()
            m = re.search(r"Used (\d+) registers", line)
            if kernel and m:
                if any(n in kernel for n in names):
                    out.append(f"{kernel}: {m.group(1)} registers, {spill}")
                kernel = None
    return out


def _main(card, kind, only=None) -> int:
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    for name, log in logs.items():
        print(f"[build] {name}:\n{log.strip()}")
    print(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f}s")
    for line in ptxas_summary(logs, ("rmsnorm_kernel", "rmsnorm_wide",
                                     "rmsnorm_chunked",
                                     "selective_scan_bwd")):
        print(f"[build] {line}")

    cfg = C.get("smollm_360m")
    trace = S.load_trace(S.resolve_trace_path("smoke6"), cfg.vocab_size)
    max_len = max(len(t["prompt"]) + t["max_new"] for t in trace) + 8
    smoke_cfg = C.get_smoke("smollm_360m")
    smoke_trace = S.load_trace(S.resolve_trace_path("smoke6"),
                               smoke_cfg.vocab_size)
    smoke_len = max(len(t["prompt"]) + t["max_new"] for t in smoke_trace) + 8
    def timed(name, fn, *args):
        if only is not None and name not in only:
            return {}
        t = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f} s")
        return out

    timed("kernels", kernel_phase, cfg, max_len, smoke_len)
    timed("attention bwd kernels", attention_bwd_phase)
    timed("wkv kernels", wkv_phase)
    counts = dict(timed("serve SMOKE", smoke_serve_phase, smoke_cfg,
                        smoke_trace, smoke_len))
    for name, n in timed("serve FULL", serve_phase, served(cfg),
                         max_len).items():
        counts[name] = counts.get(name, 0) + n
    timed("archs kernels", archs_kernel_phase)
    for name, n in timed("serve archs", archs_phase).items():
        counts[name] = counts.get(name, 0) + n
    timed("hybrid kernels", hybrid_kernel_phase)
    for name, n in timed("serve hybrid", hybrid_phase).items():
        counts[name] = counts.get(name, 0) + n
    timed("encdec kernels", encdec_kernel_phase)
    for name, n in timed("serve encdec", encdec_phase).items():
        counts[name] = counts.get(name, 0) + n
    for name, n in timed("serve vl", vl_phase).items():
        counts[name] = counts.get(name, 0) + n
    for name, n in timed("tune", tune_phase, served(cfg)).items():
        counts[name] = counts.get(name, 0) + n
    for name, n in timed("train", train_phase).items():
        counts[name] = counts.get(name, 0) + n
    timed("train kernels vs plain", train_kernel_vs_plain)
    for name, n in timed("train attention", train_attention_phase).items():
        counts[name] = counts.get(name, 0) + n
    timed("trainer", trainer_phase)
    timed("scan bwd kernels", scan_bwd_phase)
    for name, n in timed("train jamba", train_jamba_phase).items():
        counts[name] = counts.get(name, 0) + n
    timed("attention bwd passes", bwd_pass_phase)
    print(f"[phase] total: {time.perf_counter() - t0:.1f} s")
    if only is not None:
        print(f"[phase] partial run of {sorted(only)}: no kernels line")
        return 0

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
