"""Analytic prior over the design space (counterpart of
``repro/tuning/prior.py``).

For every op the #1 candidate is today's plan: ``analytic_gemm`` is
``kernels/gemm.py:plan``, ``analytic_attention`` is
``kernels/flash_attention.py:plan``, ``analytic_decode`` and
``analytic_wkv`` are ``decode_chunk`` and ``wkv_chunk``, and
``analytic_serve`` is the engine's default (8 slots, pages of 32,
monolithic, uncached).  A cold cache therefore dispatches exactly the
plans an untuned port launches.

The other GEMM and attention candidates are ranked by a model of the card
(:func:`card_seconds`): the launch's bound on ``core.hw.H100_SXM`` (the
larger of its bytes over the memory rate and its operations over the
peak of its input type, counting the padding of ragged tiles and one read
of A per column tile and of B per row tile) divided by the share of the
card's block slots its blocks fill.  A block slot is one resident block:
``SMS`` SMs, each holding as many blocks as its 228 KiB of shared memory
takes (1 KiB reserved a block, at most 32).  The last wave of a launch
that fills 1.3 waves leaves 0.7 of a wave idle: the model charges it as
idle.  Ties keep the kernel's own candidate order.  The model only orders
what is measured; the measurement decides.

Pack and serve are the reference's scores, copied: pure Python, the same
rankings and the same analytic answers.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core import hw
from repro_torch.kernels import decode_attention, flash_attention, gemm, wkv
from repro_torch.tuning.space import (AttentionCandidate, DecodeCandidate,
                                      DesignSpace, GemmCandidate,
                                      PackCandidate, ServeCandidate,
                                      WkvCandidate)

CARD = hw.H100_SXM
SMS = gemm.SMS
SM_SMEM = 233472         # shared memory of one SM on sm_90 (228 KiB)
BLOCK_RESERVED = 1024    # shared memory the runtime keeps for each block
MAX_RESIDENT = 32        # resident blocks an SM may hold

_PRECISION = {torch.bfloat16: hw.BF16_BF16, torch.float32: hw.F32_F32,
              torch.int8: hw.INT8_INT8}


def resident_blocks(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory one SM holds at once."""
    return max(1, min(MAX_RESIDENT, SM_SMEM // (smem + BLOCK_RESERVED)))


def card_seconds(nbytes: float, ops: float, dtype: torch.dtype, blocks: int,
                 smem: int) -> float:
    """Modelled time of a launch: its bound divided by the share of the
    card's block slots its waves fill (see the module docstring)."""
    bound = max(nbytes / CARD.hbm_bw, ops / CARD.peak_ops(_PRECISION[dtype]))
    slots = SMS * resident_blocks(smem)
    waves = -(-blocks // slots)
    return bound * waves * slots / blocks


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


def gemm_seconds(c: GemmCandidate, m: int, k: int, n: int,
                 dtype: torch.dtype) -> float:
    p = c.plan
    tm, tn = -(-m // p.bm), -(-n // p.bn)
    elt = dtype.itemsize
    nbytes = elt * (m * k * tn + k * n * tm) + elt * m * n
    ops = 2.0 * k * tm * p.bm * tn * p.bn
    smem = gemm.smem_bytes(p, dtype) if dtype != torch.float32 else 0
    return card_seconds(nbytes, ops, dtype, gemm.blocks(p, m, n), smem)


def analytic_gemm(m: int, k: int, n: int,
                  dtype: torch.dtype) -> GemmCandidate:
    """The cache-miss answer: ``kernels/gemm.py:plan``."""
    return GemmCandidate.from_plan(gemm.plan(m, k, n, dtype))


def prune_gemm(candidates: Sequence[GemmCandidate], m: int, k: int, n: int,
               dtype: torch.dtype, keep: int = 8) -> List[GemmCandidate]:
    """The analytic plan first, then the rest by :func:`gemm_seconds`."""
    first = analytic_gemm(m, k, n, dtype)
    rest = sorted((c for c in candidates if c != first),
                  key=lambda c: gemm_seconds(c, m, k, n, dtype))
    return ([first] + rest)[:max(1, keep)]


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def attention_seconds(c: AttentionCandidate, hq: int, hkv: int, sq: int,
                      sk: int, d: int, dtype: torch.dtype) -> float:
    """Causal prefill of one sequence: each query row reads the keys up to
    its own (half the keys on average), the rows padded to the block."""
    p = c.plan
    rows = -(-sq // p.rows) * p.rows
    elt = dtype.itemsize
    nbytes = elt * d * (2 * hq * sq + 2 * hkv * sk)
    ops = 4.0 * hq * rows * d * (sk - sq + (sq + 1) / 2)
    smem = (flash_attention.smem_bytes(p, d) if p.route == "tc" else 0)
    return card_seconds(nbytes, ops, dtype,
                        flash_attention.blocks(p, 1, hq, sq), smem)


def analytic_attention(hq: int, hkv: int, sq: int, sk: int, d: int,
                       dtype: torch.dtype) -> AttentionCandidate:
    """The cache-miss answer: ``kernels/flash_attention.py:plan``."""
    return AttentionCandidate.from_plan(
        flash_attention.plan(1, hq, hkv, sq, sk, d, dtype))


def prune_attention(candidates: Sequence[AttentionCandidate], hq: int,
                    hkv: int, sq: int, sk: int, d: int, dtype: torch.dtype,
                    keep: int = 6) -> List[AttentionCandidate]:
    """The analytic plan first, then the rest by
    :func:`attention_seconds`."""
    first = analytic_attention(hq, hkv, sq, sk, d, dtype)
    rest = sorted((c for c in candidates if c != first),
                  key=lambda c: attention_seconds(c, hq, hkv, sq, sk, d,
                                                  dtype))
    return ([first] + rest)[:max(1, keep)]


# ---------------------------------------------------------------------------
# Decode and WKV: one candidate each (see space.py)
# ---------------------------------------------------------------------------


def analytic_decode(sk: int, d: int, kv_dtype: torch.dtype) -> DecodeCandidate:
    """The cache-miss answer: ``decode_chunk(d, kv_dtype)``."""
    return DecodeCandidate(bk=decode_attention.decode_chunk(d, kv_dtype))


def prune_decode(candidates: Sequence[DecodeCandidate], sk: int, d: int,
                 keep: int = 4) -> List[DecodeCandidate]:
    return list(candidates)[:max(1, keep)]


def analytic_wkv(t: int, n: int, dtype: torch.dtype) -> WkvCandidate:
    """The cache-miss answer: ``wkv_chunk(t, n, dtype)``."""
    return WkvCandidate(chunk=wkv.wkv_chunk(t, n, dtype))


def prune_wkv(candidates: Sequence[WkvCandidate], t: int, n: int,
              keep: int = 4) -> List[WkvCandidate]:
    return list(candidates)[:max(1, keep)]


# ---------------------------------------------------------------------------
# Pack level (P x Q grid + stagger + reduce order): the reference's
# ---------------------------------------------------------------------------


def _cascade_steps(m: int, k: int, n: int, data_axis: int,
                   model_axis: int) -> dict:
    """step_s per cascade depth P, from the planner's KCE sweep (Fig. 6).
    P plays the paper's G (K shards), Q = model_axis / P plays X."""
    from repro_torch.core import planner
    site = planner.GemmSite("tuned", m=m, k=k, n=n)
    choices = planner.plan_cascade(site, data_axis, model_axis)
    return {c.g: c for c in choices}


def pack_step_model(choice, overlap: bool) -> float:
    """Modelled pack step time (s): the reduce after the full local GEMM
    is exposed; the K-streamed (overlapped) ring hides its
    reduce-scatter behind the p - 2 bands still computing, and the
    terminal all-gather stays exposed."""
    comp = max(choice.compute_s, choice.hbm_s)
    if choice.g == 1:
        return comp                       # no cross-device reduce
    rs = ag = choice.ici_s
    if not overlap:
        return comp + rs + ag
    hidden = comp * (choice.g - 2) / choice.g
    return comp + max(0.0, rs - hidden) + ag


def pack_score(c: PackCandidate, steps: dict) -> Tuple:
    """Sort key, higher = better: the overlap-aware modelled step time,
    then the schedule (for P > 1 the K-streamed staggered ring at offset
    1; P == 1 keeps psum)."""
    step = pack_step_model(steps[c.p], c.overlap)
    if c.p == 1:
        sched = 1 if (c.reduce == "psum" and c.stagger == 0) else 0
    else:
        sched = (4 if c.overlap else 0) \
            + (2 if c.reduce == "ring" else 0) \
            + (1 if c.stagger == 1 else 0)
    return (-round(step * 1e9), sched)


def prune_pack(candidates: Sequence[PackCandidate], m: int, k: int, n: int,
               data_axis: int, model_axis: int,
               keep: int = 6) -> List[PackCandidate]:
    steps = _cascade_steps(m, k, n, data_axis, model_axis)
    ranked = sorted(candidates, key=lambda c: pack_score(c, steps),
                    reverse=True)
    return ranked[:max(1, keep)]


def analytic_pack(m: int, k: int, n: int, data_axis: int,
                  model_axis: int) -> PackCandidate:
    """Cache-miss answer: the top of :func:`prune_pack`'s ranking."""
    steps = _cascade_steps(m, k, n, data_axis, model_axis)
    cands = DesignSpace.pack(m, k, n, model_axis)
    return max(cands, key=lambda c: pack_score(c, steps))


# ---------------------------------------------------------------------------
# Serving: the reference's
# ---------------------------------------------------------------------------

# Modelled fixed cost of one batched decode step, in per-token units: the
# dispatch and host overhead that slots amortize.
SERVE_STEP_OVERHEAD = 8.0


def serve_score(c: ServeCandidate, max_len: int) -> Tuple:
    """Sort key, higher = better: modelled tokens per step-second (slots
    amortize the fixed step cost), then the KV rows bound but dead per
    request (half the last page, or half of max_len dense; halved again
    for int8 pages), then fewer slots; chunked and prefix-cached
    candidates just below their monolithic and uncached twins, so they
    are measured and win only when faster."""
    thpt = c.slots / (SERVE_STEP_OVERHEAD + c.slots)
    waste = (c.page_size / 2) if c.page_size else (max_len / 2)
    if c.kv_dtype == "int8":
        waste /= 2
    return (round(thpt * 1e6), -waste, -c.slots, -c.prefill_chunk,
            -int(c.prefix_cache))


def prune_serve(candidates: Sequence[ServeCandidate], max_len: int,
                keep: int = 3) -> List[ServeCandidate]:
    ranked = sorted(candidates, key=lambda c: serve_score(c, max_len),
                    reverse=True)
    return ranked[:max(1, keep)]


def analytic_serve(max_len: int) -> ServeCandidate:
    """Cache-miss answer: the engine's default 8 slots, pages of 32 (used
    only when the engine runs paged), the cache dtype, monolithic prefill
    and no prefix cache: a miss never changes numerics or latency shape."""
    return ServeCandidate(slots=8, page_size=32)
