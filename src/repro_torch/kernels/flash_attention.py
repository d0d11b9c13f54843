"""Flash attention (forward), hand-written for Hopper
(``csrc/flash_attention.cu``).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:
flash_attention``: online-softmax attention with GQA (query head h reads
KV head h // group), causal masking at an absolute ``q_offset``, a
``kv_len`` mask, future KV tiles skipped, masked logits of -1e30 and a
zero-denominator guard.  ``q_offset`` and ``kv_len`` are runtime arguments.

bf16 runs on the tensor cores (``mma.sync`` for Q.K^T and P.V, K/V tiles
of :data:`KV_TILE` keys in a ``cp.async`` ring) at head dims 64 and 128;
f32 runs on a SIMT kernel (the tensor cores take f32 only as TF32) at 16,
64 and 128 (:data:`HEAD_DIMS`).  Prefill pads a prompt to a
power-of-two bucket from 16 tokens up to ``max_len`` (488 in the
8 x 448-token replay, against a 496-row scratch cache), so Sq runs from 16
to a few hundred: a few MFLOP per block, bound by latency rather than by
the MMA rate or the bytes of q, k and v.

:func:`plan` decides the launch: the route, the query rows of a block,
whether a block packs a GQA group's query heads (so their K/V tiles are
read once), and the ring's depth.  The KV tiles start at multiples of
:func:`kv_tile` from key 0, a width that depends on (D, dtype) only, and
each row passes through them in order, so a row's bits do not depend on
the plan, Sq, ``q_offset`` or B: a prompt prefilled whole or in chunks at
runtime offsets gives the same rows.

:func:`flash_attention` runs the plain version (``ref.ref_attention``,
:data:`plain`) for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  :data:`launches` counts kernel launches,
:data:`offset_launches` those at ``q_offset > 0``.

Training differentiates it through :class:`FlashAttention`: the forward
kernel also writes each row's log-sum-exp (``return_lse``; the output's
bits and the launch are serving's), and :func:`flash_attention_bwd`, the
hand-written backward (``csrc/flash_attention_bwd.cu``: FlashAttention-2's,
two passes, no atomics, so two calls give the same bits; bf16 on ``wgmma``
fed by TMA, both grids heaviest first across every (b, head, tile)),
computes dQ, dK and dV from it.  The reference trains by autodiff of its
jnp oracle (its Pallas kernel has no VJP); the backward replaces that
VJP for the one form training runs, causal at ``q_offset`` 0 over every
key.  :data:`bwd_launches` counts its calls (two kernels each).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_bwd as plain_bwd
from repro_torch.kernels.ref import ref_attention as plain

launches = 0
bwd_launches = 0
# Launches at q_offset > 0: chunked prefill's chunks after the first, and
# suffixes after a cached prefix.
offset_launches = 0

# Head dims each route takes: SmolLM (64) and Qwen3 (128) on both, the SMOKE
# configs' 16 on the f32 SIMT kernel only (they compute in f32).
HEAD_DIMS = {torch.float32: (16, 64, 128), torch.bfloat16: (64, 128)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"simt": 0, "tc": 1}

KV_TILE = 64             # keys per tile of the tensor-core kernel
SIMT_KV_TILE = 32        # ... and of the f32 SIMT kernel (common.cuh)
ROWS = (16, 32, 64)      # query rows per head in a tensor-core block
STAGES = (2, 4)          # KV tiles the ring may hold, least and most
MAX_WARPS = 8
SMEM_LIMIT = 232448      # shared memory one block may have on sm_90


class Plan(NamedTuple):
    route: str     # "tc": tensor cores (bf16); "simt": f32 FMA
    rows: int      # query rows of each head in a block (16 per warp)
    heads: int     # query heads in a block: 1, or the GQA group
    stages: int    # KV tiles in the shared-memory ring (1: SIMT)
    kv_tile: int   # keys per KV tile: kv_tile(D, dtype)


def check_head_dim(name: str, d: int, dtype: torch.dtype) -> None:
    """Raise unless the attention kernels take head dim ``d`` in
    ``dtype`` (:data:`HEAD_DIMS`)."""
    if dtype not in HEAD_DIMS:
        raise ValueError(f"{name} takes f32 or bf16, not {dtype}")
    if d not in HEAD_DIMS[dtype]:
        raise ValueError(f"{name} takes head dims {HEAD_DIMS[dtype]} in "
                         f"{dtype}, got {d}")


def kv_tile(d: int, dtype: torch.dtype) -> int:
    """Keys per KV tile: a function of (D, dtype) only, so the tiles a row
    passes through start at the same keys however the prompt is split."""
    check_head_dim("flash_attention", d, dtype)
    return SIMT_KV_TILE if dtype == torch.float32 else KV_TILE


def warps(p: Plan) -> int:
    return p.rows // 16 * p.heads


def smem_bytes(p: Plan, d: int) -> int:
    """Shared memory of a tensor-core block: each warp's 16 Q rows and
    ``stages`` K and V tiles, every row padded by 16 bytes."""
    pitch = 2 * d + 16
    return warps(p) * 16 * pitch + p.stages * 2 * p.kv_tile * pitch


def blocks(p: Plan, b: int, hq: int, sq: int) -> int:
    """Blocks one launch of ``p`` runs."""
    return b * (hq // p.heads) * -(-sq // p.rows)


@functools.lru_cache(maxsize=4096)
def plan(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
         dtype: torch.dtype) -> Plan:
    """The launch for q (b, hq, sq, d) against k/v (b, hkv, sk, d).

    f32 takes the SIMT kernel's one plan.  bf16 takes the tensor cores
    with 64-key tiles; the rest only decides which block computes a row
    (rules fitted to ``tools/attention_table.py --sweep`` on one H100):

    * 16 rows a head (one warp) up to sq = 16, 32 up to 32, else 64;
    * at sq <= 16 a block packs the GQA group's query heads, so K and V
      are read once per KV head (10-18% faster than a 16-row block per
      head at 16 x 48);
    * a ring of 3 tiles at D = 64 past two tiles of cache, else 2 (at
      D = 128 three stages leave one block an SM).

    Raises on shapes or dtypes the kernel does not take."""
    if min(b, hq, hkv, sq, sk) < 1:
        raise ValueError(f"flash_attention got an empty problem: b={b} "
                         f"hq={hq} hkv={hkv} sq={sq} sk={sk}")
    if hq % hkv:
        raise ValueError(f"GQA needs hq % hkv == 0, got hq={hq}, hkv={hkv}")
    tile = kv_tile(d, dtype)
    if dtype == torch.float32:
        return Plan("simt", 16, 1, 1, tile)
    group = hq // hkv
    rows = 16 if sq <= 16 else 32 if sq <= 32 else 64
    heads = group if sq <= 16 and group * rows // 16 <= MAX_WARPS else 1
    stages = 3 if d == 64 and sk > 2 * tile else 2
    return Plan("tc", rows, heads, stages, tile)


# flash_attention's ``plan`` argument shadows the function's name.
_default_plan = plan


def check_plan(p: Plan, hq: int, hkv: int, d: int,
               dtype: torch.dtype) -> None:
    """Raise unless the kernel takes ``p``: the rule ``flash_attention_
    launch`` in ``csrc/flash_attention.cu`` checks again on the card."""
    if not _plan_ok(p, hq, hkv, d, dtype):
        raise ValueError(f"flash_attention does not take {p} for hq={hq} "
                         f"hkv={hkv} d={d} {dtype}")


@functools.lru_cache(maxsize=4096)
def _plan_ok(p: Plan, hq: int, hkv: int, d: int, dtype: torch.dtype) -> bool:
    # Memoised: every prefill attention call checks its plan.
    tile = kv_tile(d, dtype)
    if dtype == torch.float32:
        return tuple(p) == ("simt", 16, 1, 1, tile)
    return (p.route == "tc" and p.kv_tile == tile and p.rows in ROWS
            and p.heads in (1, hq // hkv) and warps(p) <= MAX_WARPS
            and STAGES[0] <= p.stages <= STAGES[1]
            and smem_bytes(p, d) <= SMEM_LIMIT)


def candidates(hq: int, hkv: int, d: int, dtype: torch.dtype):
    """Every plan the kernel takes for these heads, head dim and dtype:
    the choices the tuner (``repro_torch.tuning``) and
    ``tools/attention_table.py --sweep`` time and check for equal bits.
    ``kv_tile`` is fixed by (D, dtype), so all of them give the same bits
    and a prompt gives the same rows whole or in chunks."""
    tile = kv_tile(d, dtype)
    if dtype == torch.float32:
        yield Plan("simt", 16, 1, 1, tile)
        return
    for heads in sorted({1, hq // hkv}):
        for rows in ROWS:
            for stages in range(STAGES[0], STAGES[1] + 1):
                p = Plan("tc", rows, heads, stages, tile)
                if (warps(p) <= MAX_WARPS
                        and smem_bytes(p, d) <= SMEM_LIMIT):
                    yield p


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """The checks every attention kernel makes before a launch: one CUDA
    device, one float dtype the kernel takes, contiguous storage."""
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.dtype for t in tensors}) != 1 or tensors[0].dtype not in _DTYPES:
        raise ValueError(f"{name} takes f32 or bf16 operands of one dtype, "
                         f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, p: Plan, *, causal: bool, scale: float,
           q_offset: int, kv_len: int,
           lse: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel with plan ``p`` into ``out`` (and each row's
    log-sum-exp into ``lse``, f32 (B, Hq, Sq), unless None; no checks
    beyond the kernel's own, which refuses a plan it does not take)."""
    global launches, offset_launches
    b, hq, sq, d = q.shape
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), b, hq,
        k.shape[1], sq, k.shape[2], d, _DTYPES[q.dtype], int(causal),
        int(q_offset), int(kv_len), float(scale), _ROUTES[p.route], p.rows,
        p.heads, p.stages, p.kv_tile,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", err)
    launches += 1
    offset_launches += int(q_offset > 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    plan: Optional[Plan] = None, return_lse: bool = False):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).
    ``plan`` is the launch (:func:`check_plan` refuses one the kernel does
    not take); None takes :func:`plan`'s.  ``return_lse``: (out, each
    row's log-sum-exp of its scaled logits (B, Hq, Sq) f32, +inf for a row
    with no valid key), what :func:`flash_attention_bwd` takes."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    kv_len = sk if kv_len is None else int(kv_len)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                     kv_len=kv_len, return_lse=return_lse)
    _build.refuse_autograd("flash_attention", q, k, v)
    check_cuda_operands("flash_attention", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len must lie in [0, {sk}], got {kv_len}")
    if plan is None:
        plan = _default_plan(b, hq, hkv, sq, sk, d, q.dtype)
    else:
        check_plan(plan, hq, hkv, d, q.dtype)
    if plan.route == "tc":
        # 16-byte cp.async needs 16-byte aligned rows: a view that starts
        # off that boundary is copied (the rows themselves, D * 2 bytes,
        # are multiples of 16).
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    launch(q, k, v, out, plan, causal=causal, scale=scale, q_offset=q_offset,
           kv_len=kv_len, lse=lse)
    return (out, lse) if return_lse else out


def check_bwd_form(causal: bool, q_offset: int, kv_len: Optional[int],
                   sq: int, sk: int) -> None:
    """Raise ``NotImplementedError`` unless the attention is the form
    :func:`flash_attention_bwd` takes: causal at ``q_offset`` 0, a query
    for every key, every key valid (training's self-attention)."""
    if not causal or q_offset != 0 or sq != sk or kv_len not in (None, sk):
        raise NotImplementedError(
            f"flash_attention_bwd takes causal self-attention at q_offset 0 "
            f"over every key (training's form), not causal={causal} "
            f"q_offset={q_offset} Sq={sq} Sk={sk} kv_len={kv_len}")


BWD_TILE = 64            # rows of a bf16 backward tile (the scratch pads to it)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *,
                        scale: Optional[float] = None, causal: bool = True,
                        q_offset: int = 0, kv_len: Optional[int] = None):
    """The VJP of causal :func:`flash_attention` at ``q_offset`` 0 (S
    queries, S keys): q, o, dout (B, Hq, S, D); k, v (B, Hkv, S, D); lse
    (B, Hq, S) f32 from ``return_lse`` -> (dq, dk, dv) in q's dtype, dk and
    dv summed over each KV head's query heads.  Any other form raises
    ``NotImplementedError`` (:func:`check_bwd_form`).  CPU tensors run
    :data:`plain_bwd`; CUDA tensors launch the kernel or raise."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    check_bwd_form(causal, q_offset, kv_len, s, k.shape[2])
    scale = d ** -0.5 if scale is None else float(scale)
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, dout)):
        return plain_bwd(q, k, v, o, lse, dout, scale=scale)
    check_cuda_operands("flash_attention_bwd", q, k, v, o, dout)
    check_head_dim("flash_attention_bwd", d, q.dtype)
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or o.shape != q.shape or dout.shape != q.shape or hq % hkv):
        raise ValueError(f"flash_attention_bwd shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, dout {tuple(dout.shape)}")
    if (lse.shape != (b, hq, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd needs lse ({b}, {hq}, {s}) "
                         f"f32, contiguous, on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    # TMA and 16-byte vector loads need 16-byte aligned operands.
    q, k, v, o, dout, lse = (t if t.data_ptr() % 16 == 0 else t.clone()
                             for t in (q, k, v, o, dout, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # The dQ pass's scratch for the dK/dV pass: delta a row (f32), and for
    # bf16 also lse in log2 units, rows padded to whole tiles.
    delta = torch.empty(
        (b, hq, s) if q.dtype == torch.float32 else
        (b, hq, 2, -(-s // BWD_TILE) * BWD_TILE),
        dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, s, d, _DTYPES[q.dtype],
        scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention_bwd", err)
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal self-attention at ``q_offset`` 0 (:func:`check_bwd_form`'s
    form, which the caller checks) with its hand-written backward, for
    training: the forward kernel (its plan as given) also writes the rows'
    log-sum-exp, and (q, k, v, o, lse) are saved; the backward is
    :func:`flash_attention_bwd`.  CPU tensors run both plain halves
    (``ref.ref_attention`` with ``return_lse``, ``ref.attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plan):
        o, lse = flash_attention(q, k, v, causal=True, scale=scale,
                                 plan=plan, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors,
                                         dout.contiguous(), scale=ctx.scale)
        return dq, dk, dv, None, None
