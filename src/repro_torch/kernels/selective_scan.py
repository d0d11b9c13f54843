"""Mamba's selective scan, hand-written for Hopper
(``csrc/selective_scan.cu``).

It has no Pallas counterpart: the reference runs the S6 recurrence in jnp
(``repro/models/mamba.py:83-114`` for a prompt, ``:151-154`` for decode)
and contracts the states with C (``:158``).  The port's Mamba mixer runs
it here for a prompt and for a decode step alike, one launch a layer: a
thread walks four states of one (sequence, channel) row over time, and a
thread per (channel, step) sums the contraction over N in a fixed order,
so a row's bits do not depend on the batch it rides in, nor on where a
prompt is split.  :func:`scan_plan` gives the launch's geometry, a
function of (di, N, dtype) alone; the kernel refuses any other.

:func:`selective_scan_bwd` is its VJP as kernels of its own (the JAX
package differentiates its jnp scan; a launched CUDA kernel has no
autograd): it walks each 8-step tile in reverse on the forward's thread
layout, recomputing the tile's states from the state the forward saved at
the tile's start (:func:`selective_scan_fwd` returns those, (B, ceil(T /
8) + 1, di, N) f32), sums gbm's and gc's terms over a block's channels and
then over a thread-block cluster of :data:`CLUSTER` blocks through
distributed shared memory, and adds one partial a cluster and
ga's per-sequence partials in a fixed order in a second, small kernel (no
atomics).  :class:`SelectiveScan` ties the two into a
``torch.autograd.Function``.

Each wrapper runs its plain version (:data:`plain`, :data:`plain_bwd`) for
CPU tensors only; for CUDA tensors it launches its kernels or raises.
:data:`launches` counts forward calls, :data:`bwd_launches` backward
ones (one backward call launches two CUDA kernels).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan as plain
from repro_torch.kernels.ref import selective_scan_bwd as plain_bwd

launches = 0
bwd_launches = 0

MAX_STATE = 16      # states a row, at most
STATES = 4          # states a thread walks
CHANNELS = 16       # channels of one sequence a block
STEPS = 8           # steps a tile of the time walk
RING = 4            # tiles of inputs in the ring
SMEM_LIMIT = 48 * 1024   # static shared memory a block may declare
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
CLUSTER = 8         # channel blocks whose channel sums one cluster adds


class ScanPlan(NamedTuple):
    lanes: int       # threads a channel, STATES states each: a power of 2
    channels: int    # channels a block (CHANNELS)
    steps: int       # steps a tile (STEPS)
    wide: bool       # rows of di and of N values are whole 16-byte chunks:
    #                  inputs staged by 16-byte cp.async, A and the state
    #                  moved 4 states at once; else plain loads, one by one
    smem: int        # shared bytes a block: the ring of inputs and hs

    @property
    def threads(self) -> int:
        return self.lanes * self.channels

    def blocks(self, di: int, batch: int) -> Tuple[int, int]:
        """The grid: (channel blocks, sequences)."""
        return -(-di // self.channels), batch

    def bwd_blocks(self, di: int, batch: int) -> Tuple[int, int]:
        """The backward's grid: the channel blocks rounded up to whole
        clusters of :data:`CLUSTER` (a block past di pads its cluster),
        sequences."""
        return _clusters(di) * CLUSTER, batch

    def owner(self, block: int, thread: int) -> Tuple[int, int]:
        """(channel, first state) of ``thread`` in channel block
        ``block``: it walks states first .. first + STATES - 1; a channel
        >= di or a state >= N is padding."""
        return (block * self.channels + thread // self.lanes,
                thread % self.lanes * STATES)


def _clusters(di: int) -> int:
    """The backward's clusters of CLUSTER channel blocks over di (64 at
    Jamba's 512 blocks)."""
    blocks = -(-di // CHANNELS)
    return -(-blocks // CLUSTER)


def scan_plan(di: int, n: int, dtype: torch.dtype) -> ScanPlan:
    """The kernel's geometry for rows of ``di`` channels and ``n`` states
    in ``dtype`` (f32 or bf16): a function of (di, n, dtype) alone, never
    of the batch, the length or the data, so the bits are too (they
    depend on none of it: every state's operations are the same in any
    plan).  ``csrc/selective_scan.cu`` holds the same rule and refuses
    another plan.  Raises for n outside 1..MAX_STATE."""
    if dtype not in _DTYPES:
        raise ValueError(f"selective_scan takes f32 or bf16, got {dtype}")
    if not 1 <= n <= MAX_STATE or di < 1:
        raise ValueError(f"the selective_scan kernel takes 1 <= N <= "
                         f"{MAX_STATE} states and di >= 1, got N={n}, "
                         f"di={di}")
    es = torch.tensor([], dtype=dtype).element_size()
    lanes = 1 << (-(-n // STATES) - 1).bit_length()
    nsp = lanes * STATES                            # N padded
    smem = (RING * 2 * STEPS * (CHANNELS + nsp) * es  # the ring
            + 2 * STEPS * (CHANNELS * nsp + 4) * 4)  # hs, two tiles
    return ScanPlan(lanes, CHANNELS, STEPS,
                    di * es % 16 == 0 and n * es % 16 == 0, smem)


def saved_states(t: int) -> int:
    """States the forward saves a sequence for the backward: one at each
    tile's start and the final one."""
    return -(-t // STEPS) + 1


def scratch_floats(b: int, t: int, di: int, n: int) -> int:
    """f32 scratch of one backward call: the sums over channels as one
    partial a cluster of channel blocks (gbm and gc, B x T x clusters x N
    each) and the sum over sequences as one a sequence (ga, B x di x N)."""
    return 2 * b * t * _clusters(di) * n + b * di * n


def check_shapes(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[int, int, int, int]:
    """(B, T, di, N) of a call; raises on inconsistent shapes."""
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"selective_scan needs dt and x (B, T, di) of one "
                         f"shape, got {tuple(dt.shape)} and "
                         f"{tuple(x.shape)}")
    b, t, di = dt.shape
    n = a.shape[-1] if a.dim() == 2 else -1
    if (a.shape != (di, n) or bm.shape != (b, t, n) or c.shape != (b, t, n)
            or h0.shape != (b, di, n)):
        raise ValueError(f"selective_scan needs bm, c (B={b}, T={t}, N), a "
                         f"(di={di}, N) and h0 (B, di, N), got "
                         f"{tuple(bm.shape)}, {tuple(c.shape)}, "
                         f"{tuple(a.shape)}, {tuple(h0.shape)}")
    return b, t, di, n


def _lib() -> ctypes.CDLL:
    lib = _build.load("selective_scan")
    if lib.selective_scan_launch.argtypes is None:
        lib.selective_scan_launch.argtypes = _ARGTYPES
        lib.selective_scan_launch.restype = ctypes.c_int
        lib.selective_scan_bwd_launch.argtypes = _BWD_ARGTYPES
        lib.selective_scan_bwd_launch.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, dt, x, bm, c, a, h0, *more: torch.Tensor) -> None:
    """The checks before a launch: no autograd, one CUDA device, dt, x,
    bm, c (and gy) of one dtype, f32 or bf16, a and h0 (and the states)
    in f32, B <= 65535."""
    tensors = (dt, x, bm, c, a, h0) + more
    _build.refuse_autograd(name, *tensors)
    if not all(v.is_cuda and v.device == x.device for v in tensors):
        raise ValueError(f"{name} needs every input on one CUDA device, got "
                         f"{[str(v.device) for v in tensors]}")
    if x.dtype not in _DTYPES or any(v.dtype != x.dtype for v in (dt, bm, c)):
        raise ValueError(f"{name} takes dt, x, bm, c of one dtype, f32 or "
                         f"bf16, got {[v.dtype for v in (dt, x, bm, c)]}")
    if a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise ValueError(f"{name} needs a and h0 in f32, got {a.dtype} and "
                         f"{h0.dtype}")
    if dt.shape[0] > 65535:
        raise ValueError(f"the {name} kernel takes B <= 65535, got "
                         f"B={dt.shape[0]}")


def _aligned(p: ScanPlan, *tensors: torch.Tensor):
    """Contiguous copies where needed; with a wide plan, 16-byte aligned
    ones too (16-byte copies and moves)."""
    out = (v.contiguous() for v in tensors)
    if not p.wide:
        return tuple(out)
    return tuple(v if v.data_ptr() % 16 == 0 else v.clone() for v in out)


def _forward(dt, x, bm, c, a, h0, save: bool):
    """Launch the forward; with ``save`` it also returns the states it
    saves for the backward (else None)."""
    global launches
    b, t, di, n = check_shapes(dt, x, bm, c, a, h0)
    _check_cuda("selective_scan", dt, x, bm, c, a, h0)
    p = scan_plan(di, n, x.dtype)
    if t == 0:
        return (torch.empty_like(x), h0.clone(),
                h0[:, None].clone() if save else None)
    dt, x, bm, c, a, h0 = _aligned(p, dt, x, bm, c, a, h0)
    y = torch.empty_like(x)
    h_end = torch.empty_like(h0)
    states = (torch.empty((b, saved_states(t), di, n), dtype=torch.float32,
                          device=x.device) if save else None)
    lib = _lib()
    err = lib.selective_scan_launch(
        dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_end.data_ptr(),
        None if states is None else states.data_ptr(), b, t, di, n,
        _DTYPES[x.dtype], p.lanes, p.channels, p.steps, int(p.wide),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "selective_scan", err)
    launches += 1
    return y, h_end, states


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x (B, T, di) and bm, c (B, T, N) in the compute dtype (f32 or
    bf16); a (di, N) and h0 (B, di, N) f32 -> (y (B, T, di) in x's dtype,
    the state after step T (B, di, N) f32, a new tensor).  It raises if
    an input requires grad: training goes through :class:`SelectiveScan`."""
    tensors = (dt, x, bm, c, a, h0)
    check_shapes(*tensors)
    if all(v.device.type == "cpu" for v in tensors):
        return plain(*tensors)
    return _forward(*tensors, save=False)[:2]


def selective_scan_fwd(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`selective_scan` that also returns the states
    :func:`selective_scan_bwd` starts its tiles from on the card: (B,
    ceil(T / 8) + 1, di, N) f32, the state entering each 8-step tile and
    the final one; y and the final state are :func:`selective_scan`'s
    bits.  CPU tensors: the plain forward, and None for the states (the
    plain backward recomputes every state)."""
    if all(v.device.type == "cpu" for v in (dt, x, bm, c, a, h0)):
        return (*selective_scan(dt, x, bm, c, a, h0), None)
    return _forward(dt, x, bm, c, a, h0, save=True)


def selective_scan_bwd(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                       gy: torch.Tensor, states: Optional[torch.Tensor] = None,
                       ght: Optional[torch.Tensor] = None, need_gh0: bool = True):
    """The VJP of :func:`selective_scan` for gy (B, T, di) in x's dtype and
    the final state's ght (B, di, N) f32 (None: 0): (gdt, gx, gbm, gc in
    their inputs' dtype, ga (di, N) f32, gh0 (B, di, N) f32, or None
    without ``need_gh0``).  On CUDA tensors ``states`` must be
    :func:`selective_scan_fwd`'s for the same inputs; the CPU runs
    :data:`plain_bwd` and ignores it.  The sums over channels (gbm, gc)
    and over sequences and steps (ga) are taken in a fixed order: two
    calls give the same bits, and a sequence's gdt, gx, gbm and gc rows
    do not depend on the rest of the batch."""
    global bwd_launches
    b, t, di, n = check_shapes(dt, x, bm, c, a, h0)
    if gy.shape != x.shape:
        raise ValueError(f"selective_scan_bwd needs gy of x's shape "
                         f"{tuple(x.shape)}, got {tuple(gy.shape)}")
    if ght is not None and ght.shape != h0.shape:
        raise ValueError(f"selective_scan_bwd needs ght of h0's shape "
                         f"{tuple(h0.shape)}, got {tuple(ght.shape)}")
    tensors = (dt, x, bm, c, a, h0, gy) + (() if ght is None else (ght,))
    if all(v.device.type == "cpu" for v in tensors):
        out = plain_bwd(dt, x, bm, c, a, h0, gy, ght)
        return out if need_gh0 else out[:5] + (None,)
    if states is None or states.shape != (b, saved_states(t), di, n):
        raise ValueError(f"selective_scan_bwd on the card needs the states "
                         f"selective_scan_fwd saved, ({b}, "
                         f"{saved_states(t)}, {di}, {n}) f32, got "
                         f"{None if states is None else tuple(states.shape)}")
    _check_cuda("selective_scan_bwd", dt, x, bm, c, a, h0, states,
                *(() if ght is None else (ght,)))
    if gy.dtype != x.dtype or states.dtype != torch.float32 or (
            ght is not None and ght.dtype != torch.float32):
        raise ValueError(f"selective_scan_bwd takes gy in x's dtype and the "
                         f"states and ght in f32, got {gy.dtype}, "
                         f"{states.dtype}, "
                         f"{None if ght is None else ght.dtype}")
    p = scan_plan(di, n, x.dtype)
    gdt, gx, gbm, gc = (torch.empty_like(v) for v in (dt, x, bm, c))
    ga = torch.empty_like(a)
    gh0 = torch.empty_like(h0) if need_gh0 else None
    if t == 0:
        gh0 = None if gh0 is None else (
            torch.zeros_like(h0) if ght is None else ght.clone())
        return gdt, gx, gbm, gc, ga.zero_(), gh0
    dt, x, bm, c, a, states, gy = _aligned(p, dt, x, bm, c, a, states, gy)
    if ght is not None:
        (ght,) = _aligned(p, ght)
    scratch = torch.empty(scratch_floats(b, t, di, n), dtype=torch.float32,
                          device=x.device)
    lib = _lib()
    err = lib.selective_scan_bwd_launch(
        dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
        a.data_ptr(), states.data_ptr(), gy.data_ptr(),
        None if ght is None else ght.data_ptr(), gdt.data_ptr(),
        gx.data_ptr(), gbm.data_ptr(), gc.data_ptr(), ga.data_ptr(),
        None if gh0 is None else gh0.data_ptr(), scratch.data_ptr(),
        scratch.numel(), b, t, di, n, _DTYPES[x.dtype], p.lanes, p.channels,
        p.steps, int(p.wide), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "selective_scan", err)
    bwd_launches += 1
    return gdt, gx, gbm, gc, ga, gh0


class SelectiveScan(torch.autograd.Function):
    """The selective scan with its hand-written backward: CUDA tensors
    launch :func:`selective_scan_fwd` (saving the tile states through
    ``ctx.save_for_backward``, so a checkpoint recomputes them with the
    rest) and :func:`selective_scan_bwd`; CPU tensors run the plain
    forward and ``ref.selective_scan_bwd``.  Returns (y, hT); hT's gradient
    is taken when the caller uses it (a carried state)."""

    @staticmethod
    def forward(ctx, dt, x, bm, c, a, h0):
        ctx.set_materialize_grads(False)
        y, h_end, states = selective_scan_fwd(dt, x, bm, c, a, h0)
        ctx.save_for_backward(dt, x, bm, c, a, h0, states)
        return y, h_end

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, ght):
        dt, x, bm, c, a, h0, states = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        return selective_scan_bwd(dt, x, bm, c, a, h0, gy.contiguous(),
                                  states, ght,
                                  need_gh0=ctx.needs_input_grad[5])
