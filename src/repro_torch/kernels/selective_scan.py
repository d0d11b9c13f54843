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

:func:`selective_scan` runs the plain version (:data:`plain`) for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
:data:`launches` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan as plain

launches = 0

MAX_STATE = 16      # states a row, at most
STATES = 4          # states a thread walks
CHANNELS = 16       # channels of one sequence a block
STEPS = 8           # steps a tile of the time walk
RING = 4            # tiles of inputs in the ring
SMEM_LIMIT = 48 * 1024   # static shared memory a block may declare
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])


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

    def owner(self, block: int, thread: int) -> Tuple[int, int]:
        """(channel, first state) of ``thread`` in channel block
        ``block``: it walks states first .. first + STATES - 1; a channel
        >= di or a state >= N is padding."""
        return (block * self.channels + thread // self.lanes,
                thread % self.lanes * STATES)


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
    return lib


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x (B, T, di) and bm, c (B, T, N) in the compute dtype (f32 or
    bf16); a (di, N) and h0 (B, di, N) f32 -> (y (B, T, di) in x's dtype,
    the state after step T (B, di, N) f32, a new tensor).  The kernel is
    inference only: it raises if an input requires grad."""
    global launches
    tensors = (dt, x, bm, c, a, h0)
    b, t, di, n = check_shapes(*tensors)
    if all(v.device.type == "cpu" for v in tensors):
        return plain(*tensors)
    _build.refuse_autograd("selective_scan", *tensors)
    if not all(v.is_cuda and v.device == x.device for v in tensors):
        raise ValueError(f"selective_scan needs every input on one CUDA "
                         f"device, got {[str(v.device) for v in tensors]}")
    if x.dtype not in _DTYPES or any(v.dtype != x.dtype for v in (dt, bm, c)):
        raise ValueError(f"selective_scan takes dt, x, bm, c of one dtype, "
                         f"f32 or bf16, got "
                         f"{[v.dtype for v in (dt, x, bm, c)]}")
    if a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise ValueError(f"selective_scan needs a and h0 in f32, got "
                         f"{a.dtype} and {h0.dtype}")
    if b > 65535:
        raise ValueError(f"the selective_scan kernel takes B <= 65535, got "
                         f"B={b}")
    p = scan_plan(di, n, x.dtype)
    if t == 0:
        return torch.empty_like(x), h0.clone()
    dt, x, bm, c, a, h0 = (v.contiguous() for v in tensors)
    if p.wide:                       # 16-byte copies and moves
        dt, x, bm, c, a, h0 = (v if v.data_ptr() % 16 == 0 else v.clone()
                               for v in (dt, x, bm, c, a, h0))
    y = torch.empty_like(x)
    h_end = torch.empty_like(h0)
    lib = _lib()
    err = lib.selective_scan_launch(
        dt.data_ptr(), x.data_ptr(), bm.data_ptr(), c.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_end.data_ptr(), b, t,
        di, n, _DTYPES[x.dtype], p.lanes, p.channels, p.steps, int(p.wide),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "selective_scan", err)
    launches += 1
    return y, h_end
