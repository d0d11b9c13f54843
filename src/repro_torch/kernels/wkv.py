"""WKV6, the RWKV-6 recurrence, forward and backward, hand-written for
Hopper (``csrc/wkv.cu``).

:func:`wkv6` replaces the Pallas kernel ``repro/kernels/wkv.py:wkv6``:
per (batch, head) an (N, N) f32 state from zero, y_t = r_t (S + diag(u)
k_t^T v_t), S <- diag(w_t) S + k_t^T v_t, with no padding of T.
:func:`wkv6_bwd` is its VJP as kernels of its own: the JAX package
differentiates through its ``pallas_call``, a launched CUDA kernel has no
autograd.  :class:`WKV6` ties the two into a ``torch.autograd.Function``.

Time is split into chunks of :func:`wkv_chunk` steps.  The decay is
diagonal, so each chunk's state from zero and its decay product are
computed in parallel, a scan over the chunks gives the state each chunk
starts from (and, backwards, the gradient each ends with), and every chunk
replays its own steps from there (``kernels/ref.py:ref_wkv_chunked`` and
``ref_wkv_bwd_chunked`` are the same phases in plain torch).  The scratch
holds one state per chunk boundary (:func:`scratch_floats`), never one
per step.  Bound on the card: 4 N^2 f32 operations per (b, h, t) forward
and 12 N^2 backward (5.0 and 15.0 us at B=8 H=40 T=64 N=64).

Each wrapper runs its plain version (:data:`plain`, :data:`plain_bwd`)
for CPU tensors only; for CUDA tensors it launches its kernels or raises.
:data:`launches` counts forward calls, :data:`bwd_launches` backward ones
(one call launches one to five CUDA kernels).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_wkv as plain
from repro_torch.kernels.ref import ref_wkv_bwd as plain_bwd

launches = 0
bwd_launches = 0

# FULL (head size 64, bf16 compute) is the training path.  Head size 16
# and f32 r/k/v are built only for rwkv6 SMOKE (head size 16, f32
# compute), which the training launcher and the restart check run on the
# card; chip_smoke.py holds that build against the plain versions too.
HEAD_SIZES = (16, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# A chunk is whole staged tiles of 16 steps (csrc/wkv.cu RowTile::TS; the
# walk's are 8 or 16), at most MAX_CHUNK steps: the backward keeps a state
# a tile of it in shared memory.
TILE_STEPS = 16
MAX_CHUNK = 128


def wkv_chunk(t: int, n: int, dtype: torch.dtype) -> int:
    """Steps per chunk for T steps of head size ``n`` in ``dtype``: a
    function of the shape and dtype only (never of the data or the card),
    so a shape launches the same kernels every time and a CUDA graph can
    hold them.  ``csrc/wkv.cu:wkv_chunk`` holds the same table, and the
    entry points refuse another value.  T <= chunk is one chunk: the
    serial algorithm, with no scratch.  128 at N = 64 (one chunk up to
    T = 128; the fastest at T = 4096), 16 at N = 16 (the SMOKE shapes'
    few (b, h) pairs need the split): ``tools/wkv_table.py --sweep``."""
    if n not in HEAD_SIZES or dtype not in _DTYPES or t <= 0:
        raise ValueError(f"wkv_chunk takes T > 0, head sizes {HEAD_SIZES} "
                         f"and dtypes {tuple(_DTYPES)}, got {t}, {n}, {dtype}")
    return 128 if n == 64 else 16


def n_chunks(t: int, chunk: int) -> int:
    return -(-t // chunk)


def scratch_floats(b: int, h: int, t: int, n: int, chunk: int,
                   backward: bool) -> int:
    """f32 scratch of one call: a state and a decay product per chunk
    boundary, (B*H*(C-1)*(N^2 + N)) forward; the backward has them in both
    directions and gu's partials per (b, h, chunk), B*H*C*N."""
    c = n_chunks(t, chunk)
    per = b * h * (c - 1) * (n * n + n)
    return 2 * per + b * h * c * n if backward else per


def blocks(b: int, h: int, t: int, n: int, chunk: int,
           backward: bool) -> Dict[str, int]:
    """The grid of each kernel one call launches (csrc/wkv.cu)."""
    c, bh = n_chunks(t, chunk), b * h
    out = {}
    if c > 1:
        dirs = 2 if backward else 1
        out["wkv6_walk_kernel (phase A)"] = dirs * (c - 1) * bh
        out["wkv6_scan_kernel"] = dirs * bh * max(1, n * n // 4 // 256)
    out["wkv6_walk_kernel"] = c * bh
    if backward:
        out["wkv6_rows_kernel"] = c * (n // 16) * bh
        out["wkv6_gu_reduce_kernel"] = -(-h * n // 128)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ``csrc/wkv.cu`` library."""
    fwd, bwd = lib.wkv6_fwd_launch, lib.wkv6_bwd_launch
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong]
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind(_build.load("wkv"))


def _check(name: str, r, k, v, w, u, *more: torch.Tensor) -> None:
    """The checks before a launch: one CUDA device, r/k/v (and gy) of one
    float dtype, w and u f32, the shapes, contiguity, 16-byte aligned
    rows (they are copied by cp.async) and the head size."""
    _build.refuse_autograd(name, r, k, v, w, u, *more)
    tensors = (r, k, v, w, u) + more
    dev = r.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    acts = (r, k, v) + more
    if len({t.dtype for t in acts}) != 1 or r.dtype not in _DTYPES:
        raise ValueError(f"{name} takes r, k, v (and gy) as f32 or bf16 of one "
                         f"dtype, got {[t.dtype for t in acts]}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"{name} takes w and u in f32, got {w.dtype}, "
                         f"{u.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w) + more):
        raise ValueError(f"{name} needs r, k, v, w (B, H, T, N) of one shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, h, t, n = r.shape
    if u.shape != (h, n):
        raise ValueError(f"{name} needs u ({h}, {n}), got {tuple(u.shape)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"{name} takes head sizes {HEAD_SIZES}, got {n}")
    if min(b, h, t) == 0:
        raise ValueError(f"{name} got an empty problem {tuple(r.shape)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} needs contiguous operands")
    if any(x.data_ptr() % 16 for x in (r, k, v, w) + more):
        raise ValueError(f"{name} needs r, k, v, w (and gy) 16-byte aligned")


def launch_fwd(lib: ctypes.CDLL, chunk: int, r, k, v, w, u,
               y: torch.Tensor) -> None:
    """Launch ``lib``'s forward into ``y`` with chunks of ``chunk`` steps
    (the library refuses a chunk its table does not give)."""
    b, h, t, n = r.shape
    scratch = torch.empty(scratch_floats(b, h, t, n, chunk, False),
                          dtype=torch.float32, device=r.device)
    err = lib.wkv6_fwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), scratch.data_ptr(), scratch.numel(), b, h, t, n,
        _DTYPES[r.dtype], chunk,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, "wkv6", err)


def launch_bwd(lib: ctypes.CDLL, chunk: int, r, k, v, w, u, gy, gr, gk, gv,
               gw, gu) -> None:
    """Launch ``lib``'s backward into (gr, gk, gv, gw, gu)."""
    b, h, t, n = r.shape
    scratch = torch.empty(scratch_floats(b, h, t, n, chunk, True),
                          dtype=torch.float32, device=r.device)
    err = lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        gy.data_ptr(), gr.data_ptr(), gk.data_ptr(), gv.data_ptr(),
        gw.data_ptr(), gu.data_ptr(), scratch.data_ptr(), scratch.numel(),
        b, h, t, n, _DTYPES[r.dtype], chunk,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, "wkv6", err)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> torch.Tensor:
    """r/k/v/w: (B, H, T, N); u: (H, N) -> y (B, H, T, N) in r's dtype."""
    if all(t.device.type == "cpu" for t in (r, k, v, w, u)):
        return plain(r, k, v, w, u)
    _check("wkv6", r, k, v, w, u)
    global launches
    _, _, t, n = r.shape
    y = torch.empty_like(r)
    launch_fwd(_lib(), wkv_chunk(t, n, r.dtype), r, k, v, w, u, y)
    launches += 1
    return y


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, gy: torch.Tensor
             ) -> Tuple[torch.Tensor, ...]:
    """The VJP of :func:`wkv6` for the output gradient gy (B, H, T, N) in
    r's dtype: (gr, gk, gv) in r's dtype, gw (B, H, T, N) and gu (H, N) in
    f32.  gu is summed over (b, t) in a fixed order: no atomics."""
    if all(t.device.type == "cpu" for t in (r, k, v, w, u, gy)):
        return plain_bwd(r, k, v, w, u, gy)
    _check("wkv6_bwd", r, k, v, w, u, gy)
    global bwd_launches
    _, _, t, n = r.shape
    gr, gk, gv = (torch.empty_like(x) for x in (r, k, v))
    gw = torch.empty_like(w)
    gu = torch.empty_like(u)
    launch_bwd(_lib(), wkv_chunk(t, n, r.dtype), r, k, v, w, u, gy, gr, gk,
               gv, gw, gu)
    bwd_launches += 1
    return gr, gk, gv, gw, gu


class WKV6(torch.autograd.Function):
    """wkv6 with its hand-written backward: CUDA tensors launch the
    forward's and the backward's kernels, CPU tensors run ``ref_wkv`` and
    ``ref_wkv_bwd``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return wkv6(r, k, v, w, u)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        gy = gy.contiguous()
        if gy.is_cuda and gy.data_ptr() % 16:   # cp.async copies 16 B
            gy = gy.clone()
        return wkv6_bwd(*ctx.saved_tensors, gy)
