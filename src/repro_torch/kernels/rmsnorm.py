"""RMSNorm and LayerNorm with a fixed reduction order, hand-written for
Hopper (``csrc/rmsnorm.cu``).

It has no Pallas counterpart: the reference normalises with jnp
(``repro/models/layers.py:103``).  The port needs a kernel for the bits,
not the speed: chunked prefill and batched decode hold a row's output to
be the same whatever else its call holds, and torch's reductions pick
their summation order from the shape of the call.  The kernel gives each
row to one warp that sums its squares in an order fixed by the row
length alone (see the source), and replaces torch's ~10 launches a norm
with one.  A lane loads its whole part of the row, with the compile-time
count of vectors :func:`rms_plan` gives, before any arithmetic.
:func:`add_rmsnorm` is the same kernel with the residual add fused in:
``s = x + r`` (torch's bits) written out and normalised, one launch where
the serve path would run two.

:func:`layernorm` is the same for RWKV-6's LayerNorm and GroupNorm,
whose rows must not depend on the batch either (``--verify`` holds a
batched decode to a one-slot one).  Its kernel reads a row once into
registers, spread over the threads :func:`ln_plan` gives (a function of
the row's width and dtype alone, so its summation order is too); a row
too wide for the registers is walked in chunks, in the same order.

:func:`rmsnorm` runs the plain version (:data:`plain`, float64 sums),
:func:`add_rmsnorm` its own (:data:`plain_add`), :func:`layernorm` its own
(:data:`plain_layernorm`, f32 as the reference), for CPU tensors only; for
CUDA tensors each launches its kernel or raises.  :data:`launches` counts
the rmsnorm kernel's launches, fused or not (:data:`fused_launches` those
with the add), :data:`ln_launches` the layernorm kernel's.
:class:`LayerNorm` is :func:`layernorm` with a gradient (RWKV-6 trains
through its norms), :class:`RMSNorm` :func:`rmsnorm` with one (the
attention decoders train through theirs): the kernel forward, the plain
expression's backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import add_rmsnorm as plain_add
from repro_torch.kernels.ref import layernorm as plain_layernorm
from repro_torch.kernels.ref import rmsnorm as plain

launches = 0
fused_launches = 0
ln_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])
_LN_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_void_p])
LN_MAX_PER = 8           # vectors a layernorm thread holds, at most
LN_MAX_THREADS = 256     # threads of a layernorm row, at most
RMS_ROWS = 2             # rows (one warp each) of an rmsnorm block
RMS_MAX_PER = 8          # vectors an rmsnorm lane holds in registers as f32
RMS_MAX_WIDE = 32        # ... a lane sums from shared memory (a wide row,
#                          4096-8192 bf16, loaded by a block of 128 threads)


class RmsPlan(NamedTuple):
    vec: int        # elements a vector: vec_width(d, dtype)
    per: int        # vectors a lane: lane l holds l, l + 32, ...
    rows: int       # rows a block (RMS_ROWS)

    @property
    def chunked(self) -> bool:
        """The row is walked in chunks of RMS_MAX_PER vectors a lane, twice,
        instead of held in registers (more than RMS_MAX_WIDE a lane)."""
        return self.per > RMS_MAX_WIDE


class LnPlan(NamedTuple):
    vec: int        # elements a vector: vec_width(w, dtype)
    threads: int    # threads a row (a power of two)
    per: int        # vectors a thread: thread t holds t, t + threads, ...


def vec_width(d: int, dtype: torch.dtype) -> int:
    """Elements a lane loads at once: 16 bytes' worth when the row is a
    whole number of them, else 1.  A function of (d, dtype) only, so a
    row is always summed in the same order; the kernel refuses another
    width."""
    if dtype not in _DTYPES:
        raise ValueError(f"rmsnorm takes f32 or bf16, got {dtype}")
    wide = 16 // torch.tensor([], dtype=dtype).element_size()
    return wide if d % wide == 0 else 1


def rms_plan(d: int, dtype: torch.dtype) -> RmsPlan:
    """How the rmsnorm kernel walks a row of ``d`` values: one warp a row,
    lane l its vectors l, l + 32, ..., ``per = ceil(d / vec / 32)`` of them
    (960 bf16: 4, held in registers, :data:`RMS_ROWS` rows a block; 4096
    bf16: 16, the row loaded by a block of 128 threads and the lane's
    vectors read back from shared memory, up to :data:`RMS_MAX_WIDE`; past
    that walked in chunks of :data:`RMS_MAX_PER`).  A function of (d,
    dtype) alone, so a row's sums run in one order whatever the call
    holds; the kernel refuses another plan."""
    if d < 1:
        raise ValueError(f"rmsnorm needs a row of at least one value, got "
                         f"d={d}")
    vec = vec_width(d, dtype)
    return RmsPlan(vec, -(-(d // vec) // 32), RMS_ROWS)


def ln_plan(w: int, dtype: torch.dtype) -> LnPlan:
    """How the layernorm kernel splits a row of ``w`` values: ``nv = w /
    vec`` vectors over ``threads`` threads, ``per`` each.  At most 32
    vectors: the largest power of two of threads <= nv (a GroupNorm row of
    64 bf16: 8 lanes, a warp 4 rows); more: the least power of two, at
    least 32, that leaves a thread at most :data:`LN_MAX_PER` (2560 bf16:
    64 threads of 5), but at most :data:`LN_MAX_THREADS`.  A row wider
    than ``LN_MAX_THREADS * LN_MAX_PER`` vectors (2561 bf16: 256 threads of
    11) leaves a thread more than :data:`LN_MAX_PER`, which it walks in
    chunks of that many, in the same order.  A function of (w, dtype)
    alone, so a row's sums run in one order whatever the call holds; the
    kernel refuses another split."""
    if w < 1:
        raise ValueError(f"layernorm needs a row of at least one value, got "
                         f"w={w}")
    vec = vec_width(w, dtype)
    nv = w // vec
    if nv <= 32:
        threads = 1 << (nv.bit_length() - 1)
    else:
        need = -(-nv // LN_MAX_PER)
        threads = min(LN_MAX_THREADS, max(32, 1 << (need - 1).bit_length()))
    return LnPlan(vec, threads, -(-nv // threads))


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    if lib.rmsnorm_launch.argtypes is None:
        lib.rmsnorm_launch.argtypes = _ARGTYPES
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib.layernorm_launch.argtypes = _LN_ARGTYPES
        lib.layernorm_launch.restype = ctypes.c_int
    return lib


def _aligned16(*tensors: torch.Tensor):
    """Each tensor, or a copy of it where it is off the 16-byte boundary
    (the kernels' vector loads)."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _rms_launch(x: torch.Tensor, r: Optional[torch.Tensor],
                scale: torch.Tensor, eps: float, name: str):
    """The checks and the launch of the rmsnorm kernel on CUDA tensors:
    (s or None, y)."""
    global launches, fused_launches
    inputs = (x, scale) if r is None else (x, r, scale)
    _build.refuse_autograd(name, *inputs)
    d = x.shape[-1]
    if not all(t.is_cuda and t.device == x.device for t in inputs):
        raise ValueError(f"{name} needs every input on one CUDA device, got "
                         f"{[str(t.device) for t in inputs]}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes f32 or bf16 x, got {x.dtype}")
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype):
        raise ValueError(f"{name} needs r of x's shape and dtype "
                         f"{tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(r.shape)} {r.dtype}")
    if scale.shape != (d,) or not scale.is_floating_point():
        raise ValueError(f"{name} needs a float scale of shape ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.numel() == 0:
        return (None if r is None else torch.empty_like(x),
                torch.empty_like(x))
    p = rms_plan(d, x.dtype)
    rows = x.reshape(-1, d).contiguous()
    res = None if r is None else r.reshape(-1, d).contiguous()
    scale = scale.float().contiguous()
    if p.vec > 1:                    # 16-byte vector loads
        rows, scale = _aligned16(rows, scale)
        if res is not None:
            (res,) = _aligned16(res)
    out = torch.empty_like(rows)
    total = None if r is None else torch.empty_like(rows)
    lib = _lib()
    err = lib.rmsnorm_launch(
        rows.data_ptr(), None if res is None else res.data_ptr(),
        scale.data_ptr(), None if total is None else total.data_ptr(),
        out.data_ptr(), rows.shape[0], d, _DTYPES[x.dtype], p.vec, p.per,
        p.rows, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "rmsnorm", err)
    launches += 1
    if r is not None:
        fused_launches += 1
    return (None if total is None else total.reshape(x.shape),
            out.reshape(x.shape))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) f32 or bf16; scale: (d,) -> x's shape and dtype."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return plain(x, scale, eps)
    return _rms_launch(x, None, scale, eps, "rmsnorm")[1]


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm that follows it, in one launch: x, r
    (..., d) of one dtype, f32 or bf16; scale (d,) -> (s = x + r, torch's
    bits, a new tensor; :func:`rmsnorm` of s)."""
    if all(t.device.type == "cpu" for t in (x, r, scale)):
        return plain_add(x, r, scale, eps)
    return _rms_launch(x, r, scale, eps, "add_rmsnorm")


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5, groups: int = 1) -> torch.Tensor:
    """x: (..., d) f32 or bf16; scale, bias: (d,) -> x's shape and dtype.
    ``groups`` > 1: a GroupNorm over ``groups`` consecutive slices of each
    row (the kernel's rows are the slices, each with its part of scale
    and bias).  A row (a slice) of any width: past
    ``LN_MAX_THREADS * LN_MAX_PER`` = 2048 vectors (16384 bf16 or 8192 f32
    values when w is a whole number of 16-byte vectors, else 2048 values)
    the kernel reads it three times instead of once (:func:`ln_plan`)."""
    global ln_launches
    if all(t.device.type == "cpu" for t in (x, scale, bias)):
        return plain_layernorm(x, scale, bias, eps, groups)
    _build.refuse_autograd("layernorm", x, scale, bias)
    d = x.shape[-1]
    if not (x.is_cuda and scale.device == x.device
            and bias.device == x.device):
        raise ValueError(f"layernorm needs x, scale and bias on one CUDA "
                         f"device, got {x.device}, {scale.device}, "
                         f"{bias.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"layernorm takes f32 or bf16 x, got {x.dtype}")
    if groups < 1 or d % groups:
        raise ValueError(f"layernorm: {groups} groups do not divide d={d}")
    if any(t.shape != (d,) or not t.is_floating_point()
           for t in (scale, bias)):
        raise ValueError(f"layernorm needs a float scale and bias of shape "
                         f"({d},), got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if x.numel() == 0:
        return torch.empty_like(x)
    w = d // groups
    rows = x.reshape(-1, w).contiguous()
    out = torch.empty_like(rows)
    p = ln_plan(w, x.dtype)
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    if p.vec > 1:                    # 16-byte vector loads of all three
        rows, scale, bias = _aligned16(rows, scale, bias)
    lib = _lib()
    err = lib.layernorm_launch(
        rows.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows.shape[0], w, groups, _DTYPES[x.dtype], p.vec, p.threads, p.per,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "rmsnorm", err)
    ln_launches += 1
    return out.reshape(x.shape)


def _plain_grads(ctx, gy, fn, *args):
    """The gradients of ``fn(*saved, *args)`` for ``gy``: the saved inputs
    detached, those that need a gradient marked, ``fn`` recomputed and
    differentiated; None for the others."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        y = fn(*inputs, *args)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wrt, gy))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


class RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm` with the gradient of :data:`plain`, as
    :class:`LayerNorm` for its norm: the reference differentiates its jnp
    norm (``repro/models/layers.py:103``).  The forward launches the
    kernel (grad mode is off inside it); the backward recomputes the plain
    expression from the saved inputs and differentiates it."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, gy):
        return (*_plain_grads(ctx, gy, plain, ctx.eps), None)


class LayerNorm(torch.autograd.Function):
    """:func:`layernorm` with the gradient of :data:`plain_layernorm`: the
    reference differentiates its jnp norm, and a norm is no TPU kernel
    with a VJP of its own to port.  The forward launches the kernel (it
    runs with grad mode off, so :func:`layernorm` takes it); the backward
    recomputes the plain expression from the saved inputs and
    differentiates it.  So training runs the same forward kernel as
    serving."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, groups):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.groups = eps, groups
        return layernorm(x, scale, bias, eps, groups)

    @staticmethod
    def backward(ctx, gy):
        return (*_plain_grads(ctx, gy, plain_layernorm, ctx.eps, ctx.groups),
                None, None)
