"""Shared layers: RMS, layer and group norms, rotary embeddings, the SwiGLU
MLP, embeddings, cross-entropy (counterpart of ``repro/models/layers.py``).

All layers are plain functions over dicts of tensors.  Every matmul goes
through :func:`gemm`, the GAMA integration point.  Every weight is
fetched through ``models.quant.maybe_dequant``, as in the reference: an
int8 ``{"q", "scale"}`` leaf is dequantized to the compute dtype, any
other weight cast to it.  For serving, dense weights and the embedding
table are in the compute dtype already (the bridge and ``init_params``
cast them once at load), so the cast is a no-op; training keeps them in
f32.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.quant import maybe_dequant

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# GEMM indirection — the GAMA integration point
# ---------------------------------------------------------------------------

# "auto" (kernel for CUDA tensors, plain version on the CPU) | "kernel" |
# "ref" (x @ w, a plain matrix product in the compute dtype, as the
# reference's "ref": it is differentiable, and the training launcher keeps
# it, as the reference's does) — set by set_gemm_mode.
_GEMM_MODE = "auto"


def set_gemm_mode(mode: str) -> None:
    global _GEMM_MODE
    if mode not in ops.MODES:
        raise ValueError(f"gemm mode must be one of {ops.MODES}, got {mode!r}")
    _GEMM_MODE = mode


@contextlib.contextmanager
def gemm_mode(mode: str):
    """``set_gemm_mode(mode)`` for the duration of a block; the mode that
    was set before is restored after it."""
    prev = _GEMM_MODE
    set_gemm_mode(mode)
    try:
        yield
    finally:
        set_gemm_mode(prev)


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) -> (..., N): ``x @ w`` in mode "ref", else
    ``ops.matmul`` (the GAMA kernel for CUDA tensors)."""
    if _GEMM_MODE == "ref":
        return x @ w
    lead = x.shape[:-1]
    out = ops.matmul(x.reshape(-1, x.shape[-1]).contiguous(), w,
                     mode=_GEMM_MODE)
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Initializers: the reference's distributions, drawn from a torch.Generator
# (torch cannot reproduce jax.random's bits; tests carry JAX's parameters
# across with bridge.params_from_numpy instead).
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, device="cpu",
               scale: Optional[float] = None) -> Params:
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    # Scaled in place: a weight of gigabytes (Qwen2-VL-72B's 5 GB f32 lm
    # head) needs no second copy; the values are those of ``* scale``.
    return {"w": _normal(gen, (d_in, d_out), dtype, device).mul_(scale)}


def norm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", dtype=torch.float32,
             device="cpu") -> Params:
    """SwiGLU draws gate, up, down; the non-gated FFN has no gate and
    draws up first, where the reference's draw order puts it (``up``
    takes ``r1``, gate's key under SwiGLU)."""
    if kind == "swiglu":
        return {"gate": dense_init(gen, d_model, d_ff, dtype, device),
                "up": dense_init(gen, d_model, d_ff, dtype, device),
                "down": dense_init(gen, d_ff, d_model, dtype, device)}
    return {"up": dense_init(gen, d_model, d_ff, dtype, device),
            "down": dense_init(gen, d_ff, d_model, dtype, device)}


def embedding_init(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32, device="cpu") -> Params:
    return {"table": _normal(gen, (vocab, d_model), dtype, device).mul_(0.02)}


# ---------------------------------------------------------------------------
# Dense, norms
# ---------------------------------------------------------------------------


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = gemm(x, maybe_dequant(p["w"], x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, as the reference: ``ops.rmsnorm``, the fixed-order
    kernel on the card and the plain version (float64 sums) on the CPU;
    both keep a row's output independent of the rows beside it, which
    batched decode and chunked prefill need for their bit-identity."""
    return ops.rmsnorm(x, p["scale"], eps=eps)


def add_rmsnorm(p: Params, x: torch.Tensor, r: torch.Tensor,
                eps: float = 1e-6):
    """The residual sum ``x + r`` and its RMSNorm, (s, rmsnorm(s)):
    ``ops.add_rmsnorm``, one launch of the rmsnorm kernel on the card."""
    return ops.add_rmsnorm(x, r, p["scale"], eps=eps)


def layernorm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, as the reference: ``ops.layernorm``,
    the fixed-order kernel on the card (a served row's bits do not depend
    on its batch; training differentiates it) and the plain version on the
    CPU."""
    return ops.layernorm(x, p["scale"], p["bias"], eps=eps)


def groupnorm(x: torch.Tensor, n_groups: int, scale: torch.Tensor,
              bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel dim with f32 statistics (RWKV's wkv
    output, one group per head), through ``ops.layernorm`` as above."""
    return ops.layernorm(x, scale, bias, eps=eps, groups=n_groups)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def _inv_freq(d_head: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, d_head: int,
                theta: float = 10000.0) -> torch.Tensor:
    """positions: (..., S) -> angles (..., S, d_head // 2), f32."""
    return (positions[..., None].float()
            * _inv_freq(d_head, theta, positions.device))


def mrope_angles(positions: torch.Tensor, d_head: int,
                 sections: Sequence[int],
                 theta: float = 10000.0) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): positions (..., S, 3) = (t, h, w) coordinates ->
    angles (..., S, d_head // 2), f32.  The d_head // 2 frequency slots
    split into ``sections`` (t, h, w sizes summing to d_head // 2), each
    rotating by its own coordinate; t == h == w is :func:`rope_angles`."""
    half = d_head // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"d_head // 2 = {half}")
    # Which coordinate (0 = t, 1 = h, 2 = w) each frequency slot rotates by.
    select = torch.repeat_interleave(
        torch.arange(3, device=positions.device),
        torch.tensor(tuple(sections), device=positions.device))
    return (positions[..., select].float()
            * _inv_freq(d_head, theta, positions.device))


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D // 2), broadcast over heads.
    The rotation runs in f32 (the reference's default)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP, embedding, unembedding
# ---------------------------------------------------------------------------


def mlp(p: Params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """SwiGLU, or (any other ``kind``, as the reference) the non-gated
    ``down(gelu(up(x)))`` with ``jax.nn.gelu``'s default tanh
    approximation."""
    if kind == "swiglu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        h = F.gelu(dense(p["up"], x), approximate="tanh")
    return dense(p["down"], h)


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of the table in ``dtype``.  ``F.embedding``: on the card its
    backward sums repeated tokens' gradients in a fixed order (sorted
    indices, no atomics), so a training step is reproducible.  An int8
    table is gathered first and only its rows are dequantized: the same
    values as the reference's whole-table dequantize, then gather."""
    table = p["table"]
    if isinstance(table, dict):
        rows = {"q": F.embedding(tokens, table["q"]),
                "scale": table["scale"]}
        return maybe_dequant(rows, dtype)
    return F.embedding(tokens, maybe_dequant(table, dtype))


def logits(p: Params, x: torch.Tensor, head: Optional[Params]) -> torch.Tensor:
    """Tied (embedding transposed) or separate head; f32 logits.  The GEMM
    runs in the compute dtype and is rounded to it before the f32 cast,
    as in the reference.  Served, the tied operand is ``p["table_t"]``,
    the (d_model, vocab) transpose that ``models.model.tie_head`` stores
    contiguously once, so no step transposes the table; for an int8
    table it is the int8 transpose with the table's per-column scales
    (``{"q_t", "scale"}``), dequantized per step to the same values as
    the reference's dequantized table, transposed.  The trained tree has
    no ``table_t``: the head reads ``p["table"]`` transposed, so its
    gradient and the embedding's add into the one leaf."""
    if head is not None:
        return dense(head, x).float()
    if "table_t" not in p:
        return gemm(x, maybe_dequant(p["table"], x.dtype).t()).float()
    t = p["table_t"]
    if isinstance(t, dict):      # a scale a row: (d, V, 1) codes by (d, 1)
        t = ops.dequantize(t["q_t"][..., None], t["scale"][:, None],
                           x.dtype)[..., 0]
    return gemm(x, maybe_dequant(t, x.dtype)).float()


def cross_entropy(logits_: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B, S, V) f32, labels (B, S) int."""
    logp = torch.log_softmax(logits_, dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.to(ll.dtype)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
