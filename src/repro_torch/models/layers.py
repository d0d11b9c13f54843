"""Shared layers: RMS, layer and group norms, rotary embeddings, the SwiGLU
MLP, embeddings, cross-entropy (counterpart of ``repro/models/layers.py``).

All layers are plain functions over dicts of tensors.  Every matmul goes
through :func:`gemm`, the GAMA integration point.  For serving, dense
weights and the embedding table are in the compute dtype already (the
bridge and ``init_params`` cast them once at load); training keeps them in
f32, and a weight of another dtype is cast per call, as the reference's
``maybe_dequant`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

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
    return {"w": _normal(gen, (d_in, d_out), dtype, device) * scale}


def norm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device="cpu") -> Params:
    return {"gate": dense_init(gen, d_model, d_ff, dtype, device),
            "up": dense_init(gen, d_model, d_ff, dtype, device),
            "down": dense_init(gen, d_ff, d_model, dtype, device)}


def embedding_init(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32, device="cpu") -> Params:
    return {"table": _normal(gen, (vocab, d_model), dtype, device) * 0.02}


# ---------------------------------------------------------------------------
# Dense, norms
# ---------------------------------------------------------------------------


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    y = gemm(x, w if w.dtype == x.dtype else w.to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, as the reference.  The mean of squares is summed
    in float64 and rounded once to f32.  torch's reduction kernels pick
    their thread layout from the number of rows in a call, so an f32 sum
    over one row may round differently in a batch of 1 and of 3; summed
    in float64, the order (almost never) reaches the f32 result.  That
    keeps a row's output independent of its batch, which the
    3-slot-vs-1-slot greedy bit-identity needs."""
    xf = x.float()
    var = xf.double().square().mean(-1, keepdim=True).float()
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, as the reference."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


def groupnorm(x: torch.Tensor, n_groups: int, scale: torch.Tensor,
              bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel dim with f32 statistics (RWKV's wkv
    output, one group per head)."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, n_groups, d // n_groups)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, d_head: int,
                theta: float = 10000.0) -> torch.Tensor:
    """positions: (..., S) -> angles (..., S, d_head // 2), f32."""
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=positions.device) / d_head
    inv_freq = 1.0 / (theta ** exponent)
    return positions[..., None].float() * inv_freq


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
    if kind != "swiglu":
        raise NotImplementedError(
            f"ffn_kind={kind!r}: only SwiGLU is ported (ROADMAP Queue A "
            f"item 10)")
    h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    return dense(p["down"], h)


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of the table in ``dtype``.  ``F.embedding``: on the card its
    backward sums repeated tokens' gradients in a fixed order (sorted
    indices, no atomics), so a training step is reproducible."""
    table = p["table"]
    return F.embedding(tokens, table if table.dtype == dtype
                       else table.to(dtype))


def logits(p: Params, x: torch.Tensor, head: Optional[Params]) -> torch.Tensor:
    """Tied (embedding transposed) or separate head; f32 logits.  The GEMM
    runs in the compute dtype and is rounded to it before the f32 cast,
    as in the reference.  The tied operand is ``p["table_t"]``, the
    (d_model, vocab) transpose that ``models.model.prepare_params`` stores
    contiguously once, so no step transposes the table."""
    if head is not None:
        return dense(head, x).float()
    if "table_t" not in p:
        raise KeyError("tied logits need embed['table_t']; build params with "
                       "models.init_params or bridge.params_from_numpy")
    t = p["table_t"]
    return gemm(x, t if t.dtype == x.dtype else t.to(x.dtype)).float()


def cross_entropy(logits_: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B, S, V) f32, labels (B, S) int."""
    logp = torch.log_softmax(logits_, dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.to(ll.dtype)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
