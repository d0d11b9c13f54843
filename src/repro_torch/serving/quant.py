"""int8 quantization for serving (counterpart of
``repro/serving/quant.py``): KV pages, and the weight half, which lives
in ``models.quant`` (the model layer fetches every weight through it) and
is re-exported here.

**KV pages** (``kv_dtype="int8"``): beside each int8 pool tensor (P, Hkv,
page_size, D) lives an f32 *scale-row* tensor (P, Hkv, page_size): one
symmetric scale per token row per KV head.  Per-row scales make the
layout append-friendly: decode quantizes exactly the one row it writes,
and no existing row is ever requantized.  Dequantization (q * scale)
happens inside the paged decode kernel as each tile enters shared memory,
so int8 pages stream at one byte per value with no separate
dequantization pass.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.quant import (dequantize_weight,  # noqa: F401
                                      is_quantized, maybe_dequant,
                                      quantize_params, quantize_weight,
                                      weight_stats)

# -- int8 KV pages (kvpool kv_dtype="int8") ---------------------------------

KV_PAGE_DTYPES = ("int8", "bfloat16", "float32")


def quantize_kv_row(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the last (d_head) axis.

    (..., D) -> (q int8 (..., D), scale f32 (...,)).  ``torch.round``
    rounds half to even, as ``jnp.round`` does.  A zero row gets scale 0
    and dequantizes to exact zeros.
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_row`: (..., D) int8 and (...,) f32
    scales -> f32 values.  The paged decode kernel computes the same f32
    product."""
    return q.float() * scale[..., None]


def quantize_kv_pages(pages: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a whole pool: (P, Hkv, page_size, D) f32/bf16 ->
    (int8 pages, f32 scale rows (P, Hkv, page_size))."""
    return quantize_kv_row(pages)
