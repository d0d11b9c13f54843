"""Block stacks (counterpart of ``repro/models/transformer.py``) for the
``("attn", "dense")`` decoder block of this slice.

The reference stacks each pattern position's parameters over ``n_groups``
and runs them with ``lax.scan``; here a stack is a plain list with one
entry per layer, run by a Python loop.  Caches are per-layer lists too.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import BlockSpec, ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, Any]


def check_block(cfg: ModelConfig, spec: BlockSpec) -> None:
    if (spec.mixer, spec.ffn) != ("attn", "dense") or cfg.encoder_decoder \
            or cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.name}: block {spec} (norm={cfg.norm}, encoder_decoder="
            f"{cfg.encoder_decoder}) is not ported; only ('attn', 'dense') "
            f"rmsnorm decoders are (ROADMAP Queue A item 10)")


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               device: Union[str, torch.device] = "cpu") -> Params:
    check_block(cfg, spec)
    return {
        "ln1": L.norm_init(cfg.d_model, cfg.pdtype, device),
        "attn": A.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.d_head, cfg.qk_norm,
                                 cfg.pdtype, device),
        "ln2": L.norm_init(cfg.d_model, cfg.pdtype, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device),
    }


def apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                spec: BlockSpec, *, positions: Optional[torch.Tensor],
                cache: Optional[Cache] = None,
                cache_pos: Union[int, torch.Tensor, None] = None,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (x, cache updated in place)."""
    check_block(cfg, spec)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    out, _ = A.attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, positions=positions, rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections, qk_norm=cfg.qk_norm,
        causal=cfg.causal, cache=None if cache is None else cache["attn"],
        cache_pos=cache_pos, block_tables=block_tables)
    x = x + out
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    x = x + L.mlp(p["mlp"], h, cfg.ffn_kind)
    return x, cache


def layer_specs(cfg: ModelConfig) -> List[BlockSpec]:
    """The block spec of every layer, in order (pattern cycled)."""
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


def init_stack(gen: torch.Generator, cfg: ModelConfig,
               device: Union[str, torch.device] = "cpu") -> List[Params]:
    return [init_block(gen, cfg, spec, device) for spec in layer_specs(cfg)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: Union[str, torch.device] = "cpu",
                     paged: Optional[Tuple] = None) -> List[Cache]:
    """Per-layer KV caches.  ``paged=(num_pages, page_size[, kv_dtype])``
    swaps the dense (batch, Hkv, max_len, D) layout for page pools
    (``attention.init_paged_kv_cache``; ``batch`` and ``max_len`` are then
    ignored); the optional ``kv_dtype`` overrides the page dtype."""
    if paged is not None:
        return [{"attn": A.init_paged_kv_cache(
            paged[0], cfg.n_kv_heads, paged[1], cfg.d_head, cfg.kvdtype,
            kv_dtype=paged[2] if len(paged) > 2 else None, device=device)}
            for _ in layer_specs(cfg)]
    return [{"attn": A.init_kv_cache(batch, cfg.n_kv_heads, max_len,
                                     cfg.d_head, cfg.kvdtype, device)}
            for _ in layer_specs(cfg)]


def apply_stack(stack: List[Params], x: torch.Tensor, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor],
                caches: Optional[List[Cache]] = None,
                cache_pos: Union[int, torch.Tensor, None] = None,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
    """Run every layer in order.  Returns (x, caches updated in place)."""
    for i, (p, spec) in enumerate(zip(stack, layer_specs(cfg))):
        x, _ = apply_block(p, x, cfg, spec, positions=positions,
                           cache=None if caches is None else caches[i],
                           cache_pos=cache_pos, block_tables=block_tables)
    return x, caches
