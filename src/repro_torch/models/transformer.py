"""Block stacks (counterpart of ``repro/models/transformer.py``) for the
``("attn", "dense")`` decoder block (RMSNorm) and the RWKV-6
``("rwkv", "rwkv_cm")`` block (LayerNorm).

The reference stacks each pattern position's parameters over ``n_groups``
and runs them with ``lax.scan``; here a stack is a plain list with one
entry per layer, run by a Python loop.  Caches are per-layer lists too.
Training's rematerialisation wraps layers or sub-blocks in
``torch.utils.checkpoint``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models.config import BlockSpec, ModelConfig

Params = Dict[str, Any]
Cache = Dict[str, Any]

_BLOCKS = {("attn", "dense"): "rmsnorm", ("rwkv", "rwkv_cm"): "layernorm"}
REMAT_POLICIES = ("full", "tp_outs")


def check_block(cfg: ModelConfig, spec: BlockSpec) -> None:
    if _BLOCKS.get((spec.mixer, spec.ffn)) != cfg.norm or cfg.encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: block {spec} (norm={cfg.norm}, encoder_decoder="
            f"{cfg.encoder_decoder}) is not ported; only ('attn', 'dense') "
            f"rmsnorm and ('rwkv', 'rwkv_cm') layernorm decoders are "
            f"(ROADMAP Queue A item 10)")


def init_norm(cfg: ModelConfig, device) -> Params:
    if cfg.norm == "layernorm":
        return L.layernorm_init(cfg.d_model, cfg.pdtype, device)
    return L.norm_init(cfg.d_model, cfg.pdtype, device)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return L.layernorm(p, x, cfg.norm_eps)
    return L.rmsnorm(p, x, cfg.norm_eps)


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               device: Union[str, torch.device] = "cpu") -> Params:
    check_block(cfg, spec)
    if spec.mixer == "rwkv":
        return {
            "ln1": init_norm(cfg, device),
            "rwkv_tm": R.init_time_mix(gen, cfg.d_model,
                                       cfg.rwkv or R.RwkvConfig(),
                                       cfg.pdtype, device),
            "ln2": init_norm(cfg, device),
            "rwkv_cm": R.init_channel_mix(gen, cfg.d_model, cfg.d_ff,
                                          cfg.pdtype, device),
        }
    return {
        "ln1": init_norm(cfg, device),
        "attn": A.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.d_head, cfg.qk_norm,
                                 cfg.pdtype, device),
        "ln2": init_norm(cfg, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype, device),
    }


def _mixer(p: Params, h: torch.Tensor, cfg: ModelConfig, spec: BlockSpec, *,
           positions, cache, cache_pos, block_tables) -> torch.Tensor:
    if spec.mixer == "rwkv":
        out, _ = R.time_mix(p["rwkv_tm"], h, cfg.rwkv or R.RwkvConfig(),
                            None if cache is None else cache.get("rwkv"))
        return out
    out, _ = A.attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, positions=positions, rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections, qk_norm=cfg.qk_norm,
        causal=cfg.causal, cache=None if cache is None else cache["attn"],
        cache_pos=cache_pos, block_tables=block_tables)
    return out


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig, spec: BlockSpec,
         cache: Optional[Cache]) -> torch.Tensor:
    if spec.ffn == "rwkv_cm":
        out, _ = R.channel_mix(p["rwkv_cm"], h,
                               None if cache is None else cache.get("rwkv"))
        return out
    return L.mlp(p["mlp"], h, cfg.ffn_kind)


def apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                spec: BlockSpec, *, positions: Optional[torch.Tensor],
                cache: Optional[Cache] = None,
                cache_pos: Union[int, torch.Tensor, None] = None,
                block_tables: Optional[torch.Tensor] = None,
                remat_sub_blocks: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (x, cache updated in place).  ``remat_sub_blocks`` wraps
    the mixer and the FFN (each with its norm) in a checkpoint of its own,
    so only their outputs are kept for the backward (the ``tp_outs``
    policy)."""
    check_block(cfg, spec)

    def mixer(x):
        return _mixer(p, apply_norm(cfg, p["ln1"], x), cfg, spec,
                      positions=positions, cache=cache, cache_pos=cache_pos,
                      block_tables=block_tables)

    def ffn(x):
        return _ffn(p, apply_norm(cfg, p["ln2"], x), cfg, spec, cache)

    if remat_sub_blocks:
        x = x + checkpoint(mixer, x, use_reentrant=False)
        return x + checkpoint(ffn, x, use_reentrant=False), cache
    x = x + mixer(x)
    return x + ffn(x), cache


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
    if any(spec.mixer == "rwkv" for spec in cfg.pattern):
        R.init_rwkv_cache()     # raises until the RWKV serving slice
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
                block_tables: Optional[torch.Tensor] = None,
                remat: bool = False, remat_policy: str = "full"
                ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
    """Run every layer in order.  Returns (x, caches updated in place).

    ``remat`` (training) recomputes activations in the backward instead of
    keeping them: policy ``"full"`` checkpoints each layer (only its input
    is kept), ``"tp_outs"`` each sub-block (the mixer's and FFN's outputs
    are kept, as the reference's ``save_only_these_names("tp_out")``).
    The reference's ``"dots"`` (keep every matmul output) is not ported."""
    if remat and remat_policy not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy={remat_policy!r} is not ported (have "
            f"{REMAT_POLICIES}); 'dots' waits for ROADMAP Queue A item 11")
    if remat and caches is not None:
        raise ValueError("remat is for training: it takes no caches")
    for i, (p, spec) in enumerate(zip(stack, layer_specs(cfg))):
        kw = dict(positions=positions,
                  cache=None if caches is None else caches[i],
                  cache_pos=cache_pos, block_tables=block_tables)
        if remat and remat_policy == "full":
            x = checkpoint(lambda x, p=p, spec=spec, kw=kw: apply_block(
                p, x, cfg, spec, **kw)[0], x, use_reentrant=False)
        else:
            x, _ = apply_block(p, x, cfg, spec, remat_sub_blocks=remat, **kw)
    return x, caches
