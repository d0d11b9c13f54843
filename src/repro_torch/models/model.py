"""Top-level model API: init / forward / train loss / prefill / decode
(counterpart of ``repro/models/model.py``) for the dense decoders (served)
and RWKV-6 (trained).

Parameters are a dict of tensors::

    {"embed": {"table": (V, d), "table_t": (d, V)},   # table_t: tied head
     "final_norm": {"scale": (d,)},                   # + "bias": layernorm
     "ln0": {"scale": (d,), "bias": (d,)},            # layernorm models
     "blocks": [per-layer dicts],
     "head": {"w": (d, V)}}                            # untied models only

Batch dict: ``tokens`` (B, S) integer ids; optional ``positions`` (B, S);
for training ``labels`` (B, S) and an optional ``mask`` (B, S).

Training keeps the parameters in f32 (``init_params(..., dtype=
torch.float32)``) and casts each weight per GEMM, as the reference does.
``table_t``, the second layout of a tied table, would split a tied model's
gradient between two leaves; the one model trained so far, RWKV-6, is
untied.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


def prepare_params(params: Params, cfg: ModelConfig,
                   dtype: Optional[torch.dtype] = None) -> Params:
    """Make parameters ready to serve, once: every dense weight and the
    embedding table cast to the compute dtype (the reference casts them
    per GEMM, ``layers.py:93``; the rounding is the same), norm scales
    kept as they are, and the tied lm-head operand ``table.T`` stored
    contiguously beside the table.  Returns a new dict."""
    dtype = cfg.cdtype if dtype is None else dtype

    def cast(tree):
        if isinstance(tree, dict):
            return {k: (v.to(dtype) if k in ("w", "table")
                        and v.is_floating_point() else cast(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree

    out = cast(params)
    if cfg.tie_embeddings:
        out["embed"]["table_t"] = out["embed"]["table"].t().contiguous()
    return out


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda",
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters with the reference initialisers' distributions
    (``dense_init``: N(0, 1/d_in); ``embedding_init``: N(0, 0.02^2); norms:
    ones), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, then :func:`prepare_params` (``dtype=torch.float32``
    keeps f32 parameters for training)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: Params = {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.pdtype, dev),
        "final_norm": T.init_norm(cfg, dev),
        "blocks": T.init_stack(gen, cfg, dev),
    }
    if cfg.norm == "layernorm":
        p["ln0"] = L.layernorm_init(cfg.d_model, cfg.pdtype, dev)
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                 cfg.pdtype, dev)
    return prepare_params(p, cfg, dtype)


def param_count(params: Params) -> int:
    """Parameters as the reference counts them (``table_t`` is a second
    layout of the embedding table, not a parameter)."""
    def count(tree, key=None):
        if isinstance(tree, dict):
            return sum(count(v, k) for k, v in tree.items())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return 0 if key == "table_t" else tree.numel()
    return count(params)


def _positions(b: int, s: int, offset: Union[int, torch.Tensor],
               device: torch.device) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        # Per-slot decode offsets (continuous batching): each sequence
        # sits at its own position in its KV cache.
        return pos + offset.to(device=device, dtype=torch.int32)[:, None]
    return (pos + int(offset)).expand(b, s)


def forward(params: Params, batch: Batch, cfg: ModelConfig, *,
            caches: Optional[List] = None,
            cache_pos: Union[int, torch.Tensor, None] = None,
            block_tables: Optional[torch.Tensor] = None,
            remat: bool = False, remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, Optional[List]]:
    """Returns (logits (B, S, V) f32, caches updated in place).
    ``block_tables`` addresses a paged cache (decode only); ``remat`` and
    ``remat_policy`` are training's (``transformer.apply_stack``)."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, cfg.cdtype)
    if "ln0" in params:
        x = L.layernorm(params["ln0"], x, cfg.norm_eps)
    b, s = tokens.shape
    pos = batch.get("positions")
    if pos is None:
        pos = _positions(b, s, 0 if cache_pos is None else cache_pos,
                         x.device)
    x, caches = T.apply_stack(params["blocks"], x, cfg, positions=pos,
                              caches=caches, cache_pos=cache_pos,
                              block_tables=block_tables, remat=remat,
                              remat_policy=remat_policy)
    x = T.apply_norm(cfg, params["final_norm"], x)
    return L.logits(params["embed"], x, params.get("head")), caches


def loss_fn(params: Params, batch: Batch, cfg: ModelConfig,
            remat: bool = True, remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy plus the auxiliary loss (zero: no
    ported block has one).  Returns (loss, {"ce", "aux"})."""
    lg, _ = forward(params, batch, cfg, remat=remat,
                    remat_policy=remat_policy)
    ce = L.cross_entropy(lg, batch["labels"], batch.get("mask"))
    aux = torch.zeros((), dtype=torch.float32, device=lg.device)
    return ce + aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> List:
    """Dense KV caches, (batch, Hkv, max_len, D) per layer, zeroed."""
    return T.init_stack_cache(cfg, batch, max_len, resolve_device(device))


def paged_eligible(cfg: ModelConfig) -> bool:
    """True when the arch can decode through the paged KV pool: every
    mixer is attention and there is no enc-dec cross cache."""
    return (not cfg.encoder_decoder
            and all(spec.mixer == "attn" for spec in cfg.pattern))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     kv_dtype: Optional[str] = None,
                     device: Union[str, torch.device] = "cuda") -> List:
    """Paged-KV caches (``repro_torch.serving.kvpool``): per attention
    layer, a (num_pages + 1, Hkv, page_size, D) page pool — the extra page
    is the null sink that unallocated block-table entries point at.
    ``kv_dtype`` overrides the page dtype (``"int8"`` adds per-row scale
    rows; see ``attention.init_paged_kv_cache``)."""
    if not paged_eligible(cfg):
        raise ValueError(
            f"arch {cfg.name!r} has non-attention state (or an enc-dec "
            f"cross cache) — the paged KV pool covers attention KV only")
    return T.init_stack_cache(cfg, 0, 0, resolve_device(device),
                              paged=(num_pages + 1, page_size, kv_dtype))


def prefill(params: Params, batch: Batch, cfg: ModelConfig,
            caches: List) -> Tuple[torch.Tensor, List]:
    """Run the prompt, fill caches; returns (last-token logits, caches)."""
    lg, caches = forward(params, batch, cfg, caches=caches, cache_pos=0)
    return lg[:, -1], caches


def decode_step(params: Params, token: torch.Tensor,
                pos: Union[int, torch.Tensor], cfg: ModelConfig,
                caches: List, block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List]:
    """One token (B,) at position ``pos`` — a scalar (uniform batch) or a
    (B,) vector of per-slot positions (ragged continuous batching: each
    slot writes its KV at its own offset and attends only to its own valid
    prefix).  With a paged cache (:func:`init_paged_cache`),
    ``block_tables`` (B, max_pages) maps each slot's positions onto pool
    pages and ``pos`` must be the per-slot vector.  Returns (logits (B, V),
    caches)."""
    lg, caches = forward(params, {"tokens": token[:, None]}, cfg,
                         caches=caches, cache_pos=pos,
                         block_tables=block_tables)
    return lg[:, 0], caches
