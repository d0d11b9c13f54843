"""Top-level model API: init / forward / train loss / prefill / decode
(counterpart of ``repro/models/model.py``) for the dense and MoE
decoders, RWKV-6, the Jamba hybrid, the SeamlessM4T encoder-decoder and
the M-RoPE decoder Qwen2-VL (served; all but Jamba and SeamlessM4T also
trained).

Parameters are a dict of tensors::

    {"embed": {"table": (V, d), "table_t": (d, V)},   # table_t: tied, served
     # int8 weights (quantize=True): every large "w" and "table", and
     # every MoE expert stack ("gate"/"up"/"down", (E, K, N)), is
     # {"q": int8, "scale": f32 per output channel}; table_t is then
     # {"q_t": int8 (d, V), "scale": (d,)}
     "final_norm": {"scale": (d,)},                   # + "bias": layernorm
     "ln0": {"scale": (d,), "bias": (d,)},            # layernorm models
     "blocks": [per-layer dicts],     # enc-dec: + "ln_cross", "cross_attn"
     "head": {"w": (d, V)},                            # untied models only
     "encoder": {"blocks": [per-layer dicts],          # enc-dec models only
                 "final_norm": {"scale": (d,)}}}

Batch dict: ``tokens`` (B, S) integer ids, or ``embeds`` (B, S, d_model)
(the vision or audio frontend stub's inputs) in their place; optional
``positions`` (B, S), or (B, S, 3) (t, h, w) under M-RoPE, by default the
token index (t, t, t under M-RoPE); ``enc_embeds`` (B, S_enc, d_model),
an enc-dec model's encoder inputs, at every step but decode; for training
``labels`` (B, S) and an optional ``mask`` (B, S).

Training keeps the parameters in f32 (``train_tree(init_params(...,
dtype=torch.float32))``) and casts each weight per GEMM, as the
reference does.  ``table_t``, the second layout of a tied table, is
serving's only: the trained tree (:func:`train_tree`) holds a tied table
once, the tied head reads ``table`` transposed, and the embedding's and
the head's gradients add into that one leaf, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models import quant

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


def _cast_weights(tree: Any, dtype: torch.dtype) -> Any:
    """Every float ``w`` and ``table`` leaf, and every MoE expert stack
    (``gate``/``up``/``down`` leaves), cast to ``dtype``; the MoE router
    (f32 in the reference whatever the parameter dtype), int8 ``{"q",
    "scale"}`` leaves and every other leaf kept as they are."""
    if isinstance(tree, dict):
        return {k: (v if k == "router" else
                    v.to(dtype) if k in quant.WEIGHT_KEYS
                    and isinstance(v, torch.Tensor) and v.is_floating_point()
                    else _cast_weights(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_weights(v, dtype) for v in tree]
    return tree


def tie_head(params: Params) -> Params:
    """Store the tied lm-head operand ``table.T`` contiguously, once: the
    table transposed, or for an int8 table its int8 transpose beside its
    per-column scales (the head never holds a bf16 copy of it)."""
    table = params["embed"]["table"]
    if quant.is_quantized(table):
        params["embed"]["table_t"] = {"q_t": table["q"].t().contiguous(),
                                      "scale": table["scale"]}
    else:
        params["embed"]["table_t"] = table.t().contiguous()
    return params


def finish_params(tree: Params, cfg: ModelConfig,
                  dtype: Optional[torch.dtype] = None,
                  quantize: bool = False, inplace: bool = False) -> Params:
    """Make a (sub)tree of parameters ready to serve: with ``quantize``,
    int8 weights first (from the f32 values, as the reference quantizes
    its f32 parameters; ``blocks`` as the reference's stacks of
    ``n_groups`` layers, ``quant.quantize_params``), then every remaining
    dense weight and table cast to ``dtype`` (default the compute dtype;
    the reference casts them per GEMM, ``layers.py:93``, with the same
    rounding).  Norm scales and int8 weights are kept as they are.
    ``inplace``: the f32 weights are the caller's to overwrite as they are
    quantized (fresh draws)."""
    dtype = cfg.cdtype if dtype is None else dtype
    if quantize:
        tree = quant.quantize_params(tree, cfg.n_groups,
                                     cfg.n_encoder_layers, inplace)[0]
    return _cast_weights(tree, dtype)


def prepare_params(params: Params, cfg: ModelConfig,
                   dtype: Optional[torch.dtype] = None,
                   quantize: bool = False) -> Params:
    """:func:`finish_params` over a whole tree, then the tied lm-head
    operand stored beside the table (:func:`tie_head`).  Returns a new
    dict."""
    tree = {k: v for k, v in params.items() if k != "embed"}
    tree["embed"] = {k: v for k, v in params["embed"].items()
                     if k != "table_t"}
    out = finish_params(tree, cfg, dtype, quantize)
    return tie_head(out) if cfg.tie_embeddings else out


def train_tree(params: Params) -> Params:
    """The tree training differentiates, updates and checkpoints:
    ``params`` without a tied model's serving-only ``table_t``, so a tied
    table is one leaf (a new top-level dict; the leaves are shared)."""
    if "table_t" not in params["embed"]:
        return params
    out = dict(params)
    out["embed"] = {k: v for k, v in params["embed"].items()
                    if k != "table_t"}
    return out


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda",
                dtype: Optional[torch.dtype] = None,
                quantize: bool = False) -> Params:
    """Random parameters with the reference initialisers' distributions
    (``dense_init``: N(0, 1/d_in); ``embedding_init``: N(0, 0.02^2); norms:
    ones), drawn in f32 from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, made ready to serve as :func:`prepare_params` does
    (``dtype=torch.float32`` keeps f32 parameters for training), or with
    ``quantize`` with every large dense weight and the table in int8
    (``models.quant``, from the f32 values).

    Each layer, the embedding and the head are cast (or quantized) as they
    are drawn, so the f32 copy of the whole model never exists: the peak
    is the served tree plus the largest f32 subtree (its weights scaled
    and quantized in place, without a temporary of their size).  The draws
    and their order, and so the values, are those of drawing every leaf
    first: the embedding, the decoder's layers, the head, then an enc-dec
    model's encoder layers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def finish(key, sub):
        return finish_params({key: sub}, cfg, dtype, quantize,
                             inplace=True)[key]

    p: Params = {
        "embed": finish("embed", L.embedding_init(
            gen, cfg.vocab_size, cfg.d_model, cfg.pdtype, dev)),
        "final_norm": T.init_norm(cfg, dev),
        "blocks": [finish("blocks", [T.init_block(gen, cfg, spec, dev)])[0]
                   for spec in T.layer_specs(cfg)],
    }
    if cfg.norm == "layernorm":
        p["ln0"] = L.layernorm_init(cfg.d_model, cfg.pdtype, dev)
    if not cfg.tie_embeddings:
        p["head"] = finish("head", L.dense_init(
            gen, cfg.d_model, cfg.vocab_size, cfg.pdtype, dev))
    if cfg.encoder_decoder:
        enc_cfg = _encoder_cfg(cfg)
        p["encoder"] = {
            "blocks": [finish("encoder", {"blocks": [
                T.init_block(gen, enc_cfg, spec, dev)]})["blocks"][0]
                for spec in T.layer_specs(enc_cfg)],
            "final_norm": T.init_norm(cfg, dev)}
    return tie_head(p) if cfg.tie_embeddings else p


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``n_encoder_layers`` ("attn", "dense")
    blocks attending without a causal mask, no cross attention."""
    return dataclasses.replace(
        cfg, n_layers=cfg.n_encoder_layers, causal=False,
        pattern=(BlockSpec("attn", "dense"),), moe=None,
        encoder_decoder=False)


def param_count(params: Params) -> int:
    """Parameters as the reference counts them (``table_t`` is a second
    layout of the embedding table, not a parameter; an int8 weight counts
    its codes, not its scales)."""
    def count(tree, key=None):
        if key == "table_t":
            return 0
        if quant.is_quantized(tree):
            return tree["q"].numel()
        if isinstance(tree, dict):
            return sum(count(v, k) for k, v in tree.items())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()
    return count(params)


def _positions(b: int, s: int, offset: Union[int, torch.Tensor],
               device: torch.device, mrope: bool = False) -> torch.Tensor:
    """Token positions (B, S) from ``offset``; under M-RoPE (B, S, 3), the
    text form (t, t, t)."""
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        # Per-slot decode offsets (continuous batching): each sequence
        # sits at its own position in its KV cache.
        pos = pos + offset.to(device=device, dtype=torch.int32)[:, None]
    else:
        pos = (pos + int(offset)).expand(b, s)
    return pos[..., None].expand(b, s, 3) if mrope else pos


def _input_embed(params: Params, batch: Batch,
                 cfg: ModelConfig) -> torch.Tensor:
    """The frontend stub's ``embeds`` in the compute dtype, or the tokens'
    rows of the table; then ``ln0`` where the model has one."""
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.cdtype)
    else:
        x = L.embed(params["embed"], batch["tokens"], cfg.cdtype)
    if "ln0" in params:
        x = L.layernorm(params["ln0"], x, cfg.norm_eps)
    return x


def _encode(params: Params, batch: Batch, cfg: ModelConfig,
            remat: bool = False) -> Optional[torch.Tensor]:
    """An enc-dec model's encoder states (B, S_enc, d_model) from
    ``batch["enc_embeds"]`` (RoPE at positions 0..S_enc-1, no causal
    mask, the final norm); None for a decoder-only model.  A batch
    without ``enc_embeds`` raises ``KeyError``, as the reference's."""
    if not cfg.encoder_decoder:
        return None
    enc_cfg = _encoder_cfg(cfg)
    x = batch["enc_embeds"].to(cfg.cdtype)
    b, s = x.shape[:2]
    x, _, _ = T.apply_stack(params["encoder"]["blocks"], x, enc_cfg,
                            positions=_positions(b, s, 0, x.device),
                            remat=remat,
                            final_norm=params["encoder"]["final_norm"])
    return x


def forward(params: Params, batch: Batch, cfg: ModelConfig, *,
            caches: Optional[List] = None,
            cache_pos: Union[int, torch.Tensor, None] = None,
            block_tables: Optional[torch.Tensor] = None,
            decode: bool = False,
            remat: bool = False, remat_policy: str = "full",
            with_aux: bool = False
            ) -> Tuple[torch.Tensor, Optional[List], Optional[torch.Tensor]]:
    """Returns (logits (B, S, V) f32, caches updated in place, aux), the
    reference's three outputs: aux is the MoE layers' summed auxiliary
    loss, an f32 scalar (zero without MoE layers), with ``with_aux``, and
    None without it (serving skips that work, as the reference's jitted
    serving steps drop it).  ``block_tables`` addresses a paged cache
    (decode only); an enc-dec model encodes ``batch["enc_embeds"]`` unless
    ``decode`` (whose cross attention reads the cross cache prefill
    wrote); ``remat`` and ``remat_policy`` are training's
    (``transformer.apply_stack``)."""
    x = _input_embed(params, batch, cfg)
    b, s = x.shape[:2]
    pos = batch.get("positions")
    if pos is None:
        pos = _positions(b, s, 0 if cache_pos is None else cache_pos,
                         x.device, cfg.mrope_sections is not None)
    # Decode reuses the prefill-time cross-attention cache: no re-encode.
    enc_out = None if decode else _encode(params, batch, cfg, remat)
    x, caches, aux = T.apply_stack(params["blocks"], x, cfg, positions=pos,
                                   caches=caches, cache_pos=cache_pos,
                                   block_tables=block_tables,
                                   enc_out=enc_out, decode=decode,
                                   remat=remat, remat_policy=remat_policy,
                                   with_aux=with_aux,
                                   final_norm=params["final_norm"])
    return L.logits(params["embed"], x, params.get("head")), caches, aux


def loss_fn(params: Params, batch: Batch, cfg: ModelConfig,
            remat: bool = True, remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy plus the MoE layers' auxiliary loss,
    summed in layer order (zero without MoE layers).  Returns (loss,
    {"ce", "aux"})."""
    lg, _, aux = forward(params, batch, cfg, remat=remat,
                         remat_policy=remat_policy, with_aux=True)
    ce = L.cross_entropy(lg, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda",
               enc_len: int = 0) -> List:
    """Per-layer caches, zeroed: dense KV (batch, Hkv, max_len, D) for an
    attention layer, the fixed-size state for a Mamba or RWKV layer
    (``transformer.init_stack_cache``); an enc-dec model's layers also a
    cross cache of ``enc_len`` rows."""
    return T.init_stack_cache(
        cfg, batch, max_len, resolve_device(device),
        cross_len=enc_len if cfg.encoder_decoder else 0)


def paged_eligible(cfg: ModelConfig) -> bool:
    """True when the arch can decode through the paged KV pool: every
    mixer is attention (a recurrent Mamba or RWKV state is fixed-size per
    slot: nothing to page) and there is no enc-dec cross cache."""
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
    lg, caches, _ = forward(params, batch, cfg, caches=caches, cache_pos=0)
    return lg[:, -1], caches


def decode_step(params: Params, token: torch.Tensor,
                pos: Union[int, torch.Tensor], cfg: ModelConfig,
                caches: List, embeds: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List]:
    """One token (B,) at position ``pos`` — a scalar (uniform batch) or a
    (B,) vector of per-slot positions (ragged continuous batching: each
    slot writes its KV at its own offset and attends only to its own valid
    prefix); ``embeds`` (B, d_model), the frontend stub's input, replaces
    the token.  With a paged cache (:func:`init_paged_cache`),
    ``block_tables`` (B, max_pages) maps each slot's positions onto pool
    pages and ``pos`` must be the per-slot vector.  An enc-dec model's
    cross attention reads its cross cache.  Returns (logits (B, V),
    caches)."""
    batch = ({"tokens": token[:, None]} if embeds is None
             else {"embeds": embeds[:, None]})
    lg, caches, _ = forward(params, batch, cfg, caches=caches, cache_pos=pos,
                            block_tables=block_tables, decode=True)
    return lg[:, 0], caches
