"""Carry the JAX package's parameters into the port.

torch cannot reproduce ``jax.random``, so a test that holds the port
against ``repro`` initialises the parameters in JAX, converts the pytree
to numpy (``jax.tree.map(np.asarray, params)``, on the caller's side: this
module imports no JAX) and hands it to :func:`params_from_numpy`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import finish_params, tie_head
from repro_torch.models.transformer import check_block


def _to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)   # a writable copy


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: Union[str, torch.device] = "cuda",
                      dtype: Optional[torch.dtype] = None,
                      quantize: bool = False) -> Dict[str, Any]:
    """The reference's param pytree (numpy leaves) -> the port's params:

    * the stacked leading ``n_groups`` axis of ``blocks`` (one stack per
      pattern position, ``repro/models/transformer.py:206-214``) is
      unstacked into one dict per layer, in layer order; only that axis:
      an MoE expert stack keeps its E axis ((E, K, N) a layer); an
      enc-dec model's ``encoder["blocks"]`` (one stack of
      ``n_encoder_layers``) likewise, and its decoder layers carry their
      ``ln_cross`` and ``cross_attn`` leaves;
    * dense weights, expert stacks and the embedding table are cast to
      the compute dtype (``dtype``, default ``cfg.compute_dtype``) once,
      here; the MoE router stays f32, as the reference keeps it;
    * the tied lm-head operand ``table.T`` is stored contiguously once;
    * int8 weight leaves (``{"q", "scale"}``, the reference's
      ``quantize_params`` output, expert stacks' included) are carried as
      they are, each layer's codes and scales unstacked with it; ``quantize=True`` quantizes
      the (f32) tree here instead, leaf by leaf as it is converted, as
      the reference's engine quantizes its f32 parameters.

    Training passes ``dtype=torch.float32``: every leaf then stays the
    reference's f32 tensor, and an untied model (RWKV-6) gets no second
    copy of any leaf that a gradient could split over.
    """
    dev = resolve_device(device)
    for spec in cfg.pattern:
        check_block(cfg, spec)
    stacks = tree["blocks"]
    if len(stacks) != len(cfg.pattern):
        raise ValueError(f"{len(stacks)} block stacks for a pattern of "
                         f"{len(cfg.pattern)}")

    def finish(key, sub):
        return finish_params({key: sub}, cfg, dtype, quantize)[key]

    params = {k: finish(k, _to_torch(v, dev))
              for k, v in tree.items() if k not in ("blocks", "encoder")}
    params["blocks"] = [finish("blocks", [_to_torch(_unstack(stack, g),
                                                    dev)])[0]
                        for g in range(cfg.n_groups) for stack in stacks]
    if "encoder" in tree:
        enc = tree["encoder"]
        (stack,) = enc["blocks"]
        params["encoder"] = {
            "blocks": [finish("encoder", {"blocks": [_to_torch(
                _unstack(stack, g), dev)]})["blocks"][0]
                for g in range(cfg.n_encoder_layers)],
            "final_norm": _to_torch(enc["final_norm"], dev)}
    return tie_head(params) if cfg.tie_embeddings else params


def _unstack(tree: Any, g: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]
