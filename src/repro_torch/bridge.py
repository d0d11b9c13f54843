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
from repro_torch.models.model import prepare_params
from repro_torch.models.transformer import check_block


def _to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        if set(tree) == {"q", "scale"}:
            raise NotImplementedError(
                "int8 weight-only leaves ({'q', 'scale'}) come with the "
                "quantization port (ROADMAP Queue A item 3)")
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)   # a writable copy


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: Union[str, torch.device] = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's param pytree (numpy leaves) -> the port's params:

    * the stacked leading ``n_groups`` axis of ``blocks`` (one stack per
      pattern position, ``repro/models/transformer.py:206-214``) is
      unstacked into one dict per layer, in layer order;
    * dense weights and the embedding table are cast to the compute dtype
      (``dtype``, default ``cfg.compute_dtype``) once, here;
    * the tied lm-head operand ``table.T`` is stored contiguously once.

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
    blocks = []
    for g in range(cfg.n_groups):
        for stack in stacks:
            blocks.append(_unstack(stack, g))
    params = {k: _to_torch(v, dev) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = [_to_torch(b, dev) for b in blocks]
    return prepare_params(params, cfg, dtype)


def _unstack(tree: Any, g: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]
