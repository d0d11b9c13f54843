"""Model zoo of the port: the dense GQA decoder, with dense or paged KV
caches, and RWKV-6 for training."""

from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_paged_cache, init_params, loss_fn,
                                      paged_eligible, param_count, prefill,
                                      prepare_params)

__all__ = ["BlockSpec", "ModelConfig", "decode_step", "forward",
           "init_cache", "init_paged_cache", "init_params", "loss_fn",
           "paged_eligible", "param_count", "prefill", "prepare_params"]
