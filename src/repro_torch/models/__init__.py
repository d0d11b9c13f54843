"""Model zoo of the port: the dense GQA decoder, with dense or paged KV
caches."""

from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_paged_cache, init_params,
                                      paged_eligible, param_count, prefill,
                                      prepare_params)

__all__ = ["BlockSpec", "ModelConfig", "decode_step", "forward",
           "init_cache", "init_paged_cache", "init_params",
           "paged_eligible", "param_count", "prefill", "prepare_params"]
