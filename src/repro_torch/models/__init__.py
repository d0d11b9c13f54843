"""Model zoo of the port: the dense and MoE GQA decoders (dense or paged
KV caches), the Jamba Mamba/attention hybrid and RWKV-6 (their recurrent
state on the dense layout), the SeamlessM4T encoder-decoder and the M-RoPE
decoder Qwen2-VL; every decoder but Jamba also for training."""

from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_paged_cache, init_params, loss_fn,
                                      paged_eligible, param_count, prefill,
                                      prepare_params, train_tree)

__all__ = ["BlockSpec", "ModelConfig", "decode_step", "forward",
           "init_cache", "init_paged_cache", "init_params", "loss_fn",
           "paged_eligible", "param_count", "prefill", "prepare_params",
           "train_tree"]
