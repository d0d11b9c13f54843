"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay
[arXiv:2404.05892; hf].

Copy of ``repro/configs/rwkv6_3b.py``.
Assigned: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.
head_size=64 -> 40 wkv heads.
"""

from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.rwkv import RwkvConfig

FULL = ModelConfig(
    name="rwkv6-3b",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=8960, vocab_size=65536,
    pattern=(BlockSpec("rwkv", "rwkv_cm"),),
    rwkv=RwkvConfig(head_size=64, lora_mix=32, lora_decay=64),
    norm="layernorm", sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=224, vocab_size=512,
    pattern=(BlockSpec("rwkv", "rwkv_cm"),),
    rwkv=RwkvConfig(head_size=16, lora_mix=8, lora_decay=8),
    norm="layernorm", sub_quadratic=True, compute_dtype="float32",
    cache_dtype="float32",
)
