"""Qwen3-8B — dense, qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

Copy of ``repro/configs/qwen3_8b.py``.
Assigned: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12288, vocab_size=151936, qk_norm=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab_size=512, qk_norm=True, compute_dtype="float32",
    cache_dtype="float32",
)
