"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; unverified].

Copy of ``repro/configs/kimi_k2_1t_a32b.py``.
Assigned: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384e top-8.  One shared expert per the public K2 architecture.
"""

from repro_torch.models.config import BlockSpec, MoEConfig, ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, vocab_size=163840,
    pattern=(BlockSpec("attn", "moe"),),
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048,
                  n_shared=1, shared_d_ff=2048),
    rope_theta=50000.0,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=64, vocab_size=512,
    pattern=(BlockSpec("attn", "moe"),),
    moe=MoEConfig(num_experts=8, top_k=4, d_ff=64, n_shared=1,
                  shared_d_ff=64, min_capacity=64),
    compute_dtype="float32", cache_dtype="float32",
)
