"""Llama-4 Maverick — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Copy of ``repro/configs/llama4_maverick_400b_a17b.py``.
Assigned: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 128e top-1 (+ shared expert, per the public Llama-4 MoE design).
MoE layers interleave every other layer (interleave_moe_layer_step=2 in
the public config) — this reproduces the 400B total / 17B active scale.
The multimodal early-fusion frontend is out of scope for the LM cells
(text tokens only, per the assignment's backbone rule).
"""

from repro_torch.models.config import BlockSpec, MoEConfig, ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202048,
    pattern=(BlockSpec("attn", "dense"), BlockSpec("attn", "moe")),
    moe=MoEConfig(num_experts=128, top_k=1, d_ff=8192,
                  n_shared=1, shared_d_ff=8192),
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=512,
    pattern=(BlockSpec("attn", "dense"), BlockSpec("attn", "moe")),
    moe=MoEConfig(num_experts=8, top_k=1, d_ff=64, n_shared=1,
                  shared_d_ff=64, min_capacity=64),
    compute_dtype="float32", cache_dtype="float32",
)
