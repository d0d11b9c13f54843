"""Phi-3-medium — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

Copy of ``repro/configs/phi3_medium_14b.py``.
Assigned: 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_head=128,
    d_ff=17920, vocab_size=100352,
    rope_theta=10000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    n_layers=2, d_model=160, n_heads=10, n_kv_heads=5, d_head=16,
    d_ff=320, vocab_size=512, compute_dtype="float32", cache_dtype="float32",
)
