"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

Copy of ``repro/configs/smollm_360m.py``.
Assigned: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab_size=49152, tie_embeddings=True,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="smollm-smoke",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
    d_ff=192, vocab_size=512, tie_embeddings=True,
    compute_dtype="float32", cache_dtype="float32",
)
