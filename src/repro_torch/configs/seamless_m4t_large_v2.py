"""SeamlessM4T-large-v2 — encoder-decoder, multimodal
[arXiv:2308.11596; hf].

Copy of ``repro/configs/seamless_m4t_large_v2.py``.
Assigned: 24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
Backbone only: the speech frontend is a stub — the caller passes
precomputed frame embeddings (B, S_enc, d_model) to the encoder
(``enc_embeds``).  24 encoder + 24 decoder layers.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab_size=256206,
    encoder_decoder=True, n_encoder_layers=24, frontend="audio",
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=512,
    encoder_decoder=True, n_encoder_layers=2, frontend="audio",
    compute_dtype="float32", cache_dtype="float32",
)
