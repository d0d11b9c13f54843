"""Qwen2-VL-72B — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Copy of ``repro/configs/qwen2_vl_72b.py``.
Assigned: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Backbone only: the vision frontend is a stub — the caller passes
precomputed patch embeddings (B, S, d_model) (``embeds``) and their
(t, h, w) M-RoPE positions (B, S, 3).  M-RoPE sections (16, 24, 24) over
d_head/2 = 64 frequency slots; text tokens take (t, t, t).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=29568, vocab_size=152064,
    mrope_sections=(16, 24, 24), frontend="vision",
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab_size=512, mrope_sections=(4, 2, 2),
    frontend="vision", compute_dtype="float32", cache_dtype="float32",
)
