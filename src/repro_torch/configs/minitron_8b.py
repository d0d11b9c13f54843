"""Minitron-8B — width/depth-pruned Nemotron [arXiv:2407.14679; hf].

Copy of ``repro/configs/minitron_8b.py``.
Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Non-gated FFN (Nemotron family uses squared-ReLU; modelled with the
non-gated 'gelu' FFN so d_ff=16384 matches a 2-matrix FFN).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="minitron-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab_size=256000, ffn_kind="gelu",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab_size=512, ffn_kind="gelu", compute_dtype="float32",
    cache_dtype="float32",
)
