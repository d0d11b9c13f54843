"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Copy of ``repro/configs/jamba_v01_52b.py``.
Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2.  Period-8 pattern: attention at offset 4, Mamba elsewhere
(1:7 ratio); MoE replaces the dense FFN on every other layer.  Hybrid
decode state (4 attn KV caches + 28 O(1) mamba states): runs long_500k.
"""

from repro_torch.models.config import (BlockSpec, MambaConfig, MoEConfig,
                                      ModelConfig)


def _pattern():
    out = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        out.append(BlockSpec(mixer, ffn))
    return tuple(out)


FULL = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=65536,
    pattern=_pattern(),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=512,
    pattern=_pattern(),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=64, min_capacity=64),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16),
    sub_quadratic=True, compute_dtype="float32", cache_dtype="float32",
)
