"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro/configs/registry.py``'s ``get``/``get_smoke``).

Ported: the dense GQA decoders, the MoE decoders (Kimi-K2, Llama-4
Maverick), the Jamba Mamba/attention hybrid and RWKV-6 (all served;
RWKV-6 also trained); every other id of the reference raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

PORTED = ("smollm_360m", "qwen3_8b", "phi3_medium_14b", "minitron_8b",
          "rwkv6_3b", "kimi_k2_1t_a32b", "llama4_maverick_400b_a17b",
          "jamba_v01_52b")

# The reference's other architecture ids -> the ROADMAP Queue A item that
# brings each one.
LATER = {
    "seamless_m4t_large_v2": "10.5 (enc-dec)",
    "qwen2_vl_72b": "10.6 (M-RoPE)",
}


def _module(arch_id: str):
    if arch_id in LATER:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: it comes with ROADMAP "
            f"Queue A item {LATER[arch_id]}; ported: {PORTED}")
    if arch_id not in PORTED:
        raise ValueError(f"unknown arch {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
