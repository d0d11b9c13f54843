"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro/configs/registry.py``'s ``get``/``get_smoke``).

Every architecture id of the reference is ported: the dense GQA
decoders, the MoE decoders (Kimi-K2, Llama-4 Maverick), the Jamba
Mamba/attention hybrid, RWKV-6 (served and trained), the SeamlessM4T
encoder-decoder and the M-RoPE decoder Qwen2-VL.  An unknown id raises
``ValueError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

PORTED = ("smollm_360m", "qwen3_8b", "phi3_medium_14b", "minitron_8b",
          "rwkv6_3b", "kimi_k2_1t_a32b", "llama4_maverick_400b_a17b",
          "jamba_v01_52b", "seamless_m4t_large_v2", "qwen2_vl_72b")


def _module(arch_id: str):
    if arch_id not in PORTED:
        raise ValueError(f"unknown arch {arch_id!r}; have {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
