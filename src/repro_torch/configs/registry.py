"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro/configs/registry.py``'s ``get``/``get_smoke``).

Ported: the dense GQA decoders (served) and RWKV-6 (trained); every
other id of the reference raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

PORTED = ("smollm_360m", "qwen3_8b", "rwkv6_3b")

# The reference's other architecture ids, each waiting for a later slice.
LATER = (
    "kimi_k2_1t_a32b", "llama4_maverick_400b_a17b", "phi3_medium_14b",
    "minitron_8b", "jamba_v01_52b", "seamless_m4t_large_v2",
    "qwen2_vl_72b",
)


def _module(arch_id: str):
    if arch_id in LATER:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: it comes with the "
            f"other-architectures slice (ROADMAP Queue A item 10); ported: "
            f"{PORTED}")
    if arch_id not in PORTED:
        raise ValueError(f"unknown arch {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
