"""Model configuration: a JAX-free copy of ``repro/models/config.py``.

A model is a stack of ``n_layers`` blocks cycling through ``pattern`` (a
tuple of BlockSpec).  Dtype names map to ``torch`` dtypes.  The sub-config
fields of other architectures (``moe``, ``mamba``, ``rwkv``) are kept so
the dataclass has the reference's shape; ``rwkv`` holds a
``models.rwkv.RwkvConfig``, the others wait for the other-architectures
slice (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r} "
                         f"(have {sorted(DTYPES)})") from None


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"      # "attn" | "mamba" | "rwkv"
    ffn: str = "dense"       # "dense" | "moe" | "rwkv_cm" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)

    # Sub-configs of the other block kinds (rwkv: models.rwkv.RwkvConfig;
    # moe and mamba wait for their slice).
    moe: Optional[Any] = None
    mamba: Optional[Any] = None
    rwkv: Optional[Any] = None

    # Attention details.
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    causal: bool = True

    # Encoder-decoder (seamless-m4t).
    encoder_decoder: bool = False
    n_encoder_layers: int = 0

    frontend: str = "none"

    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm" (rwkv)
    ffn_kind: str = "swiglu"         # dense-FFN activation
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"

    sub_quadratic: bool = False

    @property
    def n_groups(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not "
                             f"divisible by pattern period {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def kvdtype(self) -> torch.dtype:
        return torch_dtype(self.cache_dtype)

    def gemm_shapes(self) -> dict:
        """The weight GEMMs a dense attention decoder runs per forward
        step: name -> (K, N, launches), the launches summed over the
        layers (k and v share a shape, as do gate and up) and the head."""
        d, f, v, n = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        qn, kvn = self.n_heads * self.d_head, self.n_kv_heads * self.d_head
        return {"wq": (d, qn, n), "wk/wv": (d, kvn, 2 * n), "wo": (qn, d, n),
                "gate/up": (d, f, 2 * n), "down": (f, d, n),
                "lm_head": (d, v, 1)}

    def n_params(self) -> int:
        """Total parameter count, as the reference counts it (analytic:
        the rwkv loras at their default ranks, norms and mixing vectors
        left out), for the blocks the port has: attention/dense-FFN and
        rwkv/channel-mix (other mixers and FFNs wait for their slice)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d
        if not self.tie_embeddings:
            total += v * d
        for spec in self.pattern:
            if self.encoder_decoder or (spec.mixer, spec.ffn) not in (
                    ("attn", "dense"), ("rwkv", "rwkv_cm")):
                raise NotImplementedError(
                    f"{self.name}: only ('attn', 'dense') and ('rwkv', "
                    f"'rwkv_cm') decoder blocks are ported (ROADMAP Queue A "
                    f"item 10)")
            if spec.mixer == "attn":
                n = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                n += self.n_heads * self.d_head * d
                n += (3 if self.ffn_kind == "swiglu" else 2) * d * f
            else:
                n = 5 * d * d                        # r,k,v,g,o
                n += d * 5 * 32 + 5 * 32 * d         # ddlerp loras
                n += d * 64 + 64 * d                 # decay lora
                n += 2 * d * f + d * d               # channel mix
            total += n * self.n_groups
        return total
