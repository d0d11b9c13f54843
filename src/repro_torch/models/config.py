"""Model configuration: a JAX-free copy of ``repro/models/config.py``.

A model is a stack of ``n_layers`` blocks cycling through ``pattern`` (a
tuple of BlockSpec): dense transformers use a single ("attn","dense")
entry; MoE models ("attn","moe") (Llama-4 alternates it with a dense
block); RWKV ("rwkv","rwkv_cm"); Jamba an 8-entry hybrid of Mamba and
attention mixers with dense and MoE FFNs.  Encoder-decoder models
(seamless) add an encoder stack of ``n_encoder_layers`` ("attn", "dense")
blocks and give the decoder blocks cross-attention; ``mrope_sections``
(qwen2_vl) rotates by (t, h, w) positions.  Dtype names map to ``torch``
dtypes.  The sub-configs are copies of the reference's: :class:`MoEConfig`
(``repro/models/moe.py``) and :class:`MambaConfig`
(``repro/models/mamba.py``) here, ``rwkv`` a ``models.rwkv.RwkvConfig``.
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
class MoEConfig:
    """Capacity-based top-k routing (``models/moe.py``), field for field
    the reference's."""
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    capacity_factor: float = 1.25
    min_capacity: int = 4
    n_shared: int = 0              # shared (always-on) experts
    shared_d_ff: int = 0           # hidden size of the shared branch
    aux_loss_weight: float = 0.01
    # Combine formulation: "gather" indexes the expert outputs by token,
    # "scatter" sends each expert slot back to its token.  The port sums a
    # token's contributions in a fixed order either way (no atomics).
    combine: str = "scatter"
    # Routing and capacity per group of T/G tokens (1: global dispatch).
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """The selective SSM block (``models/mamba.py``), field for field the
    reference's."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None      # default ceil(d_model / 16)
    chunk: int = 256                   # the reference's scan chunk length

    def resolve_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


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

    # Sub-configs (rwkv: models.rwkv.RwkvConfig).
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
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

    def gemm_shapes(self, step: str = "decode") -> dict:
        """The weight GEMMs one forward step runs through ``layers.gemm``:
        name -> (K, N, launches), the launches summed over the layers and
        the head.  ``step`` is the form of the step: ``"decode"`` (one
        token a slot) or ``"prefill"`` (a prompt); they differ only for an
        encoder-decoder model, whose encoder and cross-attention ``wk``/
        ``wv`` run at prefill only (decode reads the cross cache), at M =
        the encoder's rows where the decoder's sites run at M = the
        prompt's.

        An attention block runs wq, wk, wv and wo (k and v share a shape);
        a Mamba block in_proj (d -> 2 di), x_proj (di -> dt_rank + 2 N),
        dt_proj (dt_rank -> di) and out_proj (di -> d); an RWKV-6 block the
        ddlerp lora (``lora_a``, then one ``lora_b`` slice per mixed
        input), the r/k/v/g/o projections, the decay lora and the channel
        mix's wk, wv and wr.  A dense FFN runs gate, up and down (SwiGLU;
        gate and up share a shape) or up and down (``ffn_kind="gelu"``);
        an MoE FFN its router (in f32: :meth:`gemm_dtype`) and the shared
        expert's SwiGLU, its experts being batched products outside the
        GEMM (as the reference's einsums are).  An enc-dec decoder block
        adds its cross attention's ``cross wq`` and ``cross wo`` (every
        step) and ``cross wk/wv`` (prefill); the encoder's blocks are
        ``enc ...`` sites (prefill)."""
        if step not in ("decode", "prefill"):
            raise ValueError(f"step must be 'decode' or 'prefill', got "
                             f"{step!r}")
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        out: dict = {}

        def add(name, k, n_, launches):
            if name in out:
                launches += out[name][2]
            out[name] = (k, n_, launches)

        g = self.n_groups
        for spec in self.pattern:
            if spec.mixer == "rwkv":
                rc = self.rwkv
                add("lora_a", d, 5 * rc.lora_mix, g)
                add("lora_b", rc.lora_mix, d, 5 * g)
                add("wr/wk/wv/wg/wo", d, d, 5 * g)
                add("w_lora_a", d, rc.lora_decay, g)
                add("w_lora_b", rc.lora_decay, d, g)
            elif spec.mixer == "mamba":
                mc = self.mamba or MambaConfig()
                di, r = mc.expand * d, mc.resolve_dt_rank(d)
                add("in_proj", d, 2 * di, g)
                add("x_proj", di, r + 2 * mc.d_state, g)
                add("dt_proj", r, di, g)
                add("out_proj", di, d, g)
            else:
                qn = self.n_heads * self.d_head
                kvn = self.n_kv_heads * self.d_head
                add("wq", d, qn, g)
                add("wk/wv", d, kvn, 2 * g)
                add("wo", qn, d, g)
                if self.encoder_decoder:
                    add("cross wq", d, qn, g)
                    if step == "prefill":
                        add("cross wk/wv", d, kvn, 2 * g)
                    add("cross wo", qn, d, g)
            if spec.ffn == "rwkv_cm":
                add("cm_wk", d, f, g)
                add("cm_wv", f, d, g)
                add("cm_wr", d, d, g)
            elif spec.ffn == "moe":
                mo = self.moe
                add("router", d, mo.num_experts, g)
                if mo.n_shared:
                    sf = mo.shared_d_ff or mo.d_ff * mo.n_shared
                    add("shared gate/up", d, sf, 2 * g)
                    add("shared down", sf, d, g)
            elif self.ffn_kind == "swiglu":
                add("gate/up", d, f, 2 * g)
                add("down", f, d, g)
            else:
                add("up", d, f, g)
                add("down", f, d, g)
        add("lm_head", d, v, 1)
        if self.encoder_decoder and step == "prefill":
            e = self.n_encoder_layers
            add("enc wq", d, self.n_heads * self.d_head, e)
            add("enc wk/wv", d, self.n_kv_heads * self.d_head, 2 * e)
            add("enc wo", self.n_heads * self.d_head, d, e)
            if self.ffn_kind == "swiglu":
                add("enc gate/up", d, f, 2 * e)
            else:
                add("enc up", d, f, e)
            add("enc down", f, d, e)
        return out

    def gemm_dtype(self, site: str) -> torch.dtype:
        """The dtype a :meth:`gemm_shapes` site runs in: the compute dtype,
        but f32 for the MoE router (the reference routes on f32
        activations, ``repro/models/moe.py:90``)."""
        return torch.float32 if site == "router" else self.cdtype

    def n_params(self) -> int:
        """Total parameter count, as the reference counts it (analytic:
        the rwkv loras at their default ranks, norms, biases and mixing
        vectors left out; an encoder's layers counted with a SwiGLU FFN and
        the cross attention once a decoder layer, as the reference does)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for spec in self.pattern:
            n = 0
            if spec.mixer == "attn":
                n += d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                n += self.n_heads * self.d_head * d
            elif spec.mixer == "mamba":
                mc = self.mamba or MambaConfig()
                di = mc.expand * d
                n += d * 2 * di + di * d            # in/out proj
                n += mc.d_conv * di
                n += di * (mc.resolve_dt_rank(d) + 2 * mc.d_state)
                n += mc.resolve_dt_rank(d) * di + di * mc.d_state
            elif spec.mixer == "rwkv":
                n += 5 * d * d                       # r,k,v,g,o
                n += d * 5 * 32 + 5 * 32 * d         # ddlerp loras
                n += d * 64 + 64 * d                 # decay lora
            if spec.ffn == "dense":
                n += (3 if self.ffn_kind == "swiglu" else 2) * d * f
            elif spec.ffn == "moe":
                mo = self.moe
                n += d * mo.num_experts
                n += 3 * d * mo.d_ff * mo.num_experts
                if mo.n_shared:
                    n += 3 * d * (mo.shared_d_ff or mo.d_ff * mo.n_shared)
            elif spec.ffn == "rwkv_cm":
                n += 2 * d * f + d * d
            total += n * self.n_groups
        if self.encoder_decoder:
            attn = (d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                    + self.n_heads * self.d_head * d)
            total += (self.n_encoder_layers * (attn + 3 * d * f)
                      + self.n_layers * attn)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        moe_layers = sum(1 for s in self.pattern if s.ffn == "moe") \
            * self.n_groups
        per_expert = 3 * self.d_model * self.moe.d_ff * moe_layers
        return (self.n_params() - per_expert * self.moe.num_experts
                + per_expert * self.moe.top_k)
