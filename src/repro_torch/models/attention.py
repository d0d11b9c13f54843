"""Grouped-query attention with RoPE, qk-norm and a dense or paged KV
cache (counterpart of ``repro/models/attention.py``).

Execution shapes:
  * no cache: full causal self-attention;
  * prefill: causal self-attention over a dense cache at a scalar offset
    (``cache_pos``), which also writes the prompt's KV into the cache;
  * decode: one new token per slot (S == 1) at per-slot positions — a
    (B,) ``cache_pos`` — against each slot's own valid prefix, in a dense
    cache or in a page pool addressed through ``block_tables``.

The cache is updated **in place** (the reference returns a new cache from
``dynamic_update_slice`` and ``.at[].set``); :func:`attention` returns the
same dict it was given.  Cross-attention and M-RoPE wait for later slices
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import torch_dtype

Params = Dict[str, Any]


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, d_head: int, qk_norm: bool = False,
                   dtype: torch.dtype = torch.float32,
                   device: Union[str, torch.device] = "cpu") -> Params:
    p = {
        "wq": L.dense_init(gen, d_model, n_heads * d_head, dtype, device),
        "wk": L.dense_init(gen, d_model, n_kv_heads * d_head, dtype, device),
        "wv": L.dense_init(gen, d_model, n_kv_heads * d_head, dtype, device),
        "wo": L.dense_init(gen, n_heads * d_head, d_model, dtype, device),
    }
    if qk_norm:
        p["q_norm"] = L.norm_init(d_head, dtype, device)
        p["k_norm"] = L.norm_init(d_head, dtype, device)
    return p


def init_kv_cache(batch: int, n_kv_heads: int, max_len: int, d_head: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Union[str, torch.device] = "cpu") -> Params:
    shape = (batch, n_kv_heads, max_len, d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(num_pages: int, n_kv_heads: int, page_size: int,
                        d_head: int, dtype: torch.dtype = torch.bfloat16,
                        kv_dtype: Optional[str] = None,
                        device: Union[str, torch.device] = "cpu") -> Params:
    """Paged pool layout (``repro_torch.serving.kvpool``): ``num_pages``
    pages of ``page_size`` token rows shared by every slot, addressed
    through a per-slot block table.  ``num_pages`` already includes the
    null sink page (the engine allocates pool + 1).

    ``kv_dtype`` overrides the page dtype: a float name retypes the pools;
    ``"int8"`` adds per-row f32 scale rows ``k_scale``/``v_scale``
    (num_pages, Hkv, page_size), the layout the paged decode kernel
    dequantizes."""
    page_dtype = (dtype if kv_dtype is None else torch.int8
                  if kv_dtype == "int8" else torch_dtype(kv_dtype))
    shape = (num_pages, n_kv_heads, page_size, d_head)
    cache = {"k_pages": torch.zeros(shape, dtype=page_dtype, device=device),
             "v_pages": torch.zeros(shape, dtype=page_dtype, device=device)}
    if page_dtype == torch.int8:
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:3], dtype=torch.float32,
                                     device=device)
    return cache


def _paged_decode(cache: Params, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cache_pos: torch.Tensor,
                  block_tables: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Decode against a page pool: write each slot's new KV row in place at
    row ``pos % ps`` of page ``block_tables[b, pos // ps]``, then attend
    over the slot's ``pos + 1`` rows.  Free slots all point at the null
    sink page, so their writes collide there; which one wins is undefined
    and harmless, as no live slot's length reaches the sink.  int8 pools
    quantize exactly the appended row and write its scale.  q: (B, H, D);
    k/v: (B, Hkv, D).  Returns (B, H, D)."""
    ps = cache["k_pages"].shape[2]
    dev = cache["k_pages"].device
    pos = cache_pos.to(device=dev, dtype=torch.long)
    bt = block_tables.to(device=dev, dtype=torch.int32)
    page_ids = bt[torch.arange(bt.shape[0], device=dev), pos // ps].long()
    rows = pos % ps
    length = (pos + 1).to(torch.int32)
    if "k_scale" in cache:
        from repro_torch.serving.quant import quantize_kv_row
        for key, x in (("k", k), ("v", v)):
            xq, xs = quantize_kv_row(x)
            cache[f"{key}_pages"][page_ids, :, rows] = xq
            cache[f"{key}_scale"][page_ids, :, rows] = xs
        return ops.decode_paged(q, cache["k_pages"], cache["v_pages"],
                                block_tables=bt, length=length,
                                k_scale=cache["k_scale"],
                                v_scale=cache["v_scale"])
    pools = []
    for key, x in (("k", k), ("v", v)):
        pool = cache[f"{key}_pages"]
        pool[page_ids, :, rows] = x.to(pool.dtype)
        # A pool stored in another float dtype is read as the compute one.
        pools.append(pool if pool.dtype == dtype else pool.to(dtype))
    return ops.decode_paged(q, pools[0], pools[1], block_tables=bt,
                            length=length)


def attention(
    p: Params,
    x: torch.Tensor,                          # (B, S, d_model)
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    positions: Optional[torch.Tensor] = None,     # (B, S)
    rope_theta: float = 10000.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    qk_norm: bool = False,
    causal: bool = True,
    cache: Optional[Params] = None,
    cache_pos: Union[int, torch.Tensor, None] = None,   # int or (B,)
    block_tables: Optional[torch.Tensor] = None,
    kv_from: Optional[torch.Tensor] = None,
    use_cached_kv: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (output (B, S, d_model), the cache updated in place)."""
    if use_cached_kv or kv_from is not None:
        raise NotImplementedError(
            "cross-attention comes with the enc-dec architectures "
            "(ROADMAP Queue A item 10)")
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE comes with qwen2_vl (ROADMAP Queue A item 10)")
    b, s, _ = x.shape
    q = L.dense(p["wq"], x).reshape(b, s, n_heads, d_head)
    k = L.dense(p["wk"], x).reshape(b, s, n_kv_heads, d_head)
    v = L.dense(p["wv"], x).reshape(b, s, n_kv_heads, d_head)
    if qk_norm:
        q = L.rmsnorm(p["q_norm"], q)
        k = L.rmsnorm(p["k_norm"], k)
    if positions is not None:
        angles = L.rope_angles(positions, d_head, rope_theta)
        q = L.apply_rope(q, angles)
        k = L.apply_rope(k, angles)
    q = q.transpose(1, 2).contiguous()      # (B, H, S, D)
    k = k.transpose(1, 2)                   # (B, Hkv, S, D)
    v = v.transpose(1, 2)

    ragged = isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1
    if ragged and s != 1:
        raise NotImplementedError(
            "per-slot cache_pos is a decode-only shape (S == 1); prefill "
            "admits one request at a time at its own scalar offset")
    if cache is not None and "k_pages" in cache:
        # Paged KV is decode-only: prefill runs against a dense one-slot
        # cache whose pages the engine scatters into the pool.
        if not ragged or block_tables is None:
            raise NotImplementedError(
                "paged KV attention needs per-slot cache_pos and "
                "block_tables (the continuous-batching decode shape)")
        out = _paged_decode(cache, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                            cache_pos, block_tables, x.dtype)
        return L.dense(p["wo"], out.reshape(b, s, n_heads * d_head)), cache
    q_off = 0
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        max_len = ck.shape[2]
        if ragged:
            # Continuous batching: each slot writes its new KV row at its
            # own position, in place (an indexed write per slot).
            pos = cache_pos.to(device=ck.device, dtype=torch.long)
            slots = torch.arange(b, device=ck.device)
            ck[slots, :, pos] = k[:, :, 0].to(ck.dtype)
            cv[slots, :, pos] = v[:, :, 0].to(cv.dtype)
        else:
            q_off = 0 if cache_pos is None else int(cache_pos)
            if not 0 <= q_off <= max_len - s:
                raise ValueError(f"cache write [{q_off}, {q_off + s}) is "
                                 f"outside the {max_len}-row cache")
            ck[:, :, q_off:q_off + s] = k.to(ck.dtype)
            cv[:, :, q_off:q_off + s] = v.to(cv.dtype)
        k = ck if ck.dtype == x.dtype else ck.to(x.dtype)
        v = cv if cv.dtype == x.dtype else cv.to(x.dtype)
    else:
        k, v = k.contiguous(), v.contiguous()

    if s == 1 and cache is not None:
        # Decode: one token per slot against its own valid prefix.
        pos = torch.as_tensor(cache_pos, dtype=torch.int32, device=x.device)
        length = torch.broadcast_to(pos + 1, (b,))
        out = ops.decode(q[:, :, 0], k, v, length=length)
        out = out[:, :, None]                         # (B, H, 1, D)
    else:
        out = ops.attention(q, k, v, causal=causal, q_offset=q_off)
    out = out.transpose(1, 2).reshape(b, s, n_heads * d_head)
    return L.dense(p["wo"], out), cache
