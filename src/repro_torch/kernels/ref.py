"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They are what a kernel wrapper runs for CPU tensors, what ``mode="ref"``
selects, and what ``chip_smoke.py`` holds every kernel against on the
card.  They follow the kernels' semantics where those differ from the JAX
oracles: masked logits are ``-1e30``, not ``-inf``, so a fully masked
attention row (or a zero-length decode slot) is zeros, not NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
_INT_RANGE = {torch.int8: (-128, 127), torch.int16: (-32768, 32767)}


def requantize(acc: torch.Tensor, out_dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    """Accumulator -> output conversion: an integer accumulator headed for
    int8/int16 is scaled in f32, rounded half to even (``torch.round``)
    and saturated; everything else is a plain cast (float GEMMs ignore
    ``scale``)."""
    if not acc.is_floating_point() and out_dtype in _INT_RANGE:
        lo, hi = _INT_RANGE[out_dtype]
        return torch.clamp(torch.round(acc.float() * scale), lo,
                           hi).to(out_dtype)
    return acc.to(out_dtype)


def ref_gemm(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
             scale: float = 1.0) -> torch.Tensor:
    """Plain gama_gemm: int8 inputs accumulate exactly (through float64,
    exact for |sum| < 2**53, which every int8 GEMM with K < 2**38 keeps),
    floats in f32."""
    integer = not a.is_floating_point()
    if out_dtype is None:
        out_dtype = torch.int32 if integer else a.dtype
    if integer:
        acc = (a.double() @ b.double()).to(torch.int32)
    else:
        acc = a.float() @ b.float()
    return requantize(acc, out_dtype, scale)


def _softmax_av(s: torch.Tensor, valid: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Masked softmax(s) @ v with the kernels' guards: masked logits at
    -1e30 contribute 0, and a row with no valid key gives 0."""
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    return (p @ v) / torch.where(l > 0, l, 1.0)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain flash_attention.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).
    Query head h reads KV head h // (Hq // Hkv); ``q_offset`` is q[0]'s
    absolute position for the causal mask; keys at or past ``kv_len``
    (default Sk) are masked."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kv_len = sk if kv_len is None else kv_len
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    k_pos = torch.arange(sk, device=q.device)
    valid = (k_pos < kv_len)[None, :]
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    return _softmax_av(s, valid, vf).to(q.dtype)


def ref_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, length: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain flash_decode.  q: (B, Hq, D) one token; k/v: (B, Hkv, Sk, D);
    ``length`` (B,) masks each slot's valid KV prefix (default Sk)."""
    b, hq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kf)[:, :, None] * scale
    k_pos = torch.arange(sk, device=q.device)
    if length is None:
        valid = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=q.device)
    else:
        valid = (k_pos[None, :] < length.to(q.device)[:, None])[:, None, None]
    return _softmax_av(s, valid, vf)[:, :, 0].to(q.dtype)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """A contiguous per-slot cache from a page pool: pool (P, Hkv, ps, D),
    block_tables (B, max_pages) -> (B, Hkv, max_pages * ps, D), position
    ``t`` of slot ``b`` being row ``t % ps`` of page
    ``block_tables[b, t // ps]``.  (The kernel never builds this.)"""
    _, hkv, ps, d = pool.shape
    b, n_pages = block_tables.shape
    gathered = pool[block_tables.long()]         # (B, max_pages, Hkv, ps, D)
    return gathered.permute(0, 2, 1, 3, 4).reshape(b, hkv, n_pages * ps, d)


def dequantize_pool(pages: torch.Tensor,
                    page_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Apply per-row scale rows to an int8 pool: (P, Hkv, ps, D) int8 x
    (P, Hkv, ps) f32 -> f32 values (``serving.quant.dequantize_kv``'s
    product).  With ``page_scale=None`` the pool passes through."""
    if page_scale is None:
        return pages
    return pages.float() * page_scale[..., None]


def ref_paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor, *,
                               length: torch.Tensor,
                               scale: Optional[float] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain flash_paged_decode: dequantize the pools, gather each slot's
    pages, then the dense decode.  Rows at or past ``length`` (the partial
    last page, and the null sink page that unallocated table entries
    point at) are zeroed before they meet a zero softmax weight, as the
    kernel never reads them: whatever the sink holds stays unreachable."""
    kc = gather_pages(dequantize_pool(k_pages, k_scale), block_tables)
    vc = gather_pages(dequantize_pool(v_pages, v_scale), block_tables)
    rows = torch.arange(kc.shape[2], device=kc.device)
    live = (rows[None, :] < length.to(kc.device)[:, None])[:, None, :, None]
    kc, vc = kc.masked_fill(~live, 0), vc.masked_fill(~live, 0)
    return ref_decode_attention(q, kc, vc, length=length, scale=scale)


def ref_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain wkv6 from the zero state.  r/k/v/w: (B, H, T, N); u: (H, N)
    -> y (B, H, T, N) in r's dtype, computed in f32:
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} + a_t.
    Plain torch ops throughout, so torch autograd differentiates it."""
    b, h, t, n = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[:, :, None]                        # (H, N, 1)
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for i in range(t):
        a = kf[:, :, i, :, None] * vf[:, :, i, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, :, i], s + uf * a))
        s = wf[:, :, i, :, None] * s + a
    return torch.stack(ys, dim=2).to(r.dtype)


def ref_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, gy: torch.Tensor):
    """Plain VJP of :func:`ref_wkv`: (gr, gk, gv, gw, gu) for the output
    gradient gy (B, H, T, N), each in its input's dtype.  With S_t the
    state after step t (S_0 = 0) and G_t the gradient flowing into S_t
    from later steps (G_T = 0, G_{t-1} = diag(w_t) G_t + r_t gy_t^T):

    * gr_t = (S_{t-1} + diag(u) k_t v_t^T) gy_t
    * gk_t[n] = sum_m (G_t + diag(u) r_t gy_t^T)[n, m] v_t[m]
    * gv_t[m] = sum_n (G_t + diag(u) r_t gy_t^T)[n, m] k_t[n]
    * gw_t[n] = sum_m G_t[n, m] S_{t-1}[n, m]
    * gu[h, n] = sum_{b, t} r_t[n] k_t[n] (v_t . gy_t)

    Every S_{t-1} is kept from a forward pass (never recovered by dividing
    by w_t, which may underflow to 0)."""
    b, h, t, n = r.shape
    rf, kf, vf, wf, gf = (x.float() for x in (r, k, v, w, gy))
    uf = u.float()
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    prev = []
    for i in range(t):
        prev.append(s)
        s = wf[:, :, i, :, None] * s + kf[:, :, i, :, None] * vf[:, :, i, None, :]
    g = torch.zeros_like(s)
    grads = {name: [None] * t for name in ("r", "k", "v", "w")}
    gu = torch.zeros((h, n), dtype=torch.float32, device=r.device)
    for i in reversed(range(t)):
        ri, ki, vi, wi, gi = (x[:, :, i] for x in (rf, kf, vf, wf, gf))
        vg = (vi * gi).sum(-1, keepdim=True)                    # (B, H, 1)
        m = g + (uf * ri)[..., :, None] * gi[..., None, :]
        grads["r"][i] = (torch.einsum("bhnm,bhm->bhn", prev[i], gi)
                         + uf * ki * vg)
        grads["k"][i] = torch.einsum("bhnm,bhm->bhn", m, vi)
        grads["v"][i] = torch.einsum("bhnm,bhn->bhm", m, ki)
        grads["w"][i] = (g * prev[i]).sum(-1)
        gu = gu + (ri * ki * vg).sum(0)
        g = wi[..., :, None] * g + ri[..., :, None] * gi[..., None, :]
    gr, gk, gv, gw = (torch.stack(grads[x], dim=2).to(dt) for x, dt in
                      (("r", r.dtype), ("k", k.dtype), ("v", v.dtype),
                       ("w", w.dtype)))
    return gr, gk, gv, gw, gu.to(u.dtype)


# ---------------------------------------------------------------------------
# wkv6 in chunks of time: the phases of csrc/wkv.cu, in plain torch.  Only
# the tests run these; they hold the kernels' algorithm against ref_wkv,
# ref_wkv_bwd and the JAX package on the CPU.
# ---------------------------------------------------------------------------


def _wkv_chunked_inputs(chunk: int, *xs: torch.Tensor):
    """Each (B, H, T, N) input in f32, T padded to a multiple of ``chunk``
    and split as (B, H, C, chunk, N).  The last of ``xs`` is w, padded
    with 1 (padded steps keep the state as it is); the others with 0."""
    b, h, t, n = xs[0].shape
    c = -(-t // chunk)
    out = []
    for i, x in enumerate(xs):
        x = x.float()
        pad = c * chunk - t
        if pad:
            fill = 1.0 if i == len(xs) - 1 else 0.0
            x = torch.cat([x, x.new_full((b, h, pad, n), fill)], dim=2)
        out.append(x.reshape(b, h, c, chunk, n))
    return out


def _wkv_chunk_states(a: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      reverse: bool):
    """Phase A: every chunk's state from zero, X <- diag(w_t) X + a_t x_t^T
    over its steps (in reverse order for the gradient's recurrence), and
    the product of its decays.  a, x, w: (B, H, C, L, N)."""
    steps = range(a.shape[3])
    xs = torch.zeros(a.shape[:3] + (a.shape[4], a.shape[4]),
                     dtype=torch.float32, device=a.device)
    decay = torch.ones_like(a[:, :, :, 0])
    for i in (reversed(steps) if reverse else steps):
        xs = w[:, :, :, i, :, None] * xs + a[:, :, :, i, :, None] * \
            x[:, :, :, i, None, :]
        decay = decay * w[:, :, :, i]
    return xs, decay


def _wkv_scan(local: torch.Tensor, decay: torch.Tensor, reverse: bool):
    """Phase B: the state each chunk starts from (forward: S entering chunk
    c, from S_0 = 0) or ends at (reverse: G leaving chunk c, from G_T = 0):
    start(c + 1) = diag(W_c) start(c) + local_c, in chunk order."""
    c = local.shape[2]
    out = [None] * c
    x = torch.zeros_like(local[:, :, 0])
    order = range(c - 1, -1, -1) if reverse else range(c)
    for i in order:
        out[i] = x
        x = decay[:, :, i, :, None] * x + local[:, :, i]
    return torch.stack(out, dim=2)


def ref_wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, chunk: int
                    ) -> torch.Tensor:
    """:func:`ref_wkv` in the kernel's three phases over chunks of
    ``chunk`` steps: (A) each chunk's state from zero and its decay
    product, (B) a scan over the chunks for the state each one starts
    from, (C) every chunk replays its steps from that state.  No division
    anywhere: a product of decays that underflows to 0 is the answer."""
    b, h, t, n = r.shape
    rc, kc, vc, wc = _wkv_chunked_inputs(chunk, r, k, v, w)
    start = _wkv_scan(*_wkv_chunk_states(kc, vc, wc, False), False)
    uf = u.float()[:, None, :, None]                  # (H, 1, N, 1)
    s, ys = start, []
    for i in range(chunk):
        a = kc[:, :, :, i, :, None] * vc[:, :, :, i, None, :]
        ys.append(torch.einsum("bhcn,bhcnm->bhcm", rc[:, :, :, i],
                               s + uf * a))
        s = wc[:, :, :, i, :, None] * s + a
    y = torch.stack(ys, dim=3).reshape(b, h, -1, n)[:, :, :t]
    return y.to(r.dtype)


def ref_wkv_bwd_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, gy: torch.Tensor,
                        chunk: int):
    """:func:`ref_wkv_bwd` in the kernel's phases: the forward scan gives
    the state S each chunk starts from; the same phases run backwards in
    time over G_{t-1} = diag(w_t) G_t + r_t gy_t^T give the gradient G
    each chunk ends with; then every chunk replays its own states from its
    S and walks back from its G.  gu is summed per (b, h, chunk), then
    over (b, chunk)."""
    b, h, t, n = r.shape
    rc, kc, vc, gc, wc = _wkv_chunked_inputs(chunk, r, k, v, gy, w)
    s = _wkv_scan(*_wkv_chunk_states(kc, vc, wc, False), False)
    g = _wkv_scan(*_wkv_chunk_states(rc, gc, wc, True), True)
    uf = u.float()[:, None, :]                        # (H, 1, N)
    prev = []
    for i in range(chunk):
        prev.append(s)
        s = wc[:, :, :, i, :, None] * s + kc[:, :, :, i, :, None] * \
            vc[:, :, :, i, None, :]
    grads = {x: [None] * chunk for x in "rkvw"}
    gu = torch.zeros_like(rc[:, :, :, 0])             # (B, H, C, N)
    for i in reversed(range(chunk)):
        ri, ki, vi, wi, gi = (x[:, :, :, i] for x in (rc, kc, vc, wc, gc))
        vg = (vi * gi).sum(-1, keepdim=True)
        m = g + (uf * ri)[..., :, None] * gi[..., None, :]
        grads["r"][i] = (torch.einsum("bhcnm,bhcm->bhcn", prev[i], gi)
                         + uf * ki * vg)
        grads["k"][i] = torch.einsum("bhcnm,bhcm->bhcn", m, vi)
        grads["v"][i] = torch.einsum("bhcnm,bhcn->bhcm", m, ki)
        grads["w"][i] = (g * prev[i]).sum(-1)
        gu = gu + ri * ki * vg
        g = wi[..., :, None] * g + ri[..., :, None] * gi[..., None, :]
    gr, gk, gv, gw = (torch.stack(grads[x], dim=3).reshape(b, h, -1, n)
                      [:, :, :t].to(dt) for x, dt in
                      (("r", r.dtype), ("k", k.dtype), ("v", v.dtype),
                       ("w", w.dtype)))
    return gr, gk, gv, gw, gu.sum((0, 2)).to(u.dtype)
