"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They are what a kernel wrapper runs for CPU tensors, what ``mode="ref"``
selects, and what ``chip_smoke.py`` holds every kernel against on the
card.  They follow the kernels' semantics where those differ from the JAX
oracles: masked logits are ``-1e30``, not ``-inf``, so a fully masked
attention row (or a zero-length decode slot) is zeros, not NaN.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Plain rmsnorm over the last dim, in f32 as the reference, output in
    x's dtype.  The mean of squares is summed in float64 and rounded once
    to f32: torch's reduction kernels pick their thread layout from the
    number of rows in a call, so an f32 sum over one row may round
    differently in a batch of 1 and of 3; in float64 the order (almost
    never) reaches the f32 result, which keeps a row's output independent
    of its batch on the CPU.  The kernel (``csrc/rmsnorm.cu``) gets that
    property from a fixed f32 summation order instead."""
    xf = x.float()
    var = xf.double().square().mean(-1, keepdim=True).float()
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it: (s = x + r, rmsnorm(s)),
    the plain version of the fused ``rmsnorm`` kernel."""
    s = x + r
    return s, rmsnorm(s, scale, eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5, groups: int = 1) -> torch.Tensor:
    """Plain LayerNorm over the last dim in f32, as the reference, output
    in x's dtype; with ``groups`` > 1 a GroupNorm: each of the ``groups``
    consecutive slices of a row normalised on its own, then the row's
    (d,) scale and bias applied (RWKV's wkv output, one group a head).
    Plain torch ops throughout, so torch autograd differentiates it."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, groups, d // groups)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (out * scale.float() + bias.float()).to(x.dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """int8 codes q (..., K, N) times their f32 scales (..., N), one per
    column of each (K, N) matrix (scale's leading dims are q's first ones,
    or none), in f32, rounded to ``dtype``: the reference's
    ``dequantize_weight``."""
    mid = (1,) * (q.dim() - scale.dim())
    s = scale.reshape(*scale.shape[:-1], *mid, scale.shape[-1])
    return (q.float() * s).to(dtype)


def _softmax_av(s: torch.Tensor, valid: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Masked softmax(s) @ v with the kernels' guards: masked logits at
    -1e30 contribute 0, and a row with no valid key gives 0."""
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    return (p @ v) / torch.where(l > 0, l, 1.0)


def _attention_mask(sq: int, sk: int, causal: bool, q_offset: int,
                    kv_len: int, device) -> torch.Tensor:
    """(Sq, Sk) True where query i (at position q_offset + i) sees key j."""
    k_pos = torch.arange(sk, device=device)
    valid = (k_pos < kv_len)[None, :]
    if causal:
        q_pos = torch.arange(sq, device=device) + q_offset
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    return valid


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  q_offset: int = 0, kv_len: Optional[int] = None,
                  return_lse: bool = False):
    """Plain flash_attention.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).
    Query head h reads KV head h // (Hq // Hkv); ``q_offset`` is q[0]'s
    absolute position for the causal mask; keys at or past ``kv_len``
    (default Sk) are masked.  ``return_lse``: (out, each row's
    log-sum-exp of its scaled valid logits (B, Hq, Sq) f32, +inf for a row
    with no valid key), as the kernel writes it for the backward."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kv_len = sk if kv_len is None else kv_len
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    valid = _attention_mask(sq, sk, causal, q_offset, kv_len, q.device)
    out = _softmax_av(s, valid, vf).to(q.dtype)
    if not return_lse:
        return out
    m = torch.where(valid, s, NEG_INF).amax(-1)
    l = torch.where(valid, torch.exp(s - m[..., None]), 0.0).sum(-1)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                      float("inf"))
    return out, lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                  scale: Optional[float] = None):
    """Plain flash_attention_bwd: the VJP of causal attention at q_offset 0
    over S queries and S keys, from the forward's output ``o`` and its
    rows' log-sum-exp ``lse`` (B, Hq, S) f32, in f32 as the kernel's
    formulas (FlashAttention-2's backward):

        P = exp(s - lse),  delta = rowsum(dout * o),
        dS = P * (dout.V^T - delta),
        dq = scale dS.K,  dk = scale dS^T.Q,  dv = P^T.dout,

    with s = scale q.k^T and dk, dv summed over each KV head's query heads.
    Returns (dq, dk, dv) in q's dtype."""
    b, hq, s_len, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qf, of, dof = q.float(), o.float(), dout.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    valid = _attention_mask(s_len, s_len, True, 0, s_len, q.device)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, hkv, group, s_len, d).sum(2)
    dv = dv.reshape(b, hkv, group, s_len, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      q_offset: int = 0, kv_len: Optional[int] = None,
                      q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """The flash-attention algorithm in plain torch ops (the reference's
    ``chunked_attention``): an online softmax over ``kv_chunk``-key
    blocks for each ``q_chunk``-row block of queries, so memory is
    O(B * H * q_chunk * kv_chunk) instead of the O(Sq * Sk) logits of
    :func:`ref_attention`, whose function it computes (masked logits at
    -1e30, a row with no valid key gives zeros).  ``ops.attention``'s
    plain path takes it past 2048 keys, as the reference's does."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kv_len = sk if kv_len is None else kv_len
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, q_chunk):
        qf = q[:, :, q0:q0 + q_chunk].float()
        rows = qf.shape[2]
        q_pos = torch.arange(rows, device=q.device) + q_offset + q0
        m = torch.full((b, hq, rows), NEG_INF, device=q.device)
        l = torch.zeros((b, hq, rows), device=q.device)
        acc = torch.zeros((b, hq, rows, d), device=q.device)
        for k0 in range(0, sk, kv_chunk):
            kf = k[:, :, k0:k0 + kv_chunk].float().repeat_interleave(group, 1)
            vf = v[:, :, k0:k0 + kv_chunk].float().repeat_interleave(group, 1)
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
            k_pos = torch.arange(kf.shape[2], device=q.device) + k0
            valid = (k_pos < kv_len)[None, :]
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf
            m = m_new
        safe_l = torch.where(l > 0, l, 1.0)
        out[:, :, q0:q0 + rows] = (acc / safe_l[..., None]).to(q.dtype)
    return out


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


def ref_wkv_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: Optional[torch.Tensor] = None):
    """Plain wkv6 from the state ``s0`` (B, H, N, N) f32 (None: zero).
    r/k/v/w: (B, H, T, N); u: (H, N) -> (y (B, H, T, N) in r's dtype, the
    final state (B, H, N, N) f32), computed in f32 a step at a time in the
    order of the reference's ``_wkv_step`` (``repro/models/rwkv.py``):
    a_t = k_t^T v_t; y_t = r_t (S + diag(u) a_t); S <- diag(w_t) S + a_t.
    Plain torch ops throughout, so torch autograd differentiates it."""
    b, h, t, n = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[:, :, None]                        # (H, N, 1)
    s = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for i in range(t):
        a = kf[:, :, i, :, None] * vf[:, :, i, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, :, i], s + uf * a))
        s = wf[:, :, i, :, None] * s + a
    return torch.stack(ys, dim=2).to(r.dtype), s


def ref_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain wkv6 from the zero state: :func:`ref_wkv_state`'s y."""
    return ref_wkv_state(r, k, v, w, u)[0]


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


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """Plain selective scan, Mamba's S6 recurrence from the state ``h0``.
    dt, x (B, T, di) in the compute dtype; bm, c (B, T, N); a (di, N) f32
    (``-exp(a_log)``); h0 (B, di, N) f32 -> (y (B, T, di) in x's dtype,
    the final state (B, di, N) f32), a step at a time in f32 with the
    reference's rounding points (``repro/models/mamba.py:140-158``)::

        h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) B_t
        y_t = sum_n h_t[:, n] C_t[n]

    Plain torch ops throughout, so torch autograd differentiates it."""
    dtf, cf = dt.float(), c.float()
    dtx = dtf * x.float()
    bf = bm.float()
    h = h0.float()
    ys = []
    for i in range(dt.shape[1]):
        h = (torch.exp(dtf[:, i, :, None] * a) * h
             + dtx[:, i, :, None] * bf[:, i, None, :])
        ys.append((h * cf[:, i, None, :]).sum(-1))
    if not ys:
        return x.new_empty(x.shape), h
    return torch.stack(ys, dim=1).to(x.dtype), h


def selective_scan_bwd(dt: torch.Tensor, x: torch.Tensor, bm: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                       gy: torch.Tensor,
                       ght: Optional[torch.Tensor] = None):
    """Plain VJP of :func:`selective_scan` for the output gradient gy (B,
    T, di) and, optionally, the final state's ght (B, di, N) f32 ->
    (gdt, gx, gbm, gc in their inputs' dtype, ga (di, N) and gh0 (B, di,
    N) in f32).  With dA_t = exp(dt_t a), dtx_t = dt_t x_t, h_t the state
    after step t (kept from a forward walk) and g_t the gradient flowing
    into h_t (g_T = gy_T C_T + ght, g_t = gy_t C_t + dA_{t+1} g_{t+1}):

    * gc_t[n] = sum_d gy_t[d] h_t[d, n]; gbm_t[n] = sum_d g_t[d, n] dtx_t[d]
    * gdtx_t[d] = sum_n g_t[d, n] B_t[n]; gx_t = gdtx_t dt_t
    * gdt_t[d] = gdtx_t[d] x_t[d] + sum_n g_t h_{t-1} dA_t a
    * ga = sum_{b, t} g_t h_{t-1} dA_t dt_t; gh0 = dA_1 g_1

    every value in f32, each output rounded once.  A walk of plain torch
    ops a step at a time, as the kernel's (``csrc/selective_scan.cu``)."""
    b, t, di = dt.shape
    dtf, xf, bf, cf, gyf = (v.float() for v in (dt, x, bm, c, gy))
    dtx = dtf * xf
    h = h0.float()
    states, decays = [h], []
    for i in range(t):
        da = torch.exp(dtf[:, i, :, None] * a)
        h = da * h + dtx[:, i, :, None] * bf[:, i, None, :]
        decays.append(da)
        states.append(h)
    g_next = (torch.zeros_like(h) if ght is None else ght.float())
    gdt, gx, gbm, gc = (torch.empty_like(v) for v in (dtf, xf, bf, cf))
    ga = torch.zeros_like(a, dtype=torch.float32)
    for i in reversed(range(t)):
        g = gyf[:, i, :, None] * cf[:, i, None, :] + g_next
        gc[:, i] = (gyf[:, i, :, None] * states[i + 1]).sum(1)
        gbm[:, i] = (g * dtx[:, i, :, None]).sum(1)
        gdtx = (g * bf[:, i, None, :]).sum(-1)
        v = g * states[i] * decays[i]
        gdt[:, i] = gdtx * xf[:, i] + (v * a).sum(-1)
        gx[:, i] = gdtx * dtf[:, i]
        ga = ga + (v * dtf[:, i, :, None]).sum(0)
        g_next = decays[i] * g
    return (gdt.to(dt.dtype), gx.to(x.dtype), gbm.to(bm.dtype),
            gc.to(c.dtype), ga, g_next)
