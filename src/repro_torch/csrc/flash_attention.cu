// Flash attention (forward) on Hopper, for prefill.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel).  Same function: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D),
// query head h reads KV head h / (Hq / Hkv) (GQA, no KV replication), f32
// softmax, output in q's dtype.  Causal masking against an absolute q_offset,
// a kv_len mask for a cache longer than its valid prefix, KV tiles entirely
// in the future skipped, masked logits of -1e30 and a zero-denominator row
// giving 0.  q_offset and kv_len are runtime arguments here (trace-time
// constants in the TPU kernel).
//
// Two kernels, chosen by dtype alone (kernels/flash_attention.py:plan):
//   * bf16: flash_attention_tc_kernel, FlashAttention-2 on the tensor cores.
//     A block owns `rows` query rows of `heads` query heads (1, or the whole
//     GQA group of one KV head, so the group's K/V tiles are read once), one
//     warp per 16 rows of one head.  Q is loaded once (cp.async, ldmatrix)
//     and kept as mma A-fragments.  K and V tiles of BK = 64 keys stay bf16 in
//     a 2-4 stage shared-memory ring filled by 16-byte cp.async while the
//     oldest tile is used; rows are padded by 16 bytes so ldmatrix is
//     conflict-free, and rows past Sk are zero-filled, never read.  S = Q.K^T
//     and O += P.V are mma.sync m16n8k16 bf16 -> f32 (K by ldmatrix, V by
//     ldmatrix.trans); the online softmax runs on the S fragments in
//     registers, each row's max and sum reduced over the 4 lanes that hold
//     it; P is rounded to bf16 in registers and is directly the A-fragment of
//     P.V.  Masks are applied only on tiles that straddle them; tiles past the
//     block's last visible key are neither loaded nor computed.  Blocks of the
//     latest (heaviest) query tile are launched first.
//   * f32: flash_attention_simt_kernel, SIMT FMA (the tensor cores take f32
//     only as TF32, which would break the f32 check), at head dims 16 (the
//     SMOKE configs), 64 and 128; bf16 takes 64 and 128.
//
// A row's bits do not depend on how the prompt is split.  The KV tiles start
// at multiples of BK from key 0 whatever the query tile, Sq, q_offset or B,
// and a row's state passes through them in order.  Every float operation of
// a tile is an explicit round-to-nearest intrinsic, so the masked and the
// unmasked code paths give the same bits where a key is valid.  A trailing
// tile wholly masked for a row (a later row of its block still sees it) is an
// exact no-op for it: the max does not move, alpha = exp2(0) = 1, p = 0.
// So prefilling a prompt whole or in chunks at runtime q_offsets against the
// same cache gives each row the same bits, and so does any plan (rows, heads,
// stages) or batch; the mma.sync result for one row does not depend on the
// other rows of its fragment.
//
// Bound on the card.  Prefill pads a prompt to a power-of-two bucket from 16
// up to max_len (488 in the 8 x 448-token replay, whose scratch cache has 496
// rows), so Sq runs from 16 to a few hundred and Sk is the cache length.
// SmolLM-360M's 488-token prefill (15 heads of 64, causal) needs ~0.46 GFLOP
// and moves ~2.5 MB: bound ~0.75 us by the bytes, below one launch's
// latency.  A block's work is a few MFLOP in 64 x 64 tiles with D <= 128,
// where latency (cp.async round trips, the softmax's shuffles, the mma
// dependency chain of one warp) sets the time, not the MMA rate: mma.sync at
// a fraction of its peak is ample, and wgmma's 64-row warpgroup tiles and
// TMA descriptors would add set-up without shortening a block's critical
// path, which is the latest query tile's walk over every KV tile before it.
#include "common.cuh"
#include "tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: SIMT.  One block of 4 warps owns 16 query rows of one (b, h); each
// warp owns 4 rows and carries their online-softmax state in registers
// (RowState, shared with flash_decode); K and V tiles of 32 keys are staged
// in shared memory as f32.
// ---------------------------------------------------------------------------

constexpr int WARPS = 4, ROWS_PER_WARP = 4, BQ = WARPS * ROWS_PER_WARP;

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_simt_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            float* __restrict__ o, int hq, int hkv, int sq, int sk, float scale, int causal,
                            int q_offset, int kv_len) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // BQ x D
  float* Ks = Qs + BQ * D;              // KV_TILE x (D + 1)
  float* Vs = Ks + KV_TILE * (D + 1);   // KV_TILE x D

  const int bh = blockIdx.y;            // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const float* qp = q + ((size_t)bh * sq + q0) * D;
  const float* kp = k + (size_t)(b * hkv + hk) * sk * D;
  const float* vp = v + (size_t)(b * hkv + hk) * sk * D;
  load_tile<BQ, D, WARPS * 32>(Qs, D, qp, min(BQ, sq - q0));

  RowState<D> st[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) st[r].init();

  // Keys past kv_end are masked for every row of this block.
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + BQ, sq));
  for (int t0 = 0; t0 < kv_end; t0 += KV_TILE) {
    __syncthreads();  // the previous tile is consumed (and Qs is loaded)
    const int rows = min(KV_TILE, sk - t0);
    load_tile<KV_TILE, D, WARPS * 32>(Ks, D + 1, kp + (size_t)t0 * D, rows);
    load_tile<KV_TILE, D, WARPS * 32>(Vs, D, vp + (size_t)t0 * D, rows);
    __syncthreads();
    const int kpos = t0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = warp * ROWS_PER_WARP + r;
      const bool valid = kpos < kv_len && (!causal || q_offset + q0 + row >= kpos);
      st[r].step(Qs + row * D, Ks, Vs, valid, scale, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qi = q0 + warp * ROWS_PER_WARP + r;
    if (qi < sq) st[r].store(o + ((size_t)bh * sq + qi) * D, lane);
  }
}

template <int D>
void launch_simt(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int sq, int sk,
                 float scale, int causal, int q_offset, int kv_len, cudaStream_t s) {
  const size_t smem = sizeof(float) * (BQ * D + KV_TILE * (D + 1) + KV_TILE * D);
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_attention_simt_kernel<D><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hkv, sq, sk, scale, causal, q_offset, kv_len);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                         // keys per KV tile, for every D
constexpr int MIN_STAGES = 2, MAX_STAGES = 4;  // KV tiles the ring holds
constexpr int MAX_WARPS = 8;
constexpr int PAD = 16;                        // bytes after each shared row
constexpr int SMEM_LIMIT = 232448;             // shared memory one block may have on sm_90

template <int D>
struct FaTile {
  static constexpr int PITCH = D * 2 + PAD;       // bytes of one shared row
  static constexpr int TILE_BYTES = BK * PITCH;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int PIECES = D * 2 / 16;       // 16-byte copies per row
  static int smem(int warps, int stages) { return warps * 16 * PITCH + stages * STAGE_BYTES; }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Max and sum over the 4 lanes that hold one row of an mma fragment; every
// lane of the quad ends with the same bits ((a + b) + (c + d) in each).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// One warp's 16 query rows: the lane holds rows g and g + 8 (g = lane / 4)
// of every fragment, at columns 2t, 2t + 1 (t = lane % 4).
template <int D>
struct WarpRows {
  static constexpr int DK = D / 16;  // k steps of Q.K^T
  static constexpr int DN = D / 8;   // n tiles of the output
  static constexpr int KN = BK / 8;  // n tiles of S
  static constexpr int KK = BK / 16; // k steps of P.V
  uint32_t qf[DK][4];
  float acc[DN][4];
  float m[2], l[2];                  // in log2 units: m of s * scale * log2(e)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    m[0] = m[1] = REPRO_NEG_INF;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void load_q(const char* Qs, int lane) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
      ldsm_x4(smem_addr(Qs + (lane % 16) * FaTile<D>::PITCH + kk * 32 + (lane / 16) * 16), qf[kk]);
  }

  // Fold one KV tile (keys key0 .. key0 + BK - 1) into the rows.  MASK: some
  // key of the tile is masked for some row of the block; qpos0 is the
  // absolute position of the warp's row 0.
  template <bool MASK>
  __device__ __forceinline__ void step(const char* Ks, const char* Vs, int lane, float scale_log2, int key0,
                                       int qpos0, int causal, int kv_len) {
    constexpr int P = FaTile<D>::PITCH;
    const int g = lane / 4, t = lane % 4;
    float s[KN][4];
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // S = Q.K^T: one ldmatrix.x4 of K gives the B fragments of two n tiles.
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int j = 0; j < KN / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(smem_addr(Ks + (16 * j + (lane / 16) * 8 + lane % 8) * P + kk * 32 + ((lane / 8) % 2) * 16), b);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma(s[2 * j], qf[kk], b0);
        mma(s[2 * j + 1], qf[kk], b1);
      }
    }
    // Scale into log2 units, mask, and take the row max.
    auto masked = [&](int j, int e) {
      const int key = key0 + 8 * j + 2 * t + (e & 1);
      return key >= kv_len || (causal && key > qpos0 + g + (e >> 1) * 8);
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale_log2);
        if (MASK && masked(j, e)) x = REPRO_NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(__fsub_rn(m[r], mx[r]));
      m[r] = mx[r];
    }
    // p = exp2(s - m), 0 where masked; the row sums in a fixed order.
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(__fsub_rn(s[j][e], m[e >> 1]));
        if (MASK && masked(j, e)) p = 0.f;
        s[j][e] = p;
        rs[e >> 1] = __fadd_rn(rs[e >> 1], p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(alpha[r], l[r], quad_sum(rs[r]));
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fmul_rn(acc[n][e], alpha[e >> 1]);
    // O += P.V: P's fragments become the A operand in registers; one
    // ldmatrix.x4.trans of V gives the B fragments of two n tiles.
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DN / 2; ++j) {
        uint32_t b0[2], b1[2];
        ldsm_x4_trans(smem_addr(Vs + (16 * kk + lane % 16) * P + (16 * j + (lane / 16) * 8) * 2), b0[0], b0[1],
                      b1[0], b1[1]);
        mma(acc[2 * j], a, b0);
        mma(acc[2 * j + 1], a, b1);
      }
    }
  }

  // Zero-denominator guard (flash_attention.py:106-108): l == 0 -> 0.
  __device__ __forceinline__ void store(bf16* out, int row0, int sq, int lane) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= sq) continue;
      const float denom = l[r] > 0.f ? l[r] : 1.f;
      bf16* dst = out + (size_t)row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < DN; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(__fdiv_rn(acc[n][2 * r], denom), __fdiv_rn(acc[n][2 * r + 1], denom));
    }
  }
};

// One block: `rows` (= 16 * row_warps) query rows, from q0 on, of `heads`
// query heads that share a KV head; warp w takes head unit * heads +
// w / row_warps and rows q0 + 16 * (w % row_warps) ...  Grid: x walks
// (b, head unit), y the query tiles, latest first.
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          bf16* __restrict__ o, int hq, int hkv, int sq, int sk, float scale_log2, int causal,
                          int q_offset, int kv_len, int row_warps, int heads, int stages) {
  using L = FaTile<D>;
  extern __shared__ __align__(128) char tc_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = hq / heads;
  const int b = blockIdx.x / units, unit = blockIdx.x - b * units;
  const int rows = 16 * row_warps;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * rows;
  const int h = unit * heads + warp / row_warps;
  const int hk = (unit * heads) / (hq / hkv);
  const int wq0 = q0 + (warp % row_warps) * 16;   // this warp's first query row

  char* Qs = tc_smem + warp * 16 * L::PITCH;
  char* ring = tc_smem + warps * 16 * L::PITCH;
  const bf16* kp = k + (size_t)(b * hkv + hk) * sk * D;
  const bf16* vp = v + (size_t)(b * hkv + hk) * sk * D;

  // Keys at or past kv_end are masked for every row of the block; keys
  // below full_end are valid for every row.
  int kv_end = kv_len, full_end = kv_len;
  if (causal) {
    kv_end = min(kv_end, q_offset + min(q0 + rows, sq));
    full_end = min(full_end, q_offset + q0 + 1);
  }
  const int ntiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  const int nfull = full_end > 0 ? full_end / BK : 0;   // tiles below need no mask

  // The warp's Q rows (zero past Sq): part of the first copy group.
  {
    const bf16* src = q + ((size_t)(b * hq + h) * sq) * D;
    for (int i = lane; i < 16 * L::PIECES; i += 32) {
      const int r = i / L::PIECES, c = i % L::PIECES;
      const bool in = wq0 + r < sq;
      cp_async16(smem_addr(Qs + r * L::PITCH + c * 16), in ? src + (size_t)(wq0 + r) * D + c * 8 : src,
                 in ? 16 : 0);
    }
  }
  auto load_kv = [&](int stage, int tile) {
    char* Ks = ring + stage * L::STAGE_BYTES;
    char* Vs = Ks + L::TILE_BYTES;
    const int key0 = tile * BK;
    for (int i = threadIdx.x; i < BK * L::PIECES; i += blockDim.x) {
      const int r = i / L::PIECES, c = i % L::PIECES;
      const bool in = key0 + r < sk;
      const size_t off = in ? (size_t)(key0 + r) * D + c * 8 : 0;
      cp_async16(smem_addr(Ks + r * L::PITCH + c * 16), kp + off, in ? 16 : 0);
      cp_async16(smem_addr(Vs + r * L::PITCH + c * 16), vp + off, in ? 16 : 0);
    }
  };
  for (int st = 0; st < stages - 1; ++st) {
    if (st < ntiles) load_kv(st, st);
    cp_async_commit();
  }

  WarpRows<D> w;
  w.init();
  const bool active = wq0 < sq;
  int rd = 0, wr = stages - 1;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait_dyn(stages - 2);  // tile i (and Q) has landed: this thread's copies
    __syncthreads();                // ... everyone's; and stage wr (read last step) is free
    if (i + stages - 1 < ntiles) load_kv(wr, i + stages - 1);
    cp_async_commit();
    if (i == 0 && active) w.load_q(Qs, lane);
    const char* Ks = ring + rd * L::STAGE_BYTES;
    if (active) {
      if (i < nfull)
        w.template step<false>(Ks, Ks + L::TILE_BYTES, lane, scale_log2, i * BK, q_offset + wq0, causal, kv_len);
      else
        w.template step<true>(Ks, Ks + L::TILE_BYTES, lane, scale_log2, i * BK, q_offset + wq0, causal, kv_len);
    }
    rd = rd + 1 == stages ? 0 : rd + 1;
    wr = wr + 1 == stages ? 0 : wr + 1;
  }
  cp_async_wait<0>();
  if (active) w.store(o + (size_t)(b * hq + h) * sq * D, wq0, sq, lane);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int sq, int sk,
              float scale, int causal, int q_offset, int kv_len, int rows, int heads, int stages, cudaStream_t s) {
  const int row_warps = rows / 16, warps = row_warps * heads;
  if (rows % 16 || (row_warps != 1 && row_warps != 2 && row_warps != 4) ||
      (heads != 1 && heads != hq / hkv) || warps > MAX_WARPS || stages < MIN_STAGES || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const int smem = FaTile<D>::smem(warps, stages);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int qtiles = (sq + rows - 1) / rows;
  if (qtiles > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_tc_kernel<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // scale * log2(e) in f32: the softmax runs in exp2.
  const float scale_log2 = scale * 1.4426950408889634f;
  kernel<<<dim3(b * (hq / heads), qtiles), warps * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      hq, hkv, sq, sk, scale_log2, causal, q_offset, kv_len, row_warps, heads, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Tensors contiguous; dtype 0 = f32, 1 = bf16; 0 <= kv_len <= sk; q, k, v
// and o 16-byte aligned for bf16.  The plan (route, rows, heads, stages,
// kv_tile) comes from kernels/flash_attention.py:plan and is checked here:
// f32 takes only the SIMT plan (route 0, 16 rows, 1 head, 1 stage, 32-key
// tiles) at D = 16, 64 or 128; bf16 only the tensor-core route (route 1, 64-key tiles) with 16,
// 32 or 64 rows, 1 head or the whole GQA group, at most 8 warps and 2-4
// stages that fit in shared memory.  Anything else: cudaErrorInvalidValue,
// and nothing is launched.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                                      int sq, int sk, int d, int dtype, int causal, int q_offset, int kv_len,
                                      float scale, int route, int rows, int heads, int stages, int kv_tile,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1 || kv_len < 0 || kv_len > sk)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (route != 0 || rows != BQ || heads != 1 || stages != 1 || kv_tile != KV_TILE) return (int)cudaErrorInvalidValue;
    switch (d) {
      case 16: launch_simt<16>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, q_offset, kv_len, s); break;
      case 64: launch_simt<64>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, q_offset, kv_len, s); break;
      case 128: launch_simt<128>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, q_offset, kv_len, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || route != 1 || kv_tile != BK) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch_tc<64>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, q_offset, kv_len, rows, heads, stages, s);
    case 128:
      return launch_tc<128>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, q_offset, kv_len, rows, heads, stages, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

REPRO_EXPORT_ERROR_STRING(flash_attention)
