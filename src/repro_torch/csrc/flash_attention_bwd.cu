// Flash attention backward on Hopper, for training.
//
// Replaces the VJP that JAX derives for attention: the reference trains by
// autodiff of its jnp oracle (repro/kernels/ref.py:ref_attention, which
// repro/kernels/ops.py:attention runs off the TPU); its Pallas kernel
// (repro/kernels/flash_attention.py:flash_attention) has no custom_vjp.
// Same function as that VJP for causal attention at q_offset 0 over every
// key (the only form training runs): q (B, Hq, S, D), k/v (B, Hkv, S, D),
// query head h reads KV head h / (Hq / Hkv), o the forward's output and lse
// its rows' log-sum-exp of the scaled logits (f32, natural log, written by
// csrc/flash_attention.cu), dO the output's gradient.  With s = scale q.k^T:
//   P = exp(s - lse),  delta = rowsum(dO o O),  dS = P o (dO.V^T - delta),
//   dQ = scale dS.K,  dK = scale sum over the group's query heads of dS^T.Q,
//   dV = sum over the group's query heads of P^T.dO.
// This is FlashAttention-2's backward: P is recomputed tile by tile from lse,
// so nothing of size S x S is stored (the plain path keeps B*Hq*S^2 f32 of
// softmax weights a layer: 1.0 GB at SmolLM-360M's 4 x 2048 tokens).
//
// Deterministic: no atomics.  Two launches on the caller's stream:
//   1. dQ: a block per (b, query head, 64 query rows), 16 rows a warp.  It
//      first writes delta for its rows (a warp's butterfly sum over D, the
//      same bits in every lane), then walks the KV tiles from key 0 up to the
//      diagonal in order.
//   2. dK, dV: a block per (b, KV head, 64 keys), 16 keys a warp.  It walks
//      the group's query heads in order and, for each, the query tiles from
//      the diagonal to the end, reading delta from launch 1.
// So every sum runs in a fixed order, and two calls give the same bits.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16 bf16 -> f32, csrc/tc.cuh)
// at D = 64 and 128: the streamed tiles (K/V in launch 1, Q/dO with their
// lse and delta in launch 2) pass through a 2-stage cp.async ring, rows
// padded by 16 bytes so ldmatrix is conflict-free, rows past S zero-filled.
// The logits' and dP's fragments stay in registers; P and dS are rounded to
// bf16 in registers and used directly as mma A-fragments (as the forward
// does with P).  f32 runs SIMT FMA kernels (the tensor cores take f32 only as
// TF32) at D = 16, 64 and 128: one key (launch 1) or one query (launch 2) a
// lane, 32-row tiles in shared memory.  Masks are applied only on tiles that
// cross the diagonal or the end of the sequence.
//
// Bound on the card.  Causal attention backward does 5 products of
// 2 * S^2/2 * D flops each per (b, query head): 10 * B * Hq * S^2 * D / 2
// flops (8.05e10 at 4 x 2048, 15 heads of 64: 0.081 ms at 989 TFLOP/s bf16)
// against ~84 MB of inputs and outputs (0.025 ms at 3.35 TB/s), so the
// tensor cores' rate bounds it.  mma.sync reaches a fraction of that peak
// (wgmma and TMA would be the next form); the design here is the simple one
// that is right: two passes rather than atomics, the heaviest query tiles of
// launch 1 scheduled first.
#include "common.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;              // a block: 4 warps
constexpr int BROWS = 16 * WARPS;     // 64 query rows (launch 1) or keys (launch 2) a block
constexpr int PAD = 16;               // bytes after each shared row
constexpr int SMEM_LIMIT = 232448;    // shared memory one block may have on sm_90

// Tile widths of the streamed operand: 64 rows at D = 64, 32 at D = 128 (the
// logits' and dP's fragments of a tile, and the D-wide dQ or dK/dV
// accumulators, stay within the register file).
template <int D>
struct Bwd {
  static constexpr int PITCH = D * 2 + PAD;   // bytes of one shared row
  static constexpr int PIECES = D * 2 / 16;   // 16-byte copies a row
  static constexpr int TILE = D == 64 ? 64 : 32;
  static constexpr int DK = D / 16;           // k steps over D
  static constexpr int DN = D / 8;            // n tiles over D
  static constexpr int TN = TILE / 8;         // n tiles over a streamed tile
  static constexpr int TK = TILE / 16;        // k steps over a streamed tile
  // Launch 1: each warp's Q and dO rows, then 2 stages of (K tile, V tile).
  static constexpr int DQ_SMEM = WARPS * 2 * 16 * PITCH + 2 * 2 * TILE * PITCH;
  // Launch 2: the block's K and V rows, then 2 stages of (Q tile, dO tile,
  // lse and delta of its rows).
  static constexpr int STAGE2 = 2 * TILE * PITCH + 2 * TILE * 4;
  static constexpr int DKV_SMEM = 2 * BROWS * PITCH + 2 * STAGE2;
  static_assert(DQ_SMEM <= SMEM_LIMIT && DKV_SMEM <= SMEM_LIMIT, "shared memory");
};

// Copy rows [row0, row0 + rows) of a (., D) bf16 matrix at `base` into
// shared memory at pitch Bwd<D>::PITCH; rows at or past `n` are zero-filled
// and not read.  Threads `tid` of `nthreads` share the copies.
template <int D>
__device__ __forceinline__ void copy_rows(char* dst, const bf16* base, int row0, int rows, int n, int tid,
                                          int nthreads) {
  using L = Bwd<D>;
  for (int i = tid; i < rows * L::PIECES; i += nthreads) {
    const int r = i / L::PIECES, c = i % L::PIECES;
    const bool in = row0 + r < n;
    cp_async16(smem_addr(dst + r * L::PITCH + c * 16), in ? base + (size_t)(row0 + r) * D + c * 8 : base,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The A fragment (16 rows x 16) of columns 16 kk .. 16 kk + 15 of a 16-row
// C-fragment tile x[n][4], rounded to bf16.
template <int N>
__device__ __forceinline__ void a_frag(const float (&x)[N][4], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// acc (16 x TN*8) += A (16 x D, fragments af[DK]) . B^T, B a TILE x D tile
// in shared memory at pitch PITCH (row n of B is column n of the product).
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[Bwd<D>::TN][4], const uint32_t (&af)[Bwd<D>::DK][4],
                                        const char* B, int lane) {
  using L = Bwd<D>;
#pragma unroll
  for (int kk = 0; kk < L::DK; ++kk)
#pragma unroll
    for (int j = 0; j < L::TN / 2; ++j) {
      uint32_t b[4];
      ldsm_x4(smem_addr(B + (16 * j + (lane / 16) * 8 + lane % 8) * L::PITCH + kk * 32 + ((lane / 8) % 2) * 16), b);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma(acc[2 * j], af[kk], b0);
      mma(acc[2 * j + 1], af[kk], b1);
    }
}

// The same with A's 16 rows read from shared memory at pitch PITCH, one
// k step's fragment at a time (launch 2's K and V rows, so that its two
// products do not hold 2 x D/16 fragments in registers at once).
template <int D>
__device__ __forceinline__ void mma_abt_s(float (&acc)[Bwd<D>::TN][4], const char* A, const char* B, int lane) {
  using L = Bwd<D>;
#pragma unroll
  for (int kk = 0; kk < L::DK; ++kk) {
    uint32_t af[4];
    ldsm_x4(smem_addr(A + (lane % 16) * L::PITCH + kk * 32 + (lane / 16) * 16), af);
#pragma unroll
    for (int j = 0; j < L::TN / 2; ++j) {
      uint32_t b[4];
      ldsm_x4(smem_addr(B + (16 * j + (lane / 16) * 8 + lane % 8) * L::PITCH + kk * 32 + ((lane / 8) % 2) * 16), b);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma(acc[2 * j], af, b0);
      mma(acc[2 * j + 1], af, b1);
    }
  }
}

// acc (16 x D) += X (16 x TILE, C fragments x[TN], rounded to bf16) . B, B a
// TILE x D tile in shared memory (ldmatrix.trans).
template <int D>
__device__ __forceinline__ void mma_xb(float (&acc)[Bwd<D>::DN][4], const float (&x)[Bwd<D>::TN][4],
                                       const char* B, int lane) {
  using L = Bwd<D>;
#pragma unroll
  for (int kk = 0; kk < L::TK; ++kk) {
    uint32_t a[4];
    a_frag(x, kk, a);
#pragma unroll
    for (int j = 0; j < L::DN / 2; ++j) {
      uint32_t b0[2], b1[2];
      ldsm_x4_trans(smem_addr(B + (16 * kk + lane % 16) * L::PITCH + (16 * j + (lane / 16) * 8) * 2), b0[0], b0[1],
                    b1[0], b1[1]);
      mma(acc[2 * j], a, b0);
      mma(acc[2 * j + 1], a, b1);
    }
  }
}

// Store a 16 x D C-fragment accumulator times `mul` as bf16 rows row0 ..
// row0 + 15 of `out` (rows at or past n skipped).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[Bwd<D>::DN][4], float mul, int row0, int n,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    bf16* dst = out + (size_t)row * D + 2 * t;
#pragma unroll
    for (int nn = 0; nn < Bwd<D>::DN; ++nn)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nn) =
          __floats2bfloat162_rn(__fmul_rn(acc[nn][2 * r], mul), __fmul_rn(acc[nn][2 * r + 1], mul));
  }
}

// ---------------------------------------------------------------------------
// bf16, launch 1: delta, then dQ.  Grid: x the query tiles (latest, the
// heaviest, first), y = b * hq + h.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                      float* __restrict__ delta, bf16* __restrict__ dq, int hq, int hkv, int s, float scale_log2,
                      float scale) {
  using L = Bwd<D>;
  extern __shared__ __align__(128) char bwd_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / hq, h = bh - b * hq, hk = h / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BROWS;
  const int wq0 = q0 + warp * 16;  // the warp's first query row
  char* Qs = bwd_smem + warp * 2 * 16 * L::PITCH;
  char* dOs = Qs + 16 * L::PITCH;
  char* ring = bwd_smem + WARPS * 2 * 16 * L::PITCH;
  const size_t row_base = (size_t)bh * s;
  const bf16* qp = q + row_base * D;
  const bf16* dop = dout + row_base * D;
  const bf16* kp = k + (size_t)(b * hkv + hk) * s * D;
  const bf16* vp = v + (size_t)(b * hkv + hk) * s * D;

  // The warp's Q and dO rows, and K/V tile 0: the first copy group.
  copy_rows<D>(Qs, qp, wq0, 16, s, lane, 32);
  copy_rows<D>(dOs, dop, wq0, 16, s, lane, 32);
  const int kv_end = min(s, q0 + BROWS);  // the block's last row sees keys below it
  const int ntiles = (kv_end + L::TILE - 1) / L::TILE;
  auto load_kv = [&](int stage, int tile) {
    char* Ks = ring + stage * 2 * L::TILE * L::PITCH;
    copy_rows<D>(Ks, kp, tile * L::TILE, L::TILE, s, threadIdx.x, blockDim.x);
    copy_rows<D>(Ks + L::TILE * L::PITCH, vp, tile * L::TILE, L::TILE, s, threadIdx.x, blockDim.x);
  };
  load_kv(0, 0);
  cp_async_commit();

  // delta = rowsum(dO o O) of the warp's rows, in a fixed order (lane c
  // sums columns 2c, 2c + 1, 2c + 64, ...; then the butterfly), written
  // for launch 2; lane keeps rows g and g + 8, and their lse in log2 units.
  const bf16* op = o + row_base * D;
  float dl[2] = {0.f, 0.f}, ls[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int row = wq0 + r;
    float acc = 0.f;
    if (row < s) {
#pragma unroll
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + (size_t)row * D + c));
        const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dop + (size_t)row * D + c));
        acc = __fmaf_rn(of.x, df.x, acc);
        acc = __fmaf_rn(of.y, df.y, acc);
      }
    }
    acc = warp_sum(acc);
    if (r == g) dl[0] = acc;
    if (r == g + 8) dl[1] = acc;
    if (lane == 0 && row < s) delta[row_base + row] = acc;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    ls[r] = row < s ? __fmul_rn(lse[row_base + row], LOG2E) : 0.f;
  }

  uint32_t qf[L::DK][4], df[L::DK][4];
  float acc[L::DN][4];
#pragma unroll
  for (int n = 0; n < L::DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool active = wq0 < s;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) load_kv((i + 1) % 2, i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and Q, dO) landed: this thread's copies
    __syncthreads();     // ... everyone's
    if (i == 0 && active) {
#pragma unroll
      for (int kk = 0; kk < L::DK; ++kk) {
        ldsm_x4(smem_addr(Qs + (lane % 16) * L::PITCH + kk * 32 + (lane / 16) * 16), qf[kk]);
        ldsm_x4(smem_addr(dOs + (lane % 16) * L::PITCH + kk * 32 + (lane / 16) * 16), df[kk]);
      }
    }
    const int key0 = i * L::TILE;
    // Tiles wholly past the warp's last row are masked for all of it.
    if (active && key0 <= wq0 + 15) {
      const char* Ks = ring + (i % 2) * 2 * L::TILE * L::PITCH;
      const char* Vs = Ks + L::TILE * L::PITCH;
      float sf[L::TN][4], dp[L::TN][4];
#pragma unroll
      for (int j = 0; j < L::TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sf[j][e] = dp[j][e] = 0.f;
      mma_abt<D>(sf, qf, Ks, lane);   // S = Q.K^T
      mma_abt<D>(dp, df, Vs, lane);   // dP = dO.V^T
      const bool mask = key0 + L::TILE - 1 > wq0 || key0 + L::TILE > s;
#pragma unroll
      for (int j = 0; j < L::TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * j + 2 * t + (e & 1), row = wq0 + g + 8 * (e >> 1);
          float p = exp2f(__fsub_rn(__fmul_rn(sf[j][e], scale_log2), ls[e >> 1]));
          if (mask && (key > row || key >= s)) p = 0.f;
          sf[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], dl[e >> 1]));  // dS
        }
      mma_xb<D>(acc, sf, Ks, lane);   // dQ += dS.K
    }
    __syncthreads();  // stage i % 2 is read: the next iteration may refill it
  }
  cp_async_wait<0>();
  if (active) store_rows<D>(dq + row_base * D, acc, scale, wq0, s, lane);
}

// ---------------------------------------------------------------------------
// bf16, launch 2: dK and dV.  Grid: x the key tiles (earliest, the heaviest,
// first), y = b * hkv + hk.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int hq,
                       int hkv, int s, float scale_log2, float scale) {
  using L = Bwd<D>;
  extern __shared__ __align__(128) char bwd_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bk = blockIdx.y, b = bk / hkv, hk = bk - b * hkv, group = hq / hkv;
  const int kv0 = blockIdx.x * BROWS;
  const int wk0 = kv0 + warp * 16;  // the warp's first key
  char* Ks = bwd_smem;
  char* Vs = Ks + BROWS * L::PITCH;
  char* ring = Vs + BROWS * L::PITCH;
  const size_t kv_base = (size_t)bk * s;

  copy_rows<D>(Ks, k + kv_base * D, kv0, BROWS, s, threadIdx.x, blockDim.x);
  copy_rows<D>(Vs, v + kv_base * D, kv0, BROWS, s, threadIdx.x, blockDim.x);
  // Work items in order: the group's query heads, each from the query tile
  // holding row kv0 (the first that sees a key of the block) to the last.
  const int qt0 = kv0 / L::TILE, per = (s + L::TILE - 1) / L::TILE - qt0, items = group * per;
  auto load_q = [&](int stage, int item) {
    const int h = hk * group + item / per, qrow0 = (qt0 + item % per) * L::TILE;
    const size_t base = (size_t)(b * hq + h) * s;
    char* Qt = ring + stage * L::STAGE2;
    char* dOt = Qt + L::TILE * L::PITCH;
    float* lt = reinterpret_cast<float*>(dOt + L::TILE * L::PITCH);
    copy_rows<D>(Qt, q + base * D, qrow0, L::TILE, s, threadIdx.x, blockDim.x);
    copy_rows<D>(dOt, dout + base * D, qrow0, L::TILE, s, threadIdx.x, blockDim.x);
    for (int i = threadIdx.x; i < L::TILE; i += blockDim.x) {
      const int row = qrow0 + i;
      lt[i] = row < s ? __fmul_rn(lse[base + row], LOG2E) : 0.f;
      lt[L::TILE + i] = row < s ? delta[base + row] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();

  float dka[L::DN][4], dva[L::DN][4];
#pragma unroll
  for (int n = 0; n < L::DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const bool active = wk0 < s;
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) load_q((i + 1) % 2, i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int qrow0 = (qt0 + i % per) * L::TILE;
    // Query tiles wholly before the warp's first key are masked for all of it.
    if (active && qrow0 + L::TILE - 1 >= wk0) {
      const char* Qt = ring + (i % 2) * L::STAGE2;
      const char* dOt = Qt + L::TILE * L::PITCH;
      const float* lt = reinterpret_cast<const float*>(dOt + L::TILE * L::PITCH);
      float st[L::TN][4], dpt[L::TN][4];
#pragma unroll
      for (int j = 0; j < L::TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_abt_s<D>(st, Ks + warp * 16 * L::PITCH, Qt, lane);    // S^T = K.Q^T
      mma_abt_s<D>(dpt, Vs + warp * 16 * L::PITCH, dOt, lane);  // dP^T = V.dO^T
      const bool mask = qrow0 < wk0 + 15 || qrow0 + L::TILE > s;
#pragma unroll
      for (int j = 0; j < L::TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), key = wk0 + g + 8 * (e >> 1), row = qrow0 + col;
          float p = exp2f(__fsub_rn(__fmul_rn(st[j][e], scale_log2), lt[col]));
          if (mask && (key > row || row >= s)) p = 0.f;
          st[j][e] = p;                                                      // P^T
          dpt[j][e] = __fmul_rn(p, __fsub_rn(dpt[j][e], lt[L::TILE + col]));  // dS^T
        }
      mma_xb<D>(dva, st, dOt, lane);   // dV += P^T.dO
      mma_xb<D>(dka, dpt, Qt, lane);   // dK += dS^T.Q
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (active) {
    store_rows<D>(dk + kv_base * D, dka, scale, wk0, s, lane);
    store_rows<D>(dv + kv_base * D, dva, 1.f, wk0, s, lane);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, void* dq, void* dk, void* dv, int b, int hq, int hkv, int s, float scale,
              cudaStream_t st) {
  using L = Bwd<D>;
  auto k1 = attn_bwd_dq_tc_kernel<D>;
  auto k2 = attn_bwd_dkv_tc_kernel<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DQ_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DKV_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tiles = (s + BROWS - 1) / BROWS;
  const float scale_log2 = scale * LOG2E;
  k1<<<dim3(tiles, b * hq), WARPS * 32, L::DQ_SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), hq, hkv, s,
      scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<dim3(tiles, b * hkv), WARPS * 32, L::DKV_SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, s,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: SIMT.  Blocks of 4 warps own 16 query rows (launch 1) or 16 keys
// (launch 2), 4 a warp; tiles of 32 keys (launch 1) or queries (launch 2),
// one a lane, in shared memory padded to D + 1 floats a row.  A lane owns
// output dims RowState<D>::dim(lane, j) (common.cuh).
// ---------------------------------------------------------------------------
constexpr int SIMT_ROWS = 4, SIMT_BLOCK = WARPS * SIMT_ROWS, SIMT_TILE = 32;

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ o, const float* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq, int hq,
                        int hkv, int s, float scale) {
  using RS = RowState<D>;
  extern __shared__ float fsm[];
  float* Qs = fsm;                              // SIMT_BLOCK x D
  float* dOs = Qs + SIMT_BLOCK * D;             // SIMT_BLOCK x D
  float* Ks = dOs + SIMT_BLOCK * D;             // SIMT_TILE x (D + 1)
  float* Vs = Ks + SIMT_TILE * (D + 1);         // SIMT_TILE x (D + 1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / hq, h = bh - b * hq, hk = h / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * SIMT_BLOCK;
  const size_t row_base = (size_t)bh * s;
  const float* kp = k + (size_t)(b * hkv + hk) * s * D;
  const float* vp = v + (size_t)(b * hkv + hk) * s * D;
  load_tile<SIMT_BLOCK, D, WARPS * 32>(Qs, D, q + (row_base + q0) * D, min(SIMT_BLOCK, s - q0));
  load_tile<SIMT_BLOCK, D, WARPS * 32>(dOs, D, dout + (row_base + q0) * D, min(SIMT_BLOCK, s - q0));

  float dl[SIMT_ROWS], ls[SIMT_ROWS], acc[SIMT_ROWS][RS::DPL];
#pragma unroll
  for (int r = 0; r < SIMT_ROWS; ++r) {
    const int row = q0 + warp * SIMT_ROWS + r;
    float x = 0.f;
    if (row < s)
      for (int c = lane; c < D; c += 32) x = __fmaf_rn(o[(row_base + row) * D + c], dout[(row_base + row) * D + c], x);
    dl[r] = warp_sum(x);
    if (lane == 0 && row < s) delta[row_base + row] = dl[r];
    ls[r] = row < s ? lse[row_base + row] : 0.f;
#pragma unroll
    for (int j = 0; j < RS::DPL; ++j) acc[r][j] = 0.f;
  }
  const int kv_end = min(s, q0 + SIMT_BLOCK);
  for (int t0 = 0; t0 < kv_end; t0 += SIMT_TILE) {
    __syncthreads();  // the previous tile is consumed (and Qs, dOs loaded)
    const int rows = min(SIMT_TILE, s - t0);
    load_tile<SIMT_TILE, D, WARPS * 32>(Ks, D + 1, kp + (size_t)t0 * D, rows);
    load_tile<SIMT_TILE, D, WARPS * 32>(Vs, D + 1, vp + (size_t)t0 * D, rows);
    __syncthreads();
    const int key = t0 + lane;
#pragma unroll
    for (int r = 0; r < SIMT_ROWS; ++r) {
      const int lr = warp * SIMT_ROWS + r, row = q0 + lr;
      const float* qrow = Qs + lr * D;
      const float* drow = dOs + lr * D;
      const float* krow = Ks + lane * (D + 1);
      const float* vrow = Vs + lane * (D + 1);
      float sd = 0.f, dp = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        sd = __fmaf_rn(qrow[c], krow[c], sd);
        dp = __fmaf_rn(drow[c], vrow[c], dp);
      }
      const bool valid = key < s && key <= row && row < s;
      const float p = valid ? expf(__fsub_rn(__fmul_rn(sd, scale), ls[r])) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp, dl[r]));
#pragma unroll 4
      for (int kk = 0; kk < SIMT_TILE; ++kk) {
        const float dsk = __shfl_sync(0xffffffffu, ds, kk);
#pragma unroll
        for (int j = 0; j < RS::DPL; ++j)
          acc[r][j] = __fmaf_rn(dsk, Ks[kk * (D + 1) + RS::dim(lane, j)], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SIMT_ROWS; ++r) {
    const int row = q0 + warp * SIMT_ROWS + r;
    if (row < s && RS::owns(lane))
#pragma unroll
      for (int j = 0; j < RS::DPL; ++j) dq[(row_base + row) * D + RS::dim(lane, j)] = __fmul_rn(acc[r][j], scale);
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int hq,
                         int hkv, int s, float scale) {
  using RS = RowState<D>;
  extern __shared__ float fsm[];
  float* Kb = fsm;                              // SIMT_BLOCK x D: the block's keys
  float* Vb = Kb + SIMT_BLOCK * D;              // SIMT_BLOCK x D
  float* Qt = Vb + SIMT_BLOCK * D;              // SIMT_TILE x (D + 1)
  float* dOt = Qt + SIMT_TILE * (D + 1);        // SIMT_TILE x (D + 1)
  float* lt = dOt + SIMT_TILE * (D + 1);        // SIMT_TILE lse, then SIMT_TILE delta
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bk = blockIdx.y, b = bk / hkv, hk = bk - b * hkv, group = hq / hkv;
  const int k0 = blockIdx.x * SIMT_BLOCK;
  const size_t kv_base = (size_t)bk * s;
  load_tile<SIMT_BLOCK, D, WARPS * 32>(Kb, D, k + (kv_base + k0) * D, min(SIMT_BLOCK, s - k0));
  load_tile<SIMT_BLOCK, D, WARPS * 32>(Vb, D, v + (kv_base + k0) * D, min(SIMT_BLOCK, s - k0));

  float dka[SIMT_ROWS][RS::DPL], dva[SIMT_ROWS][RS::DPL];
#pragma unroll
  for (int r = 0; r < SIMT_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < RS::DPL; ++j) dka[r][j] = dva[r][j] = 0.f;
  for (int hg = 0; hg < group; ++hg) {
    const size_t base = (size_t)(b * hq + hk * group + hg) * s;
    for (int q0 = k0 / SIMT_TILE * SIMT_TILE; q0 < s; q0 += SIMT_TILE) {
      __syncthreads();  // the previous tile is consumed (and Kb, Vb loaded)
      const int rows = min(SIMT_TILE, s - q0);
      load_tile<SIMT_TILE, D, WARPS * 32>(Qt, D + 1, q + (base + q0) * D, rows);
      load_tile<SIMT_TILE, D, WARPS * 32>(dOt, D + 1, dout + (base + q0) * D, rows);
      if (threadIdx.x < SIMT_TILE) {
        const int row = q0 + threadIdx.x;
        lt[threadIdx.x] = row < s ? lse[base + row] : 0.f;
        lt[SIMT_TILE + threadIdx.x] = row < s ? delta[base + row] : 0.f;
      }
      __syncthreads();
      const int row = q0 + lane;
      const float* qrow = Qt + lane * (D + 1);
      const float* drow = dOt + lane * (D + 1);
#pragma unroll
      for (int r = 0; r < SIMT_ROWS; ++r) {
        const int lk = warp * SIMT_ROWS + r, key = k0 + lk;
        const float* krow = Kb + lk * D;
        const float* vrow = Vb + lk * D;
        float sd = 0.f, dp = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
          sd = __fmaf_rn(qrow[c], krow[c], sd);
          dp = __fmaf_rn(drow[c], vrow[c], dp);
        }
        const bool valid = row < s && key <= row && key < s;
        const float p = valid ? expf(__fsub_rn(__fmul_rn(sd, scale), lt[lane])) : 0.f;
        const float ds = __fmul_rn(p, __fsub_rn(dp, lt[SIMT_TILE + lane]));
#pragma unroll 4
        for (int qq = 0; qq < SIMT_TILE; ++qq) {
          const float pq = __shfl_sync(0xffffffffu, p, qq);
          const float dsq = __shfl_sync(0xffffffffu, ds, qq);
#pragma unroll
          for (int j = 0; j < RS::DPL; ++j) {
            dva[r][j] = __fmaf_rn(pq, dOt[qq * (D + 1) + RS::dim(lane, j)], dva[r][j]);
            dka[r][j] = __fmaf_rn(dsq, Qt[qq * (D + 1) + RS::dim(lane, j)], dka[r][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SIMT_ROWS; ++r) {
    const int key = k0 + warp * SIMT_ROWS + r;
    if (key < s && RS::owns(lane))
#pragma unroll
      for (int j = 0; j < RS::DPL; ++j) {
        dk[(kv_base + key) * D + RS::dim(lane, j)] = __fmul_rn(dka[r][j], scale);
        dv[(kv_base + key) * D + RS::dim(lane, j)] = dva[r][j];
      }
  }
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                float* delta, void* dq, void* dk, void* dv, int b, int hq, int hkv, int s, float scale,
                cudaStream_t st) {
  const int tiles = (s + SIMT_BLOCK - 1) / SIMT_BLOCK;
  const int smem = sizeof(float) * (2 * SIMT_BLOCK * D + 2 * SIMT_TILE * (D + 1) + 2 * SIMT_TILE);
  static bool configured = false;  // 48.5 KB at D = 128: above the default 48 KB
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(attn_bwd_dq_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dkv_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  attn_bwd_dq_simt_kernel<D><<<dim3(tiles, b * hq), WARPS * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), hq, hkv,
      s, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_simt_kernel<D><<<dim3(tiles, b * hkv), WARPS * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), hq, hkv, s,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Causal attention backward at q_offset 0 over all S keys.  q, o, dout, dq:
// (b, hq, s, d); k, v, dk, dv: (b, hkv, s, d); all contiguous, of one dtype
// (0 = f32 at d = 16, 64, 128; 1 = bf16 at d = 64, 128; bf16 pointers
// 16-byte aligned); lse (b, hq, s) f32 from flash_attention_launch; delta
// (b, hq, s) f32 scratch, written by launch 1 and read by launch 2.
// Anything else: cudaErrorInvalidValue, and nothing is launched.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                          const void* dout, const void* lse, void* delta, void* dq, void* dk,
                                          void* dv, int b, int hq, int hkv, int s, int d, int dtype, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv || s < 1 || (size_t)b * hq > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_simt<16>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
      case 64: return launch_simt<64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
      case 128: return launch_simt<128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return launch_tc<64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
    case 128: return launch_tc<128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

REPRO_EXPORT_ERROR_STRING(flash_attention_bwd)
