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
// Deterministic: no atomics.  Two launches on the caller's stream, each
// block walking its tiles in an order fixed by (S, D, group) alone, so two
// calls give the same bits, and so does a batch element computed alone:
//   1. dQ: a block per (b, query head, 64 query rows).  It first writes delta
//      for its rows, then walks the K/V tiles from key 0 up to the diagonal.
//   2. dK, dV: a block per (b, KV head, 64 keys).  It walks the group's
//      query heads in order and, for each, the query tiles from the
//      diagonal to the end, reading delta from launch 1.  With two consumer
//      warpgroups (D = 128), one takes the even and one the odd of these
//      tiles, and the second's sums are added to the first's at the end.
// Both grids are one-dimensional and heaviest first across every (b, head,
// tile) item, so the longest blocks start in the first wave on every head.
//
// bf16 (D = 64, 128) runs on Hopper's warpgroup MMA (csrc/wgmma.cuh): a
// consumer warpgroup owns a 64-row slab (launch 1: its queries' Q and dO;
// launch 2: its keys' K and V), loaded once by TMA, and one producer thread
// keeps a ring of streamed 64-row tiles (launch 1: K and V; launch 2: Q,
// dO, lse and delta) in flight by TMA with 128-byte swizzle, behind full and
// empty mbarriers; TMA's zero fill past S stands for the masked rows.
// S = Q.K^T and dP = dO.V^T (launch 2: their transposes, K.Q^T and V.dO^T)
// take both operands from shared memory; P and dS, computed in registers
// and rounded to bf16, are the register A operand of dQ += dS.K (launch 2:
// dV += P^T.dO, dK += dS^T.Q), whose B is the streamed tile read MN-major.
// setmaxnreg hands the producer warpgroup's registers to the consumers (the
// dK and dV sums of 64 x D f32 each live in registers).  f32 runs SIMT FMA
// kernels (the tensor cores take f32 only as TF32) at D = 16, 64 and 128: one
// key (launch 1) or one query (launch 2) a lane, 32-row tiles in shared
// memory.
//
// Bound on the card.  Causal attention backward does 5 products of
// 2 * S^2/2 * D flops each per (b, query head): 10 * B * Hq * S^2 * D / 2
// flops (8.05e10 at 4 x 2048, 15 heads of 64: 0.081 ms at 989 TFLOP/s bf16)
// against ~84 MB of inputs and outputs (0.025 ms at 3.35 TB/s), so the
// tensor cores' rate bounds it.  Two passes without atomics recompute S and
// dP in both, 7 products for the bound's 5.  Between a tile's products a
// warpgroup computes P and dS (an exp, three flops and two conversions an
// element), with its tensor-core work waiting: that element-wise step, not
// the products or the tiles' traffic, sets the time, so it has a masked and
// an unmasked form (compiled as one, every tile paid the mask's compares),
// takes its exp as one ex2.approx instruction, and several
// warpgroups share an SM to overlap one's step with another's products: at
// D = 64 three dQ blocks (136 registers a consumer thread) and two dK/dV
// blocks an SM.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;              // a warpgroup; the SIMT kernels' block
constexpr int WG = 128;               // threads of a warpgroup
constexpr int TILE = 64;              // rows of a slab and of each streamed tile
constexpr int SMEM_LIMIT = 232448;    // shared memory one block may have on sm_90
constexpr int PRODUCER_REGS = 24;

// A TILE x D bf16 tile as TMA writes it: D / 64 column blocks of TILE rows x
// 128 bytes (swizzled), each 1024-byte aligned.
template <int D>
struct Tile {
  static constexpr int BYTES = TILE * D * 2;
  static constexpr int BLOCK = TILE * 128;
  static constexpr int KSTEPS = D / 16;
  // K-major operand (rows of the tile are the product's M or N): k step kk.
  __device__ __forceinline__ static uint64_t kmajor(const char* t, int kk) {
    return hop::sw128_desc(hop::smem_u32(t + (kk / 4) * BLOCK + (kk % 4) * 32), 16, 1024);
  }
  // MN-major operand (rows of the tile are the product's depth): k step kk
  // of 16 rows; the D columns are the product's N.
  __device__ __forceinline__ static uint64_t mnmajor(const char* t, int kk) {
    return hop::sw128_desc(hop::smem_u32(t + kk * 2048), BLOCK, 1024);
  }
};

// Launch 1's shared memory: the Q and dO slabs, STAGES (K, V) tiles, the
// slab's delta, the barriers.  Launch 2's: the K and V slabs, STAGES
// (Q, dO, lse, delta) tiles, the barriers.
template <int D, int STAGES>
struct DqSmem {
  static constexpr int RING = 2 * Tile<D>::BYTES;
  static constexpr int DELTA = 2 * Tile<D>::BYTES + STAGES * RING;
  static constexpr int BARS = DELTA + TILE * 4;
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 1) + 1024;   // + alignment
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};
template <int D, int NWG>
struct DkvSmem {
  static constexpr int STAGES = 2 * NWG;   // a warpgroup's tiles, t % STAGES
  static constexpr int STAGE = (2 * Tile<D>::BYTES + 2 * TILE * 4 + 1023) / 1024 * 1024;
  static constexpr int SLABS = 2 * Tile<D>::BYTES;
  static constexpr int BARS = SLABS + STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 1) + 1024;
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
  static_assert(NWG == 1 || STAGES * STAGE >= 2 * D * WG * 4, "the partial sums fit the ring");
};

__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024 - (hop::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Columns 16 kk .. 16 kk + 15 of a 64 x 64 accumulator, rounded to bf16, as
// the register A operand of a k step.
__device__ __forceinline__ void a_frag(const float (&x)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// 2^x in one instruction (MUFU.EX2; subnormal results flush to zero, far
// below what a bf16 P or dS keeps).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Launch 1's element-wise step on a 64 x 64 tile, in place: S -> dS =
// P o (dP - delta), P = 2^(S scale_log2 - lse2) of the thread's rows row0,
// row0 + 8 (lse2, delta ls[i], dl[i]) and columns key0 + 8 j + {0, 1}.  MASK
// (the diagonal tile and the one crossing s, only): dS = 0 past the
// diagonal and past s.  The masked form is a separate path, so the others
// pay nothing for it.
template <bool MASK>
__device__ __forceinline__ void ds_tile(float (&sf)[32], const float (&dp)[32], const float (&ls)[2],
                                        const float (&dl)[2], float scale_log2, int key0, int row0, int s) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(__fmaf_rn(sf[4 * j + e], scale_log2, -ls[e >> 1]));
      float ds = __fmul_rn(p, __fsub_rn(dp[4 * j + e], dl[e >> 1]));
      if (MASK) {
        const int key = key0 + 8 * j + (e & 1), row = row0 + 8 * (e >> 1);
        if (key > row || key >= s) ds = 0.f;
      }
      sf[4 * j + e] = ds;
    }
}

// Launch 2's element-wise step on a 64 x 64 tile of S^T and dP^T, in place:
// P^T and dS^T for the thread's keys key0, key0 + 8 and the columns (query
// rows) row0 + 8 j + {0, 1}, whose lse2 and delta are at lt2[4 j + qd] and
// lt2[32 + 4 j + qd] (float2).  MASK: P = dS = 0 where key > row or row >= s.
template <bool MASK>
__device__ __forceinline__ void pds_tile(float (&st)[32], float (&dpt)[32], const float2* lt2, int qd,
                                         float scale_log2, int key0, int row0, int s) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = lt2[4 * j + qd], d2 = lt2[TILE / 2 + 4 * j + qd];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(__fmaf_rn(st[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
      float ds = __fmul_rn(p, __fsub_rn(dpt[4 * j + e], (e & 1) ? d2.y : d2.x));
      if (MASK) {
        const int key = key0 + 8 * (e >> 1), row = row0 + 8 * j + (e & 1);
        if (key > row || row >= s) p = ds = 0.f;
      }
      st[4 * j + e] = p;     // P^T
      dpt[4 * j + e] = ds;   // dS^T
    }
  }
}

// Store a warpgroup's 64 x D accumulator times `mul` as bf16 rows row0 ..
// row0 + 63 of `out` (rows at or past n skipped).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2], float mul, int row0, int n) {
  const int warp = (threadIdx.x / 32) % WARPS, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * i;
    if (row >= n) continue;
    bf16* dst = out + (size_t)row * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(__fmul_rn(acc[4 * j + 2 * i], mul), __fmul_rn(acc[4 * j + 2 * i + 1], mul));
  }
}

// ---------------------------------------------------------------------------
// bf16, launch 1: delta, then dQ.  Block x: query tile nt - 1 - x / (b hq)
// (the heaviest first), (b, query head) x % (b hq).  Warpgroup 0 computes,
// warpgroup 1's first thread loads.
// ---------------------------------------------------------------------------
template <int D, int STAGES, int BLOCKS, int REGS>
__global__ void __launch_bounds__(2 * WG, BLOCKS)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ aux, bf16* __restrict__ dq, int bhq, int hq, int hkv, int s,
                   float scale_log2, float scale) {
  using T = Tile<D>;
  using L = DqSmem<D, STAGES>;
  extern __shared__ char bwd_smem_raw[];
  char* sm = align1024(bwd_smem_raw);
  char* Qs = sm;
  char* dOs = sm + T::BYTES;
  char* ring = sm + 2 * T::BYTES;
  float* dl_s = reinterpret_cast<float*>(sm + L::DELTA);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* slab = empty + STAGES;
  const int nt = (s + TILE - 1) / TILE;
  const int qt = nt - 1 - blockIdx.x / bhq, bh = blockIdx.x % bhq;
  const int b = bh / hq, h = bh - b * hq, bkv = b * hkv + h / (hq / hkv);
  const int q0 = qt * TILE, ntiles = qt + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], WG);
    }
    hop::mbar_init(slab, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG) {  // the producer warpgroup
    hop::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == WG) {
      hop::mbar_expect_tx(slab, 2 * T::BYTES);
      for (int c = 0; c < D / 64; ++c) {
        hop::tma_load_3d(Qs + c * T::BLOCK, &tq, slab, 64 * c, q0, bh);
        hop::tma_load_3d(dOs + c * T::BLOCK, &tdo, slab, 64 * c, q0, bh);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) hop::mbar_wait(&empty[st], (t / STAGES - 1) & 1);
        hop::mbar_expect_tx(&full[st], 2 * T::BYTES);
        char* kt = ring + st * L::RING;
        for (int c = 0; c < D / 64; ++c) {
          hop::tma_load_3d(kt + c * T::BLOCK, &tk, &full[st], 64 * c, t * TILE, bkv);
          hop::tma_load_3d(kt + T::BYTES + c * T::BLOCK, &tv, &full[st], 64 * c, t * TILE, bkv);
        }
      }
    }
  } else {  // the consumer warpgroup: query rows q0 .. q0 + 63
    hop::regs_inc<REGS>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
    const size_t row_base = (size_t)bh * s;
    // delta = rowsum(dO o O): a row's D / 8 lanes each sum one 16-byte vector
    // in order, then an xor tree over those lanes; the warp's 16 rows in
    // 16 / RPP passes, every load issued first.  Launch 2 reads each row's
    // lse in log2 units and delta from aux: (b hq, 2, SP) f32, rows padded
    // to SP = nt * TILE, with zeros past s.
    {
      constexpr int LPR = D / 8, RPP = 32 / LPR, PASSES = 16 / RPP;
      uint4 ov[PASSES], dv[PASSES];
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        const int row = q0 + 16 * warp + i * RPP + lane / LPR;
        if (row < s) {
          const size_t at = (row_base + row) * D + (lane % LPR) * 8;
          ov[i] = *reinterpret_cast<const uint4*>(o + at);
          dv[i] = *reinterpret_cast<const uint4*>(dout + at);
        } else {
          ov[i] = dv[i] = make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
        const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(&dv[i]);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(a[j]), y = __bfloat1622float2(c[j]);
          acc = __fmaf_rn(x.x, y.x, acc);
          acc = __fmaf_rn(x.y, y.y, acc);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
        const int r = 16 * warp + i * RPP + lane / LPR;
        if (lane % LPR == 0) {
          dl_s[r] = acc;
          float* at = aux + (size_t)bh * 2 * (nt * TILE) + q0 + r;
          at[0] = q0 + r < s ? __fmul_rn(lse[row_base + q0 + r], LOG2E) : 0.f;
          at[nt * TILE] = acc;
        }
      }
    }
    hop::bar_sync<1>(WG);
    float dl[2], ls[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      dl[i] = dl_s[r];
      ls[i] = q0 + r < s ? __fmul_rn(lse[row_base + q0 + r], LOG2E) : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    hop::mbar_wait(slab, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES;
      hop::mbar_wait(&full[st], (t / STAGES) & 1);
      const char* Kt = ring + st * L::RING;
      const char* Vt = Kt + T::BYTES;
      float sf[32], dp[32];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        hop::Wgmma<64>::ss(sf, T::kmajor(Qs, kk), T::kmajor(Kt, kk), kk > 0);   // S = Q.K^T
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        hop::Wgmma<64>::ss(dp, T::kmajor(dOs, kk), T::kmajor(Vt, kk), kk > 0);  // dP = dO.V^T
      hop::wg_commit();
      hop::wg_wait();
      hop::fence_regs(sf);
      hop::fence_regs(dp);
      // The last tile holds the diagonal, and is the only one that can
      // cross s.
      if (t == ntiles - 1)
        ds_tile<true>(sf, dp, ls, dl, scale_log2, t * TILE + 2 * qd, q0 + 16 * warp + g, s);
      else
        ds_tile<false>(sf, dp, ls, dl, scale_log2, t * TILE + 2 * qd, q0 + 16 * warp + g, s);
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(sf, kk, a[kk]);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::Wgmma<D>::rs(acc, a[kk], T::mnmajor(Kt, kk));   // dQ += dS.K
      hop::wg_commit();
      hop::wg_wait();
      hop::fence_regs(acc);
      hop::mbar_arrive(&empty[st]);
    }
    store_rows<D>(dq + row_base * D, acc, scale, q0, s);
  }
}

// ---------------------------------------------------------------------------
// bf16, launch 2: dK and dV.  Block x: key tile x / (b hkv) (the heaviest
// first) of (b, KV head) x % (b hkv); it walks the group's query heads and,
// for each, the query tiles from the diagonal to the end.  Warpgroups 0 ..
// NWG - 1 compute (tile t of the walk goes to warpgroup t % NWG), warpgroup
// NWG's first thread loads.
// ---------------------------------------------------------------------------
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * WG, 3 - NWG)
attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap taux, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int bhkv, int hq, int hkv, int s, float scale_log2, float scale) {
  using T = Tile<D>;
  using L = DkvSmem<D, NWG>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ char bwd_smem_raw[];
  char* sm = align1024(bwd_smem_raw);
  char* Ks = sm;
  char* Vs = sm + T::BYTES;
  char* ring = sm + L::SLABS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* slab = empty + STAGES;
  const int nt = (s + TILE - 1) / TILE;
  const int kt = blockIdx.x / bhkv, bk = blockIdx.x % bhkv;
  const int b = bk / hkv, hk = bk - b * hkv, group = hq / hkv;
  const int k0 = kt * TILE, per = nt - kt, items = group * per;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], WG);
    }
    hop::mbar_init(slab, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * WG) {  // the producer warpgroup
    hop::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * WG) {
      hop::mbar_expect_tx(slab, 2 * T::BYTES);
      for (int c = 0; c < D / 64; ++c) {
        hop::tma_load_3d(Ks + c * T::BLOCK, &tk, slab, 64 * c, k0, bk);
        hop::tma_load_3d(Vs + c * T::BLOCK, &tv, slab, 64 * c, k0, bk);
      }
      for (int t = 0; t < items; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) hop::mbar_wait(&empty[st], (t / STAGES - 1) & 1);
        hop::mbar_expect_tx(&full[st], 2 * T::BYTES + 2 * TILE * 4);
        const int bh = b * hq + hk * group + t / per, qrow0 = (kt + t % per) * TILE;
        char* Qt = ring + st * L::STAGE;
        for (int c = 0; c < D / 64; ++c) {
          hop::tma_load_3d(Qt + c * T::BLOCK, &tq, &full[st], 64 * c, qrow0, bh);
          hop::tma_load_3d(Qt + T::BYTES + c * T::BLOCK, &tdo, &full[st], 64 * c, qrow0, bh);
        }
        // The tile's rows' lse (log2 units) and delta, zeros past s.
        hop::tma_load_2d(Qt + 2 * T::BYTES, &taux, &full[st], qrow0, 2 * bh);
      }
    }
  } else {  // consumer warpgroup wg: keys k0 .. k0 + 63
    hop::regs_inc<NWG == 2 ? 240 : 232>();
    const int wg = threadIdx.x / WG, warp = (threadIdx.x / 32) % WARPS, lane = threadIdx.x % 32;
    const int g = lane / 4, qd = lane % 4;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    hop::mbar_wait(slab, 0);
    for (int t = wg; t < items; t += NWG) {
      const int st = t % STAGES;
      hop::mbar_wait(&full[st], (t / STAGES) & 1);
      const int qt = kt + t % per, qrow0 = qt * TILE;
      const char* Qt = ring + st * L::STAGE;
      const char* dOt = Qt + T::BYTES;
      const float2* lt2 = reinterpret_cast<const float2*>(Qt + 2 * T::BYTES);   // lse2, then delta
      float st_[32], dpt[32];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        hop::Wgmma<64>::ss(st_, T::kmajor(Ks, kk), T::kmajor(Qt, kk), kk > 0);   // S^T = K.Q^T
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk)
        hop::Wgmma<64>::ss(dpt, T::kmajor(Vs, kk), T::kmajor(dOt, kk), kk > 0);  // dP^T = V.dO^T
      hop::wg_commit();
      hop::wg_wait();
      hop::fence_regs(st_);
      hop::fence_regs(dpt);
      // The diagonal tile, and the one that crosses s, are masked.
      if (qt == kt || qrow0 + TILE > s)
        pds_tile<true>(st_, dpt, lt2, qd, scale_log2, k0 + 16 * warp + g, qrow0 + 2 * qd, s);
      else
        pds_tile<false>(st_, dpt, lt2, qd, scale_log2, k0 + 16 * warp + g, qrow0 + 2 * qd, s);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a_frag(st_, kk, pa[kk]);
        a_frag(dpt, kk, da[kk]);
      }
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::Wgmma<D>::rs(dva, pa[kk], T::mnmajor(dOt, kk));   // dV += P^T.dO
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::Wgmma<D>::rs(dka, da[kk], T::mnmajor(Qt, kk));    // dK += dS^T.Q
      hop::wg_commit();
      hop::wg_wait();
      hop::fence_regs(dva);
      hop::fence_regs(dka);
      hop::mbar_arrive(&empty[st]);
    }
    if (NWG == 2) {
      // Every tile is consumed, so the ring is free: warpgroup 1 leaves its
      // sums there and warpgroup 0 adds them to its own (first + second).
      float* part = reinterpret_cast<float*>(ring);
      const int tid = threadIdx.x % WG;
      hop::bar_sync<1>(NWG * WG);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          part[i * WG + tid] = dka[i];
          part[(D / 2 + i) * WG + tid] = dva[i];
        }
      }
      hop::bar_sync<1>(NWG * WG);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          dka[i] = __fadd_rn(dka[i], part[i * WG + tid]);
          dva[i] = __fadd_rn(dva[i], part[(D / 2 + i) * WG + tid]);
        }
      }
    }
    if (wg == 0) {
      store_rows<D>(dk + (size_t)bk * s * D, dka, scale, k0, s);
      store_rows<D>(dv + (size_t)bk * s * D, dva, 1.f, k0, s);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Rows (bh, s, d) of bf16 as boxes of TILE rows x 64 columns, 128-byte
// swizzle; rows past s read as zeros.
bool map_rows(CUtensorMap* m, const void* base, int bh, int s, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, TILE, 1}, unit[3] = {1, 1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// aux (rows, sp) f32 as boxes of 2 rows x TILE values.
bool map_aux(CUtensorMap* m, const float* base, int rows, int sp) {
  const cuuint64_t dims[2] = {(cuuint64_t)sp, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)sp * 4};
  const cuuint32_t box[2] = {TILE, 2}, unit[2] = {1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dQ at D = 64 (3 stages): three blocks an SM, its consumer held to 136
// registers; at D = 128 (2 stages) two, 232 registers.  dK/dV: one consumer
// warpgroup at D = 64 (two blocks an SM), two at D = 128, so that a KV
// head's heaviest key tile takes half the time and Qwen3-8B's 8 KV heads
// (256 blocks on 132 SMs) stop waiting on one block.  Fixed by D alone: the
// split changes dK's and dV's summation order, so it must not follow B.
template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* aux, void* dq, void* dk, void* dv, int b, int hq, int hkv, int s, float scale,
              cudaStream_t st) {
  constexpr int QSTAGES = D == 64 ? 3 : 2, QBLOCKS = D == 64 ? 3 : 2, QREGS = D == 64 ? 136 : 232;
  constexpr int NWG = D == 64 ? 1 : 2;
  auto k1 = attn_bwd_dq_kernel<D, QSTAGES, QBLOCKS, QREGS>;
  auto k2 = attn_bwd_dkv_kernel<D, NWG>;
  constexpr int SM1 = DqSmem<D, QSTAGES>::BYTES, SM2 = DkvSmem<D, NWG>::BYTES;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, SM1);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, SM2);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo, taux;
  const int nt = (s + TILE - 1) / TILE;
  if (!map_rows(&tq, q, b * hq, s, D) || !map_rows(&tk, k, b * hkv, s, D) || !map_rows(&tv, v, b * hkv, s, D) ||
      !map_rows(&tdo, dout, b * hq, s, D) || !map_aux(&taux, aux, 2 * b * hq, nt * TILE))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  k1<<<nt * b * hq, 2 * WG, SM1, st>>>(tq, tk, tv, tdo, static_cast<const bf16*>(o),
                                       static_cast<const bf16*>(dout), lse, aux, static_cast<bf16*>(dq), b * hq,
                                       hq, hkv, s, scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2<<<nt * b * hkv, (NWG + 1) * WG, SM2, st>>>(tq, tk, tv, tdo, taux, static_cast<bf16*>(dk),
                                                static_cast<bf16*>(dv), b * hkv, hq, hkv, s, scale_log2, scale);
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
// f32 scratch, written by launch 1 and read by launch 2: (b, hq, s) for f32,
// (b, hq, 2, ceil(s / 64) * 64) for bf16 (each row's lse in log2 units and
// its delta, rows padded to whole tiles, 16-byte aligned).  Anything else
// (and b * hq > 65535 in f32, b * hq * s >= 2^31 in bf16):
// cudaErrorInvalidValue, and nothing is launched.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                          const void* dout, const void* lse, void* delta, void* dq, void* dk,
                                          void* dv, int b, int hq, int hkv, int s, int d, int dtype, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv || s < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if ((size_t)b * hq > 65535) return (int)cudaErrorInvalidValue;
    switch (d) {
      case 16: return launch_simt<16>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
      case 64: return launch_simt<64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
      case 128: return launch_simt<128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || (size_t)b * hq * s > 0x7fffffff) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return launch_tc<64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
    case 128: return launch_tc<128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, hq, hkv, s, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

REPRO_EXPORT_ERROR_STRING(flash_attention_bwd)
