// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is a plain C interface loaded with ctypes: each
// launch function takes raw device pointers, sizes and the caller's CUDA
// stream, launches on that stream without synchronising, and returns the
// code of cudaGetLastError() right after the launch (0 = success).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Masked logit, as in the TPU kernels (flash_attention.py:28): finite, so a
// fully masked row keeps m = -1e30, p = 0, l = 0 and ends as a zero output.
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round to nearest even, as torch's and jax's f32 -> bf16 casts do.
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Online-softmax attention shared by flash_attention.cu, decode_attention.cu
// and paged_decode_attention.cu.  One warp owns one query row; a KV tile of
// 32 keys sits in shared memory as f32, one key per lane for Q.K^T.  Ks rows
// are padded to D + 1 floats so the 32 lanes reading 32 different keys hit
// 32 different banks.  For P.V a lane owns DPL output dims: dims lane,
// lane + 32, ... (D / 32 of them) for D >= 32; for D < 32 (the SMOKE
// configs' 16) one, dim `lane`, on lanes 0..D-1, while lanes D..31 repeat
// dim lane % D and store nothing.
constexpr int KV_TILE = 32;

template <int D>
struct RowState {
  static_assert(D == 16 || (D >= 32 && D % 32 == 0), "head dim");
  static constexpr int DPL = D >= 32 ? D / 32 : 1;
  float m, l, acc[DPL];

  __device__ __forceinline__ static int dim(int lane, int j) { return D >= 32 ? lane + 32 * j : lane % D; }
  __device__ __forceinline__ static bool owns(int lane) { return D >= 32 || lane < D; }

  __device__ __forceinline__ void init() {
    m = REPRO_NEG_INF;
    l = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
  }
  // Fold one KV tile into the row: `valid` masks this lane's key.
  __device__ __forceinline__ void step(const float* qrow, const float* Ks, const float* Vs,
                                       bool valid, float scale, int lane) {
    float s = 0.f;
    const float* krow = Ks + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
    s = valid ? s * scale : REPRO_NEG_INF;
    const float m_new = fmaxf(m, warp_max(s));
    const float p = valid ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = alpha * l + warp_sum(p);
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int kk = 0; kk < KV_TILE; ++kk) {
      const float pk = __shfl_sync(0xffffffffu, p, kk);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] = fmaf(pk, Vs[kk * D + dim(lane, j)], acc[j]);
    }
    m = m_new;
  }
  // Zero-denominator guard (flash_attention.py:106-108): l == 0 -> 0.
  template <typename T>
  __device__ __forceinline__ void store(T* out, int lane) const {
    const float denom = l > 0.f ? l : 1.f;
    if (!owns(lane)) return;
#pragma unroll
    for (int j = 0; j < DPL; ++j) store_f32(out + dim(lane, j), acc[j] / denom);
  }
  // The unnormalised state of one chunk of keys, for merge_partials: m and
  // l at ml[0], ml[1], the D sums at acc_out[0, D).
  __device__ __forceinline__ void store_partial(float* ml, float* acc_out, int lane) const {
    if (lane == 0) {
      ml[0] = m;
      ml[1] = l;
    }
    if (!owns(lane)) return;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc_out[dim(lane, j)] = acc[j];
  }
};

// Keys per decode chunk: a slot's keys [0, length) split into chunks of this
// many keys counted from key 0, each folded by its own block, the partial
// states merged in chunk order (decode_attention.cu,
// paged_decode_attention.cu).  A function of (D, KV dtype: 0 f32, 1 bf16,
// 2 int8) only, never of the batch, the lengths or the cache's size, so a
// slot's bits do not depend on them.  kernels/decode_attention.py:
// decode_chunk holds the same table; the entry points refuse any other
// value.  A multiple of KV_TILE: 32 keys at D = 16 and 64, 128 at D = 128,
// for every KV dtype, the fastest of 32-256 in tools/decode_table.py
// --sweep (PERF.md).  REPRO_DECODE_CHUNK overrides it for every (D, dtype)
// in a build made to time other chunk sizes.
__host__ __device__ constexpr int decode_chunk(int d, int kv_dtype) {
#ifdef REPRO_DECODE_CHUNK
  return (void)d, (void)kv_dtype, REPRO_DECODE_CHUNK;
#else
  return (void)kv_dtype, d == 128 ? 128 : 32;
#endif
}

// Merge the partial states of chunks 0..n-1 of one query row (one warp):
// M = max_c m_c, e_c = exp(m_c - M), out = (sum_c e_c acc_c) / (sum_c e_c
// l_c), both sums taken in chunk order with round-to-nearest FMAs, so the
// bits depend only on the partials.  One partial gives e_0 = 1 and the
// state's own acc / l.  Lane i holds m and l of chunk i (of each group of
// 32), and a lane loads the acc values of 32 / DPL chunks at once; the
// first group's m and l and the first batch of acc are all requested
// before the max, so up to 32 / DPL chunks arrive in one round trip.  The
// partials were written by other blocks of the same launch, so they are
// read through L2 (__ldcg), never a stale L1.
template <int D, typename T>
__device__ __forceinline__ void merge_partials(const float* ml, const float* acc, int n, T* out,
                                               int lane) {
  using RS = RowState<D>;
  constexpr int BATCH = 32 / RS::DPL;
  float v[BATCH][RS::DPL];
  auto load_batch = [&](int c_first, int c_end) {  // acc of chunks [c_first, c_first + BATCH)
#pragma unroll
    for (int i = 0; i < BATCH; ++i)
#pragma unroll
      for (int j = 0; j < RS::DPL; ++j)
        v[i][j] = c_first + i < c_end ? __ldcg(acc + (size_t)(c_first + i) * D + RS::dim(lane, j)) : 0.f;
  };
  float m_i = REPRO_NEG_INF, l_i = 0.f;  // chunk `lane`
  if (lane < n) {
    m_i = __ldcg(ml + 2 * lane);
    l_i = __ldcg(ml + 2 * lane + 1);
  }
  load_batch(0, n);
  float M = m_i;
  for (int c = lane + 32; c < n; c += 32) M = fmaxf(M, __ldcg(ml + 2 * c));
  M = warp_max(M);
  float L = 0.f, a[RS::DPL];
#pragma unroll
  for (int j = 0; j < RS::DPL; ++j) a[j] = 0.f;
  for (int c32 = 0; c32 < n; c32 += 32) {
    if (c32 > 0) {  // chunk c32 + lane
      const bool ok = c32 + lane < n;
      m_i = ok ? __ldcg(ml + 2 * (c32 + lane)) : REPRO_NEG_INF;
      l_i = ok ? __ldcg(ml + 2 * (c32 + lane) + 1) : 0.f;
    }
    const float e_i = expf(__fsub_rn(m_i, M));
    const int c_end = min(c32 + 32, n);
    for (int c0 = c32; c0 < c_end; c0 += BATCH) {
      if (c0 > 0) load_batch(c0, c_end);
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const float e = __shfl_sync(0xffffffffu, e_i, (c0 + i) % 32);
        const float l = __shfl_sync(0xffffffffu, l_i, (c0 + i) % 32);
        if (c0 + i < c_end) {
          L = __fmaf_rn(e, l, L);
#pragma unroll
          for (int j = 0; j < RS::DPL; ++j) a[j] = __fmaf_rn(e, v[i][j], a[j]);
        }
      }
    }
  }
  const float denom = L > 0.f ? L : 1.f;
  if (!RS::owns(lane)) return;
#pragma unroll
  for (int j = 0; j < RS::DPL; ++j) store_f32(out + RS::dim(lane, j), a[j] / denom);
}

// The end of a chunked decode block, after every thread wrote its part of
// the block's partial states: take a ticket from this (slot, KV head)'s
// counter and return true in the block that finishes last, which resets
// the counter to 0 (so the next launch, a CUDA graph replay included,
// finds it zeroed) and then merges.  The barrier orders the block's writes
// before thread 0's device-scope fence, which orders them before the
// ticket (the pattern of a cooperative grid barrier).  Every thread of the
// block calls it.
__device__ __forceinline__ bool last_chunk_block(int* ticket, int n_active) {
  __shared__ int last;
  __syncthreads();  // every thread's partials are written ...
  if (threadIdx.x == 0) {
    __threadfence();  // ... and visible on the card before this block's ticket
    last = atomicAdd(ticket, 1) == n_active - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Copy ROWS rows of a (., D) tile starting at `src` into shared memory as
// f32 with row stride `ld`; rows at or past `valid_rows` are zero.  The
// trip count is a compile-time constant, so the loop unrolls and all of a
// thread's loads are in flight at once.
template <int ROWS, int D, int THREADS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int valid_rows) {
  static_assert((ROWS * D) % THREADS == 0, "tile loads");
#pragma unroll
  for (int it = 0; it < ROWS * D / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / D, c = i % D;
    dst[r * ld + c] = r < valid_rows ? to_f32(src[(size_t)r * D + c]) : 0.f;
  }
}

// The same for a runtime number of rows, all valid.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) dst[i] = to_f32(src[i]);
}

#define REPRO_EXPORT_ERROR_STRING(prefix) \
  extern "C" const char* prefix##_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
