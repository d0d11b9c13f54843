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

// Online-softmax attention shared by flash_attention.cu and
// decode_attention.cu.  One warp owns one query row; a KV tile of 32 keys
// sits in shared memory as f32, one key per lane for Q.K^T and D/32
// output dims per lane for P.V.  Ks rows are padded to D + 1 floats so the
// 32 lanes reading 32 different keys hit 32 different banks.
constexpr int KV_TILE = 32;

template <int DPL>  // DPL = D / 32 output dims per lane
struct RowState {
  float m, l, acc[DPL];
  __device__ __forceinline__ void init() {
    m = REPRO_NEG_INF;
    l = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
  }
  // Fold one KV tile into the row: `valid` masks this lane's key.
  __device__ __forceinline__ void step(const float* qrow, const float* Ks, const float* Vs,
                                       bool valid, float scale, int lane) {
    constexpr int D = DPL * 32;
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
      for (int j = 0; j < DPL; ++j) acc[j] = fmaf(pk, Vs[kk * D + lane + 32 * j], acc[j]);
    }
    m = m_new;
  }
  // Zero-denominator guard (flash_attention.py:106-108): l == 0 -> 0.
  template <typename T>
  __device__ __forceinline__ void store(T* out, int lane) const {
    const float denom = l > 0.f ? l : 1.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) store_f32(out + lane + 32 * j, acc[j] / denom);
  }
};

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
