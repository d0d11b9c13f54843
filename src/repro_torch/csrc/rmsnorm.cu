// RMSNorm on Hopper: y = x * rsqrt(mean(x^2) + eps) * scale over the last
// dim, f32 math, output in x's dtype; and LayerNorm (RWKV-6's norms, and
// its GroupNorm over each head's slice of a row): y = (x - mean(x)) *
// rsqrt(mean((x - mean(x))^2) + eps) * scale + bias, in the same
// fixed order.
//
// No Pallas counterpart: the reference computes them with jnp
// (src/repro/models/layers.py:103, :115, :125) and leaves the reduction
// order to XLA.  Every norm of a dense decoder runs rmsnorm: two a layer
// and the final norm, and qk_norm over each head's row (Qwen3).  Every
// norm of RWKV-6's serve path runs layernorm: ln0, two a layer, the wkv
// output's GroupNorm (rows of one head's N channels) and the final norm.
//
// Why a kernel.  Chunked prefill must give a prompt row the same bits
// whether its call holds 64, 128 or 488 rows, and decode a slot's row the
// same bits in a batch of 1 or 8.  torch's reduction kernels choose their
// thread layout, and so the order of an f32 sum, from the shape of the
// call; this kernel fixes the order.  One warp owns one row: lane l sums
// the squares of its fixed strided subset of the row (16-byte vectors l,
// l + 32, l + 64, ... in order, or elements when the row is not a whole
// number of vectors) with __fmaf_rn, then a fixed xor-shuffle tree adds
// the 32 partial sums with __fadd_rn.  Nothing depends on the row count,
// the row's index or the grid, and the explicit _rn intrinsics leave the
// compiler no contraction to choose, so a row's output bits are a
// function of the row, eps and scale alone.  layernorm sums the row once
// for its mean and once more for the squares of x - mean, each in that
// order, so its rows are batch-independent too.
//
// Bound on the card: bytes.  A row is read twice (the second pass mostly
// from L1) and written once; 3 operations an element.  A decode step's
// norms are 3-8 rows of 960, where the launch, not the bytes, is the cost:
// one launch a norm replaces torch's ~10 elementwise and reduction
// launches.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;   // rows a block: one warp a row

template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <typename T>
struct Vec<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float* v) { v[0] = to_f32(*p); }
  __device__ __forceinline__ static void store(T* p, const float* v) { store_f32(p, v[0]); }
};

template <typename T, int V>
__global__ void __launch_bounds__(WARPS * 32)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
                   int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int nvec = d / V;
  float acc = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float v[V];
    Vec<T, V>::load(xr + c * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = __fmaf_rn(v[j], v[j], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  acc = __shfl_sync(0xffffffffu, acc, 0);
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(acc, (float)d), eps));
  for (int c = lane; c < nvec; c += 32) {
    float v[V];
    Vec<T, V>::load(xr + c * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __fmul_rn(__fmul_rn(v[j], r), scale[c * V + j]);
    Vec<T, V>::store(yr + c * V, v);
  }
}

// One warp a row of d values, the row's scale and bias at (row % groups) *
// d: groups = 1 for a LayerNorm, the head count for a GroupNorm whose rows
// are the heads' slices of a model row.
template <typename T, int V>
__global__ void __launch_bounds__(WARPS * 32)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y, int rows, int d, int groups,
                     float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const long at = (row % groups) * d;
  const int nvec = d / V;
  float acc = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float v[V];
    Vec<T, V>::load(xr + c * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = __fadd_rn(acc, v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  const float mu = __fdiv_rn(__shfl_sync(0xffffffffu, acc, 0), (float)d);
  float sq = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float v[V];
    Vec<T, V>::load(xr + c * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dx = __fsub_rn(v[j], mu);
      sq = __fmaf_rn(dx, dx, sq);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  sq = __shfl_sync(0xffffffffu, sq, 0);
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(sq, (float)d), eps));
  for (int c = lane; c < nvec; c += 32) {
    float v[V];
    Vec<T, V>::load(xr + c * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long e = at + c * V + j;
      v[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j], mu), r), scale[e]), bias[e]);
    }
    Vec<T, V>::store(yr + c * V, v);
  }
}

template <typename T, int V>
int launch(const void* x, const void* scale, void* y, int rows, int d, float eps,
           cudaStream_t s) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  rmsnorm_kernel<T, V><<<blocks, WARPS * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(y), rows, d,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (rows, d) contiguous in dtype 0 = f32 or 1 = bf16; scale (d,) f32.
// vec is the elements a lane loads at once: 16 bytes' worth (4 f32, 8
// bf16) when d is a multiple of it, else 1 (kernels/rmsnorm.py:
// vec_width, a function of (d, dtype) only; any other value is refused).
// With vec > 1, x and y must be 16-byte aligned.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, int rows, int d,
                              int dtype, int vec, float eps, void* stream) {
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (vec != (d % wide == 0 ? wide : 1)) return (int)cudaErrorInvalidValue;
  if (vec > 1 && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec == 4 ? launch<float, 4>(x, scale, y, rows, d, eps, s)
                    : launch<float, 1>(x, scale, y, rows, d, eps, s);
  return vec == 8 ? launch<__nv_bfloat16, 8>(x, scale, y, rows, d, eps, s)
                  : launch<__nv_bfloat16, 1>(x, scale, y, rows, d, eps, s);
}

// The same contract for layernorm: x, y (rows, d); scale and bias
// (groups * d,) f32, row i normalised with the slice (i % groups) * d.
extern "C" int layernorm_launch(const void* x, const void* scale, const void* bias, void* y,
                                int rows, int d, int groups, int dtype, int vec, float eps,
                                void* stream) {
  if (rows < 1 || d < 1 || groups < 1) return (int)cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (vec != (d % wide == 0 ? wide : 1)) return (int)cudaErrorInvalidValue;
  if (vec > 1 && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + WARPS - 1) / WARPS;
  const float *S = static_cast<const float*>(scale), *B = static_cast<const float*>(bias);
#define LN(T, V)                                                                             \
  layernorm_kernel<T, V><<<blocks, WARPS * 32, 0, s>>>(static_cast<const T*>(x), S, B,      \
                                                        static_cast<T*>(y), rows, d, groups, eps)
  if (dtype == 0 && vec == 4) LN(float, 4);
  else if (dtype == 0) LN(float, 1);
  else if (vec == 8) LN(__nv_bfloat16, 8);
  else LN(__nv_bfloat16, 1);
#undef LN
  return (int)cudaGetLastError();
}

REPRO_EXPORT_ERROR_STRING(rmsnorm)
