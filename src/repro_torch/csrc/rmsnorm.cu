// RMSNorm on Hopper: y = x * rsqrt(mean(x^2) + eps) * scale over the last
// dim, f32 math, output in x's dtype; and LayerNorm (RWKV-6's norms, and
// its GroupNorm over each head's slice of a row): y = (x - mean(x)) *
// rsqrt(mean((x - mean(x))^2) + eps) * scale + bias, each in a fixed
// order.
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
// function of the row, eps and scale alone.
//
// layernorm (redesigned after rmsnorm's one-warp form took 1.34x
// F.layer_norm's time on an H100 at RWKV-6 3B's decode, 8 rows of 2560: three dependent
// passes over the row, a loop whose trip count was known only at run time,
// 24 of 32 lanes idle on GroupNorm's rows of 64) reads a row once into
// registers, with a compile-time number of vectors a thread, and spreads a
// row over as many threads as ln_plan(w, dtype) gives: 8 lanes for a
// GroupNorm row of 64 bf16 (4 rows a warp), 64 threads for a row of 2560
// bf16 (5 vectors each, 8 blocks at M = 8).  Its sums keep a fixed order
// (see layernorm_kernel), which depends on (w, dtype) alone, so its rows are
// batch-independent too.
//
// Bound on the card: bytes.  A row is read once and written once (rmsnorm
// reads it twice, the second pass mostly from L1); 3 (rmsnorm) or 6
// (layernorm) operations an element.  A decode step's norms are 3-8 rows
// of 960 or 2560, where the launch and one round trip to memory, not the
// bytes, are the cost: one launch a norm replaces torch's ~10 elementwise
// and reduction launches.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;          // rmsnorm: rows a block, one warp a row
constexpr int LN_MAX_PER = 8;     // layernorm: vectors a thread, at most
constexpr int LN_MAX_THREADS = 256;  // (so a thread may keep its row's 3 P V values in registers)

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
struct Vec<float, 8> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    Vec<float, 4>::load(p, v);
    Vec<float, 4>::load(p + 4, v + 4);
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

// LayerNorm: a row of w values (its scale and bias at (row % groups) * w:
// groups = 1 for a LayerNorm, the head count for a GroupNorm whose rows are
// the heads' slices of a model row) is read once.  `threads` threads own a
// row (kernels/rmsnorm.py:ln_plan, a function of (w, dtype) alone): thread t
// loads vectors t, t + threads, ..., P of them, with the scale and bias they
// meet, into registers before any arithmetic, so the loads' latencies
// overlap.  The mean, then the sum of (x - mean)^2, then the output come from
// those registers.  Each sum: the thread's values in order (__fadd_rn /
// __fmaf_rn), an xor tree over the row's lanes of a warp, and, when a row
// spans warps, the warps' partials added in warp order through shared memory
// by every thread (so every thread holds the same bits).  threads < 32: a
// warp holds 32 / threads rows, a block 128 threads; threads >= 64: a block
// is one row.  Scale and bias are f32 (4 bytes to x's 2 in bf16), so they
// are read as 16-byte vectors too.
template <typename T, int V, int P>
__global__ void __launch_bounds__(LN_MAX_THREADS)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y, int rows, int w, int groups,
                     float eps, int threads) {
  __shared__ float part[2 * 32];
  const int lanes = threads < 32 ? threads : 32;   // the row's lanes in one warp
  const int tr = threadIdx.x % threads;             // the thread's place in its row
  const long row = (long)blockIdx.x * (blockDim.x / threads) + threadIdx.x / threads;
  const bool live = row < rows;   // lanes of a dead row still join the shuffles
  if (threads >= 64 && !live) return;   // a block is one row
  const int nv = w / V;
  const T* xr = x + row * w;
  const long at = (row % groups) * w;
  float v[P][V], sc[P][V], bi[P][V];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = tr + p * threads;
    if (live && c < nv) {
      Vec<T, V>::load(xr + c * V, v[p]);
      Vec<float, V>::load(scale + at + c * V, sc[p]);   // 16-byte aligned: w % V == 0
      Vec<float, V>::load(bias + at + c * V, bi[p]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[p][j] = sc[p][j] = bi[p][j] = 0.f;
    }
  }
  // The sum of a value over the row, the same bits in each of its threads.
  const int nwarps = threads / 32;
  auto row_sum = [&](float a, float* buf) {
    for (int off = lanes / 2; off > 0; off >>= 1)
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (nwarps > 1) {
      if (threadIdx.x % 32 == 0) buf[threadIdx.x / 32] = a;
      __syncthreads();
      a = buf[0];
      for (int i = 1; i < nwarps; ++i) a = __fadd_rn(a, buf[i]);
    }
    return a;
  };
  float acc = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (tr + p * threads < nv)
#pragma unroll
      for (int j = 0; j < V; ++j) acc = __fadd_rn(acc, v[p][j]);
  const float mu = __fdiv_rn(row_sum(acc, part), (float)w);
  float sq = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (tr + p * threads < nv)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float dx = __fsub_rn(v[p][j], mu);
        sq = __fmaf_rn(dx, dx, sq);
      }
  sq = row_sum(sq, part + 32);
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(sq, (float)w), eps));
  if (!live) return;
  T* yr = y + row * w;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = tr + p * threads;
    if (c < nv) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[p][j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[p][j], mu), r), sc[p][j]), bi[p][j]);
      Vec<T, V>::store(yr + c * V, v[p]);
    }
  }
}

// A row wider than LN_MAX_THREADS x LN_MAX_PER vectors (ln_plan: 256
// threads, per > 8; no served width): thread t walks its vectors t, t + 256,
// ... in chunks of LN_MAX_PER, in that order, three times (the mean, the
// squares, the output), reading the row from memory each time instead of
// holding it.  The sums run in layernorm_kernel's order: the thread's values
// in order, the xor tree over the warp, the warps' partials in warp order.
template <typename T, int V>
__global__ void __launch_bounds__(LN_MAX_THREADS)
    layernorm_chunked_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ bias, T* __restrict__ y, int w, int groups,
                             float eps, int per) {
  __shared__ float part[2 * 32];
  constexpr int NWARPS = LN_MAX_THREADS / 32;
  const int tr = threadIdx.x;
  const long row = blockIdx.x;   // a block is one row
  const int nv = w / V;
  const T* xr = x + row * w;
  T* yr = y + row * w;
  const long at = (row % groups) * w;
  auto row_sum = [&](float a, float* buf) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (tr % 32 == 0) buf[tr / 32] = a;
    __syncthreads();
    a = buf[0];
#pragma unroll
    for (int i = 1; i < NWARPS; ++i) a = __fadd_rn(a, buf[i]);
    return a;
  };
  // Chunk by chunk: load up to LN_MAX_PER vectors, then fold them in order.
  auto walk = [&](auto fold) {
    for (int p0 = 0; p0 < per; p0 += LN_MAX_PER) {
      float v[LN_MAX_PER][V];
#pragma unroll
      for (int q = 0; q < LN_MAX_PER; ++q) {
        const int c = tr + (p0 + q) * LN_MAX_THREADS;
        if (c < nv) Vec<T, V>::load(xr + c * V, v[q]);
      }
#pragma unroll
      for (int q = 0; q < LN_MAX_PER; ++q) {
        const int c = tr + (p0 + q) * LN_MAX_THREADS;
        if (c < nv) fold(c, v[q]);
      }
    }
  };
  float acc = 0.f;
  walk([&](int, const float* v) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc = __fadd_rn(acc, v[j]);
  });
  const float mu = __fdiv_rn(row_sum(acc, part), (float)w);
  float sq = 0.f;
  walk([&](int, const float* v) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dx = __fsub_rn(v[j], mu);
      sq = __fmaf_rn(dx, dx, sq);
    }
  });
  sq = row_sum(sq, part + 32);
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(sq, (float)w), eps));
  walk([&](int c, const float* v) {
    float sc[V], bi[V], o[V];
    Vec<float, V>::load(scale + at + c * V, sc);
    Vec<float, V>::load(bias + at + c * V, bi);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j], mu), r), sc[j]), bi[j]);
    Vec<T, V>::store(yr + c * V, o);
  });
}

// ln_plan's rule (kernels/rmsnorm.py): threads and vectors a thread for a
// row of nv vectors.  nv <= 32: the largest power of two <= nv; else the
// least power of two, at least 32, that leaves each thread at most 8, but
// at most LN_MAX_THREADS (then a thread may hold more, in chunks).
__host__ int ln_threads(int nv) {
  int t = 1;
  if (nv <= 32) {
    while (2 * t <= nv) t *= 2;
    return t;
  }
  const int need = (nv + LN_MAX_PER - 1) / LN_MAX_PER;
  while (t < need && t < LN_MAX_THREADS) t *= 2;
  return t < 32 ? 32 : t;
}

template <typename T, int V, int P>
void launch_ln(const void* x, const float* scale, const float* bias, void* y, int rows, int w,
               int groups, float eps, int threads, cudaStream_t s) {
  const int block = threads >= 64 ? threads : 128;
  const long per_block = block / threads;
  const long blocks = (rows + per_block - 1) / per_block;
  layernorm_kernel<T, V, P><<<(unsigned)blocks, block, 0, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, w, groups, eps, threads);
}

template <typename T, int V>
void launch_ln_per(int per, const void* x, const float* scale, const float* bias, void* y,
                   int rows, int w, int groups, float eps, int threads, cudaStream_t s) {
  if (per > LN_MAX_PER) {   // threads == LN_MAX_THREADS
    layernorm_chunked_kernel<T, V><<<(unsigned)rows, LN_MAX_THREADS, 0, s>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(y), w, groups, eps, per);
    return;
  }
  switch (per) {
    case 1: launch_ln<T, V, 1>(x, scale, bias, y, rows, w, groups, eps, threads, s); break;
    case 2: launch_ln<T, V, 2>(x, scale, bias, y, rows, w, groups, eps, threads, s); break;
    case 3: launch_ln<T, V, 3>(x, scale, bias, y, rows, w, groups, eps, threads, s); break;
    case 4: launch_ln<T, V, 4>(x, scale, bias, y, rows, w, groups, eps, threads, s); break;
    case 5: launch_ln<T, V, 5>(x, scale, bias, y, rows, w, groups, eps, threads, s); break;
    case 6: launch_ln<T, V, 6>(x, scale, bias, y, rows, w, groups, eps, threads, s); break;
    case 7: launch_ln<T, V, 7>(x, scale, bias, y, rows, w, groups, eps, threads, s); break;
    default: launch_ln<T, V, 8>(x, scale, bias, y, rows, w, groups, eps, threads, s); break;
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

// The same contract for layernorm: x, y (rows, w); scale and bias
// (groups * w,) f32 (16-byte aligned too when vec > 1), row i normalised
// with the slice (i % groups) * w;
// threads and per the row's threads and each one's vectors (ln_plan; any
// other split is refused, as is another vec; per > LN_MAX_PER runs
// layernorm_chunked_kernel).
extern "C" int layernorm_launch(const void* x, const void* scale, const void* bias, void* y,
                                int rows, int w, int groups, int dtype, int vec, int threads,
                                int per, float eps, void* stream) {
  if (rows < 1 || w < 1 || groups < 1) return (int)cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (vec != (w % wide == 0 ? wide : 1)) return (int)cudaErrorInvalidValue;
  const int nv = w / vec;
  if (threads != ln_threads(nv) || per != (nv + threads - 1) / threads)
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16 ||
                  reinterpret_cast<uintptr_t>(scale) % 16 || reinterpret_cast<uintptr_t>(bias) % 16))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *S = static_cast<const float*>(scale), *B = static_cast<const float*>(bias);
  if (dtype == 0 && vec == 4) launch_ln_per<float, 4>(per, x, S, B, y, rows, w, groups, eps, threads, s);
  else if (dtype == 0) launch_ln_per<float, 1>(per, x, S, B, y, rows, w, groups, eps, threads, s);
  else if (vec == 8) launch_ln_per<__nv_bfloat16, 8>(per, x, S, B, y, rows, w, groups, eps, threads, s);
  else launch_ln_per<__nv_bfloat16, 1>(per, x, S, B, y, rows, w, groups, eps, threads, s);
  return (int)cudaGetLastError();
}

REPRO_EXPORT_ERROR_STRING(rmsnorm)
