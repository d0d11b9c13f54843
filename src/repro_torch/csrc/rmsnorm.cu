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
// rmsnorm's form (redesigned after its first form, a loop over the row
// whose trip count was known only at run time, walked twice, with the
// scale read as scalar f32 after the shuffle tree, took 0.00298 ms at 8
// rows of 960 bf16 against a 0.000010 ms bound on an H100): a lane issues
// every load of its part of the row, and of the f32 scale vectors it
// meets, before any arithmetic, with a compile-time number of vectors a
// lane (rms_plan(d, dtype)); a row of 9-32 vectors a lane (4096-8192
// bf16) is loaded by a block of 128 threads and summed by one warp from
// shared memory (rmsnorm_wide_kernel), a wider one walked in chunks of 8,
// each in the same order.  The order of every sum is the first
// form's, so are its bits.  The fused residual add: given r, the kernel
// forms s = x + r (f32, rounded once: torch's x + r), writes s and
// normalises it, one launch where the serve path ran an eager add and a
// norm.
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
// Bound on the card: bytes.  A row is read once and written once (the
// fused form also reads r and writes s); 3 (rmsnorm) or 6 (layernorm)
// operations an element.  A decode step's norms are 3-8 rows of 960 or
// 2560, where the launch and one round trip to memory, not the bytes, are
// the cost: one launch a norm replaces torch's ~10 elementwise and
// reduction launches, and the fused form the residual add's launch too.
#include "common.cuh"

namespace {

constexpr int RMS_ROWS = 2;       // rmsnorm: rows a block, one warp a row
constexpr int RMS_MAX_PER = 8;    // rmsnorm: vectors a lane holds in registers as f32, at most
constexpr int RMS_MAX_WIDE = 32;  // rmsnorm: vectors a lane sums from shared memory (8192 bf16)
constexpr int WIDE_THREADS = 128;  // rmsnorm: a wide row's threads (RMS_MAX_WIDE / 4 vectors each)
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

// x (+ r) rounded to T: torch's x + r (the sum in f32, rounded once to
// the tensors' dtype); f32 values pass unchanged.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The fused add on vector c of a row: r's values w added to x's v in f32,
// each sum rounded to T (torch's x + r) and the vector stored to sr.
template <typename T, int V>
__device__ __forceinline__ void add_vec(float (&v)[V], const float (&w)[V], T* sr, int c) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = round_as(__fadd_rn(v[j], w[j]), sr);
  Vec<T, V>::store(sr + c * V, v);
}

// rmsnorm (the first form's order, the row read once): one warp owns one row, RMS_ROWS rows
// a block.  Lane l holds the row's vectors l, l + 32, ..., P of them (P =
// ceil(nvec / 32), a compile-time count: kernels/rmsnorm.py:rms_plan), and
// issues every 16-byte load of x, of r (the fused residual, or none) and
// of the f32 scale vectors they meet before any arithmetic; the row stays
// in registers for the output.  Given r, s = x + r (rounded to T) is
// written to `sum` and normalised.  The sum of squares: the lane's values
// in order (__fmaf_rn), then the xor tree over the 32 lanes (__fadd_rn;
// a + b == b + a, so every lane ends with the same bits).
template <typename T, int V, int P>
__global__ void __launch_bounds__(RMS_ROWS * 32)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ scale, T* __restrict__ sum, T* __restrict__ y,
                   int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * RMS_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp: a row is a warp's
  const int nvec = d / V;
  const T* xr = x + row * d;
  float v[P][V], sc[P][V];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = lane + 32 * p;
    if (c < nvec) {
      Vec<T, V>::load(xr + c * V, v[p]);
      Vec<float, V>::load(scale + c * V, sc[p]);
    }
  }
  if (res != nullptr) {
    const T* rr = res + row * d;
    float w[P][V];
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (lane + 32 * p < nvec) Vec<T, V>::load(rr + (lane + 32 * p) * V, w[p]);
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (lane + 32 * p < nvec) add_vec<T, V>(v[p], w[p], sum + row * d, lane + 32 * p);
  }
  float acc = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (lane + 32 * p < nvec)
#pragma unroll
      for (int j = 0; j < V; ++j) acc = __fmaf_rn(v[p][j], v[p][j], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(acc, (float)d), eps));
  T* yr = y + row * d;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = lane + 32 * p;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[p][j] = __fmul_rn(__fmul_rn(v[p][j], r), sc[p][j]);
      Vec<T, V>::store(yr + c * V, v[p]);
    }
  }
}

// A vector of V values of T as it lies in memory, widened to f32 where it
// is used: a wide row's vectors in shared memory.
template <typename T, int V>
struct alignas(sizeof(T) * V) Raw {
  T e[V];
  __device__ __forceinline__ void unpack(float (&v)[V]) const {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_f32(e[j]);
  }
  __device__ __forceinline__ void pack(const float (&v)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) store_f32(&e[j], v[j]);
  }
};

// A row of 8 < per <= RMS_MAX_WIDE vectors a lane (4096, 5120 and 8192
// bf16): a block of WIDE_THREADS threads a row.  Thread t loads vectors t,
// t + WIDE_THREADS, ... (Q <= 8 of them), of r (the fused add) and of the
// scale, all before any arithmetic, forms s (and stores it), and leaves
// its vectors in shared memory as T.  Warp 0 then sums the squares in
// rmsnorm_kernel's order (lane l its vectors l, l + 32, ..., read back from
// shared memory; the xor tree), so the bits are rmsnorm_kernel's, and every
// thread writes its vectors' output from its registers: the scale's loads
// ride beside the row's, not after the sum.
template <typename T, int V, int Q>
__global__ void __launch_bounds__(WIDE_THREADS)
    rmsnorm_wide_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const float* __restrict__ scale, T* __restrict__ sum,
                        T* __restrict__ y, int d, float eps) {
  __shared__ Raw<T, V> held[WIDE_THREADS * Q];
  __shared__ float factor;
  const int t = threadIdx.x;
  const long row = blockIdx.x;
  const int nvec = d / V;
  const T* xr = x + row * d;
  float v[Q][V], sc[Q][V];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = t + WIDE_THREADS * q;
    if (c < nvec) {
      Vec<T, V>::load(xr + c * V, v[q]);
      Vec<float, V>::load(scale + c * V, sc[q]);
    }
  }
  if (res != nullptr) {
    const T* rr = res + row * d;
    float w[Q][V];
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (t + WIDE_THREADS * q < nvec) Vec<T, V>::load(rr + (t + WIDE_THREADS * q) * V, w[q]);
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (t + WIDE_THREADS * q < nvec) add_vec<T, V>(v[q], w[q], sum + row * d, t + WIDE_THREADS * q);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (t + WIDE_THREADS * q < nvec) held[t + WIDE_THREADS * q].pack(v[q]);   // exact: v holds T values
  __syncthreads();
  if (t < 32) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < WIDE_THREADS / 32 * Q; ++p)
      if (t + 32 * p < nvec) {
        float a[V];
        held[t + 32 * p].unpack(a);
#pragma unroll
        for (int j = 0; j < V; ++j) acc = __fmaf_rn(a[j], a[j], acc);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (t == 0) factor = __frsqrt_rn(__fadd_rn(__fdiv_rn(acc, (float)d), eps));
  }
  __syncthreads();
  const float r = factor;
  T* yr = y + row * d;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = t + WIDE_THREADS * q;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[q][j] = __fmul_rn(__fmul_rn(v[q][j], r), sc[q][j]);
      Vec<T, V>::store(yr + c * V, v[q]);
    }
  }
}

// A row of more than RMS_MAX_WIDE vectors a lane (no served width):
// lane l walks its vectors l, l + 32, ... in chunks of RMS_MAX_PER (a
// chunk's loads all in flight before its arithmetic), in rmsnorm_kernel's
// order, then walks them again for the output, re-reading x (and r: s is
// formed again, the same bits, rather than read back from `sum`).
template <typename T, int V>
__global__ void __launch_bounds__(RMS_ROWS * 32)
    rmsnorm_chunked_kernel(const T* __restrict__ x, const T* __restrict__ res,
                           const float* __restrict__ scale, T* __restrict__ sum,
                           T* __restrict__ y, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * RMS_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / V;
  const T* xr = x + row * d;
  const T* rr = res == nullptr ? nullptr : res + row * d;
  // Chunk by chunk: x (and r, their sum stored with `store`) loaded, then
  // fold(c, v) on each vector in order.
  auto walk = [&](bool store, auto fold) {
    for (int c0 = lane; c0 < nvec; c0 += 32 * RMS_MAX_PER) {
      float v[RMS_MAX_PER][V];
#pragma unroll
      for (int q = 0; q < RMS_MAX_PER; ++q)
        if (c0 + 32 * q < nvec) Vec<T, V>::load(xr + (c0 + 32 * q) * V, v[q]);
      if (rr != nullptr) {
        float w[RMS_MAX_PER][V];
#pragma unroll
        for (int q = 0; q < RMS_MAX_PER; ++q)
          if (c0 + 32 * q < nvec) Vec<T, V>::load(rr + (c0 + 32 * q) * V, w[q]);
#pragma unroll
        for (int q = 0; q < RMS_MAX_PER; ++q) {
          const int c = c0 + 32 * q;
          if (c >= nvec) continue;
          if (store) {
            add_vec<T, V>(v[q], w[q], sum + row * d, c);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) v[q][j] = round_as(__fadd_rn(v[q][j], w[q][j]), xr);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RMS_MAX_PER; ++q)
        if (c0 + 32 * q < nvec) fold(c0 + 32 * q, v[q]);
    }
  };
  float acc = 0.f;
  walk(true, [&](int, const float (&v)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc = __fmaf_rn(v[j], v[j], acc);
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(acc, (float)d), eps));
  T* yr = y + row * d;
  walk(false, [&](int c, const float (&v)[V]) {
    float sc[V], o[V];
    Vec<float, V>::load(scale + c * V, sc);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = __fmul_rn(__fmul_rn(v[j], r), sc[j]);
    Vec<T, V>::store(yr + c * V, o);
  });
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

template <typename T, int V, int P>
void launch_rms(const void* x, const void* res, const float* scale, void* sum, void* y, int rows,
                int d, float eps, cudaStream_t s) {
  const int blocks = (rows + RMS_ROWS - 1) / RMS_ROWS;
  const T *X = static_cast<const T*>(x), *R = static_cast<const T*>(res);
  T *Sum = static_cast<T*>(sum), *Y = static_cast<T*>(y);
  if constexpr (P > RMS_MAX_WIDE)
    rmsnorm_chunked_kernel<T, V><<<blocks, RMS_ROWS * 32, 0, s>>>(X, R, scale, Sum, Y, rows, d, eps);
  else if constexpr (P > RMS_MAX_PER)   // a block a row, P / 4 vectors a thread
    rmsnorm_wide_kernel<T, V, P / 4><<<rows, WIDE_THREADS, 0, s>>>(X, R, scale, Sum, Y, d, eps);
  else
    rmsnorm_kernel<T, V, P><<<blocks, RMS_ROWS * 32, 0, s>>>(X, R, scale, Sum, Y, rows, d, eps);
}

template <typename T, int V>
void launch_rms_per(int per, const void* x, const void* res, const float* scale, void* sum,
                    void* y, int rows, int d, float eps, cudaStream_t s) {
  switch (per) {
    case 1: launch_rms<T, V, 1>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 2: launch_rms<T, V, 2>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 3: launch_rms<T, V, 3>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 4: launch_rms<T, V, 4>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 5: launch_rms<T, V, 5>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 6: launch_rms<T, V, 6>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 7: launch_rms<T, V, 7>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 8: launch_rms<T, V, 8>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 9: case 10: case 11: case 12: launch_rms<T, V, 12>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 13: case 14: case 15: case 16: launch_rms<T, V, 16>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 17: case 18: case 19: case 20: launch_rms<T, V, 20>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 21: case 22: case 23: case 24: launch_rms<T, V, 24>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 25: case 26: case 27: case 28: launch_rms<T, V, 28>(x, res, scale, sum, y, rows, d, eps, s); break;
    case 29: case 30: case 31: case 32: launch_rms<T, V, 32>(x, res, scale, sum, y, rows, d, eps, s); break;
    default: launch_rms<T, V, RMS_MAX_WIDE + 1>(x, res, scale, sum, y, rows, d, eps, s); break;
  }
}

}  // namespace

// x, y (rows, d) contiguous in dtype 0 = f32 or 1 = bf16; scale (d,) f32.
// res and sum (rows, d) in x's dtype, both or neither: the fused residual
// add (sum = x + res, rounded once, and y its norm).  The plan
// (kernels/rmsnorm.py:rms_plan, a function of (d, dtype) only; any other
// is refused): vec, the elements a lane loads at once, 16 bytes' worth (4
// f32, 8 bf16) when d is a multiple of it, else 1; per = ceil(d / vec /
// 32), the vectors a lane holds; rows_a_block = RMS_ROWS.  With vec > 1,
// x, res, sum, y and scale must be 16-byte aligned.
extern "C" int rmsnorm_launch(const void* x, const void* res, const void* scale, void* sum,
                              void* y, int rows, int d, int dtype, int vec, int per,
                              int rows_a_block, float eps, void* stream) {
  if (rows < 1 || d < 1 || (res == nullptr) != (sum == nullptr)) return (int)cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (vec != (d % wide == 0 ? wide : 1)) return (int)cudaErrorInvalidValue;
  if (per != (d / vec + 31) / 32 || rows_a_block != RMS_ROWS) return (int)cudaErrorInvalidValue;
  auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (vec > 1 && (off16(x) || off16(y) || off16(scale) || off16(res) || off16(sum)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* S = static_cast<const float*>(scale);
  if (dtype == 0 && vec == 4) launch_rms_per<float, 4>(per, x, res, S, sum, y, rows, d, eps, s);
  else if (dtype == 0) launch_rms_per<float, 1>(per, x, res, S, sum, y, rows, d, eps, s);
  else if (vec == 8) launch_rms_per<__nv_bfloat16, 8>(per, x, res, S, sum, y, rows, d, eps, s);
  else launch_rms_per<__nv_bfloat16, 1>(per, x, res, S, sum, y, rows, d, eps, s);
  return (int)cudaGetLastError();
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
