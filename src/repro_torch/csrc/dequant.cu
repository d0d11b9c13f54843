// int8 weight dequantization on Hopper: out = dtype(f32(q) * scale), the
// per-output-channel codes and scales of models/quant.py.
//
// No Pallas counterpart: the reference dequantizes with jnp on every
// weight fetch (src/repro/serving/quant.py:44, dequantize_weight), an
// expression XLA fuses into one pass.  Under --quantize the port's weight
// fetch (models/quant.py:maybe_dequant) runs it once a weight a decode
// step, every weight of the model.  Eager torch ran it as three passes
// (~19 bytes a parameter), and one torch.mul into a bf16 output still ran
// at about a fifth of the card's memory rate on an H100 (chip_smoke.py's
// int8 decode step): one-byte loads, the casts and the broadcast scale on
// its generic path.
//
// Layout: q (G, K, N) int8, scale (G, N) f32, out (G, K, N), contiguous:
// out[g, k, n] = q[g, k, n] * scale[g, n] taken in f32 with __fmul_rn and
// rounded to nearest even into bf16 (or kept in f32), the bits of the
// plain version (q.float() * scale).to(dtype).  N = 1 gives a scale a row
// of a (G, K) matrix (the tied head's int8 transpose).
//
// Bound on the card: bytes.  Each code read once (1 byte) and each value
// written once (2 bytes in bf16); the scales are read from L2.  A thread
// converts 16 codes at a time, one 16-byte load and two (bf16) or four
// (f32) 16-byte stores, when the 16 share a row of scales (N a multiple of
// 16: 16 consecutive scales) or one scale (N = 1, K a multiple of 16);
// else one code at a time.  A grid-stride loop over at most MAX_BLOCKS
// blocks of 256 threads keeps enough 16-byte loads in flight.
#include "common.cuh"

namespace {

constexpr int VEC = 16;                 // codes a thread converts at once
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 8;

__device__ __forceinline__ void store16(float* p, const float* f) {
  float4* o = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* f) {
  uint4 u[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(u);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  uint4* o = reinterpret_cast<uint4*>(p);
  o[0] = u[0];
  o[1] = u[1];
}

// Code j of 16 packed in an int4, sign-extended (arithmetic shift).
__device__ __forceinline__ float code(const int4& r, int j) {
  const int w = j < 4 ? r.x : j < 8 ? r.y : j < 12 ? r.z : r.w;
  return (float)((w << (24 - 8 * (j & 3))) >> 24);
}

// nvec = G*K*N / 16 vectors; kn = K*N.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dequant_vec_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                       T* __restrict__ out, long long nvec, long long kn, int n) {
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * THREADS) {
    const long long e = v * VEC;
    const float* s = scale + (e / kn) * n + (n == 1 ? 0 : (int)(e % n));
    const int4 raw = *reinterpret_cast<const int4*>(q + e);
    float f[VEC];
    if (n == 1) {
      const float sv = *s;
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = __fmul_rn(code(raw, j), sv);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        const float4 s4 = *reinterpret_cast<const float4*>(s + j);
        f[j] = __fmul_rn(code(raw, j), s4.x);
        f[j + 1] = __fmul_rn(code(raw, j + 1), s4.y);
        f[j + 2] = __fmul_rn(code(raw, j + 2), s4.z);
        f[j + 3] = __fmul_rn(code(raw, j + 3), s4.w);
      }
    }
    store16(out + e, f);
  }
}

// One code a thread: any N, any K.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                   T* __restrict__ out, long long total, long long kn, int n) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS)
    store_f32(out + e, __fmul_rn((float)q[e], scale[(e / kn) * n + e % n]));
}

template <typename T>
int launch(const void* q, const void* scale, void* out, long long groups, long long k, int n,
           int vec, cudaStream_t s) {
  const long long total = groups * k * n;
  const long long items = vec == VEC ? total / VEC : total;
  const long long want = (items + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  const int8_t* Q = static_cast<const int8_t*>(q);
  const float* S = static_cast<const float*>(scale);
  if (vec == VEC)
    dequant_vec_kernel<T><<<blocks, THREADS, 0, s>>>(Q, S, static_cast<T*>(out), items, k * n, n);
  else
    dequant_kernel<T><<<blocks, THREADS, 0, s>>>(Q, S, static_cast<T*>(out), total, k * n, n);
  return (int)cudaGetLastError();
}

}  // namespace

// q (groups, k, n) int8, scale (groups, n) f32, out (groups, k, n) in dtype
// 0 = f32 or 1 = bf16, all contiguous.  vec is 16 when n is a multiple of
// 16 or n = 1 and k a multiple of 16, else 1 (kernels/dequant.py:
// vec_width, a function of (k, n) only; any other value is refused).  With
// vec = 16, q and out must be 16-byte aligned, and scale too when n > 1.
extern "C" int dequant_launch(const void* q, const void* scale, void* out, long long groups,
                              long long k, int n, int dtype, int vec, void* stream) {
  if (groups < 1 || k < 1 || n < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool wide = n % VEC == 0 || (n == 1 && k % VEC == 0);
  if (vec != (wide ? VEC : 1)) return (int)cudaErrorInvalidValue;
  if (vec == VEC && (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
                     (n > 1 && reinterpret_cast<uintptr_t>(scale) % 16)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(q, scale, out, groups, k, n, vec, s)
                    : launch<__nv_bfloat16>(q, scale, out, groups, k, n, vec, s);
}

REPRO_EXPORT_ERROR_STRING(dequant)
