// GAMA GEMM on Hopper: C[M,N] = A[M,K] @ B[K,N], all row-major and contiguous.
//
// Replaces the Pallas kernel repro/kernels/gemm.py:gama_gemm (_gemm_kernel).
// What it computes is the same: f32 accumulation for f32/bf16 inputs (output
// in the input dtype), int32 accumulation for int8 inputs with the output in
// int32, or in int16/int8 through the requant epilogue of gemm.py:56-60:
// (float)acc * scale in f32, round half to even (rintf), saturate.
//
// Design.  One block owns a BM x BN output tile and walks K in BK steps; the
// partial sums stay in registers for the whole K loop (the TPU kernel's VMEM
// accumulator across its "arbitrary" K grid axis becomes this in-block loop).
// A and B tiles are staged through shared memory as the accumulator type and
// the ragged M, K and N edges are masked with zeros, so no caller pads.
//
// Row independence.  Each output element is summed over k = 0..K-1 in order
// by one thread, with the same tile sizes for every M.  So a row's result
// does not depend on how many other rows are in the batch: the serving
// engine's 3-slot decode is bit-identical to its 1-slot reference.  No split
// K, and no tile choice that depends on M.
//
// Bound on the card.  Decode (M <= 8) reads each weight once and is bound by
// device memory bytes; prefill at M = 16..64 is still far below the ridge of
// ~295 bf16 operations per byte.  This first kernel is SIMT FMA (no wgmma, no
// TMA): simple and right first; the tensor-core pipeline is later work.
#include "common.cuh"

namespace {

constexpr int BM = 16, BN = 64, BK = 64, THREADS = 128;
constexpr int TM = 2, TN = 4;  // per-thread outputs: rows ty*TM + i, cols tx + 16*j
static_assert((BM / TM) * (BN / TN) == THREADS, "thread layout");
static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0, "tile loads");

enum Epilogue { EPI_CAST = 0, EPI_REQUANT = 1 };

template <typename TAcc, typename TIn>
__device__ __forceinline__ TAcc widen(TIn x);
template <> __device__ __forceinline__ float widen<float, float>(float x) { return x; }
template <> __device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ int widen<int, int8_t>(int8_t x) { return (int)x; }

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int a, int b, int acc) { return acc + a * b; }

template <typename TOut, int EPI> struct Out;
template <> struct Out<float, EPI_CAST> {
  static __device__ __forceinline__ float of(float acc, float) { return acc; }
};
template <> struct Out<__nv_bfloat16, EPI_CAST> {
  static __device__ __forceinline__ __nv_bfloat16 of(float acc, float) { return __float2bfloat16_rn(acc); }
};
template <> struct Out<int32_t, EPI_CAST> {
  static __device__ __forceinline__ int32_t of(int acc, float) { return acc; }
};
template <typename TOut> struct Out<TOut, EPI_REQUANT> {
  static __device__ __forceinline__ TOut of(int acc, float scale) {
    constexpr float lo = sizeof(TOut) == 1 ? -128.f : -32768.f;
    constexpr float hi = sizeof(TOut) == 1 ? 127.f : 32767.f;
    const float scaled = __fmul_rn((float)acc, scale);  // no contraction with the rounding
    return (TOut)(int)fminf(fmaxf(rintf(scaled), lo), hi);
  }
};

template <typename TIn, typename TAcc, typename TOut, int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B, TOut* __restrict__ C,
            int M, int K, int N, float scale) {
  __shared__ TAcc As[BK][BM + 1];  // A tile transposed; +1 avoids store bank conflicts
  __shared__ TAcc Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  TAcc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = TAcc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Consecutive threads read consecutive addresses of A's rows and B's
    // rows.  Trip counts are compile-time constants, so the loops unroll
    // and every load of the tile is in flight at once.
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? widen<TAcc>(A[(size_t)gr * K + gc]) : TAcc(0);
    }
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? widen<TAcc>(B[(size_t)gr * N + gc]) : TAcc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      TAcc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + (BN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + (BN / TN) * j;
      if (c < N) C[(size_t)r * N + c] = Out<TOut, EPI>::of(acc[i][j], scale);
    }
  }
}

template <typename TIn, typename TAcc, typename TOut, int EPI>
void launch(const void* a, const void* b, void* c, int m, int k, int n, float scale, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<TIn, TAcc, TOut, EPI><<<grid, THREADS, 0, s>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), static_cast<TOut*>(c), m, k, n, scale);
}

}  // namespace

// code: 0 f32 -> f32, 1 bf16 -> bf16, 2 int8 -> int32, 3 int8 -> int16, 4 int8 -> int8.
extern "C" int gama_gemm_launch(const void* a, const void* b, void* c, int m, int k, int n, int code,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: launch<float, float, float, EPI_CAST>(a, b, c, m, k, n, scale, s); break;
    case 1: launch<__nv_bfloat16, float, __nv_bfloat16, EPI_CAST>(a, b, c, m, k, n, scale, s); break;
    case 2: launch<int8_t, int, int32_t, EPI_CAST>(a, b, c, m, k, n, scale, s); break;
    case 3: launch<int8_t, int, int16_t, EPI_REQUANT>(a, b, c, m, k, n, scale, s); break;
    case 4: launch<int8_t, int, int8_t, EPI_REQUANT>(a, b, c, m, k, n, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

REPRO_EXPORT_ERROR_STRING(gama_gemm)
