// Mamba's selective scan (S6) on Hopper: the diagonal recurrence of the
// Jamba hybrid's Mamba mixer, from a carried state.
//
// No Pallas counterpart: the reference runs it in jnp, a chunked
// associative scan for a prompt (src/repro/models/mamba.py:83-114,
// _ssm_scan_chunked) and one step for decode (:151-154), then contracts
// the states with C (:158).  Eager torch would issue about five launches a
// token (a 448-token prompt: ~2,240 a layer) and sum the contraction over
// N in an order set by the call's shape; this kernel is one launch a layer
// a call, for a prompt and for a decode step alike.
//
// Layout (contiguous): dt, x (B, T, di) and y (B, T, di) in the compute
// dtype (f32 or bf16); bm, c (B, T, N) in the same dtype; A (di, N) f32
// (-exp(a_log)); h0 and hT (B, di, N) f32.  In f32, the reference's
// rounding points:
//   dtx   = dt * x                       (rounded once)
//   h[n]  = exp(dt * A[n]) * h[n] + dtx * B[n]   (each product rounded)
//   y     = sum_n h[n] * C[n]            (fma, n = 0, 1, ..., N-1 in order)
// y is rounded once to the compute dtype; hT is the state after step T.
//
// Design: one thread owns one (b, d) row and its N states in registers and
// walks T in order, so a row's bits depend on nothing else in the batch
// (what the serving engine's --verify needs) and T = 1 (decode) and T =
// 448 (a prompt) are the same kernel.  A block holds THREADS consecutive
// channels of one sequence; it stages the B and C rows of TT steps at a
// time in shared memory, which all its threads read (broadcast).  expf is
// the precise one (no --use_fast_math).
//
// Bound on the card: bytes at decode (the f32 state read and written once,
// 2 x B x di x N x 4 bytes, against 7 f32 operations a state a step);
// at a long prompt on one sequence the walk over T is serial, and only
// di / THREADS blocks run: speed work for a later change.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;   // channels of one sequence a block
constexpr int TT = 32;        // steps whose B and C rows a block stages
constexpr int MAX_STATE = 16; // states a row keeps in registers (Jamba's d_state)

template <typename T>
__global__ void __launch_bounds__(THREADS)
    selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                          const T* __restrict__ c, const float* __restrict__ A,
                          const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
                          int t_len, int di, int n) {
  __shared__ float Bs[TT][MAX_STATE];
  __shared__ float Cs[TT][MAX_STATE];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;
  const long long row = (long long)b * di + d;
  float h[MAX_STATE], a[MAX_STATE];
#pragma unroll
  for (int j = 0; j < MAX_STATE; ++j) {
    const bool on = live && j < n;
    h[j] = on ? h0[row * n + j] : 0.f;
    a[j] = on ? A[(long long)d * n + j] : 0.f;
  }
  for (int t0 = 0; t0 < t_len; t0 += TT) {
    const int steps = min(TT, t_len - t0);
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < steps * n; i += THREADS) {
      const int s = i / n, j = i - s * n;
      const long long e = ((long long)b * t_len + t0 + s) * n + j;
      Bs[s][j] = to_f32(bm[e]);
      Cs[s][j] = to_f32(c[e]);
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < steps; ++s) {
      const long long e = ((long long)b * t_len + t0 + s) * di + d;
      const float dtv = to_f32(dt[e]);
      const float dtx = __fmul_rn(dtv, to_f32(x[e]));
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_STATE; ++j) {
        if (j < n) {
          const float da = expf(__fmul_rn(dtv, a[j]));
          h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dtx, Bs[s][j]));
          acc = fmaf(h[j], Cs[s][j], acc);
        }
      }
      store_f32(y + e, acc);
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < MAX_STATE; ++j)
      if (j < n) hT[row * n + j] = h[j];
  }
}

template <typename T>
int launch(const void* dt, const void* x, const void* bm, const void* c, const void* A,
           const void* h0, void* y, void* hT, int batch, int t_len, int di, int n,
           cudaStream_t s) {
  const dim3 grid((di + THREADS - 1) / THREADS, batch);
  const T* DT = static_cast<const T*>(dt);
  const T* X = static_cast<const T*>(x);
  const T* BM = static_cast<const T*>(bm);
  const T* CC = static_cast<const T*>(c);
  const float* AA = static_cast<const float*>(A);
  const float* H0 = static_cast<const float*>(h0);
  selective_scan_kernel<T><<<grid, THREADS, 0, s>>>(
      DT, X, BM, CC, AA, H0, static_cast<T*>(y), static_cast<float*>(hT), t_len, di, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dt, x, y (batch, t_len, di) and bm, c (batch, t_len, n) in dtype 0 = f32
// or 1 = bf16; A (di, n), h0 and hT (batch, di, n) f32; all contiguous.
// 1 <= n <= 16 (kernels/selective_scan.py: MAX_STATE); batch <= 65535.
extern "C" int selective_scan_launch(const void* dt, const void* x, const void* bm, const void* c,
                                     const void* A, const void* h0, void* y, void* hT, int batch,
                                     int t_len, int di, int n, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || di < 1 || n < 1 || n > MAX_STATE ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(dt, x, bm, c, A, h0, y, hT, batch, t_len, di, n, s)
                    : launch<__nv_bfloat16>(dt, x, bm, c, A, h0, y, hT, batch, t_len, di, n, s);
}

REPRO_EXPORT_ERROR_STRING(selective_scan)
