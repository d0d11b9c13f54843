// WKV6, the RWKV-6 recurrence, forward and backward on Hopper.
//
// Replaces the Pallas kernel repro/kernels/wkv.py:wkv6 (_wkv_kernel).  Per
// (batch b, head h), over time t, with an (N, N) f32 state S from zero:
//
//     a_t = k_t^T v_t
//     y_t = r_t (S + diag(u) a_t)
//     S  <- diag(w_t) S + a_t
//
// r, k, v (B, H, T, N) in f32 or bf16; w (B, H, T, N) and u (H, N) in f32;
// y in r's dtype, all arithmetic in f32.  The TPU kernel pads T to its
// `chunk` grid step with w = 1, r = k = v = 0 (ops.py:301-313); here the
// time loop runs inside the block and stops at T, so nothing is padded.
//
// The JAX package differentiates through its pallas_call; a launched CUDA
// kernel has no autograd, so the backward is a kernel of its own that
// computes the same VJP (kernels/ref.py:ref_wkv_bwd is its plain version).
// With S_t the state after step t (S_0 = 0) and G_t the gradient flowing
// into S_t from later steps (G_T = 0, G_{t-1} = diag(w_t) G_t + r_t gy_t^T):
//
//     gr_t[n] = sum_m (S_{t-1} + diag(u) k_t v_t^T)[n,m] gy_t[m]
//     gk_t[n] = sum_m (G_t + diag(u) r_t gy_t^T)[n,m] v_t[m]
//     gv_t[m] = sum_n (G_t + diag(u) r_t gy_t^T)[n,m] k_t[n]
//     gw_t[n] = sum_m G_t[n,m] S_{t-1}[n,m]
//     gu[h,n] = sum_{b,t} r_t[n] k_t[n] (v_t . gy_t)
//
// Design (simple and right first).  Forward: one block per (b, h) and one
// thread per column m of S, held in registers (N floats); the r, k, v and w
// rows of 32 steps at a time are staged in shared memory, which every
// thread reads as float4 broadcasts.  Backward: one block per (b, h) and
// one thread per row n of S and of G.  A first pass re-runs the forward
// recurrence and writes every S_{t-1} to a scratch buffer (B*H*T*N*N f32,
// laid out [t][m][n] so a warp's stores are coalesced); S_{t-1} is never
// recovered by dividing by w_t, which underflows towards 0 in trained
// models.  The reverse pass then reads S_{t-1} back and carries G in
// registers; gr, gk, gw and gu are sums along the thread's own row, and gv,
// a sum down a column, goes through an (N, N + 1) shared-memory tile.  gu
// is summed per (b, h) in a fixed order and then over b by a second small
// kernel in a fixed order: no atomics, so a training step is bit-for-bit
// reproducible.
//
// Bound on the card.  At the training shape (B=8, H=40, T=64, N=64) the
// forward moves 15.7 MB and does 4 N^2 f32 operations per (b, h, t): 4.7 us
// at 3.35 TB/s, 5.0 us at 67 TFLOP/s.  The simple design is bound
// by the serial time loop and by shared-memory reads instead: 320 blocks of
// 64 threads fill the 132 SMs thinly.  The backward adds the scratch
// buffer's write and read (335 MB at the training shape).
#include "common.cuh"

namespace {

constexpr int FWD_STEPS = 32;  // time steps staged in shared memory at once
constexpr int BWD_STEPS = 16;

// Stage `len` rows of N values (rows t0.. of a (T, N) slice) as f32; thread
// x copies column x.  Full chunks use a compile-time trip count.
template <int STEPS, int N, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int len) {
  const int x = threadIdx.x;
  if (len == STEPS) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) dst[j * N + x] = to_f32(src[j * N + x]);
  } else {
    for (int j = 0; j < len; ++j) dst[j * N + x] = to_f32(src[j * N + x]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
                int heads, int steps) {
  __shared__ __align__(16) float rs[FWD_STEPS * N];
  __shared__ __align__(16) float ks[FWD_STEPS * N];
  __shared__ __align__(16) float vs[FWD_STEPS * N];
  __shared__ __align__(16) float ws[FWD_STEPS * N];
  __shared__ __align__(16) float us[N];
  const int m = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * steps * N;
  us[m] = u[(blockIdx.x % heads) * N + m];
  float s[N];  // column m of S
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = 0.f;

  for (int t0 = 0; t0 < steps; t0 += FWD_STEPS) {
    const int len = min(FWD_STEPS, steps - t0);
    const size_t off = base + (size_t)t0 * N;
    __syncthreads();  // the previous chunk is consumed
    stage<FWD_STEPS, N>(rs, r + off, len);
    stage<FWD_STEPS, N>(ks, k + off, len);
    stage<FWD_STEPS, N>(vs, v + off, len);
    stage<FWD_STEPS, N>(ws, w + off, len);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float* rt = rs + j * N;
      const float* kt = ks + j * N;
      const float* wt = ws + j * N;
      const float vm = vs[j * N + m];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 r4 = ld4(rt + n), k4 = ld4(kt + n), w4 = ld4(wt + n), u4 = ld4(us + n);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w}, uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float a = kk[c] * vm;
          acc = fmaf(rr[c], fmaf(uu[c], a, s[n + c]), acc);
          s[n + c] = fmaf(ww[c], s[n + c], a);
        }
      }
      store_f32(y + off + (size_t)j * N + m, acc);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u, const T* __restrict__ gy,
                T* __restrict__ gr, T* __restrict__ gk, T* __restrict__ gv, float* __restrict__ gw,
                float* __restrict__ gu_part, float* __restrict__ states, int heads, int steps) {
  __shared__ __align__(16) float rs[BWD_STEPS * N];
  __shared__ __align__(16) float ks[BWD_STEPS * N];
  __shared__ __align__(16) float vs[BWD_STEPS * N];
  __shared__ __align__(16) float gs[BWD_STEPS * N];
  __shared__ __align__(16) float us[N];
  __shared__ float red[N * (N + 1)];  // red[n][m] = k_t[n] G_t[n, m], padded rows
  const int i = threadIdx.x;          // row i of S and G; column i of gv's sum
  const size_t base = (size_t)blockIdx.x * steps * N;
  float* st = states + (size_t)blockIdx.x * steps * N * N + i;
  const float ui = u[(blockIdx.x % heads) * N + i];
  us[i] = ui;

  // Pass 1: the forward recurrence, saving row i of every S_{t-1}.
  {
    float s[N];
#pragma unroll
    for (int m = 0; m < N; ++m) s[m] = 0.f;
    for (int t0 = 0; t0 < steps; t0 += BWD_STEPS) {
      const int len = min(BWD_STEPS, steps - t0);
      const size_t off = base + (size_t)t0 * N;
      __syncthreads();
      stage<BWD_STEPS, N>(vs, v + off, len);
      __syncthreads();
      for (int j = 0; j < len; ++j) {
        const float ki = to_f32(k[off + (size_t)j * N + i]);
        const float wi = w[off + (size_t)j * N + i];
        float* out = st + (size_t)(t0 + j) * N * N;
        const float* vt = vs + j * N;
#pragma unroll
        for (int m = 0; m < N; ++m) {
          out[m * N] = s[m];
          s[m] = fmaf(wi, s[m], ki * vt[m]);
        }
      }
    }
  }

  // Pass 2: backwards in time, G_t in registers.
  float g[N];
#pragma unroll
  for (int m = 0; m < N; ++m) g[m] = 0.f;
  float gu_acc = 0.f;
  const int chunks = (steps + BWD_STEPS - 1) / BWD_STEPS;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * BWD_STEPS;
    const int len = min(BWD_STEPS, steps - t0);
    const size_t off = base + (size_t)t0 * N;
    __syncthreads();
    stage<BWD_STEPS, N>(rs, r + off, len);
    stage<BWD_STEPS, N>(ks, k + off, len);
    stage<BWD_STEPS, N>(vs, v + off, len);
    stage<BWD_STEPS, N>(gs, gy + off, len);
    __syncthreads();
    for (int j = len - 1; j >= 0; --j) {
      const float* rt = rs + j * N;
      const float* kt = ks + j * N;
      const float* vt = vs + j * N;
      const float* gt = gs + j * N;
      float vg = 0.f, urk = 0.f;  // v_t . gy_t and sum_n u[n] r_t[n] k_t[n]
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 v4 = ld4(vt + n), g4 = ld4(gt + n), r4 = ld4(rt + n), k4 = ld4(kt + n),
                     u4 = ld4(us + n);
        vg = fmaf(v4.x, g4.x, fmaf(v4.y, g4.y, fmaf(v4.z, g4.z, fmaf(v4.w, g4.w, vg))));
        urk = fmaf(u4.x * r4.x, k4.x,
                   fmaf(u4.y * r4.y, k4.y, fmaf(u4.z * r4.z, k4.z, fmaf(u4.w * r4.w, k4.w, urk))));
      }
      const float ri = rt[i], ki = kt[i];
      const size_t at = off + (size_t)j * N + i;
      const float wi = w[at];
      const float* prev = st + (size_t)(t0 + j) * N * N;
      float dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const float pm = prev[m * N];
        dr = fmaf(pm, gt[m], dr);
        dk = fmaf(g[m], vt[m], dk);
        dw = fmaf(g[m], pm, dw);
        red[i * (N + 1) + m] = ki * g[m];
      }
      dr = fmaf(ui * ki, vg, dr);
      dk = fmaf(ui * ri, vg, dk);
      gu_acc = fmaf(ri * ki, vg, gu_acc);
      __syncthreads();
      float dv = gt[i] * urk;
#pragma unroll
      for (int n = 0; n < N; ++n) dv += red[n * (N + 1) + i];
      __syncthreads();  // red is read before the next step writes it
#pragma unroll
      for (int m = 0; m < N; ++m) g[m] = fmaf(wi, g[m], ri * gt[m]);
      store_f32(gr + at, dr);
      store_f32(gk + at, dk);
      store_f32(gv + at, dv);
      gw[at] = dw;
    }
  }
  gu_part[(size_t)blockIdx.x * N + i] = gu_acc;
}

// gu[h, n] = sum over b, in order, of the per-(b, h) partials (B, H, N).
__global__ void wkv6_gu_reduce_kernel(const float* __restrict__ part, float* __restrict__ gu,
                                      int batch, int hn) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hn) return;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) acc += part[(size_t)b * hn + idx];
  gu[idx] = acc;
}

template <typename T, int N>
void launch_fwd(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
                int b, int h, int t, cudaStream_t s) {
  wkv6_fwd_kernel<T, N><<<b * h, N, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<T*>(y), h, t);
}

template <typename T, int N>
void launch_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                const void* gy, void* gr, void* gk, void* gv, void* gw, void* gu, void* gu_part,
                void* states, int b, int h, int t, cudaStream_t s) {
  wkv6_bwd_kernel<T, N><<<b * h, N, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const T*>(gy),
      static_cast<T*>(gr), static_cast<T*>(gk), static_cast<T*>(gv), static_cast<float*>(gw),
      static_cast<float*>(gu_part), static_cast<float*>(states), h, t);
  const int hn = h * N;
  wkv6_gu_reduce_kernel<<<(hn + 127) / 128, 128, 0, s>>>(static_cast<const float*>(gu_part),
                                                         static_cast<float*>(gu), b, hn);
}

}  // namespace

// Tensors contiguous; dtype of r, k, v, y (and gy, gr, gk, gv) 0 = f32,
// 1 = bf16; w, u, gw, gu, gu_part (B, H, N) and states (B, H, T, N, N) f32;
// head size n 16 or 64.  Returns the code of cudaGetLastError().
extern "C" int wkv6_fwd_launch(const void* r, const void* k, const void* v, const void* w,
                               const void* u, void* y, int b, int h, int t, int n, int dtype,
                               void* stream) {
  if (b <= 0 || h <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && n == 16) launch_fwd<float, 16>(r, k, v, w, u, y, b, h, t, s);
  else if (dtype == 0 && n == 64) launch_fwd<float, 64>(r, k, v, w, u, y, b, h, t, s);
  else if (dtype == 1 && n == 16) launch_fwd<__nv_bfloat16, 16>(r, k, v, w, u, y, b, h, t, s);
  else if (dtype == 1 && n == 64) launch_fwd<__nv_bfloat16, 64>(r, k, v, w, u, y, b, h, t, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* gy, void* gr, void* gk, void* gv,
                               void* gw, void* gu, void* gu_part, void* states, int b, int h,
                               int t, int n, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WKV6_BWD(T, N) \
  launch_bwd<T, N>(r, k, v, w, u, gy, gr, gk, gv, gw, gu, gu_part, states, b, h, t, s)
  if (dtype == 0 && n == 16) WKV6_BWD(float, 16);
  else if (dtype == 0 && n == 64) WKV6_BWD(float, 64);
  else if (dtype == 1 && n == 16) WKV6_BWD(__nv_bfloat16, 16);
  else if (dtype == 1 && n == 64) WKV6_BWD(__nv_bfloat16, 64);
  else return (int)cudaErrorInvalidValue;
#undef WKV6_BWD
  return (int)cudaGetLastError();
}

REPRO_EXPORT_ERROR_STRING(wkv6)
