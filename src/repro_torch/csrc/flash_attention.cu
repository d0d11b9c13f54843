// Flash attention (forward) on Hopper, for prefill.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel).  Same function: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D),
// query head h reads KV head h / (Hq / Hkv) (GQA, no KV replication), f32
// math, output in q's dtype.  Causal masking against an absolute q_offset,
// a kv_len mask for a cache longer than its valid prefix, KV tiles entirely
// in the future skipped, and a zero-denominator row giving 0.  q_offset and
// kv_len are runtime arguments here (trace-time constants in the TPU kernel).
//
// Design.  One block of 4 warps owns BQ = 16 query rows of one (b, h); each
// warp owns 4 rows and carries their online-softmax state (m, l, acc) in
// registers across the KV loop, which takes the place of the TPU kernel's
// sequential KV grid axis.  K and V tiles of 32 keys are staged in shared
// memory as f32 and shared by the 16 rows.  The loop stops at the last key
// any row of the block may see (causal) or at kv_len, so skipped tiles cost
// nothing; partial tiles are masked per key.
//
// Bound on the card.  On the prefill path Sq is a 16..64-token bucket and Sk
// the cache length, so the work is a few MFLOP per head: the kernel is bound
// by latency and by reading q, k and v once, far from the tensor-core rate.
// SIMT FMA keeps it simple; a wgmma version is later work.
#include "common.cuh"

namespace {

constexpr int WARPS = 4, ROWS_PER_WARP = 4, BQ = WARPS * ROWS_PER_WARP;

template <typename T, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int hq, int hkv, int sq, int sk, float scale, int causal,
                       int q_offset, int kv_len) {
  constexpr int D = DPL * 32;
  extern __shared__ float smem[];
  float* Qs = smem;                     // BQ x D
  float* Ks = Qs + BQ * D;              // KV_TILE x (D + 1)
  float* Vs = Ks + KV_TILE * (D + 1);   // KV_TILE x D

  const int bh = blockIdx.y;            // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const T* qp = q + ((size_t)bh * sq + q0) * D;
  const T* kp = k + (size_t)(b * hkv + hk) * sk * D;
  const T* vp = v + (size_t)(b * hkv + hk) * sk * D;
  load_tile<BQ, D, WARPS * 32>(Qs, D, qp, min(BQ, sq - q0));

  RowState<DPL> st[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) st[r].init();

  // Keys past kv_end are masked for every row of this block.
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + BQ, sq));
  for (int t0 = 0; t0 < kv_end; t0 += KV_TILE) {
    __syncthreads();  // the previous tile is consumed (and Qs is loaded)
    const int rows = min(KV_TILE, sk - t0);
    load_tile<KV_TILE, D, WARPS * 32>(Ks, D + 1, kp + (size_t)t0 * D, rows);
    load_tile<KV_TILE, D, WARPS * 32>(Vs, D, vp + (size_t)t0 * D, rows);
    __syncthreads();
    const int kpos = t0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = warp * ROWS_PER_WARP + r;
      const bool valid = kpos < kv_len && (!causal || q_offset + q0 + row >= kpos);
      st[r].step(Qs + row * D, Ks, Vs, valid, scale, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qi = q0 + warp * ROWS_PER_WARP + r;
    if (qi < sq) st[r].store(o + ((size_t)bh * sq + qi) * D, lane);
  }
}

template <typename T, int DPL>
void launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int sq,
            int sk, float scale, int causal, int q_offset, int kv_len, cudaStream_t s) {
  constexpr int D = DPL * 32;
  const size_t smem = sizeof(float) * (BQ * D + KV_TILE * (D + 1) + KV_TILE * D);
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_attention_kernel<T, DPL><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      hq, hkv, sq, sk, scale, causal, q_offset, kv_len);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int sq,
               int sk, int d, float scale, int causal, int q_offset, int kv_len, cudaStream_t s) {
  switch (d) {
    case 64: launch<T, 2>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, q_offset, kv_len, s); break;
    case 128: launch<T, 4>(q, k, v, o, b, hq, hkv, sq, sk, scale, causal, q_offset, kv_len, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Tensors contiguous; dtype 0 = f32, 1 = bf16; 0 <= kv_len <= sk.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int b,
                                      int hq, int hkv, int sq, int sk, int d, int dtype, int causal,
                                      int q_offset, int kv_len, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, o, b, hq, hkv, sq, sk, d, scale, causal, q_offset, kv_len, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d, scale, causal, q_offset, kv_len, s);
  return (int)cudaErrorInvalidValue;
}

REPRO_EXPORT_ERROR_STRING(flash_attention)
