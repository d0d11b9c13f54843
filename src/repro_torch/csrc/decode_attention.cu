// Flash decode on Hopper: one new token per slot against a dense KV cache.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:flash_decode
// (_decode_kernel).  Same function: q (B, Hq, D), k/v (B, Hkv, Sk, D),
// length (B,) int32 valid-prefix lengths, one per slot (a ragged continuous
// batch); f32 math, output in q's dtype.  Keys at or past length[b] are
// masked and their tiles never read; a zero length gives a zero output.
//
// Design.  One block per (b, KV head).  The group = Hq / Hkv query heads
// that share the KV head are handled together (the TPU kernel stacks them
// into sublanes): each KV tile of 32 keys is read from device memory once
// into shared memory and used by every head of the group, one warp per head
// (a warp takes heads w, w + 4, ... when the group is larger than 4).  The
// loop over the cache runs inside the block and stops at the slot's own
// length, so a short slot costs only its own prefix.
//
// Bound on the card.  Decode reads the valid KV prefix once and does 4 * D
// operations per key and head: it is bound by device memory bytes.  Reading
// each KV tile once per group, not once per query head, is what the design
// does about it.  At the serve path's lengths (tens of keys) the blocks are
// few and short, so launch latency dominates.
#include "common.cuh"

namespace {

constexpr int WARPS = 4, MAX_HEADS_PER_WARP = 4, MAX_GROUP = WARPS * MAX_HEADS_PER_WARP;

template <typename T, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ length, T* __restrict__ o, int hq, int hkv, int sk,
                    float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ float smem[];
  const int group = hq / hkv;
  float* Ks = smem;                     // KV_TILE x (D + 1)
  float* Vs = Ks + KV_TILE * (D + 1);   // KV_TILE x D
  float* Qs = Vs + KV_TILE * D;         // group x D

  const int b = blockIdx.y, hk = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qp = q + ((size_t)b * hq + (size_t)hk * group) * D;
  const T* kp = k + (size_t)(b * hkv + hk) * sk * D;
  const T* vp = v + (size_t)(b * hkv + hk) * sk * D;
  load_rows<D>(Qs, qp, group);
  const int len = min(length[b], sk);

  RowState<DPL> st[MAX_HEADS_PER_WARP];
#pragma unroll
  for (int r = 0; r < MAX_HEADS_PER_WARP; ++r) st[r].init();

  for (int t0 = 0; t0 < len; t0 += KV_TILE) {
    __syncthreads();  // the previous tile is consumed (and Qs is loaded)
    const int rows = min(KV_TILE, sk - t0);
    load_tile<KV_TILE, D, WARPS * 32>(Ks, D + 1, kp + (size_t)t0 * D, rows);
    load_tile<KV_TILE, D, WARPS * 32>(Vs, D, vp + (size_t)t0 * D, rows);
    __syncthreads();
    const bool valid = t0 + lane < len;
#pragma unroll
    for (int r = 0; r < MAX_HEADS_PER_WARP; ++r) {
      const int g = warp + WARPS * r;
      if (g < group) st[r].step(Qs + g * D, Ks, Vs, valid, scale, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < MAX_HEADS_PER_WARP; ++r) {
    const int g = warp + WARPS * r;
    if (g < group) st[r].store(o + ((size_t)b * hq + (size_t)hk * group + g) * D, lane);
  }
}

template <typename T, int DPL>
void launch(const void* q, const void* k, const void* v, const int* length, void* o, int b, int hq,
            int hkv, int sk, float scale, cudaStream_t s) {
  constexpr int D = DPL * 32;
  const size_t smem = sizeof(float) * (KV_TILE * (D + 1) + KV_TILE * D + (hq / hkv) * D);
  const dim3 grid(hkv, b);
  flash_decode_kernel<T, DPL><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      static_cast<T*>(o), hq, hkv, sk, scale);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* length, void* o, int b, int hq,
               int hkv, int sk, int d, float scale, cudaStream_t s) {
  switch (d) {
    case 64: launch<T, 2>(q, k, v, length, o, b, hq, hkv, sk, scale, s); break;
    case 128: launch<T, 4>(q, k, v, length, o, b, hq, hkv, sk, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Tensors contiguous; dtype 0 = f32, 1 = bf16; hq / hkv <= 16.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, const void* length,
                                   void* o, int b, int hq, int hkv, int sk, int d, int dtype,
                                   float scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > MAX_GROUP) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  if (dtype == 0) return dispatch_d<float>(q, k, v, len, o, b, hq, hkv, sk, d, scale, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(q, k, v, len, o, b, hq, hkv, sk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

REPRO_EXPORT_ERROR_STRING(flash_decode)
