// Paged flash decode on Hopper: one new token per slot against a KV page
// pool, gathered through a per-slot block table.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:
// flash_paged_decode (_paged_decode_kernel for buffers=1,
// _paged_decode_dbuf_kernel for buffers=2, both through _paged_page_step
// and _dequant_page).  Same function: q (B, Hq, D); k/v pools
// (P, Hkv, ps, D) in q's dtype or int8; for int8 pools, f32 scale rows
// (P, Hkv, ps); block_tables (B, max_pages) int32; length (B,) int32.  Key
// t of slot b is row t % ps of pool page block_tables[b, t / ps].  f32
// math, output (B, Hq, D) in q's dtype.
//
// Design.  As in decode_attention.cu: one block per (slot, KV head), one
// warp per query head of the GQA group (a warp takes heads w, w + 4, ...),
// keys walked in KV_TILE = 32 tiles and every tile folded in by the same
// RowState::step as flash_decode.  A tile's 32 rows are gathered row by
// row through the table, so any page size works, pages straddling a tile
// included.  Rows at or past length[b] are zeros and never read: the loop
// stops at the slot's length and never reads a table entry at or past
// pages_for(length), so the pool's null sink page (which unallocated
// entries point at, and which may hold anything) is unreachable.  A zero
// length gives zeros.  For a pool in q's dtype the tile in shared memory
// equals the one flash_decode builds from the gathered cache (up to rows
// with zero weight), so the two kernels give bit-identical outputs.
//
// int8 pools are dequantized as they enter shared memory: q * scale in
// f32, the product serving/quant.py:dequantize_kv computes, so the pages
// stream from device memory at one byte per value.
//
// buffers=1 loads each tile synchronously.  buffers=2 keeps a two-stage
// cp.async ring of raw tiles in shared memory: tile i + 1 is in flight
// while tile i is dequantized and computed (the TPU kernel's DMA
// ping-pong).  Both turn the raw rows into the same f32 tile and call the
// same step, so their outputs are bit-identical.
//
// Bound on the card: every valid KV row (and its scale) is read once per
// GQA group, 4 * D operations per key and head: device memory bytes bound
// it.  The ring hides each tile's load latency behind the previous tile's
// compute; splitting a long slot's keys over several blocks (to fill the
// 132 SMs when B * Hkv is small) is left for a later change.
#include <cstddef>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 4, THREADS = WARPS * 32, MAX_HEADS_PER_WARP = 4;
constexpr int MAX_GROUP = WARPS * MAX_HEADS_PER_WARP;

__device__ __forceinline__ float dequant(float x, float) { return x; }
__device__ __forceinline__ float dequant(__nv_bfloat16 x, float) { return __bfloat162float(x); }
__device__ __forceinline__ float dequant(int8_t x, float s) { return static_cast<float>(x) * s; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Where a slot's keys live: the pools, scale rows and table row of one
// (slot, KV head).
template <typename KV>
struct PagedKV {
  const KV* k;
  const KV* v;
  const float* ks;  // int8 pools only
  const float* vs;
  const int* table;  // this slot's block-table row
  int hkv, hk, ps;
  // Pool row index of key t (t < length: its table entry is allocated).
  __device__ __forceinline__ size_t row(int t) const {
    return ((size_t)table[t / ps] * hkv + hk) * ps + t % ps;
  }
};

template <typename KV>
constexpr bool kQuantized = std::is_same<KV, int8_t>::value;

// buffers=1: gather tile [t0, t0 + 32) straight into the f32 tile.
template <int D, typename KV>
__device__ __forceinline__ void load_tile_sync(float* Ks, float* Vs, const PagedKV<KV>& kv, int t0,
                                               int len) {
  constexpr bool Q = kQuantized<KV>;
#pragma unroll
  for (int it = 0; it < KV_TILE * D / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / D, c = i % D, t = t0 + r;
    float kx = 0.f, vx = 0.f;
    if (t < len) {
      const size_t row = kv.row(t);
      kx = dequant(kv.k[row * D + c], Q ? kv.ks[row] : 1.f);
      vx = dequant(kv.v[row * D + c], Q ? kv.vs[row] : 1.f);
    }
    Ks[r * (D + 1) + c] = kx;
    Vs[r * D + c] = vx;
  }
}

// buffers=2: the raw rows of one ring stage, in the pool's own type.
template <int D, typename KV>
struct Stage {
  KV k[KV_TILE * D];
  KV v[KV_TILE * D];
  float ks[KV_TILE];
  float vs[KV_TILE];
};

// Start the cp.async copies of tile [t0, t0 + 32) into a stage (rows at or
// past len are not copied) and commit them as one group.
template <int D, typename KV>
__device__ __forceinline__ void prefetch_tile(Stage<D, KV>* st, const PagedKV<KV>& kv, int t0, int len) {
  constexpr int PER_ROW = D * (int)sizeof(KV) / 16;  // 16-byte chunks per row
  constexpr int ELTS = 16 / (int)sizeof(KV);
  static_assert((KV_TILE * PER_ROW) % THREADS == 0, "chunk split");
#pragma unroll
  for (int it = 0; it < KV_TILE * PER_ROW / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = (i % PER_ROW) * ELTS, t = t0 + r;
    if (t < len) {
      const size_t row = kv.row(t);
      cp_async16(st->k + r * D + c, kv.k + row * D + c);
      cp_async16(st->v + r * D + c, kv.v + row * D + c);
    }
  }
  if constexpr (kQuantized<KV>) {
    const int r = threadIdx.x % KV_TILE, t = t0 + r;
    if (threadIdx.x < 2 * KV_TILE && t < len) {
      const size_t row = kv.row(t);
      if (threadIdx.x < KV_TILE) cp_async4(st->ks + r, kv.ks + row);
      else cp_async4(st->vs + r, kv.vs + row);
    }
  }
  cp_async_commit();
}

// Turn an arrived stage into the f32 tile: the same values load_tile_sync
// writes.
template <int D, typename KV>
__device__ __forceinline__ void convert_stage(float* Ks, float* Vs, const Stage<D, KV>* st, int t0,
                                              int len) {
  constexpr bool Q = kQuantized<KV>;
#pragma unroll
  for (int it = 0; it < KV_TILE * D / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / D, c = i % D;
    const bool ok = t0 + r < len;
    Ks[r * (D + 1) + c] = ok ? dequant(st->k[r * D + c], Q ? st->ks[r] : 1.f) : 0.f;
    Vs[r * D + c] = ok ? dequant(st->v[r * D + c], Q ? st->vs[r] : 1.f) : 0.f;
  }
}

template <typename T, typename KV, int DPL, int BUFFERS>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                    const int* __restrict__ length, T* __restrict__ o, int hq, int hkv, int ps,
                    int max_pages, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = hq / hkv;
  Stage<D, KV>* ring = reinterpret_cast<Stage<D, KV>*>(smem);   // buffers=2 only
  float* Ks = reinterpret_cast<float*>(smem + (BUFFERS == 2 ? 2 * sizeof(Stage<D, KV>) : 0));
  float* Vs = Ks + KV_TILE * (D + 1);   // KV_TILE x D
  float* Qs = Vs + KV_TILE * D;         // group x D

  const int b = blockIdx.y, hk = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const PagedKV<KV> kv{k_pages, v_pages, k_scale, v_scale,
                       block_tables + (size_t)b * max_pages, hkv, hk, ps};
  load_rows<D>(Qs, q + ((size_t)b * hq + (size_t)hk * group) * D, group);
  const int len = max(0, min(length[b], max_pages * ps));

  RowState<DPL> st[MAX_HEADS_PER_WARP];
#pragma unroll
  for (int r = 0; r < MAX_HEADS_PER_WARP; ++r) st[r].init();

  if constexpr (BUFFERS == 2) {
    if (len > 0) prefetch_tile<D>(&ring[0], kv, 0, len);
  }
  for (int t0 = 0, i = 0; t0 < len; t0 += KV_TILE, ++i) {
    if constexpr (BUFFERS == 2) {
      // Stage (i + 1) % 2 was last read by convert_stage of tile i - 1,
      // which every thread finished before the barrier that followed it.
      if (t0 + KV_TILE < len) prefetch_tile<D>(&ring[(i + 1) % 2], kv, t0 + KV_TILE, len);
      else cp_async_commit();          // an empty group keeps the count
      cp_async_wait<1>();              // this thread's copies of tile i
      __syncthreads();                 // everyone's copies; tile i - 1 consumed
      convert_stage<D>(Ks, Vs, &ring[i % 2], t0, len);
    } else {
      __syncthreads();                 // tile i - 1 consumed (and Qs loaded)
      load_tile_sync<D>(Ks, Vs, kv, t0, len);
    }
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

struct Args {
  const void *q, *k, *v, *ks, *vs;
  const int *table, *length;
  void* o;
  int b, hq, hkv, ps, max_pages;
  float scale;
  cudaStream_t s;
};

template <typename T, typename KV, int DPL, int BUFFERS>
int launch(const Args& a) {
  constexpr int D = DPL * 32;
  const size_t smem = (BUFFERS == 2 ? 2 * sizeof(Stage<D, KV>) : 0)
                      + sizeof(float) * (KV_TILE * (D + 1) + KV_TILE * D + (a.hq / a.hkv) * D);
  auto kernel = paged_decode_kernel<T, KV, DPL, BUFFERS>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.hkv, a.b);
  kernel<<<grid, THREADS, smem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs), a.table, a.length,
      static_cast<T*>(a.o), a.hq, a.hkv, a.ps, a.max_pages, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int BUFFERS>
int dispatch_d(const Args& a, int d) {
  switch (d) {
    case 64: return launch<T, KV, 2, BUFFERS>(a);
    case 128: return launch<T, KV, 4, BUFFERS>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
int dispatch_buffers(const Args& a, int d, int buffers) {
  if (buffers == 1) return dispatch_d<T, KV, 1>(a, d);
  if (buffers == 2) return dispatch_d<T, KV, 2>(a, d);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Tensors contiguous and 16-byte aligned; dtype (q and out) 0 = f32,
// 1 = bf16; kv_dtype 0 = f32, 1 = bf16, 2 = int8 (a float pool has q's
// dtype; an int8 pool needs k_scale and v_scale); hq / hkv <= 16.
extern "C" int flash_paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                         const void* k_scale, const void* v_scale,
                                         const void* block_tables, const void* length, void* o,
                                         int b, int hq, int hkv, int page_size, int d,
                                         int max_pages, int dtype, int kv_dtype, int buffers,
                                         float scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > MAX_GROUP || page_size <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale,
               static_cast<const int*>(block_tables), static_cast<const int*>(length), o,
               b, hq, hkv, page_size, max_pages, scale, static_cast<cudaStream_t>(stream)};
  if (kv_dtype == 2) {
    if (k_scale == nullptr || v_scale == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return dispatch_buffers<float, int8_t>(a, d, buffers);
    if (dtype == 1) return dispatch_buffers<__nv_bfloat16, int8_t>(a, d, buffers);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != dtype) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_buffers<float, float>(a, d, buffers);
  if (dtype == 1) return dispatch_buffers<__nv_bfloat16, __nv_bfloat16>(a, d, buffers);
  return (int)cudaErrorInvalidValue;
}

REPRO_EXPORT_ERROR_STRING(flash_paged_decode)
