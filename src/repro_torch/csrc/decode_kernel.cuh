// The decode kernel body shared by decode_attention.cu (flash_decode, a
// dense cache) and paged_decode_attention.cu (flash_paged_decode, a page
// pool): one query token per slot, the slot's keys split into chunks of
// decode_chunk(D, KV dtype) keys counted from key 0, one block per (chunk,
// KV head, slot) folding its chunk's 32-key tiles with RowState::step, and
// the chunks' partial states merged in chunk order by the block of the
// (slot, KV head) that finishes last.  Both kernels run this one body, so a
// float pool gives the bits of the dense kernel on the gathered cache by
// construction.  The design and the bound are in the two .cu files.
#pragma once

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

// Where a slot's keys live: the pools (or the dense cache), scale rows and
// table row of one (slot, KV head).  A dense (B, Hkv, Sk, D) cache is the
// pool of B pages of ps = Sk rows whose slot b owns page b: no table.
template <typename KV, bool PAGED>
struct KVRows {
  const KV* k;
  const KV* v;
  const float* ks;   // int8 pools only
  const float* vs;
  const int* table;  // paged: this slot's block-table row
  int slot, hkv, hk, ps;
  // Row index of key t (t < length: a paged slot's table entry is
  // allocated).
  __device__ __forceinline__ size_t row(int t) const {
    if constexpr (PAGED) return ((size_t)table[t / ps] * hkv + hk) * ps + t % ps;
    return ((size_t)slot * hkv + hk) * ps + t;
  }
};

template <typename KV>
constexpr bool kQuantized = std::is_same<KV, int8_t>::value;

// buffers=1: gather tile [t0, t0 + 32) straight into the f32 tile.
template <int D, typename KV, bool PAGED>
__device__ __forceinline__ void load_tile_sync(float* Ks, float* Vs, const KVRows<KV, PAGED>& kv,
                                               int t0, int len) {
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
template <int D, typename KV, bool PAGED>
__device__ __forceinline__ void prefetch_tile(Stage<D, KV>* st, const KVRows<KV, PAGED>& kv, int t0,
                                              int len) {
  constexpr int PER_ROW = D * (int)sizeof(KV) / 16;  // 16-byte chunks per row
  constexpr int ELTS = 16 / (int)sizeof(KV);
  constexpr int N = KV_TILE * PER_ROW;
  static_assert(N % THREADS == 0 || N < THREADS, "chunk split");
#pragma unroll
  for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = (i % PER_ROW) * ELTS, t = t0 + r;
    if (i < N && t < len) {
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

struct Args {
  const void *q, *k, *v, *ks, *vs;
  const int *table, *length;
  void* o;
  float *part_ml, *part_acc;  // (B, Hq, chunks, 2) and (B, Hq, chunks, D); null if chunks == 1
  int* tickets;               // (B, Hkv) zeros; null if chunks == 1
  int b, hq, hkv, ps, max_pages, chunk, chunks;
  float scale;
  cudaStream_t s;
};

// The kernel's operands.  Dense: table == nullptr, ps = Sk, max_pages = 1.
template <typename T, typename KV>
struct DecodeArgs {
  const T* __restrict__ q;
  const KV* __restrict__ k;
  const KV* __restrict__ v;
  const float* __restrict__ ks;       // int8 pools only
  const float* __restrict__ vs;
  const int* __restrict__ table;      // (B, max_pages); paged only
  const int* __restrict__ length;     // (B,)
  T* __restrict__ o;                  // (B, Hq, D)
  float* part_ml;                     // (B, Hq, chunks, 2); null if chunks == 1
  float* part_acc;                    // (B, Hq, chunks, D); null if chunks == 1
  int* tickets;                       // (B, Hkv) zeros; null if chunks == 1
  int hq, hkv, ps, max_pages, chunk, chunks;
  float scale;
};

// One block: chunk blockIdx.x of slot blockIdx.z against KV head
// blockIdx.y, the GQA group's query heads one warp each (a warp takes
// heads w, w + 4, ...).
template <typename T, typename KV, int D, int BUFFERS, bool PAGED>
__device__ __forceinline__ void decode_block(const DecodeArgs<T, KV>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hq = a.hq, hkv = a.hkv, group = hq / hkv;
  Stage<D, KV>* ring = reinterpret_cast<Stage<D, KV>*>(smem);   // buffers=2 only
  float* Ks = reinterpret_cast<float*>(smem + (BUFFERS == 2 ? 2 * sizeof(Stage<D, KV>) : 0));
  float* Vs = Ks + KV_TILE * (D + 1);   // KV_TILE x D
  float* Qs = Vs + KV_TILE * D;         // group x D

  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * hq + (size_t)hk * group;  // first query row of the group
  const int len = max(0, min(a.length[b], a.max_pages * a.ps));
  const int n_active = max(1, (len + a.chunk - 1) / a.chunk);
  if (c >= n_active) return;  // before loading anything else
  load_rows<D>(Qs, a.q + row0 * D, group);
  const int t_begin = c * a.chunk, t_end = min(len, t_begin + a.chunk);
  const KVRows<KV, PAGED> kv{a.k, a.v, a.ks, a.vs, PAGED ? a.table + (size_t)b * a.max_pages : nullptr,
                             b, hkv, hk, a.ps};

  RowState<D> st[MAX_HEADS_PER_WARP];
#pragma unroll
  for (int r = 0; r < MAX_HEADS_PER_WARP; ++r) st[r].init();

  // Tiles [t0, t0 + 32) of the chunk; rows at or past t_end are zeros.
  if constexpr (BUFFERS == 2) {
    if (t_begin < t_end) prefetch_tile<D>(&ring[0], kv, t_begin, t_end);
  }
  for (int t0 = t_begin, i = 0; t0 < t_end; t0 += KV_TILE, ++i) {
    if constexpr (BUFFERS == 2) {
      // Stage (i + 1) % 2 was last read by convert_stage of tile i - 1,
      // which every thread finished before the barrier that followed it.
      if (t0 + KV_TILE < t_end) prefetch_tile<D>(&ring[(i + 1) % 2], kv, t0 + KV_TILE, t_end);
      else cp_async_commit();          // an empty group keeps the count
      cp_async_wait<1>();              // this thread's copies of tile i
      __syncthreads();                 // everyone's copies; tile i - 1 consumed
      convert_stage<D>(Ks, Vs, &ring[i % 2], t0, t_end);
    } else {
      __syncthreads();                 // tile i - 1 consumed (and Qs loaded)
      load_tile_sync<D>(Ks, Vs, kv, t0, t_end);
    }
    __syncthreads();
    const bool valid = t0 + lane < t_end;
#pragma unroll
    for (int r = 0; r < MAX_HEADS_PER_WARP; ++r) {
      const int g = warp + WARPS * r;
      if (g < group) st[r].step(Qs + g * D, Ks, Vs, valid, a.scale, lane);
    }
  }

  if (n_active == 1) {
#pragma unroll
    for (int r = 0; r < MAX_HEADS_PER_WARP; ++r) {
      const int g = warp + WARPS * r;
      if (g < group) st[r].store(a.o + (row0 + g) * D, lane);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < MAX_HEADS_PER_WARP; ++r) {
    const int g = warp + WARPS * r;
    const size_t p = (row0 + g) * a.chunks + c;
    if (g < group) st[r].store_partial(a.part_ml + 2 * p, a.part_acc + p * D, lane);
  }
  if (!last_chunk_block(a.tickets + b * hkv + hk, n_active)) return;
  for (int g = warp; g < group; g += WARPS) {
    const size_t p = (row0 + g) * a.chunks;
    merge_partials<D>(a.part_ml + 2 * p, a.part_acc + p * D, n_active, a.o + (row0 + g) * D, lane);
  }
}

// Launch `kernel` (a __global__ wrapper of decode_block) over (chunks, Hkv,
// B); returns cudaGetLastError().
template <typename T, typename KV, int D, int BUFFERS, typename Kernel>
int launch_decode(Kernel kernel, const DecodeArgs<T, KV>& a, int b, cudaStream_t s) {
  const size_t smem = (BUFFERS == 2 ? 2 * sizeof(Stage<D, KV>) : 0)
                      + sizeof(float) * (KV_TILE * (D + 1) + KV_TILE * D + (a.hq / a.hkv) * D);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(a.chunks, a.hkv, b), THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The checks both entry points make: chunk == decode_chunk(d, KV dtype),
// the grid's extent, and scratch present when a slot can span chunks.
// Returns the chunk count, or -1.
inline int decode_chunks(int b, int hq, int hkv, long long keys, int d, int kv_dtype, int chunk,
                         const void* part_ml, const void* part_acc, const void* tickets) {
  if (b < 1 || b > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv != 0 || hq / hkv > MAX_GROUP ||
      keys < 1 || keys > (1LL << 30) || chunk != decode_chunk(d, kv_dtype))
    return -1;
  const int chunks = (int)((keys + chunk - 1) / chunk);
  if (chunks > 1 && (part_ml == nullptr || part_acc == nullptr || tickets == nullptr)) return -1;
  return chunks;
}

}  // namespace
