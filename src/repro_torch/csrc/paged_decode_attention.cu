// Paged flash decode on Hopper: one new token per slot against a KV page
// pool, gathered through a per-slot block table.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:415
// (flash_paged_decode's pallas_call: _paged_decode_kernel :189 for
// buffers=1, _paged_decode_dbuf_kernel :235 for buffers=2, both through
// _paged_page_step and _dequant_page).  Same function: q (B, Hq, D); k/v
// pools (P, Hkv, ps, D) in q's dtype or int8; for int8 pools, f32 scale
// rows (P, Hkv, ps); block_tables (B, max_pages) int32; length (B,) int32.
// Key t of slot b is row t % ps of pool page block_tables[b, t / ps].  f32
// math, output (B, Hq, D) in q's dtype.
//
// Bound on the card: every valid KV row (and its scale) is read once per
// GQA group, 4 * D operations per key and head: device-memory bytes bound
// it.  One block per (slot, KV head) gave 40 blocks on 132 SMs in the
// 8 x 448-token replay, each walking ~15 tiles in series at ~2 us a tile
// (a barrier, the f32 conversion, a dependent softmax step): ~33 us a call
// against a ~1.4 us byte bound, with the memory system nearly idle.
//
// Design (flash-decoding), shared with decode_attention.cu: a slot's keys split
// into chunks of decode_chunk(D, KV dtype) keys counted from key 0; the grid
// is (chunk, KV head, slot) with ceil(max_pages * ps / chunk) chunks, taken
// from the table's shape and never from the lengths (no host sync); a block
// whose chunk starts at or past its slot's length exits at once.  A block
// runs the GQA group's query heads, one warp a head (a warp takes heads w,
// w + 4, ...), and folds its chunk's 32-key tiles in order with the same
// RowState::step.  A slot of one chunk stores directly; otherwise every
// block writes its partial state to f32 scratch and the last block of the
// (slot, KV head) to take a ticket merges them in chunk order and resets
// the counter (one launch a call).  flash_decode runs the same body, so a
// pool in q's dtype gives the bits of flash_decode on the gathered cache,
// and a slot's bits do not depend on B or max_pages.
//
// A tile's 32 rows are gathered row by row through the table, so any page
// size works, pages straddling a tile included.  Rows at or past the
// chunk's end are zeros and never read, and a block reads only the table
// entries of its own chunk's keys below length[b]: the pool's null sink
// page (which unallocated entries point at, and which may hold anything)
// is unreachable.  A zero length gives zeros.  For a pool in q's dtype the
// tile in shared memory equals the one flash_decode builds from the
// gathered cache (up to rows with zero weight).
//
// int8 pools are dequantized as they enter shared memory: q * scale in
// f32, the product serving/quant.py:dequantize_kv computes, so the pages
// stream from device memory at one byte per value.
//
// buffers=1 loads each tile synchronously.  buffers=2 keeps a two-stage
// cp.async ring of raw tiles in shared memory: tile i + 1 is in flight
// while tile i is dequantized and computed (the TPU kernel's DMA
// ping-pong).  Both turn the raw rows into the same f32 tile and call the
// same step, so their outputs are bit-identical.  The body is
// decode_kernel.cuh's decode_block, which flash_decode runs too.
#include "decode_kernel.cuh"

namespace {

template <typename T, typename KV, int D, int BUFFERS>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(DecodeArgs<T, KV> a) {
  decode_block<T, KV, D, BUFFERS, true>(a);
}

// Head dims: f32 q 16, 64, 128; bf16 q 64, 128 (kernels/decode_attention.py:
// HEAD_DIMS by dtype).
template <typename T, typename KV, int BUFFERS>
int dispatch_d(const DecodeArgs<T, KV>& a, int d, int b, cudaStream_t s) {
  switch (d) {
    case 16:
      if constexpr (std::is_same<T, float>::value)
        return launch_decode<T, KV, 16, BUFFERS>(paged_decode_kernel<T, KV, 16, BUFFERS>, a, b, s);
      return (int)cudaErrorInvalidValue;
    case 64: return launch_decode<T, KV, 64, BUFFERS>(paged_decode_kernel<T, KV, 64, BUFFERS>, a, b, s);
    case 128: return launch_decode<T, KV, 128, BUFFERS>(paged_decode_kernel<T, KV, 128, BUFFERS>, a, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const int* table, const int* length, void* o, void* part_ml, void* part_acc,
             void* tickets, int b, int hq, int hkv, int ps, int d, int max_pages, int buffers,
             int chunk, int chunks, float scale, cudaStream_t s) {
  const DecodeArgs<T, KV> a{static_cast<const T*>(q), static_cast<const KV*>(k),
                            static_cast<const KV*>(v), static_cast<const float*>(ks),
                            static_cast<const float*>(vs), table, length, static_cast<T*>(o),
                            static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                            static_cast<int*>(tickets), hq, hkv, ps, max_pages, chunk, chunks,
                            scale};
  if (buffers == 1) return dispatch_d<T, KV, 1>(a, d, b, s);
  if (buffers == 2) return dispatch_d<T, KV, 2>(a, d, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Tensors contiguous and 16-byte aligned; dtype (q and out) 0 = f32,
// 1 = bf16; kv_dtype 0 = f32, 1 = bf16, 2 = int8 (a float pool has q's
// dtype; an int8 pool needs k_scale and v_scale); hq / hkv <= 16; chunk ==
// decode_chunk(d, kv_dtype).  With ceil(max_pages * page_size / chunk) > 1
// chunks, part_ml (B, Hq, chunks, 2) and part_acc (B, Hq, chunks, D) are f32
// scratch and tickets (B, Hkv) int32 zeros, which the launch leaves zeroed.
extern "C" int flash_paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                         const void* k_scale, const void* v_scale,
                                         const void* block_tables, const void* length, void* o,
                                         void* part_ml, void* part_acc, void* tickets, int b,
                                         int hq, int hkv, int page_size, int d, int max_pages,
                                         int dtype, int kv_dtype, int buffers, int chunk,
                                         float scale, void* stream) {
  if (page_size <= 0 || max_pages <= 0) return (int)cudaErrorInvalidValue;
  const int chunks = decode_chunks(b, hq, hkv, (long long)max_pages * page_size, d, kv_dtype,
                                   chunk, part_ml, part_acc, tickets);
  if (chunks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(block_tables);
  const int* len = static_cast<const int*>(length);
#define REPRO_PAGED_ARGS q, k_pages, v_pages, k_scale, v_scale, table, len, o, part_ml, part_acc, \
    tickets, b, hq, hkv, page_size, d, max_pages, buffers, chunk, chunks, scale, s
  if (kv_dtype == 2) {
    if (k_scale == nullptr || v_scale == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return dispatch<float, int8_t>(REPRO_PAGED_ARGS);
    if (dtype == 1) return dispatch<__nv_bfloat16, int8_t>(REPRO_PAGED_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != dtype) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float, float>(REPRO_PAGED_ARGS);
  if (dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(REPRO_PAGED_ARGS);
#undef REPRO_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

REPRO_EXPORT_ERROR_STRING(flash_paged_decode)
