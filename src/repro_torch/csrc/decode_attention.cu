// Flash decode on Hopper: one new token per slot against a dense KV cache.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:127
// (flash_decode's pallas_call, _decode_kernel).  Same function: q (B, Hq,
// D), k/v (B, Hkv, Sk, D), length (B,) int32 valid-prefix lengths, one per
// slot (a ragged continuous batch); f32 math, output in q's dtype.  Keys at
// or past length[b] (clamped to Sk) are masked and their tiles never read;
// a zero length gives a zero output.
//
// Bound on the card.  Decode reads the valid KV prefix once and does 4 * D
// operations per key and head: device-memory bytes bound it.  One block per
// (slot, KV head) reads each KV tile once for the whole GQA group, but at
// a few slots and a few KV heads that is tens of blocks on 132 SMs, each
// walking its slot's keys one 32-key tile at a time: a tile costs a
// barrier, an f32 conversion and a dependent softmax step, so a long slot
// takes its tile count times that latency while the memory system idles.
//
// Design (flash-decoding).  A slot's keys split into chunks of
// decode_chunk(D, dtype) keys counted from key 0 (common.cuh); the grid is
// (chunk, KV head, slot), ceil(Sk / chunk) chunks, and a block whose chunk
// starts at or past its slot's length exits at once.  A block runs the
// group = Hq / Hkv query heads that share its KV head, one warp per head (a
// warp takes heads w, w + 4, ... when the group is larger than 4), keeps a
// two-stage cp.async ring of raw 32-key tiles (tile i + 1 in flight while
// tile i is converted to f32 and folded in), and folds its chunk's tiles in
// order with RowState::step.  A slot of one chunk stores its rows directly,
// as one block walking every tile did before the split.  Otherwise each
// block writes its unnormalised partial state (m, l, acc) to an f32
// scratch, takes a ticket from the (slot, KV head) counter, and the last
// block to finish merges the partials in chunk order (merge_partials) and
// resets the counter: one launch a call.  The chunks depend only on key
// positions, never on B, Sk or the lengths, so a slot's bits do not depend
// on its batch or its cache's size.  The body is decode_kernel.cuh's
// decode_block, which flash_paged_decode runs too, reading the dense cache
// as a pool of B pages of Sk rows (slot b owns page b), so a float pool
// gives the bits of this kernel on the gathered cache.
#include "decode_kernel.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(DecodeArgs<T, T> a) {
  decode_block<T, T, D, 2, false>(a);
}

// Head dims: f32 16, 64, 128; bf16 64, 128 (kernels/decode_attention.py:
// HEAD_DIMS by dtype).
template <typename T>
int dispatch_d(const DecodeArgs<T, T>& a, int d, int b, cudaStream_t s) {
  switch (d) {
    case 16:
      if constexpr (std::is_same<T, float>::value)
        return launch_decode<T, T, 16, 2>(flash_decode_kernel<T, 16>, a, b, s);
      return (int)cudaErrorInvalidValue;
    case 64: return launch_decode<T, T, 64, 2>(flash_decode_kernel<T, 64>, a, b, s);
    case 128: return launch_decode<T, T, 128, 2>(flash_decode_kernel<T, 128>, a, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* length, void* o,
             void* part_ml, void* part_acc, void* tickets, int b, int hq, int hkv, int sk, int d,
             int chunk, int chunks, float scale, cudaStream_t s) {
  const DecodeArgs<T, T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), nullptr, nullptr, nullptr, length,
                           static_cast<T*>(o), static_cast<float*>(part_ml),
                           static_cast<float*>(part_acc), static_cast<int*>(tickets), hq, hkv,
                           sk, 1, chunk, chunks, scale};
  return dispatch_d<T>(a, d, b, s);
}

}  // namespace

// Tensors contiguous and 16-byte aligned; dtype 0 = f32, 1 = bf16;
// hq / hkv <= 16; chunk == decode_chunk(d, dtype).  With ceil(sk / chunk)
// > 1 chunks, part_ml (B, Hq, chunks, 2) and part_acc (B, Hq, chunks, D) are
// f32 scratch and tickets (B, Hkv) int32 zeros, which the launch leaves
// zeroed.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, const void* length,
                                   void* o, void* part_ml, void* part_acc, void* tickets, int b,
                                   int hq, int hkv, int sk, int d, int dtype, int chunk, float scale,
                                   void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int chunks =
      decode_chunks(b, hq, hkv, sk, d, dtype, chunk, part_ml, part_acc, tickets);
  if (chunks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  if (dtype == 0)
    return dispatch<float>(q, k, v, len, o, part_ml, part_acc, tickets, b, hq, hkv, sk, d, chunk,
                           chunks, scale, s);
  return dispatch<__nv_bfloat16>(q, k, v, len, o, part_ml, part_acc, tickets, b, hq, hkv, sk, d,
                                 chunk, chunks, scale, s);
}

REPRO_EXPORT_ERROR_STRING(flash_decode)
