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
// expf is the precise one (no --use_fast_math).
//
// Design (redesigned for Hopper after the first form, one thread a (b, d)
// row walking T with its N states in registers, ran a 448-token prompt at
// 70x its bound: di / 64 blocks of 2 warps, a global load of dt and x in
// every step, the state moved at a 64-byte stride across a warp).  Now a
// thread walks SPT = 4 states of one row, `lanes` (N / 4, a power of two)
// consecutive threads a row, CHANNELS = 16 consecutive channels of one
// sequence a block: 4x the threads of the first form at Jamba's N = 16,
// each with four independent chains.  Time runs in tiles of STEPS = 8
// steps.  dt and x (STEPS x CHANNELS) and B and C (STEPS x N) of tile
// i + 2 are copied by 16-byte cp.async into a ring of RING tiles while
// tile i is walked, so the serial loop reads only shared memory; the walk
// widens them to f32 as it reads them.  In a whole tile a thread forms the
// exponentials and dtx * B of four steps at once (they do not depend on
// the state), then advances its four states through those steps in
// order, storing each step's states to hs[step][channel][state].  A
// thread per (channel, step) then runs the contraction over n = 0 .. N-1
// from 0 in order (fmaf), as the first form did; tile i's contraction
// runs beside tile i + 1's walk (hs is double-buffered), one barrier a
// tile.  So every operation and its order are the first form's: y and hT
// are its bits, a row's bits depend on nothing else in the batch (what
// the serving engine's --verify needs), and a prompt split in two with the
// state carried equals the whole.  h0, hT and A move 16 bytes a thread,
// consecutive threads on consecutive states.  Where a row of dt/x (di) or
// of B/C (N) is not a whole number of 16-byte chunks the inputs are staged
// by plain loads instead (ragged widths).  The geometry is
// kernels/selective_scan.py:scan_plan(di, N, dtype), mirrored here; the
// entry refuses any other plan.  A thread walks its states in order over t
// tile by tile, so a backward can walk the tiles in reverse from states
// checkpointed at tile boundaries.
//
// Bound on the card: bytes at decode (the f32 state read and written once,
// 2 x B x di x N x 4 bytes, against 7 f32 operations a state a step).  A
// long prompt on one sequence has only di x N / 4 chains: it is bound by
// instruction throughput, ~12 instructions a state a step (expf's ~8, one
// of them on the MUFU, and the recurrence's four), above the 7-operation
// bound.  For training the forward also saves the state at every tile's
// start and the final state (`saved`, (B, ceil(T / 8) + 1, di, N) f32: 38
// MB a Jamba layer at 8 x 64 tokens), one 16-byte store a thread a tile;
// y and hT keep their bits.
//
// selective_scan_bwd replaces the VJP that JAX derives through the
// reference's chunked scan and its contraction (src/repro/models/
// mamba.py:83-114, :158): given gy (and the final state's gradient ght),
// gdt, gx, gbm, gc in the compute dtype, ga and gh0 in f32 (the formulas
// at selective_scan_bwd_kernel).  Bound: the larger of bytes (the VJP's
// dt, x, gy, B, C, A, h0 and ght read once; gdt, gx, gbm, gc, ga, gh0
// written once; 55.6 MB at Jamba's 8 x 64 in bf16) and 20 f32 operations
// a state a step (the tile's recomputation 5, the reverse walk 15; 1.34
// GFLOP there), so operations bound it.  The saved states and partials
// are this design's traffic, not the function's.  The walk is
// serial in time, so the design keeps every step's work in registers and
// shared memory: the forward's layout (a thread 4 states, the inputs of the next
// tile in flight by cp.async while one is walked), a tile's 8 decays
// recomputed in registers from its saved start (never a state a step in
// memory), and the two sums over di (gbm, gc) and the one over sequences
// (ga) taken in a fixed order: no atomics, so two calls and a restarted run
// give the same bits, and a sequence's gdt, gx, gbm, gc rows do not depend
// on the batch.
//
// The backward's form (redesigned after its first form ran Jamba's 8 x 64
// bf16 step at 8.8x its operations bound on an H100: 151-165 registers a
// thread, so about 12 warps an SM; each of a channel's 4 threads widening
// the same dt, x and gy and forming dtx twice a step; 33.5 MB of
// per-block channel partials written and read back, and three launches):
// a tile's inputs are widened to f32 once per (channel, step) and (step,
// state) into shared memory, read 4 steps to a 16-byte load; of a tile's
// states only its start and the second half's are held, the first half's
// formed again from the start (no exponential) when the walk reaches them,
// for at most 128 registers a thread; and the channel sums are added over
// a thread-block cluster of 8 channel blocks through distributed shared
// memory, in rank order, one partial a cluster (4.2 MB at 8 x 64), which
// one small kernel adds beside ga's sum over sequences: two launches.
#include "common.cuh"
#include "tc.cuh"
#include "wgmma.cuh"

namespace {

constexpr int CHANNELS = 16;   // channels of one sequence a block
constexpr int STEPS = 8;       // steps a tile
constexpr int RING = 4;        // tiles of inputs in the ring (RING - 2 in flight)
constexpr int SPT = 4;         // states a thread (load4, store4)
constexpr int HALF = 4;        // steps whose exponentials a thread forms at once
constexpr int MAX_STATE = 16;  // kernels/selective_scan.py: MAX_STATE

// Threads a channel: N states, SPT a thread, a power of two.
constexpr int lanes_for(int n) { return n <= SPT ? 1 : n <= 2 * SPT ? 2 : 4; }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

// Four consecutive values in one load (p aligned to four elements),
// widened to f32; four floats in one store.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p), w = *reinterpret_cast<const float4*>(p + 4);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w, v[4] = w.x, v[5] = w.y, v[6] = w.z, v[7] = w.w;
}

// States j .. j + 3 of a row of n at p; else those >= n are 0.  WIDE: n %
// 4 == 0, one vector load, states >= n (still inside the tile) read as they
// are: a state >= n is never summed or stored.
template <bool WIDE, typename T>
__device__ __forceinline__ void load_states(const T* p, int j, int n, float (&v)[4]) {
  if constexpr (WIDE) {
    load4(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = j + q < n ? to_f32(p[q]) : 0.f;
  }
}

// Shared memory of one block, L threads a channel (NSP = SPT x L states,
// N padded).  The ring holds tiles of the inputs as they lie in memory;
// the walk and the contraction read them there and widen them to f32 as
// they go.  hs holds the tile's states step by step: a thread stores its
// SPT states of a step in one 16-byte store, and a step's rows are padded
// by 16 bytes, so a warp's stores and the contraction's 16-byte reads (2
// channels x 4 steps a quarter-warp) hit distinct banks.
template <typename T, int L>
struct Smem {
  static constexpr int LANES = L, NSP = SPT * L;
  static constexpr int HS = CHANNELS * NSP + 4;   // floats a step of hs
  __align__(16) T raw_dt[RING][STEPS][CHANNELS];
  __align__(16) T raw_x[RING][STEPS][CHANNELS];
  __align__(16) T raw_b[RING][STEPS * NSP];   // STEPS rows of N, dense
  __align__(16) T raw_c[RING][STEPS * NSP];
  __align__(16) float hs[2][STEPS * HS];   // tile i's walk writes hs[i % 2]
};

// Rows t0 .. t0 + steps of a (T, di) input (the block's channels: src is
// the sequence's row 0 at channel d0) into dst[STEPS][CHANNELS]: WIDE (rows
// of whole 16-byte chunks), 16-byte cp.async from straight-line code; else
// plain loads in a rolled loop.  Channels past di and rows past `steps` are
// zero.
template <bool WIDE, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(T (*dst)[CHANNELS], const T* src, int t0, int steps,
                                           int d0, int di) {
  if constexpr (WIDE) {
    constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
    constexpr int CPR = CHANNELS / EPC;        // chunks a row
    constexpr int NX = STEPS * CPR;
#pragma unroll
    for (int i0 = 0; i0 < NX; i0 += THREADS) {
      const int i = i0 + threadIdx.x, s = i / CPR, c = i % CPR;
      const bool ok = s < steps && d0 + c * EPC < di;   // di % EPC == 0: a chunk is whole
      const long long e = ok ? (long long)(t0 + s) * di + c * EPC : 0;
      if (NX % THREADS == 0 || i < NX) cp_async16(smem_addr(&dst[s][c * EPC]), src + e, ok ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < STEPS * CHANNELS; i += THREADS) {
      const int s = i / CHANNELS, c = i % CHANNELS;
      const bool ok = s < steps && d0 + c < di;
      dst[s][c] = ok ? src[(long long)(t0 + s) * di + c] : zero<T>();
    }
  }
}

// Rows t0 .. t0 + steps of a (T, n) input (B or C), steps * n dense
// elements, into dst (STEPS * NSP elements); with `pad`, elements steps *
// n .. STEPS * n are zero (the backward's short last tile).
template <bool WIDE, int THREADS, int NSP, typename T>
__device__ __forceinline__ void stage_dense(T* dst, const T* src, int t0, int steps, int n,
                                            bool pad = false) {
  const long long f0 = (long long)t0 * n;
  if constexpr (WIDE) {
    constexpr int EPC = 16 / (int)sizeof(T);
    constexpr int NB = STEPS * NSP / EPC;
    const int chunks = steps * n / EPC;   // n % EPC == 0
#pragma unroll
    for (int i0 = 0; i0 < NB; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      if (i < chunks) cp_async16(smem_addr(dst + i * EPC), src + f0 + i * EPC, 16);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < steps * n; i += THREADS) dst[i] = src[f0 + i];
  }
  if (pad)
    for (int i = steps * n + threadIdx.x; i < STEPS * n; i += THREADS) dst[i] = zero<T>();
}

// Rows t0 .. t0 + steps of dt and x (the block's channels, from dtb and xb)
// and of B and C (from bb and cb) into ring slot `slot`.
template <bool WIDE, typename T, typename Sm>
__device__ __forceinline__ void stage(Sm& sm, int slot, const T* dtb, const T* xb, const T* bb,
                                      const T* cb, int t0, int steps, int d0, int di, int n,
                                      bool pad = false) {
  constexpr int THREADS = CHANNELS * Sm::LANES;
  stage_rows<WIDE, THREADS>(sm.raw_dt[slot], dtb, t0, steps, d0, di);
  stage_rows<WIDE, THREADS>(sm.raw_x[slot], xb, t0, steps, d0, di);
  stage_dense<WIDE, THREADS, Sm::NSP>(sm.raw_b[slot], bb, t0, steps, n, pad);
  stage_dense<WIDE, THREADS, Sm::NSP>(sm.raw_c[slot], cb, t0, steps, n, pad);
}

// A thread's SPT states of a row at p (16-byte aligned when `whole`): all
// four when `whole`, else those marked in `on`.
__device__ __forceinline__ void put_state(float* p, const float (&h)[SPT], bool whole,
                                          const bool (&on)[SPT]) {
  if (whole) {
    store4(p, h);
  } else {
#pragma unroll
    for (int q = 0; q < SPT; ++q)
      if (on[q]) p[q] = h[q];
  }
}
__device__ __forceinline__ void get_state(const float* p, float (&h)[SPT], bool whole,
                                          const bool (&on)[SPT]) {
  if (whole) {
    load4(p, h);
  } else {
#pragma unroll
    for (int q = 0; q < SPT; ++q) h[q] = on[q] ? p[q] : 0.f;
  }
}

template <typename T, int L, bool WIDE>
__global__ void __launch_bounds__(CHANNELS * L)
    selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                          const T* __restrict__ cm, const float* __restrict__ A,
                          const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
                          float* __restrict__ saved, int t_len, int di, int n) {
  static_assert(STEPS == 8 && CHANNELS % 8 == 0 && STEPS % HALF == 0 && RING >= 3,
                "the contraction's map; a tile in flight");
  using Sm = Smem<T, L>;
  constexpr int THREADS = CHANNELS * L, NSP = Sm::NSP;
  constexpr int PAIRS = STEPS * CHANNELS / THREADS;   // contraction (channel, step) pairs a thread
  __shared__ Sm sm;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CHANNELS;
  const int ch = threadIdx.x / L, j0 = threadIdx.x % L * SPT;   // channel, first state
  const int d = d0 + ch;
  const bool whole = WIDE && d < di && j0 < n;             // the thread's 4 states are real
  const long long st = ((long long)b * di + d) * n + j0;   // (b, d, j0) in h0 and hT
  const long long at = (long long)d * n + j0;              // (d, j0) in A
  const int tiles = (t_len + STEPS - 1) / STEPS;
  bool on[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) on[q] = d < di && j0 + q < n;
  // (b, tile 0, d, j0) in saved: (batch, tiles + 1, di, n)
  const long long sv = ((long long)b * (tiles + 1) * di + d) * n + j0;
  const long long row0 = (long long)b * t_len;             // sequence b's first row
  const T* dtb = dt + row0 * di + d0;
  const T* xb = x + row0 * di + d0;
  const T* bb = bm + row0 * n;
  const T* cb = cm + row0 * n;
  T* yb = y + row0 * di + d0;

  auto steps_of = [&](int i) { return min(STEPS, t_len - i * STEPS); };
#pragma unroll 1
  for (int r = 0; r < RING - 2; ++r) {   // a commit group a tile, empty ones too
    if (r < tiles) stage<WIDE>(sm, r, dtb, xb, bb, cb, r * STEPS, steps_of(r), d0, di, n);
    cp_async_commit();
  }
  float h[SPT], a[SPT];
  if (whole) {
    load4(h0 + st, h);
    load4(A + at, a);
  } else {
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      h[q] = on[q] ? h0[st + q] : 0.f;
      a[q] = on[q] ? A[at + q] : 0.f;
    }
  }
  // The contraction's (channel, step) pairs: a warp is 8 channels x 4
  // steps, a quarter-warp 2 channels x 4 steps.
  int cs[PAIRS], ss[PAIRS];
#pragma unroll
  for (int r = 0; r < PAIRS; ++r) {
    const int k = threadIdx.x + r * THREADS, l = k % 32, w = k / 32;
    cs[r] = l % 2 + 2 * (l / 8) + 8 * (w % (CHANNELS / 8));
    ss[r] = (l / 2) % 4 + 4 * (w / (CHANNELS / 8));
  }

  // Tile i's walk: a whole tile HALF steps at a time (their exponentials and
  // dtx * B first, independent of the state, then the recurrence in step
  // order); the last tile of a prompt, or a decode step, step by step.
  auto walk = [&](int i, bool whole_tile) {
    const int slot = i % RING, steps = steps_of(i);
    const T* rdt = &sm.raw_dt[slot][0][ch];
    const T* rx = &sm.raw_x[slot][0][ch];
    const T* rb = &sm.raw_b[slot][j0];
    float* hw = &sm.hs[i % 2][ch * NSP + j0];
    auto inputs = [&](int s, float (&da)[SPT], float (&u)[SPT]) {
      const float dv = to_f32(rdt[s * CHANNELS]);
      const float dtx = __fmul_rn(dv, to_f32(rx[s * CHANNELS]));
      float bq[SPT];
      load_states<WIDE>(rb + s * n, j0, n, bq);
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        da[q] = expf(__fmul_rn(dv, a[q]));
        u[q] = __fmul_rn(dtx, bq[q]);
      }
    };
    auto advance = [&](int s, const float (&da)[SPT], const float (&u)[SPT]) {
#pragma unroll
      for (int q = 0; q < SPT; ++q) h[q] = __fadd_rn(__fmul_rn(da[q], h[q]), u[q]);
      store4(hw + s * Sm::HS, h);
    };
    if (whole_tile) {
#pragma unroll
      for (int s0 = 0; s0 < STEPS; s0 += HALF) {
        float da[HALF][SPT], u[HALF][SPT];
#pragma unroll
        for (int r = 0; r < HALF; ++r) inputs(s0 + r, da[r], u[r]);
#pragma unroll
        for (int r = 0; r < HALF; ++r) advance(s0 + r, da[r], u[r]);
      }
    } else {
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        float da[SPT], u[SPT];
        inputs(s, da, u);
        advance(s, da, u);
      }
    }
  };
  // Tile i's contraction: each pair's fma chain over n = 0 .. N-1 from 0,
  // the PAIRS chains of a thread interleaved.
  auto contract = [&](int i) {
    const int slot = i % RING, steps = steps_of(i);
    const float* hr = sm.hs[i % 2];
    float acc[PAIRS];
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) acc[r] = 0.f;
#pragma unroll
    for (int q = 0; q < NSP; q += 4) {
#pragma unroll
      for (int r = 0; r < PAIRS; ++r) {
        float hv[4], cv[4];
        load4(&hr[ss[r] * Sm::HS + cs[r] * NSP + q], hv);
        load_states<WIDE>(&sm.raw_c[slot][ss[r] * n + q], q, n, cv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q + e < n) acc[r] = fmaf(hv[e], cv[e], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < PAIRS; ++r)
      if (ss[r] < steps && d0 + cs[r] < di)
        store_f32(yb + (long long)(i * STEPS + ss[r]) * di + cs[r], acc[r]);
  };

  // One barrier a tile: tile i's walk and tile i - 1's contraction run in
  // the same stretch of code, so each fills the other's stalls.  Tile
  // i + RING - 2 is staged into the slot of tile i - 2, whose contraction
  // ended before the barrier.
#pragma unroll 1
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<RING - 3>();   // tile i has landed (tile i + 1 may be in flight)
    __syncthreads();   // ... for every thread; tile i - 1's states are in hs
    const int ahead = i + RING - 2;
    if (ahead < tiles)
      stage<WIDE>(sm, ahead % RING, dtb, xb, bb, cb, ahead * STEPS, steps_of(ahead), d0, di, n);
    cp_async_commit();
    if (saved != nullptr) put_state(saved + sv + (long long)i * di * n, h, whole, on);
    if (steps_of(i) == STEPS && i > 0) {
      walk(i, true);
      contract(i - 1);
    } else {
      walk(i, steps_of(i) == STEPS);
      if (i > 0) contract(i - 1);
    }
  }
  __syncthreads();
  contract(tiles - 1);
  if (saved != nullptr) put_state(saved + sv + (long long)tiles * di * n, h, whole, on);
  if (whole) {
    store4(hT + st, h);
  } else {
#pragma unroll
    for (int q = 0; q < SPT; ++q)
      if (on[q]) hT[st + q] = h[q];
  }
}

template <typename T, int L>
int launch(const void* dt, const void* x, const void* bm, const void* c, const void* A,
           const void* h0, void* y, void* hT, void* saved, int batch, int t_len, int di, int n,
           bool wide, cudaStream_t s) {
  const dim3 grid((di + CHANNELS - 1) / CHANNELS, batch);
  auto kernel = wide ? selective_scan_kernel<T, L, true> : selective_scan_kernel<T, L, false>;
  kernel<<<grid, CHANNELS * L, 0, s>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(c), static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hT), static_cast<float*>(saved), t_len, di, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lanes(int lanes, const void* dt, const void* x, const void* bm, const void* c,
                 const void* A, const void* h0, void* y, void* hT, void* saved, int batch,
                 int t_len, int di, int n, bool wide, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<T, 1>(dt, x, bm, c, A, h0, y, hT, saved, batch, t_len, di, n, wide, s);
    case 2: return launch<T, 2>(dt, x, bm, c, A, h0, y, hT, saved, batch, t_len, di, n, wide, s);
    default: return launch<T, 4>(dt, x, bm, c, A, h0, y, hT, saved, batch, t_len, di, n, wide, s);
  }
}

// ---------------------------------------------------------------------------
// The backward (selective_scan_bwd).  Shared memory of one block: the raw
// inputs of the tile in flight; the walked
// tile's dt, x, gy and dtx = dt x widened to f32 once per (channel, step),
// a channel's 8 steps in a 16-byte-aligned row (padded to WS floats, so a
// quarter-warp's 8 channels read distinct banks), and its B and C widened
// per (step, state), states >= N zero; per tile each state's terms of the
// two sums over channels (red[0]: g dtx for gbm, red[1]: gy h for gc; a
// step's row padded by NSP floats, so the channel sums' reads of two steps
// hit distinct banks), the channels' gdt and gx, and, in a cluster, this
// rank's share of each block's channel sums of the last two tiles (recv).
constexpr int WS = STEPS + 4;     // floats a channel's row of a widened input
// Channel blocks a cluster: 8, the portable size.  tools/scan_table.py
// --cluster builds the backward with another (-DSCAN_BWD_CLUSTER=K, K a
// power of two up to 8) to time it against this one.
#ifndef SCAN_BWD_CLUSTER
#define SCAN_BWD_CLUSTER 8
#endif
constexpr int CLUSTER = SCAN_BWD_CLUSTER;

template <typename T, int L>
struct BwdSmem {
  static constexpr int LANES = L, NSP = SPT * L;
  static constexpr int RS = CHANNELS * NSP + NSP;   // floats a step of red
  __align__(16) T raw_dt[1][STEPS][CHANNELS];   // the next tile's inputs, as they lie in memory
  __align__(16) T raw_x[1][STEPS][CHANNELS];
  __align__(16) T raw_gy[1][STEPS][CHANNELS];
  __align__(16) T raw_b[1][STEPS * NSP];
  __align__(16) T raw_c[1][STEPS * NSP];
  __align__(16) float wide[4][CHANNELS][WS];   // the walked tile's dt, x, gy, dtx
  __align__(16) float wb[STEPS][NSP];
  __align__(16) float wc[STEPS][NSP];
  __align__(16) float red[2][STEPS * RS];
  float outs[2][STEPS][CHANNELS];   // gdt, gx
  // A rank's share of a tile's channel sums ((which, step, state) values)
  // from each block of the cluster, by tile parity, and their barriers.
  __align__(16) float recv[2][CLUSTER][2 * STEPS * NSP / CLUSTER];
  uint64_t full[2];
};

// The cluster's barrier (arrive with release, wait with acquire): a full
// memory barrier on the card, so the backward takes it once, after
// initialising its mbarriers, and moves its channel sums by st.async.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The shared::cluster address of `local` (this block's shared memory) in
// block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(hop::smem_u32(local)), "r"(rank));
  return r;
}
// v[0..3] into another block's shared memory (16-byte aligned), completing
// 16 bytes on its mbarrier.
__device__ __forceinline__ void st_async4(uint32_t dst, const float (&v)[4], uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
               "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(__float_as_uint(v[2])),
               "r"(__float_as_uint(v[3])), "r"(bar)
               : "memory");
}

// One block walks CHANNELS channels of one sequence backwards in time, a
// tile at a time from its last, on the forward's thread layout: a thread
// the same SPT states of one channel.  For tile i it reloads the state
// the forward saved at the tile's start, recomputes the tile's decays and
// states with the forward's operations (so the forward's bits), then walks
// the tile's steps in reverse carrying g, the gradient flowing into the
// state.  Per step and state (f32, each product rounded; fmaf where noted):
//   g    = gy C + carry                 carry = dA g, for the step before
//   gbm's term g dtx, gc's term gy h     (summed over channels below)
//   v    = (g h_prev) dA
//   gdtx = sum_n g B (fmaf)   sA = sum_n v A (fmaf)   ga += v dt (fmaf)
// the sums over a channel's states taken in state order in each thread,
// then across its `lanes` threads by an xor butterfly; gdt = gdtx x + sA
// and gx = gdtx dt, rounded once.
//
// Registers: the tile's 8 decays stay in registers, but of its 9 states
// only the tile's start and the second half's 5: the first half's states
// are formed again from the start (three steps of two products and a sum,
// no exponential) when the reverse walk reaches them.  Every value is the
// one the forward gave, so gdt, gx, ga and gh0 keep their bits.
//
// Channel sums: after each tile the block sums gbm's and gc's terms over
// its 16 channels in order; the CLUSTER consecutive channel blocks of a
// cluster (the grid padded to whole clusters) then add those sums in rank
// order through distributed shared memory: each block sends each of its
// values to the rank that owns it by st.async, counted on the owner's
// mbarrier (a cluster barrier would cost a full memory barrier a tile),
// and the owner adds them and writes one partial a cluster to part_bc (2,
// batch, t_len, clusters, n).  At the end each thread's ga over the
// sequence goes to part_a (batch, di, n) and, given gh0, dA_1 g_1 to gh0;
// selective_scan_bwd_sums adds the partials in cluster and in sequence
// order.
//
// Eight blocks an SM at least: at most 128 registers a thread at Jamba's
// 4 threads a channel (fewer threads a channel may take up to 255).
template <typename T, int L, bool WIDE>
__global__ void __launch_bounds__(CHANNELS * L, 8)
    selective_scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                              const T* __restrict__ bm, const T* __restrict__ cm,
                              const float* __restrict__ A, const float* __restrict__ saved,
                              const T* __restrict__ gy, const float* __restrict__ ght,
                              T* __restrict__ gdt, T* __restrict__ gx, float* __restrict__ gh0,
                              float* __restrict__ part_bc, float* __restrict__ part_a, int t_len,
                              int di, int n) {
  using Sm = BwdSmem<T, L>;
  constexpr int THREADS = CHANNELS * L, NSP = Sm::NSP, RS = Sm::RS;
  constexpr int VALS = 2 * STEPS * NSP;             // a tile's channel sums
  static_assert(STEPS == 2 * HALF, "the halves");
  __shared__ Sm sm;
  const int b = blockIdx.y, blk = blockIdx.x, batch = gridDim.y;
  const int rank = blk % CLUSTER, cl = blk / CLUSTER, ncl = gridDim.x / CLUSTER;
  const int d0 = blk * CHANNELS;
  const int ch = threadIdx.x / L, j0 = threadIdx.x % L * SPT;
  const int d = d0 + ch;
  const bool whole = WIDE && d < di && j0 < n;
  bool on[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) on[q] = d < di && j0 + q < n;
  const long long st = ((long long)b * di + d) * n + j0;
  const long long at = (long long)d * n + j0;
  const int tiles = (t_len + STEPS - 1) / STEPS;
  const long long sv = ((long long)b * (tiles + 1) * di + d) * n + j0;
  const long long row0 = (long long)b * t_len;
  const T* dtb = dt + row0 * di + d0;
  const T* xb = x + row0 * di + d0;
  const T* gyb = gy + row0 * di + d0;
  const T* bb = bm + row0 * n;
  const T* cb = cm + row0 * n;
  auto steps_of = [&](int i) { return min(STEPS, t_len - i * STEPS); };
  auto stage_tile = [&](int i) {
    const int steps = steps_of(i);
    stage<WIDE>(sm, 0, dtb, xb, bb, cb, i * STEPS, steps, d0, di, n, steps < STEPS);
    stage_rows<WIDE, THREADS>(sm.raw_gy[0], gyb, i * STEPS, steps, d0, di);
  };
  // The staged tile widened once: a (channel, step) pair's dt, x, gy and
  // dtx, a (step, state) pair's B and C (states >= n zero).  Steps past a
  // short last tile's have dt = x = gy = B = C = 0: dA = 1 and no input,
  // so the states and the carry pass unchanged.
  // Thread t widens channel t % CHANNELS at steps t / CHANNELS + L j, and
  // B and C at state t % NSP of steps t / NSP + 4 j (straight-line code).
  auto widen = [&]() {
    const int c = threadIdx.x % CHANNELS, s0 = threadIdx.x / CHANNELS;
#pragma unroll
    for (int j = 0; j < STEPS / L; ++j) {
      const int s = s0 + L * j;
      const float dv = to_f32(sm.raw_dt[0][s][c]), xv = to_f32(sm.raw_x[0][s][c]);
      sm.wide[0][c][s] = dv;
      sm.wide[1][c][s] = xv;
      sm.wide[2][c][s] = to_f32(sm.raw_gy[0][s][c]);
      sm.wide[3][c][s] = __fmul_rn(dv, xv);
    }
    const int q = threadIdx.x % NSP, t0 = threadIdx.x / NSP;
#pragma unroll
    for (int j = 0; j < 2; ++j) {   // THREADS / NSP = 4 steps a pass
      const int s = t0 + 4 * j;
      sm.wb[s][q] = q < n ? to_f32(sm.raw_b[0][s * n + q]) : 0.f;
      sm.wc[s][q] = q < n ? to_f32(sm.raw_c[0][s * n + q]) : 0.f;
    }
  };
  // Where a partial of gbm or gc goes: (which, step, state) of tile i.
  auto put = [&](int i, int which, int s, int q, float v) {
    if (s < steps_of(i) && q < n)
      part_bc[((((long long)which * batch + b) * t_len + i * STEPS + s) * ncl + cl) * n + q] = v;
  };
  // A cluster's channel sums: each thread sends its 4 block sums
  // of tile i, values k .. k + 3, to their owner, rank k / SHARE, which
  // holds them at recv[i % 2][sender][k % SHARE ..] and counts their bytes
  // on full[i % 2]; the owner's thread t then adds values rank * SHARE +
  // t, t + THREADS, ... below SHARE over the senders in rank order (one
  // value a thread at most at CLUSTER = 8).  A block sends tile i only
  // after a barrier that follows its own take of tile i + 1, and a sender
  // sends tile i - 2, which reuses recv[i % 2], only after taking tile i -
  // 1, which every block sends after taking tile i: so no value lands in a
  // buffer, nor is counted on a barrier, that its owner still reads.
  constexpr int SHARE = VALS / CLUSTER;
  static_assert(SHARE % 4 == 0 && SHARE * CLUSTER == VALS, "whole 16-byte sends a rank");
  uint32_t phase = 0;   // the parity of each full barrier's next phase
  auto take = [&](int i) {
    const int p = i % 2;
    if (threadIdx.x == 0) hop::mbar_expect_tx(&sm.full[p], CLUSTER * SHARE * 4);
    if ((int)threadIdx.x < SHARE) {
      hop::mbar_wait(&sm.full[p], (phase >> p) & 1);
#pragma unroll
      for (int u = 0; u < (SHARE + THREADS - 1) / THREADS; ++u) {
        const int v = threadIdx.x + u * THREADS;
        if (v < SHARE) {
          float tot = 0.f;
#pragma unroll
          for (int r = 0; r < CLUSTER; ++r) tot = __fadd_rn(tot, sm.recv[p][r][v]);
          const int k = rank * SHARE + v;
          put(i, k / (STEPS * NSP), k % (STEPS * NSP) / NSP, k % NSP, tot);
        }
      }
    }
    phase ^= 1u << p;
  };
  if (threadIdx.x == 0) {
    hop::mbar_init(&sm.full[0], 1);
    hop::mbar_init(&sm.full[1], 1);
    hop::fence_barrier_init();
  }
  cluster_sync_all();   // every block's barriers ready before any st.async
  stage_tile(tiles - 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  widen();

  float a[SPT], carry[SPT], ga[SPT], h_in[SPT];
  get_state(A + at, a, whole, on);
  if (ght != nullptr) {
    get_state(ght + st, carry, whole, on);
  } else {
#pragma unroll
    for (int q = 0; q < SPT; ++q) carry[q] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < SPT; ++q) ga[q] = 0.f;
  get_state(saved + sv + (long long)(tiles - 1) * di * n, h_in, whole, on);

  // Two barriers a tile: the top one (tile i widened; tile i + 1's sums
  // and stores done, so its block sums can be sent), and one after the walk
  // (tile i's channel terms written, and tile i - 1, staged by cp.async
  // while i was walked, landed).
#pragma unroll 1
  for (int i = tiles - 1; i >= 0; --i) {
    __syncthreads();
    if (i > 0) stage_tile(i - 1);
    cp_async_commit();
    float dv[STEPS], dtx[STEPS];
    load8(sm.wide[0][ch], dv);
    load8(sm.wide[3][ch], dtx);
    // The tile's decays, and its states from step HALF on: hi[k] is the
    // state after step HALF - 1 + k (hi[0] before step HALF).
    float da[STEPS][SPT], hi[HALF + 1][SPT], lo[HALF][SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) hi[0][q] = lo[0][q] = h_in[q];
    if (i > 0) get_state(saved + sv + (long long)(i - 1) * di * n, h_in, whole, on);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      float bq[SPT];
      load4(&sm.wb[s][j0], bq);
#pragma unroll
      for (int q = 0; q < SPT; ++q) da[s][q] = expf(__fmul_rn(dv[s], a[q]));
      if (s < HALF) {
#pragma unroll
        for (int q = 0; q < SPT; ++q)
          hi[0][q] = __fadd_rn(__fmul_rn(da[s][q], hi[0][q]), __fmul_rn(dtx[s], bq[q]));
      } else {
#pragma unroll
        for (int q = 0; q < SPT; ++q)
          hi[s - HALF + 1][q] =
              __fadd_rn(__fmul_rn(da[s][q], hi[s - HALF][q]), __fmul_rn(dtx[s], bq[q]));
      }
    }
    // The reverse walk reads dt, x, gy and dtx again from shared memory, a
    // half at a time, so only the decays and the states stay in registers
    // through it (at 128 registers a thread the compiler would otherwise
    // recompute decays, exponentials included).
    asm volatile("" ::: "memory");
    // One reverse step s from the states before (hp) and after (hn) it; w
    // holds the half's dt, x, gy and dtx, step s at w[.][s % HALF].
    auto back = [&](int s, const float (&hp)[SPT], const float (&hn)[SPT],
                    const float (&w)[4][HALF]) {
      const float dvs = w[0][s % HALF], xv = w[1][s % HALF], gv = w[2][s % HALF];
      const float dtxs = w[3][s % HALF];
      float bq[SPT], cq[SPT], tb[SPT], tc[SPT];
      load4(&sm.wb[s][j0], bq);
      load4(&sm.wc[s][j0], cq);
      float gdtx = 0.f, sa = 0.f;
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        const float g = __fadd_rn(__fmul_rn(gv, cq[q]), carry[q]);
        tb[q] = __fmul_rn(g, dtxs);
        tc[q] = __fmul_rn(gv, hn[q]);
        gdtx = __fmaf_rn(g, bq[q], gdtx);
        const float v = __fmul_rn(__fmul_rn(g, hp[q]), da[s][q]);
        sa = __fmaf_rn(v, a[q], sa);
        ga[q] = __fmaf_rn(v, dvs, ga[q]);
        carry[q] = __fmul_rn(da[s][q], g);
      }
      store4(&sm.red[0][s * RS + ch * NSP + j0], tb);
      store4(&sm.red[1][s * RS + ch * NSP + j0], tc);
#pragma unroll
      for (int o = 1; o < L; o <<= 1) {
        gdtx += __shfl_xor_sync(0xffffffffu, gdtx, o);
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
      }
      if (j0 == 0) {
        sm.outs[0][s][ch] = __fadd_rn(__fmul_rn(gdtx, xv), sa);
        sm.outs[1][s][ch] = __fmul_rn(gdtx, dvs);
      }
    };
    auto half_inputs = [&](int s0, float (&w)[4][HALF]) {
#pragma unroll
      for (int k = 0; k < 4; ++k) load4(&sm.wide[k][ch][s0], w[k]);
    };
    float w[4][HALF];
    // The second half, steps STEPS - 1 .. HALF.
    half_inputs(HALF, w);
#pragma unroll
    for (int s = STEPS - 1; s >= HALF; --s) back(s, hi[s - HALF], hi[s - HALF + 1], w);
    // The first half: its states again from the tile's start, then steps
    // HALF - 1 .. 0.
    half_inputs(0, w);
#pragma unroll
    for (int s = 0; s + 1 < HALF; ++s) {
      float bq[SPT];
      load4(&sm.wb[s][j0], bq);
#pragma unroll
      for (int q = 0; q < SPT; ++q)
        lo[s + 1][q] = __fadd_rn(__fmul_rn(da[s][q], lo[s][q]), __fmul_rn(w[3][s], bq[q]));
    }
    back(HALF - 1, lo[HALF - 1], hi[0], w);
#pragma unroll
    for (int s = HALF - 2; s >= 0; --s) back(s, lo[s], lo[s + 1], w);
    // Tile i + 1's sums, which every block sent before walking tile i:
    // taken before the barrier, so no thread of this block sends tile i
    // (below) before they are read.
    if (i + 1 < tiles) take(i + 1);
    cp_async_wait<0>();
    __syncthreads();
    // gbm's and gc's terms summed over the block's channels in order (each
    // of 4 states by a 16-byte load a channel): thread t sums (which, step,
    // states q0 .. q0 + 3) = (t / (STEPS QD), t / QD % STEPS, 4 (t % QD)),
    // value k0 = which STEPS NSP + step NSP + q0; then sends them to their
    // owner.
    {
      constexpr int QD = NSP / 4;
      static_assert(2 * STEPS * QD == THREADS, "a thread four sums");
      const int which = threadIdx.x / (STEPS * QD), s = threadIdx.x / QD % STEPS;
      const int q0 = 4 * (threadIdx.x % QD);
      const float* col = &sm.red[which][s * RS + q0];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < CHANNELS; ++c) {
        float v[4];
        load4(col + c * NSP, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
      }
      const int k0 = which * STEPS * NSP + s * NSP + q0, owner = k0 / SHARE;
      st_async4(cluster_addr(&sm.recv[i % 2][rank][k0 % SHARE], owner), acc,
                cluster_addr(&sm.full[i % 2], owner));
    }
    // gdt and gx: thread t stores channel t % CHANNELS at steps t /
    // CHANNELS + (L j) % STEPS, of gdt for L j < STEPS, else of gx.
    {
      const int steps = steps_of(i), c = threadIdx.x % CHANNELS, s0 = threadIdx.x / CHANNELS;
      const long long at0 = (row0 + i * STEPS + s0) * di + d0 + c;
#pragma unroll
      for (int j = 0; j < 2 * STEPS / L; ++j) {
        const int which = j * L / STEPS, s = s0 + j * L % STEPS;
        if (s < steps && d0 + c < di)
          store_f32((which ? gx : gdt) + at0 + (long long)(j * L % STEPS) * di,
                    sm.outs[which][s][c]);
      }
    }
    if (i > 0) widen();   // tile i - 1, for the next pass
  }
  take(0);   // every block waits for its share of tile 0, so none leaves
             // while another's st.async to it is in flight
  put_state(part_a + st, ga, whole, on);   // a block past di (a cluster's padding) stores nothing
  if (gh0 != nullptr) put_state(gh0 + st, carry, whole, on);
}

// gbm and gc: a thread a (which, b, t, state), the clusters' partials in
// order; ga: a thread a (d, state), the sequences' partials in order.  One
// launch for both.  The order depends on (di, n) alone.
template <typename T>
__global__ void selective_scan_bwd_sums(const float* __restrict__ part_bc,
                                        const float* __restrict__ part_a, T* __restrict__ gbm,
                                        T* __restrict__ gc, float* __restrict__ ga, int rows,
                                        int ncl, int n, int batch, long long elems) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bc = 2LL * rows * n;
  if (e < bc) {
    const long long row = e / n;   // (which, b, t)
    const int q = (int)(e % n);
    const float* p = part_bc + row * ncl * n + q;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < ncl; ++j) acc = __fadd_rn(acc, p[(long long)j * n]);
    store_f32((row < rows ? gbm : gc) + (row % rows) * n + q, acc);
  } else if (e - bc < elems) {
    const long long f = e - bc;
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc = __fadd_rn(acc, part_a[b * elems + f]);
    ga[f] = acc;
  }
}

// Channel blocks of a backward launch: the di / CHANNELS blocks rounded up
// to a whole number of clusters (a block past di only pads its cluster).
int bwd_blocks(int di) {
  const int nblk = (di + CHANNELS - 1) / CHANNELS;
  return (nblk + CLUSTER - 1) / CLUSTER * CLUSTER;
}

template <typename T, int L>
int launch_bwd(const void* dt, const void* x, const void* bm, const void* c, const void* A,
               const void* saved, const void* gy, const void* ght, void* gdt, void* gx,
               void* gbm, void* gc, void* ga, void* gh0, float* part_bc, float* part_a,
               int batch, int t_len, int di, int n, bool wide, cudaStream_t s) {
  const int blocks = bwd_blocks(di);
  auto kernel = wide ? selective_scan_bwd_kernel<T, L, true> : selective_scan_bwd_kernel<T, L, false>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, batch);
  cfg.blockDim = dim3(CHANNELS * L);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bm), static_cast<const T*>(c), static_cast<const float*>(A),
      static_cast<const float*>(saved), static_cast<const T*>(gy),
      static_cast<const float*>(ght), static_cast<T*>(gdt), static_cast<T*>(gx),
      static_cast<float*>(gh0), part_bc, part_a, t_len, di, n);
  int err = e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  if (err) return err;
  const int rows = batch * t_len;
  const long long elems = (long long)di * n;
  const long long total = 2LL * rows * n + elems;
  selective_scan_bwd_sums<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_bc, part_a, static_cast<T*>(gbm), static_cast<T*>(gc), static_cast<float*>(ga), rows,
      blocks / CLUSTER, n, batch, elems);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_lanes(int lanes, const void* dt, const void* x, const void* bm, const void* c,
                     const void* A, const void* saved, const void* gy, const void* ght, void* gdt,
                     void* gx, void* gbm, void* gc, void* ga, void* gh0, float* part_bc,
                     float* part_a, int batch, int t_len, int di, int n, bool wide,
                     cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch_bwd<T, 1>(dt, x, bm, c, A, saved, gy, ght, gdt, gx, gbm, gc, ga, gh0, part_bc,
                              part_a, batch, t_len, di, n, wide, s);
    case 2:
      return launch_bwd<T, 2>(dt, x, bm, c, A, saved, gy, ght, gdt, gx, gbm, gc, ga, gh0, part_bc,
                              part_a, batch, t_len, di, n, wide, s);
    default:
      return launch_bwd<T, 4>(dt, x, bm, c, A, saved, gy, ght, gdt, gx, gbm, gc, ga, gh0, part_bc,
                              part_a, batch, t_len, di, n, wide, s);
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// The plan's checks shared by both entries.
int check_plan(int batch, int t_len, int di, int n, int dtype, int lanes, int channels, int steps,
               int wide) {
  if (batch < 1 || batch > 65535 || t_len < 1 || di < 1 || n < 1 || n > MAX_STATE ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  if (lanes != lanes_for(n) || channels != CHANNELS || steps != STEPS ||
      wide != (di * es % 16 == 0 && n * es % 16 == 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dt, x, y (batch, t_len, di) and bm, c (batch, t_len, n) in dtype 0 = f32
// or 1 = bf16; A (di, n), h0 and hT (batch, di, n) f32; all contiguous.
// 1 <= n <= 16; batch <= 65535.  The plan (kernels/selective_scan.py:
// scan_plan, a function of (di, n, dtype) alone): lanes = threads a
// channel (SPT states each, a power of two), channels = CHANNELS, steps =
// STEPS, wide = rows of di values and of n values are whole 16-byte chunks
// (16-byte cp.async of the inputs, 16-byte moves of A and the state); any
// other plan is refused.  With wide, every pointer must be 16-byte aligned.
// saved (batch, ceil(t_len / STEPS) + 1, di, n) f32, or null: the state
// at each tile's start and the final state, for the backward.
extern "C" int selective_scan_launch(const void* dt, const void* x, const void* bm, const void* c,
                                     const void* A, const void* h0, void* y, void* hT,
                                     void* saved, int batch, int t_len, int di, int n, int dtype,
                                     int lanes, int channels, int steps, int wide, void* stream) {
  if (int err = check_plan(batch, t_len, di, n, dtype, lanes, channels, steps, wide)) return err;
  if (wide && (misaligned(dt) || misaligned(x) || misaligned(bm) || misaligned(c) || misaligned(A) ||
               misaligned(h0) || misaligned(hT) || misaligned(saved)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_lanes<float>(lanes, dt, x, bm, c, A, h0, y, hT, saved, batch, t_len,
                                          di, n, wide, s)
                    : launch_lanes<__nv_bfloat16>(lanes, dt, x, bm, c, A, h0, y, hT, saved, batch,
                                                  t_len, di, n, wide, s);
}

// The VJP: dt, x, bm, c, A and saved as the forward took and gave them; gy
// (batch, t_len, di) in dtype; ght (batch, di, n) f32 or null (0) -> gdt,
// gx (batch, t_len, di) and gbm, gc (batch, t_len, n) in dtype, ga (di, n)
// f32, and gh0 (batch, di, n) f32 unless null.  The plan as the forward's.
// scratch: scratch_floats = 2 batch t_len clusters n + batch di n f32
// (clusters = ceil(ceil(di / CHANNELS) / CLUSTER)).  Two kernels, no
// atomics: two calls give the same bits.
extern "C" int selective_scan_bwd_launch(const void* dt, const void* x, const void* bm,
                                         const void* c, const void* A, const void* saved,
                                         const void* gy, const void* ght, void* gdt, void* gx,
                                         void* gbm, void* gc, void* ga, void* gh0, void* scratch,
                                         long long scratch_floats, int batch, int t_len, int di,
                                         int n, int dtype, int lanes, int channels, int steps,
                                         int wide, void* stream) {
  if (int err = check_plan(batch, t_len, di, n, dtype, lanes, channels, steps, wide)) return err;
  const long long ncl = bwd_blocks(di) / CLUSTER;
  const long long bc = 2LL * batch * t_len * ncl * n;
  if (saved == nullptr || scratch == nullptr || scratch_floats < bc + (long long)batch * di * n)
    return (int)cudaErrorInvalidValue;
  if (wide && (misaligned(dt) || misaligned(x) || misaligned(bm) || misaligned(c) || misaligned(A) ||
               misaligned(saved) || misaligned(gy) || misaligned(ght) || misaligned(gh0) ||
               misaligned(scratch)))
    return (int)cudaErrorMisalignedAddress;
  float* part_bc = static_cast<float*>(scratch);
  float* part_a = part_bc + bc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_bwd_lanes<float>(lanes, dt, x, bm, c, A, saved, gy, ght, gdt, gx, gbm, gc,
                                       ga, gh0, part_bc, part_a, batch, t_len, di, n, wide, s)
             : launch_bwd_lanes<__nv_bfloat16>(lanes, dt, x, bm, c, A, saved, gy, ght, gdt, gx,
                                               gbm, gc, ga, gh0, part_bc, part_a, batch, t_len,
                                               di, n, wide, s);
}

REPRO_EXPORT_ERROR_STRING(selective_scan)
