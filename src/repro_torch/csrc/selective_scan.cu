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
// tile in flight by cp.async while one is walked), a tile's 9 states and
// 8 decays recomputed in registers from its saved start (never a state a
// step in memory), and the two sums over di (gbm, gc: 512 channel blocks
// at di = 8192) and the one over sequences (ga) taken as per-block
// partials that two small kernels add in a fixed order: no atomics, so
// two calls and a restarted run give the same bits, and a sequence's
// gdt, gx, gbm, gc rows do not depend on the batch.
#include "common.cuh"
#include "tc.cuh"

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
// The backward (selective_scan_bwd).  Shared memory of one block: the
// inputs of two tiles (the one walked and the one in flight), and per
// tile each state's terms of the two sums over channels (red[0]: g dtx for
// gbm, red[1]: gy h for gc; a step's row padded by NSP floats, so the
// channel sums' reads of two steps hit distinct banks) and the
// channels' gdt and gx.
template <typename T, int L>
struct BwdSmem {
  static constexpr int LANES = L, NSP = SPT * L;
  static constexpr int RS = CHANNELS * NSP + NSP;   // floats a step of red
  __align__(16) T raw_dt[2][STEPS][CHANNELS];
  __align__(16) T raw_x[2][STEPS][CHANNELS];
  __align__(16) T raw_gy[2][STEPS][CHANNELS];
  __align__(16) T raw_b[2][STEPS * NSP];
  __align__(16) T raw_c[2][STEPS * NSP];
  __align__(16) float red[2][STEPS * RS];
  float outs[2][STEPS][CHANNELS];   // gdt, gx
};

// One block walks CHANNELS channels of one sequence backwards in time, a
// tile at a time from its last, on the forward's thread layout: a thread
// the same SPT states of one channel.  For tile i it reloads the state
// the forward saved at the tile's start, recomputes the tile's states and
// decays with the forward's operations (so the forward's bits), then walks
// the tile's steps in reverse carrying g, the gradient flowing into the
// state.  Per step and state (f32, each product rounded; fmaf where noted):
//   g    = gy C + carry                 carry = dA g, for the step before
//   gbm's term g dtx, gc's term gy h     (summed over channels below)
//   v    = (g h_prev) dA
//   gdtx = sum_n g B (fmaf)   sA = sum_n v A (fmaf)   ga += v dt (fmaf)
// the sums over a channel's states taken in state order in each thread,
// then across its `lanes` threads by an xor butterfly; gdt = gdtx x + sA
// and gx = gdtx dt, rounded once.  After each tile the block sums gbm's and
// gc's terms over its channels in channel order into part_bc (batch,
// t_len, blocks, n) x 2; at the end each thread's ga over the sequence goes
// to part_a (batch, di, n) and, given gh0, dA_1 g_1 to gh0.
// selective_scan_bwd_sum_* add the partials in block and in sequence order.
template <typename T, int L, bool WIDE>
__global__ void __launch_bounds__(CHANNELS * L)
    selective_scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                              const T* __restrict__ bm, const T* __restrict__ cm,
                              const float* __restrict__ A, const float* __restrict__ saved,
                              const T* __restrict__ gy, const float* __restrict__ ght,
                              T* __restrict__ gdt, T* __restrict__ gx, float* __restrict__ gh0,
                              float* __restrict__ part_bc, float* __restrict__ part_a, int t_len,
                              int di, int n) {
  using Sm = BwdSmem<T, L>;
  constexpr int THREADS = CHANNELS * L, NSP = Sm::NSP, RS = Sm::RS;
  constexpr int SUMS = 2 * STEPS * NSP / THREADS;   // channel sums a thread a tile
  static_assert(2 * STEPS * NSP % THREADS == 0, "the channel sums' map");
  __shared__ Sm sm;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, batch = gridDim.y;
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
    const int slot = i % 2, steps = steps_of(i);
    stage<WIDE>(sm, slot, dtb, xb, bb, cb, i * STEPS, steps, d0, di, n, steps < STEPS);
    stage_rows<WIDE, THREADS>(sm.raw_gy[slot], gyb, i * STEPS, steps, d0, di);
  };
  stage_tile(tiles - 1);
  cp_async_commit();

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

#pragma unroll 1
  for (int i = tiles - 1; i >= 0; --i) {
    cp_async_wait<0>();
    __syncthreads();   // tile i has landed; tile i + 1's sums and stores are done
    if (i > 0) stage_tile(i - 1);
    cp_async_commit();
    const int slot = i % 2, steps = steps_of(i);
    // The tile's states: hist[s] before step s, hist[s + 1] after it.
    // Steps past `steps` (a short last tile) have dt = x = gy = B = C = 0:
    // dA = 1 and no input, so the states and the carry pass unchanged.
    float hist[STEPS + 1][SPT], da[STEPS][SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) hist[0][q] = h_in[q];
    if (i > 0) get_state(saved + sv + (long long)(i - 1) * di * n, h_in, whole, on);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const float dv = to_f32(sm.raw_dt[slot][s][ch]);
      const float dtx = __fmul_rn(dv, to_f32(sm.raw_x[slot][s][ch]));
      float bq[SPT];
      load_states<WIDE>(&sm.raw_b[slot][s * n + j0], j0, n, bq);
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        const float bv = on[q] ? bq[q] : 0.f;
        da[s][q] = expf(__fmul_rn(dv, a[q]));
        hist[s + 1][q] = __fadd_rn(__fmul_rn(da[s][q], hist[s][q]), __fmul_rn(dtx, bv));
      }
    }
#pragma unroll
    for (int s = STEPS - 1; s >= 0; --s) {
      const float dv = to_f32(sm.raw_dt[slot][s][ch]);
      const float xv = to_f32(sm.raw_x[slot][s][ch]);
      const float gv = to_f32(sm.raw_gy[slot][s][ch]);
      const float dtx = __fmul_rn(dv, xv);
      float bq[SPT], cq[SPT], tb[SPT], tc[SPT];
      load_states<WIDE>(&sm.raw_b[slot][s * n + j0], j0, n, bq);
      load_states<WIDE>(&sm.raw_c[slot][s * n + j0], j0, n, cq);
      float gdtx = 0.f, sa = 0.f;
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        const float bv = on[q] ? bq[q] : 0.f, cv = on[q] ? cq[q] : 0.f;
        const float g = __fadd_rn(__fmul_rn(gv, cv), carry[q]);
        tb[q] = __fmul_rn(g, dtx);
        tc[q] = __fmul_rn(gv, hist[s + 1][q]);
        gdtx = __fmaf_rn(g, bv, gdtx);
        const float v = __fmul_rn(__fmul_rn(g, hist[s][q]), da[s][q]);
        sa = __fmaf_rn(v, a[q], sa);
        ga[q] = __fmaf_rn(v, dv, ga[q]);
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
        sm.outs[1][s][ch] = __fmul_rn(gdtx, dv);
      }
    }
    __syncthreads();
    // gbm's and gc's terms summed over the block's channels in order.
#pragma unroll
    for (int r = 0; r < SUMS; ++r) {
      const int k = threadIdx.x + r * THREADS, which = k / (STEPS * NSP);
      const int s = k % (STEPS * NSP) / NSP, q = k % NSP;
      if (s < steps && q < n) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < CHANNELS; ++c) acc = __fadd_rn(acc, sm.red[which][s * RS + c * NSP + q]);
        part_bc[((((long long)which * batch + b) * t_len + i * STEPS + s) * nblk + blk) * n + q] =
            acc;
      }
    }
    for (int k = threadIdx.x; k < 2 * STEPS * CHANNELS; k += THREADS) {
      const int which = k / (STEPS * CHANNELS), s = k % (STEPS * CHANNELS) / CHANNELS;
      const int c = k % CHANNELS;
      if (s < steps && d0 + c < di)
        store_f32((which ? gx : gdt) + (row0 + i * STEPS + s) * di + d0 + c, sm.outs[which][s][c]);
    }
  }
  put_state(part_a + st, ga, whole, on);
  if (gh0 != nullptr) put_state(gh0 + st, carry, whole, on);
}

constexpr int SUM_CHUNKS = 16;   // runs of channel blocks summed apart, then in order

// gbm and gc: block (n, SUM_CHUNKS) for one (which, b, t) row; thread (q,
// k) sums the partials of channel blocks [k per, (k + 1) per) in order,
// thread (q, 0) then the SUM_CHUNKS sums in order.  The order depends on
// the number of channel blocks alone.
template <typename T>
__global__ void selective_scan_bwd_sum_bc(const float* __restrict__ part_bc, T* __restrict__ gbm,
                                          T* __restrict__ gc, int rows, int nblk, int n) {
  __shared__ float sums[SUM_CHUNKS][MAX_STATE];
  const int row = blockIdx.x, q = threadIdx.x, k = threadIdx.y;   // row: (which, b, t)
  const int per = (nblk + SUM_CHUNKS - 1) / SUM_CHUNKS;
  const float* p = part_bc + (long long)row * nblk * n + q;
  float acc = 0.f;
  for (int j = k * per; j < min(nblk, (k + 1) * per); ++j) acc = __fadd_rn(acc, p[(long long)j * n]);
  sums[k][q] = acc;
  __syncthreads();
  if (k == 0) {
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < SUM_CHUNKS; ++j) tot = __fadd_rn(tot, sums[j][q]);
    const int r = row % rows;
    store_f32((row < rows ? gbm : gc) + (long long)r * n + q, tot);
  }
}

// ga: a thread a (d, n), the sequences' partials in order.
__global__ void selective_scan_bwd_sum_a(const float* __restrict__ part_a, float* __restrict__ ga,
                                         int batch, long long elems) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) acc = __fadd_rn(acc, part_a[b * elems + e]);
  ga[e] = acc;
}

template <typename T, int L>
int launch_bwd(const void* dt, const void* x, const void* bm, const void* c, const void* A,
               const void* saved, const void* gy, const void* ght, void* gdt, void* gx,
               void* gbm, void* gc, void* ga, void* gh0, float* part_bc, float* part_a,
               int batch, int t_len, int di, int n, bool wide, cudaStream_t s) {
  const int nblk = (di + CHANNELS - 1) / CHANNELS;
  const dim3 grid(nblk, batch);
  auto kernel = wide ? selective_scan_bwd_kernel<T, L, true> : selective_scan_bwd_kernel<T, L, false>;
  kernel<<<grid, CHANNELS * L, 0, s>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(c), static_cast<const float*>(A), static_cast<const float*>(saved),
      static_cast<const T*>(gy), static_cast<const float*>(ght), static_cast<T*>(gdt),
      static_cast<T*>(gx), static_cast<float*>(gh0), part_bc, part_a, t_len, di, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int rows = batch * t_len;
  selective_scan_bwd_sum_bc<T><<<2 * rows, dim3(n, SUM_CHUNKS), 0, s>>>(
      part_bc, static_cast<T*>(gbm), static_cast<T*>(gc), rows, nblk, n);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long elems = (long long)di * n;
  selective_scan_bwd_sum_a<<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(
      part_a, static_cast<float*>(ga), batch, elems);
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
// f32, and gh0 (batch, di, n) f32 unless null.  scratch: scratch_floats
// = 2 batch t_len blocks n + batch di n f32 (blocks = ceil(di /
// CHANNELS)).  Three kernels, no atomics: two calls give the same bits.
extern "C" int selective_scan_bwd_launch(const void* dt, const void* x, const void* bm,
                                         const void* c, const void* A, const void* saved,
                                         const void* gy, const void* ght, void* gdt, void* gx,
                                         void* gbm, void* gc, void* ga, void* gh0, void* scratch,
                                         long long scratch_floats, int batch, int t_len, int di,
                                         int n, int dtype, int lanes, int channels, int steps,
                                         int wide, void* stream) {
  if (int err = check_plan(batch, t_len, di, n, dtype, lanes, channels, steps, wide)) return err;
  const long long nblk = (di + CHANNELS - 1) / CHANNELS;
  const long long bc = 2LL * batch * t_len * nblk * n;
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
