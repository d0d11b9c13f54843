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
// bound.
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
  static constexpr int NSP = SPT * L;
  static constexpr int HS = CHANNELS * NSP + 4;   // floats a step of hs
  __align__(16) T raw_dt[RING][STEPS][CHANNELS];
  __align__(16) T raw_x[RING][STEPS][CHANNELS];
  __align__(16) T raw_b[RING][STEPS * NSP];   // STEPS rows of N, dense
  __align__(16) T raw_c[RING][STEPS * NSP];
  __align__(16) float hs[2][STEPS * HS];   // tile i's walk writes hs[i % 2]
};

// Rows t0 .. t0 + steps of dt and x (the block's channels, from dtb and xb)
// and of B and C (from bb and cb) into ring slot `slot`: WIDE (rows of
// whole 16-byte chunks), 16-byte cp.async from straight-line code; else
// plain loads in rolled loops.  Channels past di and rows past T of dt and
// x are zero.
template <bool WIDE, typename T, int L>
__device__ __forceinline__ void stage(Smem<T, L>& sm, int slot, const T* dtb, const T* xb,
                                      const T* bb, const T* cb, int t0, int steps, int d0, int di,
                                      int n) {
  constexpr int THREADS = CHANNELS * L;
  const long long f0 = (long long)t0 * n;   // B and C of the tile: steps * n dense elements
  if constexpr (WIDE) {
    constexpr int EPC = 16 / (int)sizeof(T);         // elements a chunk
    constexpr int CPR = CHANNELS / EPC;              // chunks a row
    constexpr int NX = STEPS * CPR, NB = STEPS * Smem<T, L>::NSP / EPC;
    const int chunks = steps * n / EPC;              // n % EPC == 0
#pragma unroll
    for (int i0 = 0; i0 < NX; i0 += THREADS) {
      const int i = i0 + threadIdx.x, s = i / CPR, c = i % CPR;
      const bool ok = s < steps && d0 + c * EPC < di;   // di % EPC == 0: a chunk is whole
      const long long e = ok ? (long long)(t0 + s) * di + c * EPC : 0;
      if (NX % THREADS == 0 || i < NX) {
        cp_async16(smem_addr(&sm.raw_dt[slot][s][c * EPC]), dtb + e, ok ? 16 : 0);
        cp_async16(smem_addr(&sm.raw_x[slot][s][c * EPC]), xb + e, ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int i0 = 0; i0 < NB; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      if (i < chunks) {
        cp_async16(smem_addr(&sm.raw_b[slot][i * EPC]), bb + f0 + i * EPC, 16);
        cp_async16(smem_addr(&sm.raw_c[slot][i * EPC]), cb + f0 + i * EPC, 16);
      }
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < STEPS * CHANNELS; i += THREADS) {
      const int s = i / CHANNELS, c = i % CHANNELS;
      const bool ok = s < steps && d0 + c < di;
      const long long e = (long long)(t0 + s) * di + c;
      sm.raw_dt[slot][s][c] = ok ? dtb[e] : zero<T>();
      sm.raw_x[slot][s][c] = ok ? xb[e] : zero<T>();
    }
#pragma unroll 1
    for (int i = threadIdx.x; i < steps * n; i += THREADS) {
      sm.raw_b[slot][i] = bb[f0 + i];
      sm.raw_c[slot][i] = cb[f0 + i];
    }
  }
}

template <typename T, int L, bool WIDE>
__global__ void __launch_bounds__(CHANNELS * L)
    selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                          const T* __restrict__ cm, const float* __restrict__ A,
                          const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
                          int t_len, int di, int n) {
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
      const bool on = d < di && j0 + q < n;
      h[q] = on ? h0[st + q] : 0.f;
      a[q] = on ? A[at + q] : 0.f;
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
  if (whole) {
    store4(hT + st, h);
  } else {
#pragma unroll
    for (int q = 0; q < SPT; ++q)
      if (d < di && j0 + q < n) hT[st + q] = h[q];
  }
}

template <typename T, int L>
int launch(const void* dt, const void* x, const void* bm, const void* c, const void* A,
           const void* h0, void* y, void* hT, int batch, int t_len, int di, int n, bool wide,
           cudaStream_t s) {
  const dim3 grid((di + CHANNELS - 1) / CHANNELS, batch);
  auto kernel = wide ? selective_scan_kernel<T, L, true> : selective_scan_kernel<T, L, false>;
  kernel<<<grid, CHANNELS * L, 0, s>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(c), static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hT), t_len, di, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lanes(int lanes, const void* dt, const void* x, const void* bm, const void* c,
                 const void* A, const void* h0, void* y, void* hT, int batch, int t_len, int di,
                 int n, bool wide, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<T, 1>(dt, x, bm, c, A, h0, y, hT, batch, t_len, di, n, wide, s);
    case 2: return launch<T, 2>(dt, x, bm, c, A, h0, y, hT, batch, t_len, di, n, wide, s);
    default: return launch<T, 4>(dt, x, bm, c, A, h0, y, hT, batch, t_len, di, n, wide, s);
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// dt, x, y (batch, t_len, di) and bm, c (batch, t_len, n) in dtype 0 = f32
// or 1 = bf16; A (di, n), h0 and hT (batch, di, n) f32; all contiguous.
// 1 <= n <= 16; batch <= 65535.  The plan (kernels/selective_scan.py:
// scan_plan, a function of (di, n, dtype) alone): lanes = threads a
// channel (SPT states each, a power of two), channels = CHANNELS, steps =
// STEPS, wide = rows of di values and of n values are whole 16-byte chunks
// (16-byte cp.async of the inputs, 16-byte moves of A and the state); any
// other plan is refused.  With wide, every pointer must be 16-byte aligned.
extern "C" int selective_scan_launch(const void* dt, const void* x, const void* bm, const void* c,
                                     const void* A, const void* h0, void* y, void* hT, int batch,
                                     int t_len, int di, int n, int dtype, int lanes, int channels,
                                     int steps, int wide, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || di < 1 || n < 1 || n > MAX_STATE ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  if (lanes != lanes_for(n) || channels != CHANNELS || steps != STEPS ||
      wide != (di * es % 16 == 0 && n * es % 16 == 0))
    return (int)cudaErrorInvalidValue;
  if (wide && (misaligned(dt) || misaligned(x) || misaligned(bm) || misaligned(c) || misaligned(A) ||
               misaligned(h0) || misaligned(hT)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_lanes<float>(lanes, dt, x, bm, c, A, h0, y, hT, batch, t_len, di, n, wide, s)
             : launch_lanes<__nv_bfloat16>(lanes, dt, x, bm, c, A, h0, y, hT, batch, t_len, di, n,
                                           wide, s);
}

REPRO_EXPORT_ERROR_STRING(selective_scan)
