// WKV6, the RWKV-6 recurrence, forward and backward on Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/wkv.py:wkv6 (pallas_call at
// :70, body _wkv_kernel at :33).  Per (batch b, head h), over time t, with
// an (N, N) f32 state S from zero:
//
//     a_t = k_t^T v_t
//     y_t = r_t (S + diag(u) a_t)
//     S  <- diag(w_t) S + a_t
//
// r, k, v (B, H, T, N) in f32 or bf16; w (B, H, T, N) and u (H, N) in f32;
// y in r's dtype, all arithmetic in f32.  The JAX package differentiates
// through its pallas_call; a launched CUDA kernel has no autograd, so the
// backward is a set of kernels of its own computing the same VJP
// (kernels/ref.py:ref_wkv_bwd).  With S_t the state after step t (S_0 = 0)
// and G_t the gradient flowing into S_t from later steps (G_T = 0):
//
//     G_{t-1} = diag(w_t) G_t + r_t gy_t^T
//     gr_t[n] = sum_m S_{t-1}[n,m] gy_t[m] + u[n] k_t[n] (v_t . gy_t)
//     gk_t[n] = sum_m G_t[n,m] v_t[m]     + u[n] r_t[n] (v_t . gy_t)
//     gv_t[m] = sum_n k_t[n] G_t[n,m]     + gy_t[m] sum_n u[n] r_t[n] k_t[n]
//     gw_t[n] = sum_m G_t[n,m] S_{t-1}[n,m]
//     gu[h,n] = sum_{b,t} r_t[n] k_t[n] (v_t . gy_t)
//
// Time split across blocks.  The TPU kernel carries S across a sequential
// grid axis in VMEM; Hopper's blocks run in no order, so nothing carries
// over between them.  The decay is diagonal, so a chunk of L steps moves
// the state by S_end = diag(W_c) S_start + Lambda_c, with W_c the product of
// the chunk's decays and Lambda_c its state from zero.  Three phases:
// (A) every chunk computes Lambda_c and W_c in parallel (wkv6_walk_kernel,
// LOCAL); (B) a scan over the chunks in order gives each chunk's S_start
// (wkv6_scan_kernel); (C) every chunk replays its steps from S_start
// (wkv6_walk_kernel writing y).  There is no division anywhere: a product
// of decays that underflows to 0 is the right answer.  G follows the same
// recurrence backwards in time with (r, gy) in place of (k, v), so the
// backward runs phases A and B in both directions in one launch each, and
// gv_t, a sum down a column of G like y_t down a column of S, is the
// forward's phase C run backwards with (k, r, gy) in place of (r, k, v).
// gr, gk and gw are sums along a row of S and G: wkv6_rows_kernel replays
// the chunk's states from S_start, keeping the state entering every 8
// steps in shared memory, then walks back from G_end a tile at a time,
// replaying 8 steps of states at a time into registers.  gu is summed per
// (b, h, chunk) and then over (b, chunk) in a fixed order by a small
// kernel: no atomics, so a call repeats its bits.  One chunk (T <= L) is
// the serial algorithm: phases A and B are skipped.
//
// The chunk length L comes from (T, N, dtype) only (wkv_chunk below,
// kernels/wkv.py:wkv_chunk), never from the data or the SM count, so every
// launch is the same for a shape and can be captured in a CUDA graph.
//
// What bounds the simple form on this card is not arithmetic but shared-
// memory reads and latency: a thread that owns one column (or row) of the
// state reads every row value per element per step.  So a thread owns a
// tile of rows x columns (walk 8 x 4, rows kernel 2 x 4 at N = 64), each
// value it reads serving several elements; sums over the lanes of a tile
// row or column end in one reduce-scatter a step (walk) or a sub-tile of 8
// steps (rows kernel), after which each lane stores the sums it holds.  The
// rows of r, k, v, w and gy of the next tile are copied raw into shared
// memory by cp.async while the current tile is consumed, then widened to
// f32 once per block (not once per thread), with the per-step scalars
// u.r.k and v.gy summed in the same pass.
//
// No tensor cores.  The chunked matrix form needs pairwise decay products
// within a chunk; as ratios of cumulative products they overflow or lose
// every digit at decays near 6e-4, and TF32 or bf16 products of the state
// would break the f32 gates of chip_smoke.py (loss 1e-5, gradients 1e-4).
// The bound stays the f32 rate: 4 N^2 operations per (b, h, t) forward,
// 12 N^2 backward (67 TFLOP/s: 5.0 us and 15.0 us at B=8 H=40 T=64 N=64).
//
// Scratch per call (allocated by the wrapper, kernels/wkv.py:
// scratch_floats): forward B*H*(C-1)*(N^2+N) f32 for C = ceil(T/L) chunks,
// backward twice that plus B*H*C*N for gu: 80 KB of the backward at the
// training shape (one chunk), 41.6 MB at B=1 H=40 T=4096 N=64 (L = 128).
#include "common.cuh"
#include "tc.cuh"

#include <initializer_list>

namespace {

constexpr int SUB = 8;          // steps of states the rows kernel replays into registers
constexpr int MAX_CHUNK = 128;  // the rows kernel keeps a state every SUB steps in shared memory

// The chunk length: a function of (T, N, dtype: 0 f32, 1 bf16) only, a
// multiple of 16 (every staged tile) no larger than MAX_CHUNK.  128 at
// N = 64: up to T = 128 one chunk, since phases A and B cost more than the
// blocks they add, and the fastest of 16-128 at T = 4096; 16 at N = 16,
// whose 8-32 (b, h) pairs leave the card idle without the split
// (tools/wkv_table.py --sweep, PERF.md).  kernels/wkv.py:wkv_chunk holds
// the same table; the entry points refuse any other value.
// REPRO_WKV_CHUNK overrides it in a build made to time other lengths.
constexpr int wkv_chunk(int t, int n, int dtype) {
#ifdef REPRO_WKV_CHUNK
  return (void)t, (void)n, (void)dtype, REPRO_WKV_CHUNK;
#else
  return (void)t, (void)dtype, n == 64 ? 128 : 16;
#endif
}

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Rows [0, TS) of one array (row stride `stride` elements), WIDTH elements
// each, copied raw into `dst` (TS x WIDTH, dense) by 16-byte cp.async; rows
// at or past `valid` are zero-filled and not read.
template <int TS, int WIDTH, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int stride, int valid) {
  constexpr int CPR = WIDTH * (int)sizeof(T) / 16;
  static_assert(CPR * 16 == WIDTH * (int)sizeof(T), "rows of whole 16-byte chunks");
#pragma unroll
  for (int it = 0; it < (TS * CPR + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (TS * CPR % THREADS != 0 && i >= TS * CPR) break;
    const int row = i / CPR, ch = i % CPR;
    const bool ok = row < valid;
    const char* s = reinterpret_cast<const char*>(src + (size_t)(ok ? row : 0) * stride) + ch * 16;
    cp_async16(smem_addr(reinterpret_cast<char*>(dst) + i * 16), s, ok ? 16 : 0);
  }
}

// Walk `visits` tiles with a two-deep ring: stage(i, buf) issues visit i's
// cp.async into raw buffer buf, convert(i, buf) widens it into f32 buffer
// buf, compute(i, buf) consumes it.  Visit i + 2 is in flight while visit i
// is computed.  Every thread of the block calls it.
template <class Stage, class Convert, class Compute>
__device__ __forceinline__ void pipeline(int visits, Stage stage, Convert convert, Compute compute) {
  stage(0, 0);
  cp_async_commit();
  if (visits > 1) stage(1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  convert(0, 0);
  __syncthreads();
  for (int i = 0; i < visits; ++i) {
    const int b = i & 1;
    if (i + 2 < visits) stage(i + 2, b);  // raw[b] was widened before the last barrier
    cp_async_commit();
    compute(i, b);
    cp_async_wait<1>();  // visit i + 1 has landed
    __syncthreads();
    if (i + 1 < visits) convert(i + 1, b ^ 1);
    __syncthreads();
  }
}

// Lanes of one warp over a row of N elements: E elements a lane, LPS lanes
// a step, SPW steps a warp at once (N = 16: two steps, 16 lanes each).
template <int N>
struct RowLanes {
  static constexpr int E = N >= 32 ? N / 32 : 1, LPS = N >= 32 ? 32 : N, SPW = 32 / LPS;
  __device__ __forceinline__ static int elem(int lane, int e) { return lane % LPS + 32 * e; }
  __device__ __forceinline__ static float sum(float x) {
#pragma unroll
    for (int off = LPS / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  }
};

// V partial sums on each of P consecutive lanes (g = lane % P) become
// V / P full sums a lane: lane g ends with the sums of indices
// [g * V / P, (g + 1) * V / P) in v[0 .. V / P), in a fixed order.  Each
// step sends half of what is left to the partner lane: V - V / P shuffles
// instead of V log2(P).
template <int V, int P, int O = P / 2>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int g) {
  if constexpr (O >= 1) {
    constexpr int HALF = V * O / P;  // values kept after this step
    const bool hi = g & O;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = hi ? v[i] : v[i + HALF];
      const float keep = hi ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_scatter<V, P, O / 2>(v, g);
  }
}

// R consecutive floats from shared memory (R a multiple of 2, aligned).
template <int R>
__device__ __forceinline__ void lds(float (&out)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x, out[i + 1] = x.y, out[i + 2] = x.z, out[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      out[i] = x.x, out[i + 1] = x.y;
    }
  }
}

// ---------------------------------------------------------------------------
// The walk: one block per (chunk, b*h).  A thread owns RT rows x CT columns
// of the state, so each row value it reads from shared memory serves CT
// state elements and each column value RT: reads, not arithmetic, bound a
// walk that reads a row per element.  Forward (rev = 0): (p, q, x) =
// (r, k, v), out_t[m] = y_t[m], from S_start.  Backward (rev = 1): (p, q, x)
// = (k, r, gy), time reversed, out_t = gv_t, from G_end.  Both: out_t[m] =
// sum_n p_t[n] X[n,m] + x_t[m] (u.r_t.k_t), then X <- diag(w_t) X +
// q_t x_t^T; the column sums run over the RGS lanes of a column group.
// LOCAL: phase A, X from zero, no output, the chunk's X and decay product
// written to the scratch.
// ---------------------------------------------------------------------------
template <typename T, int N>
struct WalkTile {
  static constexpr int RT = N == 64 ? 8 : 4, CT = N == 64 ? 4 : 2;  // rows, columns a thread
  static constexpr int RGS = N / RT, CGS = N / CT, THREADS = RGS * CGS;
  static constexpr int TS = N == 64 ? 8 : 16;  // steps a staged tile
  static constexpr int SEG = RT + (RT % 4 == 0 ? 4 : 2), NP = RGS * SEG;
  static constexpr int RAW_BYTES = TS * N * (3 * (int)sizeof(T) + 4);  // p, q, x raw; w f32
  static constexpr int F32_FLOATS = round4(TS * (3 * NP + N + 1));     // P, Q, W padded; X; u.r.k
  static constexpr int SMEM = 2 * RAW_BYTES + 2 * F32_FLOATS * 4;
  // Lane rg's rows [rg*RT, rg*RT + RT) sit at rg*SEG: the lanes of a column
  // group read their rows from different banks.
  __device__ __forceinline__ static int pad(int n) { return n / RT * SEG + n % RT; }
};

template <typename T, int N, bool LOCAL>
__global__ void __launch_bounds__(WalkTile<T, N>::THREADS)
wkv6_walk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ gy, const float* __restrict__ w, const float* __restrict__ u,
                 T* __restrict__ out, float* __restrict__ states, float* __restrict__ decays,
                 int heads, int steps, int chunk, int nchunks, int rev0) {
  using WT = WalkTile<T, N>;
  constexpr int RT = WT::RT, CT = WT::CT, RGS = WT::RGS, SEG = WT::SEG, NP = WT::NP, THREADS = WT::THREADS;
  constexpr int TS = WT::TS;
  using RL = RowLanes<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rev = rev0 + blockIdx.z;
  const int bh = blockIdx.y, slots = nchunks - 1;
  const int c = LOCAL ? blockIdx.x + rev : blockIdx.x;  // phase A: chunks [0, C-1) or [1, C)
  const int t0 = c * chunk, len = min(chunk, steps - t0), tiles = (len + TS - 1) / TS;
  const size_t base = ((size_t)bh * steps + t0) * N;
  const T* P = rev ? k : r;
  const T* Q = rev ? r : k;
  const T* X = rev ? gy : v;
  const int tid = threadIdx.x, cg = tid / RGS, rg = tid % RGS;
  const int lane = tid & 31, warp = tid >> 5;
  float ur[RL::E];  // u at this lane's elements of a row, for u.r.k
#pragma unroll
  for (int e = 0; e < RL::E; ++e) ur[e] = u[(bh % heads) * N + RL::elem(lane, e)];

  auto raw = [&](int b) { return smem + b * WT::RAW_BYTES; };
  auto f32 = [&](int b) { return reinterpret_cast<float*>(smem + 2 * WT::RAW_BYTES) + b * WT::F32_FLOATS; };
  auto tile_of = [&](int i) { return rev ? tiles - 1 - i : i; };
  auto valid_of = [&](int j) { return min(TS, len - j * TS); };

  auto stage = [&](int i, int b) {
    const int j = tile_of(i), valid = valid_of(j);
    const size_t off = base + (size_t)j * TS * N;
    T* rp = reinterpret_cast<T*>(raw(b));
    if (!LOCAL) stage_rows<TS, N, THREADS>(rp, P + off, N, valid);
    stage_rows<TS, N, THREADS>(rp + TS * N, Q + off, N, valid);
    stage_rows<TS, N, THREADS>(rp + 2 * TS * N, X + off, N, valid);
    stage_rows<TS, N, THREADS>(reinterpret_cast<float*>(rp + 3 * TS * N), w + off, N, valid);
  };
  auto convert = [&](int i, int b) {
    const int valid = valid_of(tile_of(i));
    const T* rp = reinterpret_cast<const T*>(raw(b));
    const float* rw = reinterpret_cast<const float*>(rp + 3 * TS * N);
    float* F = f32(b);
    static_assert(TS % ((THREADS / 32) * RL::SPW) == 0, "whole steps a warp");
#pragma unroll
    for (int it = 0; it < TS / ((THREADS / 32) * RL::SPW); ++it) {
      const int s = (it * (THREADS / 32) + warp) * RL::SPW + lane / RL::LPS;
      const bool ok = s < valid;  // padded steps: w = 1, the rest 0
      float urk = 0.f;
#pragma unroll
      for (int e = 0; e < RL::E; ++e) {
        const int n = RL::elem(lane, e), at = s * N + n;
        const float pv = (!LOCAL && ok) ? to_f32(rp[at]) : 0.f;
        const float qv = ok ? to_f32(rp[TS * N + at]) : 0.f;
        F[s * NP + WT::pad(n)] = pv;
        F[TS * NP + s * NP + WT::pad(n)] = qv;
        F[2 * TS * NP + s * NP + WT::pad(n)] = ok ? rw[at] : 1.f;
        F[3 * TS * NP + at] = ok ? to_f32(rp[2 * TS * N + at]) : 0.f;
        urk = fmaf(ur[e] * pv, qv, urk);
      }
      urk = RL::sum(urk);
      if (!LOCAL && lane % RL::LPS == 0) F[3 * TS * NP + TS * N + s] = urk;
    }
  };

  float xs[RT][CT];  // rows rg*RT + i, columns cg*CT + j
  float dp[RT];      // LOCAL, column group 0: the chunk's decay product
  // Phase A writes slot blockIdx.x; phase C reads S_start(c) at slot c - 1
  // (forward) or G_end(c) at slot c (backward).
  const bool has_start = !LOCAL && (rev ? c < nchunks - 1 : c > 0);
  const int slot = LOCAL ? (int)blockIdx.x : has_start ? (rev ? c : c - 1) : 0;
  const size_t slot_at = ((size_t)rev * gridDim.y + bh) * slots + slot;
  float* tile_at = states + slot_at * N * N + (size_t)(rg * RT) * N + cg * CT;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    dp[i] = 1.f;
#pragma unroll
    for (int j = 0; j < CT; ++j) xs[i][j] = has_start ? tile_at[i * N + j] : 0.f;
  }

  auto compute = [&](int i, int b) {
    const int j = tile_of(i), valid = valid_of(j);
    const float* F = f32(b);
#pragma unroll
    for (int ss = 0; ss < TS; ++ss) {
      const int s = rev ? TS - 1 - ss : ss;
      const float* ps = F + s * NP + rg * SEG;
      float qq[RT], ww[RT], xx[CT], acc[CT];
      lds(qq, ps + TS * NP);
      lds(ww, ps + 2 * TS * NP);
      lds(xx, F + 3 * TS * NP + s * N + cg * CT);
#pragma unroll
      for (int q = 0; q < CT; ++q) acc[q] = 0.f;
      if (!LOCAL) {
        float pp[RT];
        lds(pp, ps);
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int q = 0; q < CT; ++q) acc[q] = fmaf(pp[a], xs[a][q], acc[q]);
      } else if (cg == 0) {
#pragma unroll
        for (int a = 0; a < RT; ++a) dp[a] *= ww[a];
      }
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int q = 0; q < CT; ++q) xs[a][q] = fmaf(ww[a], xs[a][q], qq[a] * xx[q]);
      if (!LOCAL) {
        reduce_scatter<CT, CT>(acc, rg % CT);  // lane rg: column rg % CT of its group
#pragma unroll
        for (int o = CT; o < RGS; o *= 2) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
        const int m = cg * CT + rg % CT;
        if (rg < CT && s < valid)
          store_f32(out + base + (size_t)(j * TS + s) * N + m,
                    fmaf(F[3 * TS * NP + s * N + m], F[3 * TS * NP + TS * N + s], acc[0]));
      }
    }
  };
  pipeline(tiles, stage, convert, compute);

  if (LOCAL) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < CT; ++j) tile_at[i * N + j] = xs[i][j];
      if (cg == 0) decays[slot_at * N + rg * RT + i] = dp[i];
    }
  }
}

// Phase B: per (b*h, direction) and element of the N x N state, in chunk
// order (forward) or reverse chunk order (backward): X <- diag(W) X + local,
// each slot overwritten by the state it yields.  Slot i holds chunk i's
// (forward: the state entering chunk i + 1) or chunk i + 1's (backward: the
// gradient leaving chunk i) local state and decay product.
template <int N>
__global__ void wkv6_scan_kernel(float* __restrict__ states, const float* __restrict__ decays, int slots) {
  const int dir = blockIdx.z, bh = blockIdx.y;
  const size_t at = ((size_t)dir * gridDim.y + bh) * slots;
  float4* st = reinterpret_cast<float4*>(states + at * N * N);
  const float* dc = decays + at * N;
  const int e4 = blockIdx.x * blockDim.x + threadIdx.x, n = e4 * 4 / N;
  constexpr int Q4 = N * N / 4;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  int s = dir ? slots - 1 : 0;
  float4 l = st[(size_t)s * Q4 + e4];
  float d = dc[s * N + n];
  for (int i = 0; i < slots; ++i) {
    const int nxt = dir ? s - 1 : s + 1;
    float4 l2 = l;
    float d2 = d;
    if (i + 1 < slots) {  // the next slot's loads do not wait for this one's result
      l2 = st[(size_t)nxt * Q4 + e4];
      d2 = dc[nxt * N + n];
    }
    x = make_float4(fmaf(d, x.x, l.x), fmaf(d, x.y, l.y), fmaf(d, x.z, l.z), fmaf(d, x.w, l.w));
    st[(size_t)s * Q4 + e4] = x;
    s = nxt;
    l = l2;
    d = d2;
  }
}

// ---------------------------------------------------------------------------
// gr, gk, gw and gu's partials: one block per (chunk, 16 rows, b*h).  A
// thread owns RT rows x CT columns of S and of G.  Visits the staged tiles
// 0..J-1 (S from S_start: gr, and the S entering each SUB steps kept in
// shared memory), then J-1..0: each SUB steps of the tile, last first,
// replay their states into registers, then walk G back over them (gk,
// gw).  A sub-tile's row sums are summed over the row group's CGS
// lanes by one reduce-scatter, after which each lane stores the (step,
// row) sums it holds.
// ---------------------------------------------------------------------------
template <typename T, int N>
struct RowTile {
  static constexpr int RG = 16, RT = 2, CT = 4;  // rows a block; rows, columns a thread
  static constexpr int CGS = N / CT, THREADS = RG / RT * CGS, GROUPS = N / RG;
  static constexpr int TS = 16;                     // steps a staged tile: SUB-step sub-tiles
  static constexpr int EL = RT * CT, V = SUB * RT;  // state elements a thread; row sums a sub-tile
  static constexpr int RAW_BYTES = TS * (2 * RG * (int)sizeof(T) + RG * 4 + 2 * N * (int)sizeof(T));
  static constexpr int F32_FLOATS = round4(TS * (3 * RG + 2 * N + 1));  // R, K, W; V, G; v.gy
  static constexpr int BND_FLOATS = EL * THREADS;                       // one state of the block's rows
  static constexpr int smem(int chunk) { return 2 * RAW_BYTES + 2 * F32_FLOATS * 4 + chunk / SUB * BND_FLOATS * 4; }
};

template <typename T, int N>
__global__ void __launch_bounds__(RowTile<T, N>::THREADS)
wkv6_rows_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ u, const T* __restrict__ gy,
                 T* __restrict__ gr, T* __restrict__ gk, float* __restrict__ gw, float* __restrict__ gu_part,
                 const float* __restrict__ states, int heads, int steps, int chunk, int nchunks) {
  using RTl = RowTile<T, N>;
  constexpr int RG = RTl::RG, RT = RTl::RT, CT = RTl::CT, CGS = RTl::CGS, THREADS = RTl::THREADS;
  constexpr int TS = RTl::TS, V = RTl::V, VL = V / CGS;  // row sums a lane stores
  static_assert(V % CGS == 0 && TS % SUB == 0, "row sums spread evenly over the lanes");
  using RL = RowLanes<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x / RTl::GROUPS, g = blockIdx.x % RTl::GROUPS;
  const int bh = blockIdx.y, slots = nchunks - 1;
  const int t0 = c * chunk, len = min(chunk, steps - t0), tiles = (len + TS - 1) / TS;
  const size_t base = ((size_t)bh * steps + t0) * N;
  const int tid = threadIdx.x, rgl = tid / CGS, cg = tid % CGS;
  const int lane = tid & 31, warp = tid >> 5;
  const float* uh = u + (bh % heads) * N + g * RG;

  auto raw = [&](int b) { return smem + b * RTl::RAW_BYTES; };
  auto f32 = [&](int b) { return reinterpret_cast<float*>(smem + 2 * RTl::RAW_BYTES) + b * RTl::F32_FLOATS; };
  float* bnd = reinterpret_cast<float*>(smem + 2 * RTl::RAW_BYTES) + 2 * RTl::F32_FLOATS;
  auto tile_of = [&](int i) { return i < tiles ? i : 2 * tiles - 1 - i; };
  auto valid_of = [&](int j) { return min(TS, len - j * TS); };

  // raw: r, k (TS x RG), v, gy (TS x N) in T; w (TS x RG) f32.
  auto stage = [&](int i, int b) {
    const int j = tile_of(i), valid = valid_of(j);
    const size_t off = base + (size_t)j * TS * N;
    T* rp = reinterpret_cast<T*>(raw(b));
    stage_rows<TS, RG, THREADS>(rp, r + off + g * RG, N, valid);
    stage_rows<TS, RG, THREADS>(rp + TS * RG, k + off + g * RG, N, valid);
    stage_rows<TS, N, THREADS>(rp + 2 * TS * RG, v + off, N, valid);
    stage_rows<TS, N, THREADS>(rp + 2 * TS * RG + TS * N, gy + off, N, valid);
    stage_rows<TS, RG, THREADS>(reinterpret_cast<float*>(rp + 2 * TS * RG + 2 * TS * N), w + off + g * RG, N,
                                valid);
  };
  // f32: R, K, W (TS x RG), V, G (TS x N), v.gy (TS).
  auto convert = [&](int i, int b) {
    const int valid = valid_of(tile_of(i));
    const T* rp = reinterpret_cast<const T*>(raw(b));
    const float* rw = reinterpret_cast<const float*>(rp + 2 * TS * RG + 2 * TS * N);
    float* F = f32(b);
    static_assert(TS * RG % THREADS == 0 && TS % ((THREADS / 32) * RL::SPW) == 0, "whole rows a thread");
#pragma unroll
    for (int it = 0; it < TS * RG / THREADS; ++it) {
      const int at = it * THREADS + tid;
      const bool ok = at / RG < valid;
      F[at] = ok ? to_f32(rp[at]) : 0.f;
      F[TS * RG + at] = ok ? to_f32(rp[TS * RG + at]) : 0.f;
      F[2 * TS * RG + at] = ok ? rw[at] : 1.f;
    }
    float* FV = F + 3 * TS * RG;
#pragma unroll
    for (int it = 0; it < TS / ((THREADS / 32) * RL::SPW); ++it) {
      const int s = (it * (THREADS / 32) + warp) * RL::SPW + lane / RL::LPS;
      const bool ok = s < valid;
      float vg = 0.f;
#pragma unroll
      for (int e = 0; e < RL::E; ++e) {
        const int m = RL::elem(lane, e), at = s * N + m;
        const float vv = ok ? to_f32(rp[2 * TS * RG + at]) : 0.f;
        const float gg = ok ? to_f32(rp[2 * TS * RG + TS * N + at]) : 0.f;
        FV[at] = vv;
        FV[TS * N + at] = gg;
        vg = fmaf(vv, gg, vg);
      }
      vg = RL::sum(vg);
      if (lane % RL::LPS == 0) FV[2 * TS * N + s] = vg;
    }
  };

  float sv[RT][CT], gv[RT][CT];  // rows g*RG + rgl*RT + i, columns cg*CT + j, of S and of G
  {
    const size_t tile = (size_t)(g * RG + rgl * RT) * N + cg * CT;
    const float* s0 = states + ((size_t)bh * slots + (c > 0 ? c - 1 : 0)) * N * N + tile;
    const float* g0 = states + (((size_t)gridDim.y + bh) * slots + c) * N * N + tile;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        sv[i][j] = c > 0 ? s0[i * N + j] : 0.f;            // S_start(c): forward slot c - 1
        gv[i][j] = c < nchunks - 1 ? g0[i * N + j] : 0.f;  // G_end(c): backward slot c
      }
  }
  float gu_acc = 0.f;  // threads tid < RG: row g*RG + tid

  // One step of S <- diag(w) S + k v^T on this thread's tile.
  auto advance = [&](const float* F, int s, float (&x)[RT][CT]) {
    float kk[RT], ww[RT], vv[CT];
    lds(kk, F + TS * RG + s * RG + rgl * RT);
    lds(ww, F + 2 * TS * RG + s * RG + rgl * RT);
    lds(vv, F + 3 * TS * RG + s * N + cg * CT);
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int q = 0; q < CT; ++q) x[a][q] = fmaf(ww[a], x[a][q], kk[a] * vv[q]);
  };

  auto compute = [&](int i, int b) {
    const int j = tile_of(i), valid = valid_of(j);
    const float* F = f32(b);
    const float* FV = F + 3 * TS * RG;
    // The state entering sub-tile h of tile j.
    auto keep = [&](int h) { return bnd + (size_t)(j * (TS / SUB) + h) * RTl::BND_FLOATS + tid; };
    if (i < tiles) {  // forward: gr, and the state entering each sub-tile
#pragma unroll
      for (int h = 0; h < TS / SUB; ++h) {
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int q = 0; q < CT; ++q) keep(h)[(a * CT + q) * THREADS] = sv[a][q];
        float part[V];  // (step, row) sums of S_{t-1} gy_t over this thread's columns
#pragma unroll
        for (int st = 0; st < SUB; ++st) {
          const int s = h * SUB + st;
          float gg[CT];
          lds(gg, FV + TS * N + s * N + cg * CT);
#pragma unroll
          for (int a = 0; a < RT; ++a) {
            float p = 0.f;
#pragma unroll
            for (int q = 0; q < CT; ++q) p = fmaf(sv[a][q], gg[q], p);
            part[st * RT + a] = p;
          }
          advance(F, s, sv);
        }
        reduce_scatter<V, CGS>(part, cg);
#pragma unroll
        for (int e = 0; e < VL; ++e) {
          const int at = cg * VL + e, s = h * SUB + at / RT, row = rgl * RT + at % RT;
          if (s < valid)
            store_f32(gr + base + (size_t)(j * TS + s) * N + g * RG + row,
                      fmaf(uh[row] * F[TS * RG + s * RG + row], FV[2 * TS * N + s], part[e]));
        }
      }
    } else {  // backward: each sub-tile, last first: replay its states, then gk, gw and G
#pragma unroll
      for (int h = TS / SUB - 1; h >= 0; --h) {
        float hist[SUB][RT][CT];
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int q = 0; q < CT; ++q) hist[0][a][q] = keep(h)[(a * CT + q) * THREADS];
#pragma unroll
        for (int st = 0; st + 1 < SUB; ++st) {
#pragma unroll
          for (int a = 0; a < RT; ++a)
#pragma unroll
            for (int q = 0; q < CT; ++q) hist[st + 1][a][q] = hist[st][a][q];
          advance(F, h * SUB + st, hist[st + 1]);
        }
        float pk[V], pw[V];
#pragma unroll
        for (int st = SUB - 1; st >= 0; --st) {
          const int s = h * SUB + st;
          float rr[RT], ww[RT], vv[CT], gg[CT];
          lds(rr, F + s * RG + rgl * RT);
          lds(ww, F + 2 * TS * RG + s * RG + rgl * RT);
          lds(vv, FV + s * N + cg * CT);
          lds(gg, FV + TS * N + s * N + cg * CT);
#pragma unroll
          for (int a = 0; a < RT; ++a) {
            float pa = 0.f, pb = 0.f;
#pragma unroll
            for (int q = 0; q < CT; ++q) {
              pa = fmaf(gv[a][q], vv[q], pa);
              pb = fmaf(gv[a][q], hist[st][a][q], pb);
              gv[a][q] = fmaf(ww[a], gv[a][q], rr[a] * gg[q]);
            }
            pk[st * RT + a] = pa;
            pw[st * RT + a] = pb;
          }
        }
        reduce_scatter<V, CGS>(pk, cg);
        reduce_scatter<V, CGS>(pw, cg);
#pragma unroll
        for (int e = 0; e < VL; ++e) {
          const int at = cg * VL + e, s = h * SUB + at / RT, row = rgl * RT + at % RT;
          if (s < valid) {
            const size_t o = base + (size_t)(j * TS + s) * N + g * RG + row;
            store_f32(gk + o, fmaf(uh[row] * F[s * RG + row], FV[2 * TS * N + s], pk[e]));
            gw[o] = pw[e];
          }
        }
      }
      if (tid < RG) {  // gu: sum of r k (v.gy) over the tile, padded steps 0
#pragma unroll
        for (int s = 0; s < TS; ++s)
          gu_acc = fmaf(F[s * RG + tid] * F[TS * RG + s * RG + tid], FV[2 * TS * N + s], gu_acc);
      }
    }
  };
  pipeline(2 * tiles, stage, convert, compute);
  if (tid < RG) gu_part[((size_t)bh * nchunks + c) * N + g * RG + tid] = gu_acc;
}

// gu[h, n] = sum over b, then over chunks, in order, of the partials (B, H, C, N).
__global__ void wkv6_gu_reduce_kernel(const float* __restrict__ part, float* __restrict__ gu, int batch,
                                      int heads, int nchunks, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= heads * n) return;
  const int h = idx / n, i = idx % n;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b)
    for (int c = 0; c < nchunks; ++c) acc += part[(((size_t)b * heads + h) * nchunks + c) * n + i];
  gu[idx] = acc;
}

// Scratch layout: states [dir][b*h][C-1][N][N], then decays [dir][b*h][C-1][N]
// (dir 0 the forward state, dir 1 the backward's gradient), then, for the
// backward, gu's partials [b*h][C][N].
long long scratch_floats(int bh, int nchunks, int n, bool backward) {
  const long long dirs = backward ? 2 : 1;
  const long long per = (long long)bh * (nchunks - 1) * (n * n + n);
  return dirs * per + (backward ? (long long)bh * nchunks * n : 0);
}

// Above 48 KB a kernel's dynamic shared memory must be allowed, once.
template <auto KERNEL>
int allow_smem(int bytes) {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

template <int N>
void launch_scan(float* st, const float* dc, int bh, int dirs, int slots, cudaStream_t s) {
  constexpr int Q4 = N * N / 4, TPB = Q4 < 256 ? Q4 : 256;
  wkv6_scan_kernel<N><<<dim3(Q4 / TPB, bh, dirs), TPB, 0, s>>>(st, dc, slots);
}

#define WKV6_CHECK()                                  \
  do {                                                \
    const cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;            \
  } while (0)

template <typename T, int N>
int launch_fwd(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
               float* scratch, int b, int h, int t, int chunk, cudaStream_t s) {
  using WT = WalkTile<T, N>;
  const int bh = b * h, nchunks = (t + chunk - 1) / chunk;
  float* st = scratch;
  float* dc = scratch + (size_t)bh * (nchunks - 1) * N * N;
  const T *R = static_cast<const T*>(r), *K = static_cast<const T*>(k), *V = static_cast<const T*>(v);
  const float *W = static_cast<const float*>(w), *U = static_cast<const float*>(u);
  if (nchunks > 1) {
    wkv6_walk_kernel<T, N, true><<<dim3(nchunks - 1, bh, 1), WT::THREADS, WT::SMEM, s>>>(
        R, K, V, nullptr, W, U, nullptr, st, dc, h, t, chunk, nchunks, 0);
    WKV6_CHECK();
    launch_scan<N>(st, dc, bh, 1, nchunks - 1, s);
    WKV6_CHECK();
  }
  wkv6_walk_kernel<T, N, false><<<dim3(nchunks, bh, 1), WT::THREADS, WT::SMEM, s>>>(
      R, K, V, nullptr, W, U, static_cast<T*>(y), st, dc, h, t, chunk, nchunks, 0);
  WKV6_CHECK();
  return 0;
}

template <typename T, int N>
int launch_bwd(const void* r, const void* k, const void* v, const void* w, const void* u, const void* gy,
               void* gr, void* gk, void* gv, void* gw, void* gu, float* scratch, int b, int h, int t,
               int chunk, cudaStream_t s) {
  using WT = WalkTile<T, N>;
  using RT = RowTile<T, N>;
  static_assert(WT::SMEM <= 48 * 1024, "the walk stays under the default shared-memory limit");
  if (int e = allow_smem<wkv6_rows_kernel<T, N>>(RT::smem(MAX_CHUNK))) return e;
  const int bh = b * h, nchunks = (t + chunk - 1) / chunk;
  float* st = scratch;
  float* dc = scratch + 2 * (size_t)bh * (nchunks - 1) * N * N;
  float* gu_part = dc + 2 * (size_t)bh * (nchunks - 1) * N;
  const T *R = static_cast<const T*>(r), *K = static_cast<const T*>(k), *V = static_cast<const T*>(v);
  const T* GY = static_cast<const T*>(gy);
  const float *W = static_cast<const float*>(w), *U = static_cast<const float*>(u);
  if (nchunks > 1) {  // phases A and B, forward (z = 0) and backward (z = 1)
    wkv6_walk_kernel<T, N, true><<<dim3(nchunks - 1, bh, 2), WT::THREADS, WT::SMEM, s>>>(
        R, K, V, GY, W, U, nullptr, st, dc, h, t, chunk, nchunks, 0);
    WKV6_CHECK();
    launch_scan<N>(st, dc, bh, 2, nchunks - 1, s);
    WKV6_CHECK();
  }
  wkv6_walk_kernel<T, N, false><<<dim3(nchunks, bh, 1), WT::THREADS, WT::SMEM, s>>>(
      R, K, V, GY, W, U, static_cast<T*>(gv), st, dc, h, t, chunk, nchunks, 1);
  WKV6_CHECK();
  wkv6_rows_kernel<T, N><<<dim3(nchunks * RT::GROUPS, bh), RT::THREADS, RT::smem(chunk), s>>>(
      R, K, V, W, U, GY, static_cast<T*>(gr), static_cast<T*>(gk), static_cast<float*>(gw), gu_part, st, h,
      t, chunk, nchunks);
  WKV6_CHECK();
  const int hn = h * N;
  wkv6_gu_reduce_kernel<<<(hn + 127) / 128, 128, 0, s>>>(gu_part, static_cast<float*>(gu), b, h, nchunks, N);
  WKV6_CHECK();
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The checks every entry point makes: sizes, the chunk the table gives,
// 16-byte aligned rows for cp.async, and scratch enough for the layout.
bool accept(int b, int h, int t, int n, int dtype, int chunk, long long have, bool backward,
            std::initializer_list<const void*> staged) {
  if (b <= 0 || h <= 0 || t <= 0 || (n != 16 && n != 64) || (dtype != 0 && dtype != 1)) return false;
  if (chunk != wkv_chunk(t, n, dtype) || chunk % 16 != 0 || chunk <= 0 || chunk > MAX_CHUNK) return false;
  for (const void* p : staged)
    if (!aligned16(p)) return false;
  return have >= scratch_floats(b * h, (t + chunk - 1) / chunk, n, backward);
}

}  // namespace

// Tensors contiguous, r, k, v, w (and gy) 16-byte aligned; dtype of r, k, v,
// y (and gy, gr, gk, gv) 0 = f32, 1 = bf16; w, u, gw, gu f32; head size n
// 16 or 64; `chunk` must be wkv_chunk(t, n, dtype) and `scratch` hold
// `scratch_floats` f32 (at least kernels/wkv.py:scratch_floats).  Returns a
// CUDA error code (0 = success).
extern "C" int wkv6_fwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                               void* y, void* scratch, long long scratch_floats, int b, int h, int t, int n,
                               int dtype, int chunk, void* stream) {
  if (!accept(b, h, t, n, dtype, chunk, scratch_floats, false, {r, k, v, w}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0 && n == 16) return launch_fwd<float, 16>(r, k, v, w, u, y, sc, b, h, t, chunk, s);
  if (dtype == 0) return launch_fwd<float, 64>(r, k, v, w, u, y, sc, b, h, t, chunk, s);
  if (n == 16) return launch_fwd<__nv_bfloat16, 16>(r, k, v, w, u, y, sc, b, h, t, chunk, s);
  return launch_fwd<__nv_bfloat16, 64>(r, k, v, w, u, y, sc, b, h, t, chunk, s);
}

extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                               const void* gy, void* gr, void* gk, void* gv, void* gw, void* gu,
                               void* scratch, long long scratch_floats, int b, int h, int t, int n,
                               int dtype, int chunk, void* stream) {
  if (!accept(b, h, t, n, dtype, chunk, scratch_floats, true, {r, k, v, w, gy}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
#define WKV6_BWD(T, N) launch_bwd<T, N>(r, k, v, w, u, gy, gr, gk, gv, gw, gu, sc, b, h, t, chunk, s)
  if (dtype == 0 && n == 16) return WKV6_BWD(float, 16);
  if (dtype == 0) return WKV6_BWD(float, 64);
  if (n == 16) return WKV6_BWD(__nv_bfloat16, 16);
  return WKV6_BWD(__nv_bfloat16, 64);
#undef WKV6_BWD
}

REPRO_EXPORT_ERROR_STRING(wkv6)
