// GAMA GEMM on Hopper: C[M,N] = A[M,K] @ B[K,N], all row-major and contiguous.
//
// Replaces the Pallas kernel repro/kernels/gemm.py:gama_gemm (_gemm_kernel).
// What it computes is the same: f32 accumulation for f32/bf16 inputs (output
// in the input dtype, rounded once), exact int32 accumulation for int8 inputs
// with the output in int32, or in int16/int8 through the requant epilogue of
// gemm.py:56-60: (float)acc * scale in f32, round half to even (rintf),
// saturate.  Ragged M, K and N are masked here; callers never pad.
//
// Two kernels, chosen by dtype alone:
//   * bf16 and int8: gemm_tc_kernel, on the tensor cores (mma.sync m16n8k16
//     bf16 -> f32, m16n8k32 s8 -> s32).  Tiles stay in their input type in
//     shared memory, in a ring of 2-8 K chunks of 128 bytes a row, filled by
//     16-byte cp.async (zero-filled past the edges) while the MMAs of the
//     oldest chunk run.  A row pitch that is not 16-byte aligned (K or N not
//     a multiple of 16 bytes) is loaded element by element instead: that
//     changes how bytes reach shared memory, never the sum.
//   * f32: gemm_simt_kernel, FMA in f32.  The tensor cores take f32 only as
//     TF32 (10-bit mantissa), which would break the f32 check.
//
// Rows independent of the batch.  The serving engine's --verify holds a
// 3- or 8-slot replay bit for bit against a one-slot engine, so a row's
// result must not depend on how many rows ride with it.  The rule:
//   * the MMA instruction, the K chunk (128 bytes), the split of K into S
//     slices and their boundaries depend only on (K, N, dtype), never on M:
//     the plan (kernels/gemm.py:plan, splits_for) picks S from them, and
//     this file checks the plan;
//   * each slice is summed from zero, chunk by chunk and k16 (k32) step by
//     step in order, on the tensor core, whose result for one row does not
//     depend on the other rows of the fragment; the S slice sums are then
//     added in slice order 0..S-1;
//   * the row tile (16, 64 or 128), the column tile, the ring's depth and
//     whether the slices run in parallel (a cluster) or one after another
//     in one block may follow M: they decide which block computes an
//     element, not the order of its sum.
//
// Bound on the card.  At M <= 16 every weight byte is read once and does
// ~2M operations: the kernel is bound by device-memory bytes and has to keep
// loads in flight on all 132 SMs.  N / BN column tiles alone give 5-40
// blocks at SmolLM's projections, so K is split into S <= 8 slices, one
// block each, and the S blocks of one output tile form a thread-block
// cluster: after the K loop each block leaves its partial tile in shared
// memory, and the cluster adds them in rank (= slice) order through
// distributed shared memory.  No workspace, no counter, no float atomics,
// no second launch.  At M = 512 the weight is read M / BM times and the
// work sits near the bf16 ridge (~295 operations a byte): there mma.sync
// runs at about half of wgmma's rate and this kernel at a fraction of
// that; wgmma fed by TMA is the next form.
#include "common.cuh"
#include "tc.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

enum Epilogue { EPI_CAST = 0, EPI_REQUANT = 1 };

template <typename TOut, int EPI> struct Out;
template <> struct Out<__nv_bfloat16, EPI_CAST> {
  static __device__ __forceinline__ __nv_bfloat16 of(float acc, float) { return __float2bfloat16_rn(acc); }
};
template <> struct Out<int32_t, EPI_CAST> {
  static __device__ __forceinline__ int32_t of(int acc, float) { return acc; }
};
template <typename TOut> struct Out<TOut, EPI_REQUANT> {
  static __device__ __forceinline__ TOut of(int acc, float scale) {
    constexpr float lo = sizeof(TOut) == 1 ? -128.f : -32768.f;
    constexpr float hi = sizeof(TOut) == 1 ? 127.f : 32767.f;
    const float scaled = __fmul_rn((float)acc, scale);  // no contraction with the rounding
    return (TOut)(int)fminf(fmaxf(rintf(scaled), lo), hi);
  }
};

// ---------------------------------------------------------------------------
// f32: SIMT FMA.  One block owns a 16 x 64 output tile and walks K in steps
// of 64 through shared memory; each output is summed over k in order by one
// thread, with one tile shape for every M (row-independent).
// ---------------------------------------------------------------------------

constexpr int SBM = 16, SBN = 64, SBK = 64, STHREADS = 128;
constexpr int TM = 2, TN = 4;  // per-thread outputs: rows ty*TM + i, cols tx + 16*j
static_assert((SBM / TM) * (SBN / TN) == STHREADS, "thread layout");

__global__ void __launch_bounds__(STHREADS)
gemm_simt_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
            int M, int K, int N) {
  __shared__ float As[SBK][SBM + 1];  // A tile transposed; +1 avoids store bank conflicts
  __shared__ float Bs[SBK][SBN];
  const int tid = threadIdx.x;
  const int tx = tid % (SBN / TN);
  const int ty = tid / (SBN / TN);
  const int row0 = blockIdx.y * SBM;
  const int col0 = blockIdx.x * SBN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SBK) {
#pragma unroll
    for (int it = 0; it < SBM * SBK / STHREADS; ++it) {
      const int i = tid + it * STHREADS;
      const int r = i / SBK, c = i % SBK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[(size_t)gr * K + gc] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < SBK * SBN / STHREADS; ++it) {
      const int i = tid + it * STHREADS;
      const int r = i / SBN, c = i % SBN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[(size_t)gr * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + (SBN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + (SBN / TN) * j;
      if (c < N) C[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / int8: tensor cores.
// ---------------------------------------------------------------------------

constexpr int CHUNK_BYTES = 128;     // one K chunk: 64 bf16 or 128 int8 per row
constexpr int MIN_STAGES = 2, MAX_STAGES = 8;  // ring of K chunks in shared memory
constexpr int MAX_SPLITS = 8;        // portable cluster size
constexpr int PAD = 16;              // bytes after each shared row: ldmatrix rows hit distinct banks
constexpr int SMEM_LIMIT = 232448;   // shared memory one block may have on sm_90

template <typename T> struct TC;
template <> struct TC<__nv_bfloat16> {
  using Acc = float;
  static constexpr int KSTEP = 16;  // k of one mma
  static __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
};
template <> struct TC<int8_t> {
  using Acc = int;
  static constexpr int KSTEP = 32;
  static __device__ __forceinline__ int8_t zero() { return 0; }
};

// Shared-memory layout of one stage: A chunk [BM][CHUNK_BYTES + PAD], then
// B chunk [BK][BN * sizeof(T) + PAD] (B stays (K, N) row-major).  The
// block's f32/int32 partial tile [BM][BN + 4] lies after the ring while one
// block walks several slices, and over it once a cluster adds its blocks'
// slices; the output tile passes through the ring on its way out.
template <typename T, int BM, int BN>
struct Tile {
  static constexpr int BK = CHUNK_BYTES / (int)sizeof(T);
  static constexpr int A_PITCH = CHUNK_BYTES + PAD;              // bytes
  static constexpr int B_PITCH = BN * (int)sizeof(T) + PAD;      // bytes
  static constexpr int A_BYTES = BM * A_PITCH;
  static constexpr int STAGE_BYTES = A_BYTES + BK * B_PITCH;
  static constexpr int RED_PITCH = BN + 4;                       // partial tile, in Acc
  static constexpr int RED_BYTES = BM * RED_PITCH * 4;
  static constexpr int VEC = 16 / (int)sizeof(T);                // elements per cp.async
};

// Copies K chunks of A (rows row0..) and B (columns col0..) into ring
// stages.  vec_a / vec_b: the row pitch and base are 16-byte aligned, so
// 16-byte cp.async, zero-filled past the ragged edge; each thread's source
// pointers and shared offsets are set up once and advance by a chunk.
// Otherwise element by element.
template <typename T, int BM, int BN, int THREADS>
struct ChunkLoader {
  using L = Tile<T, BM, BN>;
  static constexpr int A_PER_ROW = CHUNK_BYTES / 16, A_RSTEP = THREADS / A_PER_ROW, A_ITERS = BM / A_RSTEP;
  static constexpr int B_PER_ROW = BN * (int)sizeof(T) / 16, B_RSTEP = THREADS / B_PER_ROW;
  static constexpr int B_ITERS = L::BK / B_RSTEP;
  static_assert(THREADS % A_PER_ROW == 0 && BM % A_RSTEP == 0, "A chunk loads");
  static_assert(THREADS % B_PER_ROW == 0 && L::BK % B_RSTEP == 0, "B chunk loads");

  const T* A;
  const T* B;
  int M, K, N, row0, col0;
  bool vec_a, vec_b;
  const T* a_src;    // this thread's first A element of chunk 0
  const T* b_src;    // ... and of B
  int a_rows;        // rows of A at and below this thread's first row
  int a_col, b_row;  // this thread's k offsets in a chunk
  bool b_col_in;
  uint32_t a_dst, b_dst;  // shared offsets within a stage

  __device__ __forceinline__ ChunkLoader(const T* A_, const T* B_, int M_, int K_, int N_, int row0_, int col0_,
                                         bool vec_a_, bool vec_b_)
      : A(A_), B(B_), M(M_), K(K_), N(N_), row0(row0_), col0(col0_), vec_a(vec_a_), vec_b(vec_b_) {
    const int tid = threadIdx.x;
    const int ar = tid / A_PER_ROW;
    a_col = (tid % A_PER_ROW) * L::VEC;
    a_rows = M - row0 - ar;
    a_src = A + (size_t)(row0 + (a_rows > 0 ? ar : 0)) * K + a_col;
    a_dst = ar * L::A_PITCH + a_col * (int)sizeof(T);
    b_row = tid / B_PER_ROW;
    const int bc = (tid % B_PER_ROW) * L::VEC;
    b_col_in = col0 + bc < N;
    b_src = B + (size_t)b_row * N + (b_col_in ? col0 + bc : 0);
    b_dst = L::A_BYTES + b_row * L::B_PITCH + bc * (int)sizeof(T);
  }

  __device__ __forceinline__ void load(char* stage, int chunk) const {
    const int k0 = chunk * L::BK;
    const uint32_t base = smem_addr(stage);
    if (vec_a) {
      const bool k_in = k0 + a_col < K;
#pragma unroll
      for (int it = 0; it < A_ITERS; ++it) {
        const bool in = k_in && it * A_RSTEP < a_rows;
        cp_async16(base + a_dst + it * A_RSTEP * L::A_PITCH, in ? a_src + (size_t)it * A_RSTEP * K + k0 : A,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = threadIdx.x; i < BM * L::BK; i += THREADS) {
        const int r = i / L::BK, c = i % L::BK;
        const int gr = row0 + r, gc = k0 + c;
        reinterpret_cast<T*>(stage + r * L::A_PITCH)[c] =
            (gr < M && gc < K) ? A[(size_t)gr * K + gc] : TC<T>::zero();
      }
    }
    if (vec_b) {
      const T* src = b_src + (size_t)k0 * N;
#pragma unroll
      for (int it = 0; it < B_ITERS; ++it) {
        const bool in = b_col_in && k0 + b_row + it * B_RSTEP < K;
        cp_async16(base + b_dst + it * B_RSTEP * L::B_PITCH, in ? src + (size_t)it * B_RSTEP * N : B, in ? 16 : 0);
      }
    } else {
      char* Bs = stage + L::A_BYTES;
#pragma unroll 4
      for (int i = threadIdx.x; i < L::BK * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const int gr = k0 + r, gc = col0 + c;
        reinterpret_cast<T*>(Bs + r * L::B_PITCH)[c] =
            (gr < K && gc < N) ? B[(size_t)gr * N + gc] : TC<T>::zero();
      }
    }
  }
};

// A and B fragments of k step `kk` of a stage, for the warp tile at (wm0, wn0).
//   bf16 B: ldmatrix.trans of the (k, n) row-major tile gives the "col" operand.
//   int8 B: ldmatrix cannot transpose bytes; each register packs B[k..k+3][n]
//           from four rows (k = 4 * (lane % 4), n = lane / 4).
template <typename T, int BM, int BN, int MI, int NI>
__device__ __forceinline__ void load_frags(const char* As, const char* Bs, int kk, int wm0, int wn0,
                                           uint32_t (&a)[MI][4], uint32_t (&b)[NI][2]) {
  using L = Tile<T, BM, BN>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    ldsm_x4(smem_addr(As + (wm0 + mi * 16 + lane % 16) * L::A_PITCH + kk * 32 + (lane / 16) * 16), a[mi]);
  if constexpr (sizeof(T) == 2) {
    const int row = kk * 16 + lane % 16;
    if constexpr (NI == 1) {
      ldsm_x2_trans(smem_addr(Bs + row * L::B_PITCH + wn0 * 2), b[0][0], b[0][1]);
    } else {
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        const int col = wn0 + j * 16 + (lane / 16) * 8;
        ldsm_x4_trans(smem_addr(Bs + row * L::B_PITCH + col * 2), b[2 * j][0], b[2 * j][1], b[2 * j + 1][0],
                      b[2 * j + 1][1]);
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* p =
            reinterpret_cast<const unsigned char*>(Bs) + (kk * 32 + h * 16 + 4 * t) * L::B_PITCH + wn0 + j * 8 + g;
        b[j][h] = (uint32_t)p[0] | ((uint32_t)p[L::B_PITCH] << 8) | ((uint32_t)p[2 * L::B_PITCH] << 16) |
                  ((uint32_t)p[3 * L::B_PITCH] << 24);
      }
    }
  }
}

// First chunk of K slice s of `splits` over `chunks` chunks: the K walk,
// a function of (K, splits) only (kernels/gemm.py:k_walk).
__device__ __forceinline__ int slice_start(int s, int chunks, int splits) {
  return (int)((long long)s * chunks / splits);
}

// One block: a BM x BN output tile; warps WM x WN, each a (BM/WM) x (BN/WN)
// warp tile.  K is cut into `splits` slices.  A cluster launch (gridDim.z
// == splits) gives each block of the cluster one slice (blockIdx.z); a
// plain launch (gridDim.z == 1) has the block walk all slices in order,
// keeping the sum of the slices before the current one in shared memory.
// Either way each slice is summed from zero and the slices are added in
// order 0..splits-1, so the two give the same bits.
template <typename T, typename TOut, int EPI, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
gemm_tc_kernel(const T* __restrict__ A, const T* __restrict__ B, TOut* __restrict__ C, int M, int K, int N,
               float scale, int splits, int stages, int vec_a, int vec_b) {
  using L = Tile<T, BM, BN>;
  using Acc = typename TC<T>::Acc;
  constexpr int THREADS = WM * WN * 32;
  constexpr int KSTEPS = L::BK / TC<T>::KSTEP;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(MI >= 1 && NI >= 1 && (NI == 1 || NI % 2 == 0), "warp tiles");
  extern __shared__ __align__(128) char smem[];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp / WN) * WTM, wn0 = (warp % WN) * WTN;
  // Blocks of one column tile are launched side by side (x walks the row
  // tiles), so a weight tile read from device memory serves every row tile
  // from L2.
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const bool cluster_slices = gridDim.z > 1;
  const int chunks = (K + L::BK - 1) / L::BK;
  int s = cluster_slices ? (int)blockIdx.z : 0;
  const int c_begin = slice_start(s, chunks, splits);
  const int c_end = cluster_slices ? slice_start(s + 1, chunks, splits) : chunks;
  int s_end = slice_start(s + 1, chunks, splits);  // where slice s ends
  const int nch = c_end - c_begin;
  // The partial tile [BM][RED_PITCH]: after the ring while one block walks
  // several slices, over the ring once a cluster adds its blocks' slices.
  Acc* red = reinterpret_cast<Acc*>(smem + (cluster_slices ? 0 : stages * L::STAGE_BYTES));
  auto red_at = [&](int mi, int ni, int e) -> Acc& {
    return red[(wm0 + mi * 16 + g + (e / 2) * 8) * L::RED_PITCH + wn0 + ni * 8 + 2 * t + e % 2];
  };

  Acc acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);
  bool folded = false;  // red holds the sum of the slices before slice s

  const ChunkLoader<T, BM, BN, THREADS> loader(A, B, M, K, N, row0, col0, vec_a, vec_b);
  for (int st = 0; st < stages - 1; ++st) {
    if (st < nch) loader.load(smem + st * L::STAGE_BYTES, c_begin + st);
    cp_async_commit();
  }
  int rd = 0, wr = stages - 1;  // ring stages read and refilled this step
  for (int i = 0; i < nch; ++i) {
    cp_async_wait_dyn(stages - 2);  // chunk i has landed (this thread's copies)
    __syncthreads();                // ... everyone's; and stage wr (read last step) is free
    if (i + stages - 1 < nch) loader.load(smem + wr * L::STAGE_BYTES, c_begin + i + stages - 1);
    cp_async_commit();
    const char* As = smem + rd * L::STAGE_BYTES;
    const char* Bs = As + L::A_BYTES;
    rd = rd + 1 == stages ? 0 : rd + 1;
    wr = wr + 1 == stages ? 0 : wr + 1;
    uint32_t a[2][MI][4], b[2][NI][2];  // fragments of step kk and kk + 1
    load_frags<T, BM, BN, MI, NI>(As, Bs, 0, wm0, wn0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk + 1 < KSTEPS) load_frags<T, BM, BN, MI, NI>(As, Bs, kk + 1, wm0, wn0, a[(kk + 1) % 2], b[(kk + 1) % 2]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma(acc[mi][ni], a[kk % 2][mi], b[kk % 2][ni]);
    }
    if (c_begin + i + 1 == s_end && i + 1 < nch) {
      // Slice s is summed and another follows in this block: add it to the
      // slices before it (each thread its own elements), restart from zero.
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            Acc& r = red_at(mi, ni, e);
            r = folded ? r + acc[mi][ni][e] : acc[mi][ni][e];
            acc[mi][ni][e] = Acc(0);
          }
      folded = true;
      s_end = slice_start(++s + 1, chunks, splits);
    }
  }
  if (folded) {  // the last slice joins the sum of those before it
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = red_at(mi, ni, e) + acc[mi][ni][e];
  }

  if (!cluster_slices) {
    // The output tile goes through shared memory, so that its rows leave in
    // 16-byte stores.
    constexpr int O_PITCH = BN * (int)sizeof(TOut) + 16;  // bytes
    constexpr int PER_ROW = BN * (int)sizeof(TOut) / 16, VEC_OUT = 16 / (int)sizeof(TOut);
    static_assert(BM * O_PITCH <= 2 * L::STAGE_BYTES && PER_ROW * 16 == BN * (int)sizeof(TOut), "output tile");
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm0 + mi * 16 + g + (e / 2) * 8, c = wn0 + ni * 8 + 2 * t + e % 2;
          reinterpret_cast<TOut*>(smem + r * O_PITCH)[c] = Out<TOut, EPI>::of(acc[mi][ni][e], scale);
        }
    __syncthreads();
    const int vm = min(BM, M - row0), vn = min(BN, N - col0);
    const bool vec = N % VEC_OUT == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
    for (int i = threadIdx.x; i < vm * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * VEC_OUT;
      if (c >= vn) continue;
      const TOut* src = reinterpret_cast<const TOut*>(smem + r * O_PITCH) + c;
      TOut* dst = C + (size_t)(row0 + r) * N + col0 + c;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < VEC_OUT && c + j < vn; ++j) dst[j] = src[j];
      }
    }
    return;
  }

  // Slices across the cluster: each block leaves its slice's partial tile in
  // its shared memory, then the cluster adds the partials in rank (= slice)
  // order through distributed shared memory; each rank finishes an equal
  // share of the tile's valid elements.
  cg::cluster_group cluster = cg::this_cluster();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) red_at(mi, ni, e) = acc[mi][ni][e];
  cluster.sync();
  const Acc* part[MAX_SPLITS];
#pragma unroll
  for (int q = 0; q < MAX_SPLITS; ++q) part[q] = q < splits ? cluster.map_shared_rank(red, q) : red;
  const int vm = min(BM, M - row0), vn = min(BN, N - col0);
  const int count = vm * vn, rank = (int)cluster.block_rank();
  const int lo = (int)((long long)rank * count / splits), hi = (int)((long long)(rank + 1) * count / splits);
  for (int e = lo + (int)threadIdx.x; e < hi; e += THREADS) {
    const int r = e / vn, c = e % vn, off = r * L::RED_PITCH + c;
    Acc sum = part[0][off];
#pragma unroll
    for (int q = 1; q < MAX_SPLITS; ++q)
      if (q < splits) sum += part[q][off];
    C[(size_t)(row0 + r) * N + col0 + c] = Out<TOut, EPI>::of(sum, scale);
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <typename T, typename TOut, int EPI, int BM, int BN, int WM, int WN>
int launch_tc(const void* a, const void* b, void* c, int m, int k, int n, float scale, int splits, int cluster,
              int stages, cudaStream_t s) {
  using L = Tile<T, BM, BN>;
  // The ring, and the partial tile: after the ring if one block walks
  // several slices, over it if a cluster adds them.
  const int ring = stages * L::STAGE_BYTES;
  const int smem = splits == 1 ? ring : cluster ? max(ring, L::RED_BYTES) : ring + L::RED_BYTES;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = gemm_tc_kernel<T, TOut, EPI, BM, BN, WM, WN>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int vec_a = (k % L::VEC == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const int vec_b = (n % L::VEC == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const int z = cluster && splits > 1 ? splits : 1;
  cudaLaunchConfig_t cfg = {};
  const int col_tiles = (n + BN - 1) / BN;
  if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3((m + BM - 1) / BM, col_tiles, z);
  cfg.blockDim = dim3(WM * WN * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = z;
  cfg.attrs = attr;
  cfg.numAttrs = z > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a), static_cast<const T*>(b),
                                       static_cast<TOut*>(c), m, k, n, scale, splits, stages, vec_a, vec_b);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The tiles the tensor-core kernel takes: (BM, BN) -> warps WM x WN.
template <typename T, typename TOut, int EPI>
int launch_tiles(const void* a, const void* b, void* c, int m, int k, int n, float scale, int bm, int bn,
                 int splits, int cluster, int stages, cudaStream_t s) {
#define REPRO_TILE(BM_, BN_, WM_, WN_)                                                                  \
  if (bm == BM_ && bn == BN_)                                                                           \
    return launch_tc<T, TOut, EPI, BM_, BN_, WM_, WN_>(a, b, c, m, k, n, scale, splits, cluster, stages, s);
  REPRO_TILE(16, 32, 1, 4)
  REPRO_TILE(16, 64, 1, 4)
  REPRO_TILE(16, 128, 1, 4)
  REPRO_TILE(64, 128, 2, 4)
  REPRO_TILE(128, 128, 2, 2)
#undef REPRO_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// code: 0 f32 -> f32, 1 bf16 -> bf16, 2 int8 -> int32, 3 int8 -> int16, 4 int8 -> int8.
// The plan (bm, bn, splits, cluster, stages) comes from kernels/gemm.py:plan
// and is checked here: f32 takes only the SIMT tile (16, 64, 1, 0, 1); bf16
// and int8 take the tiles of launch_tiles, 1..8 splits and no more splits
// than K chunks, cluster 0 or 1, and 2..8 stages that fit in shared memory.
// Anything else: cudaErrorInvalidValue, and nothing is launched.
extern "C" int gama_gemm_launch(const void* a, const void* b, void* c, int m, int k, int n, int code,
                                float scale, int bm, int bn, int splits, int cluster, int stages,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (code == 0) {
    if (bm != SBM || bn != SBN || splits != 1 || cluster != 0 || stages != 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + SBN - 1) / SBN, (m + SBM - 1) / SBM);
    gemm_simt_kernel<<<grid, STHREADS, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                               static_cast<float*>(c), m, k, n);
    return (int)cudaGetLastError();
  }
  const int chunk = code == 1 ? CHUNK_BYTES / 2 : CHUNK_BYTES;
  const int chunks = (k + chunk - 1) / chunk;
  if (splits < 1 || splits > MAX_SPLITS || splits > chunks || (cluster != 0 && cluster != 1) ||
      stages < MIN_STAGES || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  switch (code) {
    case 1:
      return launch_tiles<__nv_bfloat16, __nv_bfloat16, EPI_CAST>(a, b, c, m, k, n, scale, bm, bn, splits, cluster,
                                                                  stages, s);
    case 2:
      return launch_tiles<int8_t, int32_t, EPI_CAST>(a, b, c, m, k, n, scale, bm, bn, splits, cluster, stages, s);
    case 3:
      return launch_tiles<int8_t, int16_t, EPI_REQUANT>(a, b, c, m, k, n, scale, bm, bn, splits, cluster, stages, s);
    case 4:
      return launch_tiles<int8_t, int8_t, EPI_REQUANT>(a, b, c, m, k, n, scale, bm, bn, splits, cluster, stages, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

REPRO_EXPORT_ERROR_STRING(gama_gemm)
