// Split-K tiled matrix product C = A @ B for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (body _matmul_kernel),
// the Pallas kernel behind every 2-D block product of the reference's pallas
// backend.  Same function: f32, bf16 (f32 accumulation) and f64 (f64
// accumulation), output in the input dtype.  f32 uses IEEE fmaf, never TF32.
//
// What bounds it on this card.  The Newton loop's block products have a huge
// contraction (K = 131072 rows of one X block) and very few output tiles:
// X^T (w*X) is a 256x256 output, X^T (mu-y) is 256x1.  The TPU ran its grid
// in order on one core and carried the sum across K steps in VMEM; here a
// one-block-per-output-tile kernel would occupy a few of 132 SMs.  X^T (w*X)
// is bound by operations (f64: 17 GFLOP a block product, 0.26 ms at the
// FP64 tensor cores' 67 TFLOP/s); X @ beta and X^T (mu-y) (N = 1) are bound
// by the bytes of X (268 MB, 0.08 ms); a DGEMM tile of 4096^3 by operations
// (2.05 ms in f64 on the tensor cores, 2.05 ms in f32 on the FMA units).
//
// What the design does about it.
//  * Split-K: blockIdx.z walks a slice of K, so tiles x slices fill the card.
//    Each slice writes its partial tile to a workspace the wrapper allocates;
//    a second kernel sums the slices in a fixed order (slice 0, 1, 2, ...).
//    There are no float atomics, so the same inputs give the same bits on
//    every run (the runtime's pipelined==sync and plan-cache on==off
//    contracts rely on that).
//  * f64, wide outputs (N > 8): dmma_kernel runs the FP64 tensor cores
//    (mma.sync m16n8k8 f64, DMMA; Hopper's wgmma has no f64 form).  Its warps
//    each own 64x32 of the output (64 f64 accumulators a thread, the most
//    the registers hold beside the fragments).  The first version (128x64
//    block tiles, fragments read element by element from padded rows) ran a
//    4096^3 tile at 36% of the bound; the same loop with the copies from
//    global memory left out ran at 78%.  Each thread's share of a step's
//    16-byte copies had been a loop whose trip count was known only at run
//    time, recomputing 64-bit addresses and bounds for every chunk: some 200
//    instructions a thread a step, against 32 DMMAs a warp, issued between
//    the barrier and the first DMMA.  Now a thread copies the same chunk of
//    every RS-th row (load_tile), so the copy loop unrolls and its pointer
//    steps by a constant (64% of the bound at 4096^3).  Fragments are read
//    as double2: k is permuted inside each k8 step, the same way for A and
//    B, so that a lane's two k (or, where a tile is stored along m or n, its
//    two rows or columns) are neighbours, and the tiles are dense with their
//    16-byte chunks swizzled (Swizzled) so that those reads and the copies
//    hit distinct banks.  Two block tiles, picked by the wrapper from the
//    shape and orientation: 128x64 over four warps, 16 deep, a ring of four
//    stages, two blocks an SM (DTileNarrow); 128x128 over eight warps, 32
//    deep, three stages, one block an SM (DTileWide), which stages two
//    thirds of the bytes a flop and took the products whose A is read along
//    m (Newton's X^T (w*X)) 5-11% faster on an H100.
//  * f32, wide: sgemm_kernel, IEEE fmaf on 128x128 block tiles, 8x8 outputs
//    a thread, operands read from shared memory as float4 out of padded rows,
//    three stages.  Both kernels fill their rings by 16-byte cp.async copies
//    a few k steps ahead of the one computed, each tile kept in shared memory
//    along its operand's unit-stride axis (so global reads stay coalesced in
//    either orientation).
//  * f64 and f32, skinny outputs (N <= 8, matrix-vector products): bound by
//    the bytes of A, so skinny_*_kernel streams A with 16-byte loads along
//    its unit-stride axis (skinny_mfast_kernel for X^T r read as the view
//    X.mT, skinny_kfast_kernel for X @ beta) and keeps the <= 8-column
//    operand's slice in shared memory; each thread's partial sums are
//    added across the block in a fixed order.
//  * bf16 (no main path runs it): matmul_tile_kernel, the first simple
//    version: 64x64 (or 128x8 for N <= 8) tiles, 4x4 (4x2) outputs a
//    thread, synchronous loads.
//  * Operands are read through their strides: a transposed block (X^T) is
//    never materialised.  Ragged edges are masked in the loaders and the
//    store (a 16-byte copy of a row's last partial chunk zero-fills the
//    rest); there is no padding copy.  Where an operand's base or leading
//    stride is not 16-byte aligned (a view at an odd offset), the wrapper
//    passes vec = 0 and the same kernels copy element by element through
//    the full strides: the scalar loader.
#include <type_traits>

#include "common.cuh"

namespace {

template <typename T>
struct MatArgs {
  const T* A;
  const T* B;
  T* C;
  typename AccOf<T>::type* part;  // (splits, M, N) partial tiles, or null: write C
  int64_t M, N, K;
  int64_t sam, sak, sbk, sbn;     // element strides
  int64_t k_chunk;                // K per split
};

template <typename T>
__device__ __forceinline__ void store_out(const MatArgs<T>& p, int64_t m, int64_t n,
                                          typename AccOf<T>::type v) {
  if (p.part) p.part[static_cast<int64_t>(blockIdx.z) * p.M * p.N + m * p.N + n] = v;
  else store_to(&p.C[m * p.N + n], v);
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; bytes past src_bytes are written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// one element (4 or 8 bytes) global -> shared, or a zero where !ok
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool ok) {
  constexpr int bytes = sizeof(T);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
               "l"(src), "n"(bytes), "r"(ok ? bytes : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where tile element (s, f) sits in shared memory, in elements.  Padded: rows
// of LD elements.  Swizzled (f64 only): dense rows of FAST elements in 16-byte
// chunks of two, whose order within a row is permuted (the chunk index XOR a
// function of the row) so that dmma_kernel's double2 fragment reads hit
// distinct banks: rows of k (a tile stored along m or n) XOR 2 * ((s / 2) % 4),
// rows of m or n (stored along k) XOR 4 * (s % 2).  A chunk stays inside its
// aligned run of eight, so a warp's 16-byte copies into a row stay
// conflict-free too.
template <int LD>
struct Padded {
  __device__ __forceinline__ static int at(int s, int f) { return s * LD + f; }
};
template <int FAST, bool ROWS_OF_K>
struct Swizzled {
  static_assert(FAST >= 16, "a row holds at least eight 16-byte chunks");
  __device__ __forceinline__ static int at(int s, int f) {
    const int x = ROWS_OF_K ? ((s >> 1) & 3) << 1 : (s & 1) << 2;
    return s * FAST + ((((f >> 1) ^ x) << 1) | (f & 1));
  }
};

// One operand tile into shared memory at the layout L, "fast" being the
// operand's unit-stride axis.  Tile element (s, f) is the operand's element
// (s0 + s, f0 + f), at base + (s0 + s) * s_stride + (f0 + f) * f_stride, and is
// zero unless s0 + s < s_end and f0 + f < f_end.  VEC: 16-byte copies along
// the fast axis (f_stride is 1, base, s_stride and f0 are 16-byte aligned), a
// thread copying the same chunk of every RS-th row, so that its pointer steps
// by a constant and the loop unrolls; otherwise one copy an element.
template <typename T, int SLOW, int FAST, typename L, int NTHREADS, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, const T* base, int64_t s0, int64_t f0,
                                          int64_t s_end, int64_t f_end, int64_t s_stride,
                                          int64_t f_stride, int tid) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = FAST / E, RS = NTHREADS / CPR;  // chunks a row, rows a pass
    static_assert(NTHREADS % CPR == 0 && SLOW % RS == 0, "whole rows of chunks a pass");
    const int c = tid % CPR, s1 = tid / CPR;
    const int64_t gf = f0 + c * E;
    const int rows = static_cast<int>(max(min(s_end - s0 - s1, static_cast<int64_t>(SLOW)),
                                          static_cast<int64_t>(0)));
    const int bytes = static_cast<int>(max(min(static_cast<int64_t>(E), f_end - gf),
                                           static_cast<int64_t>(0)) * sizeof(T));
    const T* src = base + (s0 + s1) * s_stride + gf;
#pragma unroll
    for (int it = 0; it < SLOW / RS; ++it, src += RS * s_stride)  // 0 bytes: reads nothing
      cp_async16(dst + L::at(s1 + it * RS, c * E), src, it * RS < rows ? bytes : 0);
  } else {
#pragma unroll 4
    for (int idx = tid; idx < SLOW * FAST; idx += NTHREADS) {
      const int s = idx / FAST, f = idx % FAST;
      const int64_t gs = s0 + s, gf = f0 + f;
      const bool ok = gs < s_end && gf < f_end;
      cp_async_elem(dst + L::at(s, f), ok ? base + gs * s_stride + gf * f_stride : base, ok);
    }
  }
}

// The A tile (BM x BK at (m0, k0)) and the B tile (BK x BN at (k0, n0)) of
// one k step, at layouts LA and LB.  A_KFAST: A's unit stride is along k,
// stored [m][k]; else [k][m].  B_KFAST: [n][k]; else [k][n].
template <typename T, int BM, int BN, int BK, typename LA, typename LB, int NTHREADS,
          bool A_KFAST, bool B_KFAST, bool VEC>
__device__ __forceinline__ void load_step(T* As, T* Bs, const MatArgs<T>& p, int64_t m0,
                                          int64_t n0, int64_t k0, int64_t k_end, int tid) {
  if constexpr (A_KFAST)
    load_tile<T, BM, BK, LA, NTHREADS, VEC>(As, p.A, m0, k0, p.M, k_end, p.sam, p.sak, tid);
  else
    load_tile<T, BK, BM, LA, NTHREADS, VEC>(As, p.A, k0, m0, k_end, p.M, p.sak, p.sam, tid);
  if constexpr (B_KFAST)
    load_tile<T, BN, BK, LB, NTHREADS, VEC>(Bs, p.B, n0, k0, p.N, k_end, p.sbn, p.sbk, tid);
  else
    load_tile<T, BK, BN, LB, NTHREADS, VEC>(Bs, p.B, k0, n0, k_end, p.N, p.sbk, p.sbn, tid);
}

// The k loop of a block: a ring of STAGES tiles in shared memory, filled
// STAGES - 1 steps ahead of the step being computed, one barrier a step (the
// slot refilled at step st was consumed at st - 1).  load(slot, step) issues
// one step's copies into a slot; compute(slot) consumes one.
template <int STAGES, typename L, typename F>
__device__ __forceinline__ void k_loop(int steps, L&& load, F&& compute) {
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) load(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step st has landed; every thread is done with step st - 1
    const int ahead = st + STAGES - 1;
    if (ahead < steps) load(ahead % STAGES, ahead);
    cp_async_commit();
    compute(st % STAGES);
  }
}

// ---------------------------------------------------------------------------
// f64, wide outputs: FP64 tensor cores
// ---------------------------------------------------------------------------

// c (16x8) += a (16x8, row) * b (8x8, col) on the FP64 tensor cores, with
// g = lane / 4 and t = lane % 4: lane holds a[g][t], a[g + 8][t], a[g][t + 4],
// a[g + 8][t + 4]; b[t][g], b[t + 4][g]; c[g][2t], c[g][2t + 1], c[g + 8][2t],
// c[g + 8][2t + 1].  (The m8n8k4 shape reaches half the rate of this one on
// an H100: 33 against 65 TFLOP/s, registers only.)
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ double2 ld2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// An f64 block tile: BM x BN outputs over WM x WN warps of 64 x 32 (4 x 4
// m16n8 tiles each), BK deep, in a ring of STAGES.
template <int BM_, int BN_, int BK_, int STAGES_, int WM_, int WN_>
struct DTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_, WM = WM_, WN = WN_;
  static constexpr int THREADS = 32 * WM * WN, MI = BM / (16 * WM), NJ = BN / (8 * WN);
  static constexpr int A_SIZE = BM * BK, B_SIZE = BN * BK;  // elements of a stage
  static constexpr int SMEM = STAGES * (A_SIZE + B_SIZE) * static_cast<int>(sizeof(double));
  static_assert(MI * 16 * WM == BM && NJ * 8 * WN == BN && NJ % 2 == 0, "whole warp tiles");
  static_assert(BK % 8 == 0 && STAGES >= 2, "whole k8 steps, a ring");
};

template <class D, bool A_KFAST, bool B_KFAST, bool VEC>
__global__ void __launch_bounds__(D::THREADS, 1) dmma_kernel(const MatArgs<double> p) {
  constexpr int BK = D::BK, MI = D::MI, NJ = D::NJ;
  using LA = std::conditional_t<A_KFAST, Swizzled<BK, false>, Swizzled<D::BM, true>>;
  using LB = std::conditional_t<B_KFAST, Swizzled<BK, false>, Swizzled<D::BN, true>>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const As = reinterpret_cast<double*>(smem_raw);
  double* const Bs = As + D::STAGES * D::A_SIZE;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / D::WN) * (16 * MI), wn = (warp % D::WN) * (8 * NJ);  // this warp's tile
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * D::BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * D::BN;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * p.k_chunk;
  const int64_t k_end = min(k_begin + p.k_chunk, p.K);

  double acc[MI][NJ][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  // The fragments of the k8 step at kk.  k is permuted inside the step, the
  // same way for both operands (the step's sum is unchanged): mma k slot t is
  // k = kk + 2t and slot t + 4 is kk + 2t + 1, so a lane reads its two k as
  // one double2 where the operand is stored along k.  Where A is stored along
  // m, mma row g of an m16 tile is m = 2g and row g + 8 is 2g + 1; where B is
  // stored along n, column g of the first n8 tile of a pair is n = 2g and of
  // the second 2g + 1: a lane reads two neighbouring m (n) as one double2.
  auto fragments = [&](const double* a_s, const double* b_s, int kk, double (&a)[MI][4],
                       double (&b)[NJ][2]) {
    const int k = kk + 2 * t;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if constexpr (A_KFAST) {
        const int r = wm + 16 * i + g;
        const double2 x = ld2(a_s + LA::at(r, k)), y = ld2(a_s + LA::at(r + 8, k));
        a[i][0] = x.x; a[i][1] = y.x; a[i][2] = x.y; a[i][3] = y.y;
      } else {
        const int m = wm + 16 * i + 2 * g;
        const double2 x = ld2(a_s + LA::at(k, m)), y = ld2(a_s + LA::at(k + 1, m));
        a[i][0] = x.x; a[i][1] = x.y; a[i][2] = y.x; a[i][3] = y.y;
      }
    }
    if constexpr (B_KFAST) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const double2 x = ld2(b_s + LB::at(wn + 8 * j + g, k));
        b[j][0] = x.x; b[j][1] = x.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < NJ / 2; ++q) {
        const int n = wn + 16 * q + 2 * g;
        const double2 x = ld2(b_s + LB::at(k, n)), y = ld2(b_s + LB::at(k + 1, n));
        b[2 * q][0] = x.x; b[2 * q + 1][0] = x.y; b[2 * q][1] = y.x; b[2 * q + 1][1] = y.y;
      }
    }
  };

  const int steps = static_cast<int>((k_end - k_begin + BK - 1) / BK);
  k_loop<D::STAGES>(
      steps,
      [&](int slot, int st) {
        load_step<double, D::BM, D::BN, BK, LA, LB, D::THREADS, A_KFAST, B_KFAST, VEC>(
            As + slot * D::A_SIZE, Bs + slot * D::B_SIZE, p, m0, n0,
            k_begin + static_cast<int64_t>(st) * BK, k_end, tid);
      },
      [&](int slot) {
        const double* a_s = As + slot * D::A_SIZE;
        const double* b_s = Bs + slot * D::B_SIZE;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
          double a[MI][4], b[NJ][2];
          fragments(a_s, b_s, kk, a, b);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) dmma(acc[i][j], a[i], b[j]);
        }
      });

  // fragment (h, e) is mma row g + 8h, column 2t + e; a split writes its slice
  double* const out = p.part ? p.part + static_cast<int64_t>(blockIdx.z) * p.M * p.N : p.C;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm + 16 * i + (A_KFAST ? g + 8 * h : 2 * g + h);
      if (m >= p.M) continue;
      double* const row = out + m * p.N + n0 + wn;
      const int n_left = static_cast<int>(min(p.N - n0 - wn, static_cast<int64_t>(8 * NJ)));
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * t + e;
          const int n = B_KFAST ? 8 * j + c : 16 * (j / 2) + 2 * c + j % 2;
          if (n < n_left) row[n] = acc[i][j][2 * h + e];
        }
    }
}

// ---------------------------------------------------------------------------
// f32, wide outputs: register-blocked IEEE fmaf
// ---------------------------------------------------------------------------

constexpr int SG_BM = 128, SG_BN = 128, SG_BK = 16, SG_THREADS = 256, SG_STAGES = 3;

// Shared memory of a STAGES-deep ring of padded (A, B) tiles, in elements
template <int BM, int BN, int BK, bool A_KFAST, bool B_KFAST>
struct Ring {
  static constexpr int LDM = BM + 4, LDN = BN + 4, LDK = BK + 4;  // padded rows
  static constexpr int A_SIZE = A_KFAST ? BM * LDK : BK * LDM;
  static constexpr int B_SIZE = B_KFAST ? BN * LDK : BK * LDN;
  using LA = Padded<A_KFAST ? LDK : LDM>;
  using LB = Padded<B_KFAST ? LDK : LDN>;
};

template <bool A_KFAST, bool B_KFAST, bool VEC>
__global__ void __launch_bounds__(SG_THREADS) sgemm_kernel(const MatArgs<float> p) {
  constexpr int BK = SG_BK;
  using R = Ring<SG_BM, SG_BN, SG_BK, A_KFAST, B_KFAST>;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * SG_BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * SG_BN;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * p.k_chunk;
  const int64_t k_end = min(k_begin + p.k_chunk, p.K);
  // this thread's 8 rows and 8 columns: strided by 16 where the tile is
  // stored along k (float4 reads along k), else two runs of 4 (float4
  // reads along m or n)
  auto row_of = [&](int i) { return A_KFAST ? ty + 16 * i : (i / 4) * 64 + ty * 4 + i % 4; };
  auto col_of = [&](int j) { return B_KFAST ? tx + 16 * j : (j / 4) * 64 + tx * 4 + j % 4; };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float* const As = reinterpret_cast<float*>(smem_raw);
  float* const Bs = As + SG_STAGES * R::A_SIZE;
  const int steps = static_cast<int>((k_end - k_begin + BK - 1) / BK);
  k_loop<SG_STAGES>(
      steps,
      [&](int slot, int st) {
        load_step<float, SG_BM, SG_BN, BK, typename R::LA, typename R::LB, SG_THREADS, A_KFAST,
                  B_KFAST, VEC>(As + slot * R::A_SIZE, Bs + slot * R::B_SIZE, p, m0, n0,
                                k_begin + static_cast<int64_t>(st) * BK, k_end, tid);
      },
      [&](int slot) {
        const float* a_s = As + slot * R::A_SIZE;
        const float* b_s = Bs + slot * R::B_SIZE;
#pragma unroll
        for (int k4 = 0; k4 < BK; k4 += 4) {
          float a[8][4], b[8][4];  // [row or column][k]
          if constexpr (A_KFAST) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 v = *reinterpret_cast<const float4*>(a_s + row_of(i) * R::LDK + k4);
              a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float4 v =
                    *reinterpret_cast<const float4*>(a_s + (k4 + kk) * R::LDM + h * 64 + ty * 4);
                a[4 * h][kk] = v.x; a[4 * h + 1][kk] = v.y; a[4 * h + 2][kk] = v.z;
                a[4 * h + 3][kk] = v.w;
              }
          }
          if constexpr (B_KFAST) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float4 v = *reinterpret_cast<const float4*>(b_s + col_of(j) * R::LDK + k4);
              b[j][0] = v.x; b[j][1] = v.y; b[j][2] = v.z; b[j][3] = v.w;
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float4 v =
                    *reinterpret_cast<const float4*>(b_s + (k4 + kk) * R::LDN + h * 64 + tx * 4);
                b[4 * h][kk] = v.x; b[4 * h + 1][kk] = v.y; b[4 * h + 2][kk] = v.z;
                b[4 * h + 3][kk] = v.w;
              }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
        }
      });

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + row_of(i);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + col_of(j);
      if (n < p.N) store_out(p, m, n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// f64 and f32, skinny outputs (N <= 8): streaming A
// ---------------------------------------------------------------------------

constexpr int SK_THREADS = 256;  // eight warps
constexpr int SK_STAGE = 128;    // k rows of B staged in shared memory at once

// k rows [kb0, kb0 + SK_STAGE) of B's N <= NN columns, zero past k_end and N
template <typename T, int NN>
__device__ __forceinline__ void stage_b(typename AccOf<T>::type (*Bs)[NN], const MatArgs<T>& p,
                                        int64_t kb0, int64_t k_end, int tid) {
  using Acc = typename AccOf<T>::type;
  for (int idx = tid; idx < SK_STAGE * NN; idx += SK_THREADS) {
    const int kk = idx / NN, n = idx % NN;
    const int64_t k = kb0 + kk;
    Bs[kk][n] = (k < k_end && n < p.N) ? to_acc(p.B[k * p.sbk + n * p.sbn]) : Acc(0);
  }
}

// E = 16 / sizeof(T) consecutive elements of A from index (m, k) along the
// unit-stride axis (step 1 if VEC, else the axis' stride), zero past `left`
template <typename T, bool VEC>
__device__ __forceinline__ void load_run(typename AccOf<T>::type (&v)[16 / sizeof(T)],
                                         const T* src, int64_t step, int64_t left) {
  constexpr int E = 16 / sizeof(T);
  if (VEC && left >= E) {
    if constexpr (sizeof(T) == 8) {
      const double2 x = __ldg(reinterpret_cast<const double2*>(src));
      v[0] = x.x; v[1] = x.y;
    } else {
      const float4 x = __ldg(reinterpret_cast<const float4*>(src));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = e < left ? to_acc(src[e * step]) : 0;
  }
}

// A's unit stride along m (X^T r through the view X.mT): a warp reads 32 x E
// consecutive m at one k (512 bytes); the eight warps take every eighth k of
// the slice; their partial sums are added in warp order.
template <typename T, int NN, bool VEC>
__global__ void __launch_bounds__(SK_THREADS) skinny_mfast_kernel(const MatArgs<T> p) {
  using Acc = typename AccOf<T>::type;
  constexpr int E = 16 / sizeof(T), BMS = 32 * E, KL = SK_THREADS / 32;
  __shared__ Acc Bs[SK_STAGE][NN];
  __shared__ Acc red[KL][BMS][NN];
  const int tid = threadIdx.x, lane = tid % 32, kl = tid / 32;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * BMS + lane * E;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * p.k_chunk;
  const int64_t k_end = min(k_begin + p.k_chunk, p.K);
  const int64_t m_left = p.M - m;

  Acc acc[E][NN];
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int n = 0; n < NN; ++n) acc[e][n] = 0;

  for (int64_t kb0 = k_begin; kb0 < k_end; kb0 += SK_STAGE) {
    __syncthreads();
    stage_b<T, NN>(Bs, p, kb0, k_end, tid);
    __syncthreads();
    const int kn = static_cast<int>(min(static_cast<int64_t>(SK_STAGE), k_end - kb0));
    constexpr int U = 4;  // k rows in flight per warp
    for (int kk = kl; kk < kn; kk += U * KL) {
      Acc v[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kr = kk + u * KL;
        if (kr < kn && m_left > 0)
          load_run<T, VEC>(v[u], p.A + m * p.sam + (kb0 + kr) * p.sak, p.sam, m_left);
        else
#pragma unroll
          for (int e = 0; e < E; ++e) v[u][e] = 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kr = kk + u * KL;
        if (kr >= kn) break;
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int n = 0; n < NN; ++n) acc[e][n] = fma_acc(v[u][e], Bs[kr][n], acc[e][n]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int n = 0; n < NN; ++n) red[kl][lane * E + e][n] = acc[e][n];
  __syncthreads();
  for (int idx = tid; idx < BMS * NN; idx += SK_THREADS) {
    const int mm = idx / NN, n = idx % NN;
    Acc s = red[0][mm][n];
#pragma unroll
    for (int l = 1; l < KL; ++l) s += red[l][mm][n];
    const int64_t gm = static_cast<int64_t>(blockIdx.x) * BMS + mm;
    if (gm < p.M && n < p.N) store_out(p, gm, n, s);
  }
}

// A's unit stride along k (X @ beta): each warp takes RW rows; its lanes read
// E consecutive k of a row at a time (a warp, 512 contiguous bytes), and
// their partial sums are added by a butterfly of shuffles (a fixed order).
template <typename T, int NN, bool VEC>
__global__ void __launch_bounds__(SK_THREADS) skinny_kfast_kernel(const MatArgs<T> p) {
  using Acc = typename AccOf<T>::type;
  constexpr int E = 16 / sizeof(T), RW = 4, BMS = RW * SK_THREADS / 32;
  __shared__ Acc Bs[SK_STAGE][NN];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t m_first = static_cast<int64_t>(blockIdx.x) * BMS + warp * RW;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * p.k_chunk;
  const int64_t k_end = min(k_begin + p.k_chunk, p.K);

  Acc acc[RW][NN];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int n = 0; n < NN; ++n) acc[r][n] = 0;

  for (int64_t kb0 = k_begin; kb0 < k_end; kb0 += SK_STAGE) {
    __syncthreads();
    stage_b<T, NN>(Bs, p, kb0, k_end, tid);
    __syncthreads();
    const int kn = static_cast<int>(min(static_cast<int64_t>(SK_STAGE), k_end - kb0));
    for (int c = lane * E; c < kn; c += 32 * E) {
      Acc v[RW][E];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int64_t m = m_first + r;
        if (m < p.M)
          load_run<T, VEC>(v[r], p.A + m * p.sam + (kb0 + c) * p.sak, p.sak, kn - c);
        else
#pragma unroll
          for (int e = 0; e < E; ++e) v[r][e] = 0;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int n = 0; n < NN; ++n) acc[r][n] = fma_acc(v[r][e], Bs[c + e][n], acc[r][n]);
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      Acc s = acc[r][n];
#pragma unroll
      for (int w = 16; w > 0; w /= 2) s += __shfl_xor_sync(0xffffffffu, s, w);
      acc[r][n] = s;
    }
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int64_t m = m_first + r;
    if (m >= p.M) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      if (n < p.N) store_out(p, m, n, acc[r][n]);
  }
}

// ---------------------------------------------------------------------------
// bf16: the first simple tile kernel
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_tile_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, typename AccOf<T>::type* __restrict__ part,
                   int64_t M, int64_t N, int64_t K,
                   int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
                   int64_t k_chunk) {
  using Acc = typename AccOf<T>::type;
  constexpr int RY = BM / TM;  // thread rows
  constexpr int RX = BN / TN;  // thread columns
  constexpr int NT = RX * RY;
  __shared__ Acc As[BK][BM + 1];
  __shared__ Acc Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % RX;
  const int ty = tid / RX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * k_chunk;
  const int64_t k_end = (k_begin + k_chunk < K) ? k_begin + k_chunk : K;
  const bool a_k_fast = (sak == 1);
  const bool b_n_fast = (sbn == 1);

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      int mm, kk;
      if (a_k_fast) { kk = e % BK; mm = e / BK; } else { mm = e % BM; kk = e / BM; }
      const int64_t gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < k_end) ? to_acc(A[gm * sam + gk * sak]) : Acc(0);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      int kk, nn;
      if (b_n_fast) { nn = e % BN; kk = e / BN; } else { kk = e % BK; nn = e / BK; }
      const int64_t gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < k_end && gn < N) ? to_acc(B[gk * sbk + gn * sbn]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * RY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * RX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_acc(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  Acc* slice = part ? part + static_cast<int64_t>(blockIdx.z) * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty + i * RY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx + j * RX;
      if (gn >= N) continue;
      if (slice) slice[gm * N + gn] = acc[i][j];
      else store_to(&C[gm * N + gn], acc[i][j]);
    }
  }
}

// Sum the split-K partials in slice order: deterministic, no atomics.
template <typename T>
__global__ void splitk_reduce_kernel(const typename AccOf<T>::type* __restrict__ part,
                                     T* __restrict__ C, int64_t MN, int splits) {
  using Acc = typename AccOf<T>::type;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < MN;
       i += stride) {
    Acc s = part[i];
    for (int z = 1; z < splits; ++z) s += part[static_cast<int64_t>(z) * MN + i];
    store_to(&C[i], s);
  }
}

// tile shapes; keep in step with tile_config in repro_torch/kernels/matmul.py
constexpr int WIDE_BM = 64, WIDE_BN = 64, WIDE_BK = 16, WIDE_TM = 4, WIDE_TN = 4;
constexpr int SKINNY_BM = 128, SKINNY_BN = 8, SKINNY_BK = 32, SKINNY_TM = 4, SKINNY_TN = 2;

using std::false_type;
using std::true_type;

// f(x, y, z) with x, y, z as compile-time booleans
template <typename F>
void with_flags(bool x, bool y, bool z, F&& f) {
  auto zf = [&](auto X, auto Y) { z ? f(X, Y, true_type{}) : f(X, Y, false_type{}); };
  auto yf = [&](auto X) { y ? zf(X, true_type{}) : zf(X, false_type{}); };
  x ? yf(true_type{}) : yf(false_type{});
}

unsigned cdiv(int64_t a, int64_t b) { return static_cast<unsigned>((a + b - 1) / b); }

// The f64 block tiles (kernels/matmul.py::F64_TILES picks one by shape)
using DTileNarrow = DTile<128, 64, 16, 4, 2, 2>;
using DTileWide = DTile<128, 128, 32, 3, 2, 4>;

template <class D>
void launch_dmma(bool vec, const MatArgs<double>& p, int splits, cudaStream_t s) {
  const dim3 grid(cdiv(p.M, D::BM), cdiv(p.N, D::BN), splits);
  with_flags(p.sak == 1, p.sbn != 1, vec, [&](auto AK, auto BK, auto V) {
    auto kernel = dmma_kernel<D, decltype(AK)::value, decltype(BK)::value, decltype(V)::value>;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM) ==
        cudaSuccess)
      kernel<<<grid, D::THREADS, D::SMEM, s>>>(p);
  });
}

// config 0: wide outputs (f64: the BM x BN block tile), 1: N <= 8; false
// where f64 names no tile this file has
template <typename T>
bool launch_main(int config, int bm, int bn, bool vec, const MatArgs<T>& p, int splits,
                 cudaStream_t s) {
  const bool a_kfast = p.sak == 1, b_kfast = p.sbn != 1;
  if (config == 1) {
    constexpr int E = 16 / sizeof(T);
    const bool one = p.N == 1;
    if (a_kfast) {
      const dim3 grid(cdiv(p.M, 4 * SK_THREADS / 32), 1, splits);
      with_flags(one, vec, false, [&](auto ONE, auto V, auto) {
        skinny_kfast_kernel<T, decltype(ONE)::value ? 1 : 8, decltype(V)::value>
            <<<grid, SK_THREADS, 0, s>>>(p);
      });
    } else {
      const dim3 grid(cdiv(p.M, 32 * E), 1, splits);
      with_flags(one, vec, false, [&](auto ONE, auto V, auto) {
        skinny_mfast_kernel<T, decltype(ONE)::value ? 1 : 8, decltype(V)::value>
            <<<grid, SK_THREADS, 0, s>>>(p);
      });
    }
  } else if constexpr (std::is_same<T, double>::value) {
    if (bm == DTileNarrow::BM && bn == DTileNarrow::BN)
      launch_dmma<DTileNarrow>(vec, p, splits, s);
    else if (bm == DTileWide::BM && bn == DTileWide::BN)
      launch_dmma<DTileWide>(vec, p, splits, s);
    else
      return false;
  } else {
    const dim3 grid(cdiv(p.M, SG_BM), cdiv(p.N, SG_BN), splits);
    with_flags(a_kfast, b_kfast, vec, [&](auto AK, auto BK, auto V) {
      constexpr bool ak = decltype(AK)::value, bk = decltype(BK)::value;
      using R = Ring<SG_BM, SG_BN, SG_BK, ak, bk>;
      constexpr int bytes = SG_STAGES * (R::A_SIZE + R::B_SIZE) * sizeof(float);
      auto kernel = sgemm_kernel<ak, bk, decltype(V)::value>;
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
          cudaSuccess)
        kernel<<<grid, SG_THREADS, bytes, s>>>(p);
    });
  }
  return true;
}

void launch_bf16(int config, const MatArgs<__nv_bfloat16>& p, int splits, cudaStream_t s) {
  if (config == 0) {
    dim3 grid(cdiv(p.M, WIDE_BM), cdiv(p.N, WIDE_BN), splits);
    matmul_tile_kernel<__nv_bfloat16, WIDE_BM, WIDE_BN, WIDE_BK, WIDE_TM, WIDE_TN>
        <<<grid, (WIDE_BM / WIDE_TM) * (WIDE_BN / WIDE_TN), 0, s>>>(
            p.A, p.B, p.C, p.part, p.M, p.N, p.K, p.sam, p.sak, p.sbk, p.sbn, p.k_chunk);
  } else {
    dim3 grid(cdiv(p.M, SKINNY_BM), cdiv(p.N, SKINNY_BN), splits);
    matmul_tile_kernel<__nv_bfloat16, SKINNY_BM, SKINNY_BN, SKINNY_BK, SKINNY_TM, SKINNY_TN>
        <<<grid, (SKINNY_BM / SKINNY_TM) * (SKINNY_BN / SKINNY_TN), 0, s>>>(
            p.A, p.B, p.C, p.part, p.M, p.N, p.K, p.sam, p.sak, p.sbk, p.sbn, p.k_chunk);
  }
}

// Sum the split-K partials of a launch that wrote them (splits > 1).
template <typename T>
int reduce_splits(const MatArgs<T>& p, int splits, cudaStream_t stream) {
  const int64_t MN = p.M * p.N;
  const int threads = 256;
  const int64_t want = (MN + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  splitk_reduce_kernel<T><<<blocks, threads, 0, stream>>>(p.part, p.C, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int config, int bm, int bn, int vec, const void* A, const void* B, void* C,
           void* part, int64_t M, int64_t N, int64_t K, int64_t sam, int64_t sak, int64_t sbk,
           int64_t sbn, int64_t k_chunk, int splits, cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  Acc* pt = splits > 1 ? static_cast<Acc*>(part) : nullptr;
  const MatArgs<T> p{static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C), pt,
                     M, N, K, sam, sak, sbk, sbn, k_chunk};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    launch_bf16(config, p, splits, stream);
  } else if (!launch_main<T>(config, bm, bn, vec != 0, p, splits, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return reduce_splits(p, splits, stream);
}

}  // namespace

// config: 0 wide outputs (N > 8), 1 skinny (N <= 8).  bm, bn: the f64 wide
// block tile (128 x 64 or 128 x 128); other launches ignore them.  vec: 1 if
// both operands take 16-byte copies along their unit-stride axis (the wrapper
// checks base and leading-stride alignment), else 0: the element-by-element
// loader.  bf16 ignores it.
extern "C" int repro_matmul(int dtype, int config, int bm, int bn, int vec, const void* A,
                            const void* B, void* C, void* part, int64_t M, int64_t N, int64_t K,
                            int64_t sam, int64_t sak, int64_t sbk, int64_t sbn, int64_t k_chunk,
                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(config, bm, bn, vec, A, B, C, part, M, N, K, sam, sak, sbk, sbn,
                           k_chunk, splits, s);
    case REPRO_F64:
      return launch<double>(config, bm, bn, vec, A, B, C, part, M, N, K, sam, sak, sbk, sbn,
                            k_chunk, splits, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(config, bm, bn, vec, A, B, C, part, M, N, K, sam, sak, sbk,
                                   sbn, k_chunk, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
