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
//    the registers hold beside the fragments).  Two block tiles, picked by
//    the wrapper from the shape and orientation: 128x64 over four warps, 32
//    deep, a ring of two stages, two blocks an SM (DTileNarrow); 128x128 over
//    eight warps, 32 deep, three stages, one block an SM (DTileWide), which
//    stages two thirds of the bytes a flop and takes the products whose A is
//    read along m (Newton's X^T (w*X)).
//    The ring is filled by TMA.  One thread requests a stage's boxes (16 f64
//    along the operand's unit-stride axis, CU_TENSOR_MAP_SWIZZLE_128B, zeros
//    past the operand's edge) and their bytes complete on the stage's full
//    mbarrier; each warp arrives on the stage's empty mbarrier once it has
//    read the stage, and the thread refills the slot once all have: no
//    block-wide barrier in the k loop.  Split-K chunks are whole multiples
//    of BK, so only K's own edge is ragged.  Fragments land in the registers
//    the DMMA takes them in: the mma's A operand from a tile stored along
//    its rows (two neighbouring rows a double2), its B operand from one
//    stored along k (two k a double2: k is permuted inside each k8 step, the
//    same way for both operands), a tile lying the other way one double a
//    read.  So the DGEMM's row-major operands are computed as C^T = B^T A^T,
//    the same products in the same k order.  The earlier kernel read
//    fragments into registers the DMMA could not take, and ptxas moved
//    them: the row-major DGEMM's k loop (cuobjdump -sass) held 340
//    IMAD.MOVs beside 32 DMMAs and 24 LDS a 16-deep step, 545 instructions;
//    now none, 366 instructions for 64 DMMAs a 32-deep step.
//    What bounds it: a 4096^3 product draws an NVIDIA H100 80GB HBM3 to its
//    700 W limit, where the SM clock falls to 1650-1770 MHz (the 67 TFLOP/s
//    peak is quoted at 1980); cuBLAS draws the same.  Values drawn in f32
//    (fewer mantissa bits toggling) ran every kernel 6-8% faster at
//    1830-1905 MHz: the 2.92 against 3.21 ms of the earlier kernel.
//    Timed in one call (CUDA events, five rounds in turns, N(0,1) values),
//    the earlier kernel (cp.async ring, a block barrier a k step) / this /
//    cuBLAS, ms: 4096^3 3.2920 / 2.8837 / 2.5436; M M^T at 4096 (Cholesky's
//    build, B stored along k) 3.1848 / 3.0396 / 2.6356; 1024^3 0.0733 /
//    0.0602 / 0.0411; X^T (w*X) at 2^17 rows 0.3855 / 0.3733 / 0.3314, at
//    2^21 rows 6.0124 / 6.1577 / 5.6463 (power-bound: +-5% between calls).
//    The TMA ring alone, before the fragments were made register-exact,
//    moved the 4096^3 product by -2% to +5% over four calls.  Tried and
//    dropped, each against the version it changed: a cluster of two blocks
//    along N multicasting A's boxes (3.20 against 3.10 ms at 4096^3; 4.89
//    with cluster-scope release on the remote arrive; with CTA scope it gave
//    wrong bits on 2 of 14 shapes in one of two runs, both with a spare
//    block); a producer warp for the 128x128 tile (setmaxnreg 40 / 240:
//    ptxas held the kernel at 168 registers and spilled 248-588 bytes, and
//    its first launch faulted); refilling a slot after the step's DMMAs
//    (3.11 against 3.10); reading the next k8 step's fragments ahead (3.45
//    against 3.38); 16-deep stages, four of them (3.18 against 2.88: twice
//    the barrier waits and refills).
//  * f32, wide: sgemm_kernel, IEEE fmaf on 128x128 block tiles, 8x8 outputs
//    a thread, operands read from shared memory as float4 out of padded rows,
//    three stages, filled by 16-byte cp.async copies a few k steps ahead of
//    the one computed, each tile kept in shared memory along its operand's
//    unit-stride axis (so global reads stay coalesced in either
//    orientation).
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
//    passes the scalar loader and the same kernels copy element by element
//    through the full strides, with a block-wide barrier a k step.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from libcuda at run time

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

// ---------------------------------------------------------------------------
// TMA and mbarriers (sm_90)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make the initialised barriers visible to the TMA unit
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the producer's arrival, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// wait until the barrier has completed the phase of the given parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// One box of a 2-D tensor map at (c0, c1), c0 along the unit-stride axis,
// into shared memory at dst; its bytes complete_tx on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Where tile element (s, f) sits in shared memory, in elements.  Padded: rows
// of LD elements.  Swizzle128 (f64 only): TMA's 128-byte swizzle over a tile
// of ROWS rows along s, cut along f into boxes of 16 elements (128 bytes a
// row), each box ROWS x 128 bytes and 1024-byte aligned; 16-byte chunk c of
// a box's row s sits at c ^ (s % 8), which is where a TMA copy with
// CU_TENSOR_MAP_SWIZZLE_128B puts it.  The cp.async loaders write the same
// layout, so the fragment reads are the same for every loader.
template <int LD>
struct Padded {
  __device__ __forceinline__ static int at(int s, int f) { return s * LD + f; }
};
template <int ROWS>
struct Swizzle128 {
  static_assert(ROWS % 8 == 0, "whole 1024-byte periods of the swizzle a box");
  __device__ __forceinline__ static int at(int s, int f) {
    return (f >> 4) * (ROWS * 16) + s * 16 + ((((f >> 1) & 7) ^ (s & 7)) << 1) + (f & 1);
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
// m16n8 tiles, or 2 x 8 where the mma computes C^T), BK deep, in a ring of
// STAGES.
template <int BM_, int BN_, int BK_, int STAGES_, int WM_, int WN_>
struct DTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_, WM = WM_, WN = WN_;
  static constexpr int WARPS = WM * WN, THREADS = 32 * WARPS;
  static constexpr int MI = BM / (16 * WM), NJ = BN / (8 * WN);
  static constexpr int A_SIZE = BM * BK, B_SIZE = BN * BK;  // elements of a stage
  static constexpr int RING = STAGES * (A_SIZE + B_SIZE) * static_cast<int>(sizeof(double));
  // the TMA ring: aligned up to the swizzle's 1024-byte period, then a full
  // and an empty mbarrier a stage
  static constexpr int SMEM_TMA = RING + 1024 + 2 * STAGES * 8;
  static_assert(MI * 16 * WM == BM && NJ * 8 * WN == BN && NJ % 2 == 0, "whole warp tiles");
  static_assert(BK % 16 == 0 && STAGES >= 2, "whole 128-byte boxes of k, a ring");
};

// The loaders of the C interface: one cp.async copy an element (kScalar),
// 16-byte cp.async copies (kVector), both by every thread with a block-wide
// barrier a k step; TMA boxes requested by one thread and awaited on mbarriers
// (kTma).  dmma_kernel takes kTma or kScalar, the other kernels kVector or
// kScalar.
enum Loader : int { kScalar = 0, kVector = 1, kTma = 2 };

// mma row g of an m16 tile (column g of an n8 tile) read from a tile stored
// along k sits at tile row rho(g) = 0, 4, 1, 5, 2, 6, 3, 7 for g = 0..7: the
// two rows a quarter-warp reads at once are then four chunks apart under
// the swizzle, so its 16-byte reads hit distinct banks.
__device__ __forceinline__ int rho(int g) { return (g >> 1) | ((g & 1) << 2); }

template <class D, bool A_KFAST, bool B_KFAST, bool TMA>
__global__ void __launch_bounds__(D::THREADS, 1)
    dmma_kernel(const MatArgs<double> p, const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb) {
  constexpr int BK = D::BK, MI = D::MI, NJ = D::NJ, S = D::STAGES;
  using LA = Swizzle128<A_KFAST ? D::BM : BK>;
  using LB = Swizzle128<B_KFAST ? D::BN : BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = TMA ? (raw + 1023u) & ~1023u : raw;
  double* const As = reinterpret_cast<double*>(smem_raw + (ring - raw));
  double* const Bs = As + S * D::A_SIZE;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / D::WN) * (16 * MI), wn = (warp % D::WN) * (8 * NJ);  // this warp's tile
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * D::BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * D::BN;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * p.k_chunk;
  const int64_t k_end = min(k_begin + p.k_chunk, p.K);

  // The mma's A operand (16 rows x 8 k) is read from the P tile, its B
  // operand (8 k x 8 columns) from the Q tile.  A lane's reads land in the
  // registers the mma takes them in, with no moves between them.  They are
  // double2 reads, conflict-free under the swizzle, where P is stored along
  // its rows and Q along k; the other two layouts take one double a read
  // (two-way bank conflicts where P is stored along k).  So where A is
  // stored along k and B along n (the DGEMM's row-major operands) the mma
  // computes C^T = B^T A^T: P is B's tile and Q is A's.  Every output sums
  // the same products in the same k order either way.
  constexpr bool SWAP = A_KFAST && !B_KFAST;
  constexpr bool P_KFAST = SWAP ? B_KFAST : A_KFAST, Q_KFAST = SWAP ? A_KFAST : B_KFAST;
  // this warp's 64 x 32 of C in PI m16 tiles along P's side, QJ n8 tiles along Q's
  constexpr int PI = SWAP ? NJ / 2 : MI, QJ = SWAP ? 2 * MI : NJ;
  using LP = std::conditional_t<SWAP, LB, LA>;
  using LQ = std::conditional_t<SWAP, LA, LB>;
  const int pw = SWAP ? wn : wm, qw = SWAP ? wm : wn;

  double acc[PI][QJ][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < QJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  // The fragments of the k8 step at kk.  k is permuted inside the step, the
  // same way for both operands (the step's sum is unchanged): mma k slot t is
  // k = kk + 2t and slot t + 4 is kk + 2t + 1, so a lane reads its two k of
  // Q as one double2 where Q is stored along k; there mma row (column) g is
  // tile row rho(g).  Where P is stored along its rows, mma row g of an m16
  // tile is row 2g and row g + 8 is 2g + 1: a lane reads them as one double2.
  auto fragments = [&](const double* p_s, const double* q_s, int kk, double (&a)[PI][4],
                       double (&b)[QJ][2]) {
    const int k = kk + 2 * t;
#pragma unroll
    for (int i = 0; i < PI; ++i) {
      if constexpr (P_KFAST) {
        const int r = pw + 16 * i + rho(g);
        a[i][0] = p_s[LP::at(r, k)];
        a[i][1] = p_s[LP::at(r + 8, k)];
        a[i][2] = p_s[LP::at(r, k + 1)];
        a[i][3] = p_s[LP::at(r + 8, k + 1)];
      } else {
        const int r = pw + 16 * i + 2 * g;
        const double2 x = ld2(p_s + LP::at(k, r)), y = ld2(p_s + LP::at(k + 1, r));
        a[i][0] = x.x; a[i][1] = x.y; a[i][2] = y.x; a[i][3] = y.y;
      }
    }
    if constexpr (Q_KFAST) {
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const double2 x = ld2(q_s + LQ::at(qw + 8 * j + rho(g), k));
        b[j][0] = x.x; b[j][1] = x.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int c = qw + 8 * j + g;
        b[j][0] = q_s[LQ::at(k, c)];
        b[j][1] = q_s[LQ::at(k + 1, c)];
      }
    }
  };
  auto compute = [&](int slot) {
    const double* a_s = As + slot * D::A_SIZE;
    const double* b_s = Bs + slot * D::B_SIZE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      double a[PI][4], b[QJ][2];
      fragments(SWAP ? b_s : a_s, SWAP ? a_s : b_s, kk, a, b);
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) dmma(acc[i][j], a[i], b[j]);
    }
  };

  const int steps = static_cast<int>((k_end - k_begin + BK - 1) / BK);
  if constexpr (TMA) {
    // A full and an empty barrier a slot.  full: the producer's arrival with
    // the stage's bytes, then the copies' bytes; empty: every warp, once it
    // has read the slot.  A k loop with no block-wide barrier.
    const uint32_t full = ring + D::RING, empty = full + 8 * S;
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, D::WARPS);
      }
      fence_mbar_init();
    }
    __syncthreads();
    // step st's boxes into its slot: A, where stored along k, in BK / 16
    // boxes of 16 k by BM rows, else in BM / 16 boxes of 16 m by BK rows; B
    // likewise
    auto load_stage = [&](int st) {
      const int slot = st % S;
      const uint32_t bar = full + 8 * slot;
      const uint32_t a_s = ring + slot * D::A_SIZE * 8;
      const uint32_t b_s = ring + (S * D::A_SIZE + slot * D::B_SIZE) * 8;
      const int k0 = static_cast<int>(k_begin) + st * BK;
      const int mi = static_cast<int>(m0), ni = static_cast<int>(n0);
      mbar_expect_tx(bar, (D::A_SIZE + D::B_SIZE) * 8);
      if constexpr (A_KFAST) {
#pragma unroll
        for (int kb = 0; kb < BK / 16; ++kb)
          tma_load(a_s + kb * D::BM * 128, &ta, bar, k0 + 16 * kb, mi);
      } else {
#pragma unroll
        for (int mb = 0; mb < D::BM / 16; ++mb)
          tma_load(a_s + mb * BK * 128, &ta, bar, mi + 16 * mb, k0);
      }
      if constexpr (B_KFAST) {
#pragma unroll
        for (int kb = 0; kb < BK / 16; ++kb)
          tma_load(b_s + kb * D::BN * 128, &tb, bar, k0 + 16 * kb, ni);
      } else {
#pragma unroll
        for (int nb = 0; nb < D::BN / 16; ++nb)
          tma_load(b_s + nb * BK * 128, &tb, bar, ni + 16 * nb, k0);
      }
    };
    if (tid == 0) {
      prefetch_tensormap(&ta);
      prefetch_tensormap(&tb);
      for (int st = 0; st < S && st < steps; ++st) load_stage(st);
    }
    for (int st = 0; st < steps; ++st) {
      const int slot = st % S;
      // one thread refills the slot step st - 1 used, once every warp has
      // released it, S - 1 steps ahead of this one
      if (tid == 0 && st > 0 && st - 1 + S < steps) {
        mbar_wait(empty + 8 * ((st - 1) % S), ((st - 1) / S) & 1);
        load_stage(st - 1 + S);
      }
      mbar_wait(full + 8 * slot, (st / S) & 1);
      compute(slot);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }
  } else {
    k_loop<S>(
        steps,
        [&](int slot, int st) {
          load_step<double, D::BM, D::BN, BK, LA, LB, D::THREADS, A_KFAST, B_KFAST, false>(
              As + slot * D::A_SIZE, Bs + slot * D::B_SIZE, p, m0, n0,
              k_begin + static_cast<int64_t>(st) * BK, k_end, tid);
        },
        compute);
  }

  // fragment (h, e) is mma row g + 8h, column 2t + e: row pr of P's side,
  // column qc of Q's; a split writes its slice
  double* const out = p.part ? p.part + static_cast<int64_t>(blockIdx.z) * p.M * p.N : p.C;
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pr = pw + 16 * i + (P_KFAST ? rho(g) + 8 * h : 2 * g + h);
#pragma unroll
      for (int j = 0; j < QJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * t + e;
          const int qc = qw + 8 * j + (Q_KFAST ? rho(c) : c);
          const int64_t m = m0 + (SWAP ? qc : pr), n = n0 + (SWAP ? pr : qc);
          if (m < p.M && n < p.N) out[m * p.N + n] = acc[i][j][2 * h + e];
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
using DTileNarrow = DTile<128, 64, 32, 2, 2, 2>;
using DTileWide = DTile<128, 128, 32, 3, 2, 4>;

// cuTensorMapEncodeTiled, fetched from libcuda through the runtime, so
// that the library links nothing beyond the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The TMA map of an f64 operand read along its unit-stride axis: `fast`
// elements a row, `slow` rows `ld` elements apart, boxes of 16 x `rows`
// elements under the 128-byte swizzle, zeros outside the operand.  False
// where cuTensorMapEncodeTiled refuses it.
bool encode_f64(CUtensorMap* map, const double* base, int64_t fast, int64_t slow, int64_t ld,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(fast), static_cast<cuuint64_t>(slow)};
  // a single row's stride is never used: any whole 16 bytes past the row
  const cuuint64_t stride[1] = {
      static_cast<cuuint64_t>(slow > 1 ? ld * 8 : (fast * 8 + 15) / 16 * 16)};
  const cuuint32_t box[2] = {16, static_cast<cuuint32_t>(rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, const_cast<double*>(base), dims, stride,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class D, bool AK, bool BK, bool TMA>
void launch_dmma_kernel(const MatArgs<double>& p, int splits, const CUtensorMap& ta,
                        const CUtensorMap& tb, cudaStream_t s) {
  auto kernel = dmma_kernel<D, AK, BK, TMA>;
  const int smem = TMA ? D::SMEM_TMA : D::RING;
  const dim3 grid(cdiv(p.M, D::BM), cdiv(p.N, D::BN), splits);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) ==
      cudaSuccess)
    kernel<<<grid, D::THREADS, smem, s>>>(p, ta, tb);
}

// loader: kTma (the wrapper has checked what TMA needs of both operands) or
// kScalar.  False where a tensor map is refused, or for the 128 x 128
// tile where A is read along k (the wrapper never picks it there).
template <class D>
bool launch_dmma(int loader, const MatArgs<double>& p, int splits, cudaStream_t s) {
  constexpr bool wide = std::is_same<D, DTileWide>::value;
  const bool ak = p.sak == 1, bk = p.sbn != 1;
  if (wide && ak) return false;
  CUtensorMap ta{}, tb{};
  if (loader == kTma) {
    // A (M x K) in rows of k (ak) or of m; B (K x N) in rows of k (bk) or of n
    const bool ok =
        (ak ? encode_f64(&ta, p.A, p.K, p.M, p.sam, D::BM)
            : encode_f64(&ta, p.A, p.M, p.K, p.sak, D::BK)) &&
        (bk ? encode_f64(&tb, p.B, p.K, p.N, p.sbn, D::BN)
            : encode_f64(&tb, p.B, p.N, p.K, p.sbk, D::BK));
    if (!ok) return false;
  }
  with_flags(ak, bk, loader == kTma, [&](auto AK, auto BK, auto TMA) {
    constexpr bool a = decltype(AK)::value, b = decltype(BK)::value;
    if constexpr (!(wide && a))
      launch_dmma_kernel<D, a, b, decltype(TMA)::value>(p, splits, ta, tb, s);
  });
  return true;
}

// config 0: wide outputs (f64: the BM x BN block tile), 1: N <= 8; false
// where f64 names no tile this file has or TMA refuses an operand.
template <typename T>
bool launch_main(int config, int bm, int bn, int loader, const MatArgs<T>& p, int splits,
                 cudaStream_t s) {
  const bool a_kfast = p.sak == 1, b_kfast = p.sbn != 1, vec = loader != kScalar;
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
      return launch_dmma<DTileNarrow>(loader, p, splits, s);
    if (bm == DTileWide::BM && bn == DTileWide::BN)
      return launch_dmma<DTileWide>(loader, p, splits, s);
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
int launch(int config, int bm, int bn, int loader, const void* A, const void* B, void* C,
           void* part, int64_t M, int64_t N, int64_t K, int64_t sam, int64_t sak, int64_t sbk,
           int64_t sbn, int64_t k_chunk, int splits, cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  Acc* pt = splits > 1 ? static_cast<Acc*>(part) : nullptr;
  const MatArgs<T> p{static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C), pt,
                     M, N, K, sam, sak, sbk, sbn, k_chunk};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    launch_bf16(config, p, splits, stream);
  } else if (!launch_main<T>(config, bm, bn, loader, p, splits, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return reduce_splits(p, splits, stream);
}

}  // namespace

// config: 0 wide outputs (N > 8), 1 skinny (N <= 8).  bm, bn: the f64 wide
// block tile (128 x 64 or 128 x 128); other launches ignore them.  loader
// (the wrapper checks base and leading-stride alignment): 2 TMA (f64, N > 8
// only), 1 16-byte cp.async copies along each operand's unit-stride axis, 0
// the element-by-element loader.  bf16 ignores it.
extern "C" int repro_matmul(int dtype, int config, int bm, int bn, int loader, const void* A,
                            const void* B, void* C, void* part, int64_t M, int64_t N, int64_t K,
                            int64_t sam, int64_t sak, int64_t sbk, int64_t sbn, int64_t k_chunk,
                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(config, bm, bn, loader, A, B, C, part, M, N, K, sam, sak, sbk, sbn,
                           k_chunk, splits, s);
    case REPRO_F64:
      return launch<double>(config, bm, bn, loader, A, B, C, part, M, N, K, sam, sak, sbk, sbn,
                            k_chunk, splits, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(config, bm, bn, loader, A, B, C, part, M, N, K, sam, sak, sbk,
                                   sbn, k_chunk, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
