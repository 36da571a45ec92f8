// Flash attention backward for Hopper (sm_90a): the gradients dQ, dK, dV of
// flash_attention.cu's grouped-query attention (1/sqrt(hd) scale, causal
// with a query offset, an optional sliding window), from q, k, v, the
// forward's output O, its log-sum-exp lse and the output gradient dO.
// f32 or bf16 in and out, f32 inside.
//
// Replaces: src/repro/kernels/flash_attention_bwd.py::_dkv_kernel and
// _dq_kernel (through _vjp_bwd).  Like them it recomputes the probabilities
// P = exp(S - lse) tile by tile and never stores the (Sq, Skv) matrix:
//     dV += P^T dO;   dP = dO V^T;   dS = P * (dP - delta) * scale;
//     dK += dS^T Q (summed over the rep query heads of each kv head);
//     dQ += dS K,     with delta = rowsum(dO * O).
// Three kernels, all deterministic (no atomics: two backward runs give the
// same bits), as the TPU kernel's two-kernel split is:
// - delta_kernel: delta per query row, one warp per row (a small pre-pass).
// - a dK/dV kernel: one block per (batch, kv head, tile of keys).  The block
//   walks the query rows that can see any of its keys -- every position of
//   the range at all rep heads of its kv head, position-major, head-minor --
//   and sums over them.
// - a dQ kernel: one block per (batch, kv head, tile of query rows); its
//   rows are the rep heads at each position, as in the forward.  It walks
//   the key tiles its rows can see.
// Both skip the tiles a causal mask or a window hides wholly, and mask
// queries >= Sq and keys >= Skv explicitly, so no length needs padding (the
// TPU wrapper requires Sq % bq == 0 and Skv % bk == 0).  A row that sees no
// key (lse = -inf) is never visible, so its gradients are exactly 0.
//
// What bounds it on this card: operations.  Per visible (query, key) pair
// and head the five products S = QK^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q and dQ += dS K do 10 * hd flops (S and dP are computed in
// both kernels, 14 * hd in all), against q, k, v, O, dO read once or a few
// times per tile.
//
// What the design does about it, by dtype:
// - bf16 (dkv_mma_kernel, dq_mma_kernel): the products run on the tensor
//   cores, mma.sync m16n8k16 bf16 x bf16 -> f32, four warps of 16 keys
//   (dK/dV) or 16 query rows (dQ) each.  Operand fragments come from
//   shared memory by ldmatrix (.trans where the product contracts over
//   the tile's rows).  The softmax arithmetic stays in f32 registers:
//   P = exp2(S * scale * log2 e - lse * log2 e) and dS = P * (dP - delta)
//   are rounded to bf16 only as the A operand of the next product (taken
//   straight from the accumulator fragments, as FlashAttention-2 does).
//   Tiles stay bf16 in shared memory (rows padded by 16 bytes, so the
//   eight rows of an ldmatrix fall in distinct banks), filled by 16-byte
//   cp.async copies, double-buffered: the next query tile (dK/dV) or key
//   tile (dQ) is on its way while one is computed (deeper rings measured no
//   faster on the H100: the kernels are not waiting on these copies).  A
//   warp skips a tile that none of its 16 keys or rows can see, and drops
//   the mask on a tile that all of them see whole.
//   Head dim 256: a warp's dK and dV fragments for 16 keys would be 256 f32
//   registers a thread before S and dP.  So the dK/dV block takes 32 keys,
//   and its four warps pair up: both warps of a pair compute S^T and dP^T
//   for the pair's 16 keys over the whole head dim, and each owns one half
//   of the head dim of dK and dV (128 registers, as the forward's
//   accumulator at hd 256).  The cost is S and dP computed twice: 12 * hd
//   flops of products per visible pair and head in this kernel instead of
//   8 * hd.  Still no atomics, so the bits do not depend on the schedule.
//   Shared memory 102,144 B a block (K, V of 32 keys, two stages of 32
//   query rows), 2 blocks per SM.  The dQ kernel keeps its layout (16 rows
//   a warp, dQ's 128 registers, Q and dO fragments by ldmatrix each k-step)
//   with key tiles of 16: 101,376 B a block, 2 blocks per SM.
// - f32 (dkv_f32_kernel, dq_f32_kernel): IEEE f32 FMA only (the tensor
//   cores would take f32 only through TF32, which the port never uses), so
//   f32 FMA operations bound them: 67 TFLOP/s on the H100.  256 threads a
//   block; every product is a register micro-tile of outer products over
//   shared memory tiles (f32_tiles.cuh), so each 16-byte chunk a thread
//   reads feeds 2 to 4 of its outputs, and a warp's threads read few
//   distinct chunks (broadcasts, no bank conflict).  The dK/dV block takes
//   64 keys (32 above hd 64), so each kv head's Q and dO are read from
//   device memory Skv / 64 (or / 32) times; a 16 x 16 grid of threads
//   computes S^T and dP^T for 2-4 keys x 2-4 query rows each, stages P^T
//   and dS^T in shared memory rows that only their warp reads (__syncwarp),
//   and accumulates dV += P^T dO and dK += dS^T Q in registers (2 keys x 16
//   dims each at hd 256).  K and V stay resident; Q, dO, lse and delta
//   tiles of 32 rows (64 up to hd 32) come by cp.async, two in flight.  A
//   grid of fewer dK/dV blocks than the card has SMs (one kv head at rep
//   64) splits each block's query rows into `splits` ranges, whose partial
//   dK and dV dkv_split_combine_kernel sums in range order.  The dQ block
//   is the forward's: 64 position-major rows of one kv head (so rep does
//   not bound it), a 32 x 8 grid, 2 rows x 2-8 keys of S and dP a thread
//   and its rows' dQ (2 x hd / 8 dims) in registers; Q and dO stay
//   resident, K and V tiles of 16-64 keys come two in flight.  Blocks start
//   in causal-work order across all (batch, kv head): the first keys
//   (dK/dV) or the last rows (dQ) first.  As compiled on the H100
//   (PERF.md): 256 threads; at hd 256 162 (dK/dV) and 171 (dQ) registers,
//   208 and 201 KB of dynamic shared memory, one block of 8 warps per SM;
//   at hd 64 128 registers (the launch bound), 93 and 78 KB, two blocks.
//
// Operands are read through strides (batch, head, position; the head
// dimension is contiguous), so the model's (B, S, H, hd) activations are
// read and the gradients written in place, without transposing copies.
// The kernels copy rows 16 bytes at a time, so they need every operand's
// base and strides 16-byte aligned: the wrapper copies a view that is not
// into a new tensor first.
#include <math.h>

#include "common.cuh"
#include "f32_tiles.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 128;  // threads per block of delta_kernel and the bf16 kernels (four warps)

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq) contiguous
  float* delta;      // (B, H, Sq) contiguous, written by delta_kernel
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_sh, q_ss;  // element strides: batch, head, position
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  int B, H, KV, Sq, Skv;
  int rep;       // query heads per kv head
  int bq;        // query positions per bf16 dQ block
  int causal;    // 0 or 1
  int window;    // 0: no window; else key j is visible iff j > q - window
  int q_offset;  // absolute position of query 0
  float scale;
  int splits;    // f32 dK/dV: query ranges per block of keys; 1: no split
  float* ws;     // splits > 1: partial dK (splits, B, KV, Skv, hd), then partial dV
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qabs, int kj) {
  return kj < a.Skv && (!a.causal || kj <= qabs) && (a.window <= 0 || kj > qabs - a.window);
}

template <typename T>
__global__ void __launch_bounds__(NT) delta_kernel(const BwdArgs a, int hd) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  if (row >= static_cast<int64_t>(a.B) * a.H * a.Sq) return;  // whole warps leave
  const int i = static_cast<int>(row % a.Sq);
  const int h = static_cast<int>((row / a.Sq) % a.H);
  const int b = static_cast<int>(row / (static_cast<int64_t>(a.Sq) * a.H));
  const T* op = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh + i * a.o_ss;
  const T* dp = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh + i * a.do_ss;
  float s = 0.0f;
  for (int d = lane; d < hd; d += 32) s = fmaf(to_f32(dp[d]), to_f32(op[d]), s);
#pragma unroll
  for (int w = 16; w > 0; w /= 2) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) a.delta[row] = s;
}

// ---------------------------------------------------------------------------
// f32: register micro-tiles of IEEE FMA (f32_tiles.cuh)
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// Split s's steps [lo, hi) of n: contiguous, as even as whole steps allow.
__device__ __forceinline__ void split_range(int n, int s, int splits, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<int64_t>(s) * n / splits);
  hi = static_cast<int>(static_cast<int64_t>(s + 1) * n / splits);
}

// tile sizes of the f32 kernels at head dim HD
template <int HD>
struct F32Tiles {
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 2;                  // query (dK/dV) or key (dQ) tiles in flight
  static constexpr int LD = HD + 4;                 // padded row of a tile, in floats
  // dK/dV: a 16 x 16 grid; its rows are keys, its columns query rows (S^T,
  // dP^T) or head-dim chunks (dK, dV)
  static constexpr int KV_GC = 16, KV_GR = THREADS / KV_GC;
  static constexpr int BKV = HD <= 64 ? 64 : 32;    // keys per block (dkv_key_tile)
  static constexpr int BQ = HD <= 32 ? 64 : 32;     // query rows per step (dkv_row_step)
  static constexpr int KV_TR = BKV / KV_GR, KV_TC = BQ / KV_GC;
  static constexpr int KV_LDP = BQ + 16;            // padded row of P^T, dS^T: a warp's two
                                                    // key groups write 32 distinct banks
  using KV_CH = f32t::Chunks<HD, KV_GC>;            // head dims of dK, dV a thread owns
  static constexpr int DKV_SMEM = (2 * BKV * LD + STAGES * 2 * BQ * LD + 2 * BKV * KV_LDP) * 4 +
                                  STAGES * BQ * 12;
  // dQ: a 32 x 8 grid, as the forward's; rows are query rows
  static constexpr int Q_GC = 8, Q_GR = THREADS / Q_GC;
  static constexpr int ROWS = 64;                   // query rows per block, position-major
  static constexpr int BKQ = HD <= 32 ? 64 : HD <= 64 ? 32 : 16;  // keys per step
  static constexpr int Q_TR = ROWS / Q_GR, Q_TC = BKQ / Q_GC;
  static constexpr int Q_LDP = BKQ + 8;             // padded row of dS
  using Q_CH = f32t::Chunks<HD, Q_GC>;              // head dims of dQ a thread owns
  static constexpr int DQ_SMEM = (2 * ROWS * LD + STAGES * 2 * BKQ * LD + ROWS * Q_LDP) * 4;
};

// One block per (batch, kv head, BKV keys); K and V stay resident.  Thread
// (gr, gc) owns keys gr + 16 i: their S^T and dP^T against query rows
// gc + 16 j of each step, and their dK and dV in head-dim chunks gc + 16 c.
// A key's 16 threads share a warp, so P^T and dS^T go through shared
// memory rows that only that warp writes and reads.
template <int HD>
__global__ void __launch_bounds__(F32Tiles<HD>::THREADS, HD > 128 ? 1 : 2)
    dkv_f32_kernel(const BwdArgs a) {
  using TL = F32Tiles<HD>;
  constexpr int NTH = TL::THREADS, GC = TL::KV_GC, GR = TL::KV_GR, TR = TL::KV_TR;
  constexpr int TC = TL::KV_TC, BKV = TL::BKV, BQ = TL::BQ, LD = TL::LD, LDP = TL::KV_LDP;
  constexpr int ST = TL::STAGES, CW = TL::KV_CH::CW, NCH = TL::KV_CH::N, CH4 = HD / 4;
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;                // BKV x LD
  float* Vs = Ks + BKV * LD;        // BKV x LD
  float* Qs = Vs + BKV * LD;        // ST stages x BQ rows
  float* dOs = Qs + ST * BQ * LD;   // ST stages x BQ rows
  float* Ps = dOs + ST * BQ * LD;   // BKV x LDP: P^T of this step
  float* dSs = Ps + BKV * LDP;      // BKV x LDP: dS^T / scale of this step
  float* lse_s = dSs + BKV * LDP;   // ST x BQ
  float* dl_s = lse_s + ST * BQ;    // ST x BQ
  int* qabs_s = reinterpret_cast<int*>(dl_s + ST * BQ);  // ST x BQ; -1: no row

  const int tid = threadIdx.x, gc = tid % GC, gr = tid / GC;
  // the grid is (key blocks x splits, KV, B); blocks are handed out in the
  // order of their linear index, which here runs over the key blocks
  // slowest, so that under a causal mask the first keys, seen by the most
  // rows, start first across every (batch, kv head)
  int b, kvh, split, k0;
  {
    const int units = a.splits * a.KV * a.B;  // blocks a key block
    const int64_t lin =
        blockIdx.x + static_cast<int64_t>(gridDim.x) * (blockIdx.y + gridDim.y * blockIdx.z);
    const int rem = static_cast<int>(lin % units);
    k0 = static_cast<int>(lin / units) * BKV;
    split = rem % a.splits;
    kvh = rem / a.splits % a.KV;
    b = rem / a.splits / a.KV;
  }
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb;

  for (int idx = tid; idx < BKV * CH4; idx += NTH) {
    const int r = idx / CH4, c = idx % CH4, kj = k0 + r;
    const bool ok = kj < a.Skv;
    const int64_t off = static_cast<int64_t>(ok ? kj : 0);
    f32t::copy_chunk(Ks + r * LD, kb + off * a.k_ss, c, ok);
    f32t::copy_chunk(Vs + r * LD, vb + off * a.v_ss, c, ok);
  }

  // query positions that may see any key of this block: [i_lo, i_hi); rows
  // f = i * rep + head (position-major), fewer than 2^31 (the launch checks)
  const int k_last = min(k0 + BKV, a.Skv) - 1;
  const int i_lo = a.causal ? min(a.Sq, max(0, k0 - a.q_offset)) : 0;
  const int i_hi = a.window > 0
      ? static_cast<int>(max(static_cast<int64_t>(i_lo),
                             min(static_cast<int64_t>(a.Sq),
                                 static_cast<int64_t>(k_last) + a.window - a.q_offset)))
      : a.Sq;
  const int f_end = max(i_hi, i_lo) * a.rep;
  // this split's steps of BQ rows [t_lo, t_hi) of the range's
  int t_lo, t_hi;
  split_range((f_end - i_lo * a.rep + BQ - 1) / BQ, split, a.splits, t_lo, t_hi);
  const int f_begin = i_lo * a.rep + t_lo * BQ;
  const int n_tiles = t_hi - t_lo;

  // rows t * BQ ... of this split's range into stage `stage`: q, dO, lse,
  // delta by cp.async (zeros past the range), and each row's absolute
  // position
  auto load_rows = [&](int t, int stage) {
    const int f0 = f_begin + t * BQ;
    for (int idx = tid; idx < BQ * CH4; idx += NTH) {
      const int r = idx / CH4, c = idx % CH4, f = f0 + r;
      const bool ok = f < f_end;
      const int i = ok ? f / a.rep : 0;
      const int h = kvh * a.rep + (ok ? f - i * a.rep : 0);
      const int64_t qi = i;
      f32t::copy_chunk(Qs + (stage * BQ + r) * LD, qb + h * a.q_sh + qi * a.q_ss, c, ok);
      f32t::copy_chunk(dOs + (stage * BQ + r) * LD, dob + h * a.do_sh + qi * a.do_ss, c, ok);
    }
    for (int r = tid; r < BQ; r += NTH) {
      const int f = f0 + r;
      const bool ok = f < f_end;
      const int i = ok ? f / a.rep : 0;
      const int h = kvh * a.rep + (ok ? f - i * a.rep : 0);
      const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + i;
      tc::cp_async4(lse_s + stage * BQ + r, a.lse + row, ok);
      tc::cp_async4(dl_s + stage * BQ + r, a.delta + row, ok);
      qabs_s[stage * BQ + r] = ok ? i + a.q_offset : -1;
    }
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {  // K, V and the first ST - 1 query tiles
    if (t < n_tiles) load_rows(t, t);
    tc::cp_async_commit();
  }

  const float scale_log2 = a.scale * LOG2E;
  float dk[TR][CW * NCH], dv[TR][CW * NCH];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int d = 0; d < CW * NCH; ++d) dk[i][d] = dv[i][d] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<ST - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + ST - 1 < n_tiles) load_rows(t + ST - 1, (t + ST - 1) % ST);  // t - 1's stage
    tc::cp_async_commit();
    const int stage = t % ST;
    const float* Qt = Qs + stage * BQ * LD;
    const float* dOt = dOs + stage * BQ * LD;
    const int f0 = f_begin + t * BQ;
    const int p_first = f0 / a.rep + a.q_offset;
    const int p_last = (min(f0 + BQ, f_end) - 1) / a.rep + a.q_offset;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns query rows
    float st[TR][TC], dpt[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) st[i][j] = dpt[i][j] = 0.0f;
    f32t::abt<HD, TR, TC, GR, GC, LD>(st, Ks, Qt, gr, gc);
    f32t::abt<HD, TR, TC, GR, GC, LD>(dpt, Vs, dOt, gr, gc);
    // a step whose every row sees every key of the block needs no mask
    const bool full = k0 + BKV <= a.Skv && f0 + BQ <= f_end &&
                      (!a.causal || k0 + BKV - 1 <= p_first) &&
                      (a.window <= 0 || k0 > p_last - a.window);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int n = gc + GC * j;
      const float lse2 = lse_s[stage * BQ + n] * LOG2E;
      const float dl = dl_s[stage * BQ + n];
      const int qa = qabs_s[stage * BQ + n];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = gr + GR * i;
        const float p = full || (qa >= 0 && visible(a, qa, k0 + r))
                            ? exp2f(fmaf(st[i][j], scale_log2, -lse2))
                            : 0.0f;
        Ps[r * LDP + n] = p;
        dSs[r * LDP + n] = p * (dpt[i][j] - dl);  // dS / scale
      }
    }
    __syncwarp();  // this warp's rows of P^T and dS^T are written
    f32t::pb<BQ, TR, GR, GC, CW, NCH, LDP, LD>(dv, Ps, dOt, gr, gc);   // dV += P^T dO
    f32t::pb<BQ, TR, GR, GC, CW, NCH, LDP, LD>(dk, dSs, Qt, gr, gc);   // dK += dS^T Q
  }
  tc::cp_async_wait<0>();

  // the gradients, or with splits > 1 this split's partials: rows of hd
  // floats in the workspace, summed in split order by dkv_split_combine_kernel
  const bool part = a.splits > 1;
  const int64_t part_rows = static_cast<int64_t>(a.B) * a.KV * a.Skv;  // rows a split
  const int64_t wrow0 = (static_cast<int64_t>(split) * a.B * a.KV + b * a.KV + kvh) * a.Skv;
  float* dkb = part ? a.ws + wrow0 * HD
                    : static_cast<float*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
  float* dvb = part ? a.ws + (a.splits * part_rows + wrow0) * HD
                    : static_cast<float*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
  const int64_t dk_ss = part ? HD : a.dk_ss, dv_ss = part ? HD : a.dv_ss;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int kj = k0 + gr + GR * i;
    if (kj >= a.Skv) continue;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = CW * (gc + GC * c);
      f32t::store_chunk<CW>(dkb + kj * dk_ss + d, dk[i] + c * CW, a.scale);
      f32t::store_chunk<CW>(dvb + kj * dv_ss + d, dv[i] + c * CW, 1.0f);
    }
  }
}

// dK and dV of a split f32 dK/dV launch: each element the sum of its
// splits' partials, taken in split order (no atomics: two launches give
// the same bits).  One thread per element.
__global__ void __launch_bounds__(NT) dkv_split_combine_kernel(const BwdArgs a, int hd) {
  const int64_t n = static_cast<int64_t>(a.B) * a.KV * a.Skv * hd;  // elements a split
  const int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (e >= n) return;
  const int d = static_cast<int>(e % hd);
  const int64_t r = e / hd;
  const int kj = static_cast<int>(r % a.Skv);
  const int kvh = static_cast<int>(r / a.Skv % a.KV);
  const int b = static_cast<int>(r / a.Skv / a.KV);
  float sk = 0.0f, sv = 0.0f;
  for (int s = 0; s < a.splits; ++s) {
    sk += a.ws[s * n + e];
    sv += a.ws[(a.splits + s) * n + e];
  }
  static_cast<float*>(a.dk)[b * a.dk_sb + kvh * a.dk_sh + kj * a.dk_ss + d] = sk;
  static_cast<float*>(a.dv)[b * a.dv_sb + kvh * a.dv_sh + kj * a.dv_ss + d] = sv;
}

// One block per (batch, kv head, 64 position-major query rows); Q and dO
// stay resident.  Thread (gr, gc) owns rows gr + 32 i: their S and dP
// against keys gc + 8 j of each step, and their dQ in head-dim chunks
// gc + 8 c, as the forward's threads own O.
template <int HD>
__global__ void __launch_bounds__(F32Tiles<HD>::THREADS, HD > 128 ? 1 : 2)
    dq_f32_kernel(const BwdArgs a) {
  using TL = F32Tiles<HD>;
  constexpr int NTH = TL::THREADS, GC = TL::Q_GC, GR = TL::Q_GR, TR = TL::Q_TR;
  constexpr int TC = TL::Q_TC, ROWS = TL::ROWS, BKQ = TL::BKQ, LD = TL::LD, LDP = TL::Q_LDP;
  constexpr int ST = TL::STAGES, CW = TL::Q_CH::CW, NCH = TL::Q_CH::N, CH4 = HD / 4;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;               // ROWS x LD
  float* dOs = Qs + ROWS * LD;     // ROWS x LD
  float* Ks = dOs + ROWS * LD;     // ST stages x BKQ keys
  float* Vs = Ks + ST * BKQ * LD;  // ST stages x BKQ keys
  float* dSs = Vs + ST * BKQ * LD; // ROWS x LDP: dS / scale of this step

  const int tid = threadIdx.x, gc = tid % GC, gr = tid / GC;
  // the grid is (row tiles, KV, B); blocks are handed out in the order of
  // their linear index, which here runs over the row tiles slowest and in
  // reverse, so that under a causal mask the blocks with the most keys
  // start first across every (batch, kv head)
  int b, kvh, f0;
  {
    const int units = a.KV * a.B;  // blocks a row tile
    const int64_t lin =
        blockIdx.x + static_cast<int64_t>(gridDim.x) * (blockIdx.y + gridDim.y * blockIdx.z);
    const int rem = static_cast<int>(lin % units);
    f0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(lin / units)) * ROWS;
    kvh = rem % a.KV;
    b = rem / a.KV;
  }
  const int n_rows = a.Sq * a.rep;
  const int rows_ok = min(ROWS, n_rows - f0);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int idx = tid; idx < ROWS * CH4; idx += NTH) {
    const int r = idx / CH4, c = idx % CH4;
    const bool ok = r < rows_ok;
    const int i = ok ? (f0 + r) / a.rep : 0;
    const int h = kvh * a.rep + (ok ? f0 + r - i * a.rep : 0);
    const int64_t qi = i;
    f32t::copy_chunk(Qs + r * LD, qb + h * a.q_sh + qi * a.q_ss, c, ok);
    f32t::copy_chunk(dOs + r * LD, dob + h * a.do_sh + qi * a.do_ss, c, ok);
  }

  // keys any row of this block may see: [k_begin, k_end), in tiles
  const int blk_first = f0 / a.rep + a.q_offset;
  const int blk_last = (f0 + rows_ok - 1) / a.rep + a.q_offset;
  const int k_end = a.causal ? min(a.Skv, blk_last + 1) : a.Skv;
  int k_begin = a.window > 0 ? max(0, blk_first - a.window + 1) : 0;
  k_begin = (k_begin / BKQ) * BKQ;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BKQ - 1) / BKQ : 0;

  auto load_keys = [&](int t, int stage) {
    const int kt0 = k_begin + t * BKQ;
    for (int idx = tid; idx < BKQ * CH4; idx += NTH) {
      const int j = idx / CH4, c = idx % CH4, kj = kt0 + j;
      const bool ok = kj < a.Skv;
      const int64_t off = static_cast<int64_t>(ok ? kj : 0);
      f32t::copy_chunk(Ks + (stage * BKQ + j) * LD, kb + off * a.k_ss, c, ok);
      f32t::copy_chunk(Vs + (stage * BKQ + j) * LD, vb + off * a.v_ss, c, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {  // Q, dO and the first ST - 1 key tiles
    if (t < n_tiles) load_keys(t, t);
    tc::cp_async_commit();
  }

  // this thread's rows: absolute positions (-1 past the last), lse in log2
  // units, delta
  int qa[TR];
  float lse2[TR], dl[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = gr + GR * i;
    qa[i] = -1;
    lse2[i] = dl[i] = 0.0f;
    if (r < rows_ok) {
      const int f = f0 + r, pos = f / a.rep;
      const int h = kvh * a.rep + f - pos * a.rep;
      const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + pos;
      qa[i] = pos + a.q_offset;
      lse2[i] = a.lse[row] * LOG2E;
      dl[i] = a.delta[row];
    }
  }
  const float scale_log2 = a.scale * LOG2E;
  float dq[TR][CW * NCH];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int d = 0; d < CW * NCH; ++d) dq[i][d] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<ST - 2>();
    __syncthreads();  // tile t (and Q, dO) has landed; every warp is done with tile t - 1
    if (t + ST - 1 < n_tiles) load_keys(t + ST - 1, (t + ST - 1) % ST);  // t - 1's stage
    tc::cp_async_commit();
    const int stage = t % ST;
    const float* Kt = Ks + stage * BKQ * LD;
    const float* Vt = Vs + stage * BKQ * LD;
    const int kt0 = k_begin + t * BKQ;

    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.0f;
    f32t::abt<HD, TR, TC, GR, GC, LD>(s, Qs, Kt, gr, gc);    // S = Q K^T
    f32t::abt<HD, TR, TC, GR, GC, LD>(dp, dOs, Vt, gr, gc);  // dP = dO V^T
    // a step whose every key every row of the block sees needs no mask
    const bool full = rows_ok == ROWS && kt0 + BKQ <= a.Skv &&
                      (!a.causal || kt0 + BKQ - 1 <= blk_first) &&
                      (a.window <= 0 || kt0 > blk_last - a.window);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float* drow = dSs + (gr + GR * i) * LDP + gc;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kj = kt0 + gc + GC * j;
        drow[GC * j] = full || (qa[i] >= 0 && visible(a, qa[i], kj))
                           ? exp2f(fmaf(s[i][j], scale_log2, -lse2[i])) * (dp[i][j] - dl[i])
                           : 0.0f;  // dS / scale
      }
    }
    __syncwarp();  // this warp's rows of dS are written
    f32t::pb<BKQ, TR, GR, GC, CW, NCH, LDP, LD>(dq, dSs, Kt, gr, gc);  // dQ += dS K
  }
  tc::cp_async_wait<0>();

  float* dqb = static_cast<float*>(a.dq) + b * a.dq_sb;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (qa[i] < 0) continue;
    const int f = f0 + gr + GR * i, pos = f / a.rep;
    const int h = kvh * a.rep + f - pos * a.rep;
    float* row = dqb + h * a.dq_sh + static_cast<int64_t>(pos) * a.dq_ss;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      f32t::store_chunk<CW>(row + CW * (gc + GC * c), dq[i] + c * CW, a.scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using namespace tc;  // bf16, cp.async, ldmatrix, mma (mma.cuh)

// tile sizes of the bf16 kernels at head dim HD
template <int HD>
struct Tiles {
  static constexpr int DSPLIT = HD > 128 ? 2 : 1;  // warps sharing 16 keys, each a part of hd
  static constexpr int BKV = 64 / DSPLIT;          // keys per dK/dV block: 4 warps x 16 / DSPLIT
  static constexpr int BQ = HD <= 64 ? 64 : 32;    // query rows per dK/dV step
  static constexpr int ROWS = 64;                  // rows per dQ block: 4 warps x 16
  static constexpr int BKQ = HD <= 64 ? 64 : HD <= 128 ? 32 : 16;  // keys per dQ step
  static constexpr int LDS = HD + 8;              // shared row, in bf16: 16 bytes of padding
  static constexpr int CH = HD / 8;               // 16-byte chunks per row
  static constexpr int STAGES = 2;                // query (dK/dV) or key (dQ) tiles in flight
  static constexpr int DKV_SMEM = 2 * BKV * LDS * 2 + STAGES * (2 * BQ * LDS * 2 + BQ * 12);
  static constexpr int DQ_SMEM = 2 * ROWS * LDS * 2 + STAGES * 2 * BKQ * LDS * 2;
};

template <int HD>
__global__ void __launch_bounds__(NT) dkv_mma_kernel(const BwdArgs a) {
  using TL = Tiles<HD>;
  constexpr int BKV = TL::BKV, BQ = TL::BQ, LDS = TL::LDS, CH = TL::CH, ST = TL::STAGES;
  constexpr int DS = TL::DSPLIT, HDW = HD / DS;  // head dims of dK and dV a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * LDS;
  bf16* Qs = Vs + BKV * LDS;       // ST stages x BQ rows
  bf16* dOs = Qs + ST * BQ * LDS;  // ST stages x BQ rows
  float* lse_s = reinterpret_cast<float*>(dOs + ST * BQ * LDS);  // ST x BQ
  float* dl_s = lse_s + ST * BQ;                                 // ST x BQ
  int* qabs_s = reinterpret_cast<int*>(dl_s + ST * BQ);          // ST x BQ; -1: no row

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * BKV;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_sb;

  for (int idx = tid; idx < BKV * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, kj = k0 + r;
    const bool ok = kj < a.Skv;
    const int64_t off = static_cast<int64_t>(ok ? kj : 0);
    copy_row_chunk(Ks + r * LDS, kb + off * a.k_ss, c, ok);
    copy_row_chunk(Vs + r * LDS, vb + off * a.v_ss, c, ok);
  }

  // query positions that may see any key of this block: [i_lo, i_hi); rows
  // f = i * rep + head (position-major), fewer than 2^31 (the launch checks)
  const int k_last = min(k0 + BKV, a.Skv) - 1;
  const int i_lo = a.causal ? min(a.Sq, max(0, k0 - a.q_offset)) : 0;
  const int i_hi = a.window > 0
      ? static_cast<int>(max(static_cast<int64_t>(i_lo),
                             min(static_cast<int64_t>(a.Sq),
                                 static_cast<int64_t>(k_last) + a.window - a.q_offset)))
      : a.Sq;
  const int f_begin = i_lo * a.rep, f_end = max(i_hi, i_lo) * a.rep;
  const int n_tiles = (f_end - f_begin + BQ - 1) / BQ;

  // rows t * BQ ... of the range into stage `stage`: q, dO, lse, delta by
  // cp.async (zeros past the range), and each row's absolute position
  auto load_rows = [&](int t, int stage) {
    const int f0 = f_begin + t * BQ;
    for (int idx = tid; idx < BQ * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH, f = f0 + r;
      const bool ok = f < f_end;
      const int i = ok ? f / a.rep : 0;
      const int h = kvh * a.rep + (ok ? f - i * a.rep : 0);
      const int64_t qi = i;
      copy_row_chunk(Qs + (stage * BQ + r) * LDS, qb + h * a.q_sh + qi * a.q_ss, c, ok);
      copy_row_chunk(dOs + (stage * BQ + r) * LDS, dob + h * a.do_sh + qi * a.do_ss, c, ok);
    }
    for (int r = tid; r < BQ; r += NT) {
      const int f = f0 + r;
      const bool ok = f < f_end;
      const int i = ok ? f / a.rep : 0;
      const int h = kvh * a.rep + (ok ? f - i * a.rep : 0);
      const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + i;
      cp_async4(lse_s + stage * BQ + r, a.lse + row, ok);
      cp_async4(dl_s + stage * BQ + r, a.delta + row, ok);
      qabs_s[stage * BQ + r] = ok ? i + a.q_offset : -1;
    }
  };

#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {  // K, V and the first ST - 1 query tiles
    if (t < n_tiles) load_rows(t, t);
    cp_async_commit();
  }

  const int g = lane / 4, tq = lane % 4;
  const int grp = warp / DS, dpart = warp % DS;    // key group, part of the head dim
  const int key_lo = k0 + grp * 16;                // this warp's 16 keys
  const int key_hi = min(key_lo + 15, a.Skv - 1);
  const float scale_log2 = a.scale * LOG2E;
  float dk[HDW / 8][4], dv[HDW / 8][4];
#pragma unroll
  for (int n = 0; n < HDW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + ST - 1 < n_tiles) load_rows(t + ST - 1, (t + ST - 1) % ST);  // t - 1's stage
    cp_async_commit();
    const int stage = t % ST;

    // positions of this tile's first and last rows: skip the tile if none
    // of this warp's keys is visible to any of them
    const int f0 = f_begin + t * BQ;
    const int p_first = f0 / a.rep + a.q_offset;
    const int p_last = (min(f0 + BQ, f_end) - 1) / a.rep + a.q_offset;
    const bool any = key_lo < a.Skv && (!a.causal || key_lo <= p_last) &&
                     (a.window <= 0 || key_hi > p_first - a.window);
    if (any) {
      const bf16* Qt = Qs + stage * BQ * LDS;
      const bf16* dOt = dOs + stage * BQ * LDS;
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns query rows
      qk_product<HD, LDS, BQ / 8>(s, Ks + grp * 16 * LDS, Qt, lane);
      qk_product<HD, LDS, BQ / 8>(dp, Vs + grp * 16 * LDS, dOt, lane);
      // a tile every key of this warp sees whole needs no mask
      const bool full = key_lo + 15 < a.Skv && f0 + BQ <= f_end &&
                        (!a.causal || key_lo + 15 <= p_first) &&
                        (a.window <= 0 || key_lo > p_last - a.window);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const int r = stage * BQ + n * 8 + 2 * tq;  // this thread's rows r, r + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + r);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + r);
        const int2 q2 = *reinterpret_cast<const int2*>(qabs_s + r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = key_lo + g + (e >= 2 ? 8 : 0);
          const int qa = e & 1 ? q2.y : q2.x;
          const float p = full || (qa >= 0 && visible(a, qa, kj))
                              ? exp2f(fmaf(s[n][e], scale_log2, -(e & 1 ? l2.y : l2.x) * LOG2E))
                              : 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - (e & 1 ? d2.y : d2.x));  // dS / scale
        }
      }
      // dV += P^T dO and dK += dS^T Q over this warp's part of the head dim
      pv_product<HDW, LDS, BQ / 16>(dv, s, dOt + dpart * HDW, lane);
      pv_product<HDW, LDS, BQ / 16>(dk, dp, Qt + dpart * HDW, lane);
    }
  }

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = key_lo + g + half * 8;
    if (kj >= a.Skv) continue;
#pragma unroll
    for (int n = 0; n < HDW / 8; ++n) {
      const int d = dpart * HDW + n * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dkp + static_cast<int64_t>(kj) * a.dk_ss + d) =
          __floats2bfloat162_rn(dk[n][2 * half] * a.scale, dk[n][2 * half + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + static_cast<int64_t>(kj) * a.dv_ss + d) =
          __floats2bfloat162_rn(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) dq_mma_kernel(const BwdArgs a) {
  using TL = Tiles<HD>;
  constexpr int ROWS = TL::ROWS, BKQ = TL::BKQ, LDS = TL::LDS, CH = TL::CH, ST = TL::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + ROWS * LDS;
  bf16* Ks = dOs + ROWS * LDS;     // ST stages x BKQ keys
  bf16* Vs = Ks + ST * BKQ * LDS;  // ST stages x BKQ keys

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * a.bq;
  const int used = a.bq * a.rep;  // rows of this block that hold a (position, head)
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_sb;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int idx = tid; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const int i = q0 + r / a.rep;
    const bool ok = r < used && i < a.Sq;
    const int h = kvh * a.rep + r % a.rep;
    const int64_t off = ok ? static_cast<int64_t>(i) : 0;
    copy_row_chunk(Qs + r * LDS, qb + h * a.q_sh + off * a.q_ss, c, ok);
    copy_row_chunk(dOs + r * LDS, dob + h * a.do_sh + off * a.do_ss, c, ok);
  }

  // keys any row of this block may see: [k_begin, k_end)
  const int q_last = min(q0 + a.bq, a.Sq) - 1 + a.q_offset;
  const int k_end = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  int k_begin = a.window > 0 ? max(0, q0 + a.q_offset - a.window + 1) : 0;
  k_begin = (k_begin / BKQ) * BKQ;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BKQ - 1) / BKQ : 0;

  auto load_keys = [&](int t, int stage) {
    const int kt0 = k_begin + t * BKQ;
    for (int idx = tid; idx < BKQ * CH; idx += NT) {
      const int j = idx / CH, c = idx % CH, kj = kt0 + j;
      const bool ok = kj < a.Skv;
      const int64_t off = static_cast<int64_t>(ok ? kj : 0);
      copy_row_chunk(Ks + (stage * BKQ + j) * LDS, kb + off * a.k_ss, c, ok);
      copy_row_chunk(Vs + (stage * BKQ + j) * LDS, vb + off * a.v_ss, c, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {  // Q, dO and the first ST - 1 key tiles
    if (t < n_tiles) load_keys(t, t);
    cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of its warp's 16)
  const int g = lane / 4, tq = lane % 4;
  int qa[2];
  float lse2[2], dl[2];
  int h_of[2], i_of[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8;
    const int i = q0 + r / a.rep;
    const int h = kvh * a.rep + r % a.rep;
    const bool ok = r < used && i < a.Sq;
    qa[half] = ok ? i + a.q_offset : -1;
    h_of[half] = h;
    i_of[half] = i;
    lse2[half] = 0.0f;
    dl[half] = 0.0f;
    if (ok) {
      const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + i;
      lse2[half] = a.lse[row] * LOG2E;
      dl[half] = a.delta[row];
    }
  }
  // positions of this warp's first and last rows (none if it has no row)
  const int rows_ok = static_cast<int>(
      min(static_cast<int64_t>(used), static_cast<int64_t>(a.Sq - q0) * a.rep));
  const int r_first = warp * 16;
  const int r_last = min(r_first + 15, rows_ok - 1);
  const bool has_rows = r_first <= r_last;
  const int p_first = q0 + r_first / a.rep + a.q_offset;
  const int p_last = q0 + r_last / a.rep + a.q_offset;

  const float scale_log2 = a.scale * LOG2E;
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + ST - 1 < n_tiles) load_keys(t + ST - 1, (t + ST - 1) % ST);  // t - 1's stage
    cp_async_commit();
    const int stage = t % ST;

    const int kt0 = k_begin + t * BKQ;
    const int kt_last = min(kt0 + BKQ, a.Skv) - 1;
    const bool any = has_rows && (!a.causal || kt0 <= p_last) &&
                     (a.window <= 0 || kt_last > p_first - a.window);
    if (any) {
      const bf16* Kt = Ks + stage * BKQ * LDS;
      const bf16* Vt = Vs + stage * BKQ * LDS;
      float s[BKQ / 8][4], dp[BKQ / 8][4];
#pragma unroll
      for (int n = 0; n < BKQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      qk_product<HD, LDS, BKQ / 8>(s, Qs + warp * 16 * LDS, Kt, lane);    // S = Q K^T
      qk_product<HD, LDS, BKQ / 8>(dp, dOs + warp * 16 * LDS, Vt, lane);  // dP = dO V^T
      // a tile whose every key this warp's rows see whole needs no mask
      const bool full = r_first + 15 < rows_ok && kt0 + BKQ <= a.Skv &&
                        (!a.causal || kt0 + BKQ - 1 <= p_first) &&
                        (a.window <= 0 || kt0 > p_last - a.window);
#pragma unroll
      for (int n = 0; n < BKQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int kj = kt0 + n * 8 + 2 * tq + (e & 1);
          s[n][e] = full || (qa[half] >= 0 && visible(a, qa[half], kj))
                        ? exp2f(fmaf(s[n][e], scale_log2, -lse2[half])) * (dp[n][e] - dl[half])
                        : 0.0f;  // dS / scale
        }
      pv_product<HD, LDS, BKQ / 16>(dq, s, Kt, lane);  // dQ += dS K
    }
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dq_sb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (qa[half] < 0) continue;
    bf16* row = dqb + h_of[half] * a.dq_sh + static_cast<int64_t>(i_of[half]) * a.dq_ss;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(dq[n][2 * half] * a.scale, dq[n][2 * half + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
int launch_f32(const BwdArgs& a, cudaStream_t stream) {
  using TL = F32Tiles<HD>;
  // more than 48 KB of dynamic shared memory must be asked for (per device)
  cudaError_t e = cudaFuncSetAttribute(dkv_f32_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       TL::DKV_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gkv((a.Skv + TL::BKV - 1) / TL::BKV * a.splits, a.KV, a.B);
  dkv_f32_kernel<HD><<<gkv, TL::THREADS, TL::DKV_SMEM, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.splits > 1) {
    const int64_t blocks = (static_cast<int64_t>(a.B) * a.KV * a.Skv * HD + NT - 1) / NT;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    dkv_split_combine_kernel<<<static_cast<unsigned>(blocks), NT, 0, stream>>>(a, HD);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.rep;  // < 2^31: the entry checks
  const dim3 gq(static_cast<unsigned>((n_rows + TL::ROWS - 1) / TL::ROWS), a.KV, a.B);
  dq_f32_kernel<HD><<<gq, TL::THREADS, TL::DQ_SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const BwdArgs& a, cudaStream_t stream) {
  using TL = Tiles<HD>;
  // more than 48 KB of dynamic shared memory must be asked for (per device)
  cudaError_t e = cudaFuncSetAttribute(dkv_mma_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       TL::DKV_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gkv((a.Skv + TL::BKV - 1) / TL::BKV, a.KV, a.B);
  dkv_mma_kernel<HD><<<gkv, NT, TL::DKV_SMEM, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gq((a.Sq + a.bq - 1) / a.bq, a.KV, a.B);
  dq_mma_kernel<HD><<<gq, NT, TL::DQ_SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_grads(int dtype, const BwdArgs& a, cudaStream_t s) {
  return dtype == REPRO_BF16 ? launch_bf16<HD>(a, s) : launch_f32<HD>(a, s);
}

template <typename T>
int launch_delta(int hd, const BwdArgs& a, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.Sq;
  const int64_t blocks = (rows + NT / 32 - 1) / (NT / 32);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), NT, 0, s>>>(a, hd);
  return static_cast<int>(cudaGetLastError());
}

// The most query heads per kv head: a bf16 dQ block's rows (four warps of
// 16, its rep heads x bq positions), and the f32 kernels' limit too.  Keep
// in step with MAX_REP in repro_torch/kernels/flash_attention.py.
constexpr int MAX_REP = Tiles<64>::ROWS;

}  // namespace

// Launches delta_kernel, then the dK/dV and dQ kernels of the dtype.  f32
// only: with splits > 1 each dK/dV block of keys takes one of `splits`
// ranges of its query rows and writes partials to ws (2 * splits * B * KV *
// Skv * hd floats), which dkv_split_combine_kernel then sums.
extern "C" int repro_flash_attention_bwd(
    int dtype, int hd, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv, float* ws,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh,
    int64_t dq_ss, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb,
    int64_t dv_sh, int64_t dv_ss, int B, int KV, int Sq, int Skv, int rep, int causal,
    int window, int q_offset, int splits, float scale, void* stream) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (rep < 1 || rep > MAX_REP) return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || (splits > 1 && (ws == nullptr || dtype != REPRO_F32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(Sq) * rep >= (int64_t{1} << 31))  // the dK/dV and f32 dQ row index
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
            do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss,
            dv_sb, dv_sh, dv_ss, B, KV * rep, KV, Sq, Skv, rep, MAX_REP / rep, causal,
            window, q_offset, scale, splits, ws};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = dtype == REPRO_BF16 ? launch_delta<bf16>(hd, a, s) : launch_delta<float>(hd, a, s);
  if (e != 0) return e;
  switch (hd) {  // a head dim without a template is refused, never run as another
    case 16: return launch_grads<16>(dtype, a, s);
    case 32: return launch_grads<32>(dtype, a, s);
    case 64: return launch_grads<64>(dtype, a, s);
    case 128: return launch_grads<128>(dtype, a, s);
    case 256: return launch_grads<256>(dtype, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
