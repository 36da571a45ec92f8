// Flash attention forward for Hopper (sm_90a): grouped-query attention with
// a 1/sqrt(hd) scale, an online softmax over key tiles, causal masking with a
// query offset (one for the launch, or one per batch row: continuous
// batching decodes each slot at its own position), an optional sliding
// window, and tiles that are wholly masked skipped.  f32 or bf16 in and out,
// f32 inside.  When given an lse buffer it also writes each row's
// log-sum-exp of scaled scores, lse = m + log(l), as (B, H, Sq) f32 (-inf for
// a row that sees no key): the backward (flash_attention_bwd.cu) recomputes
// the probabilities from it.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel).
//
// What bounds it on this card: at prefill, operations (about 4 * Sq * keys
// * hd per query head, against q, k and v read once); at decode (Sq = 1),
// bytes: the whole key/value cache is read for one query row per head.
//
// What the design does about it:
// - One block takes one (batch, kv head) pair and a tile of query rows, and
//   its rows are the query heads that share that kv head at consecutive
//   positions.  Each key/value tile is read from device memory once for all
//   rep heads, not rep times.
// - bf16 (flash_fwd_mma_kernel): FlashAttention-2 on the tensor cores.
//   Four warps of 16 rows; a block's 64 rows are rows f = position * rep +
//   head of its kv head (position-major, as in the dK/dV kernel), so every
//   row of a tile is used whatever rep is.  Q is staged once; key/value
//   tiles of 64 keys (32 above hd 64) come by 16-byte cp.async into padded
//   bf16 shared memory, two tiles in flight.  S = Q K^T runs on mma.sync
//   m16n8k16 bf16 x bf16 -> f32 (K's fragments by ldmatrix; Q's held in
//   registers up to hd 128, and at hd 256, where they would take 64
//   registers beside the accumulator's 128, loaded by ldmatrix from the
//   staged Q at every k-step, as FlashAttention-2 does there); the online
//   softmax runs on the f32 accumulators in
//   registers, a row's max and sum shared by the four lanes that hold it;
//   P is rounded to bf16 only as the A operand of O += P V, taken straight
//   from the accumulators, with V read by ldmatrix.trans.  A warp skips a
//   tile that none of its 16 rows sees and masks element by element only a
//   tile that straddles a boundary (mma.cuh holds the building blocks).
// - f32 (flash_fwd_f32_kernel): IEEE f32 FMA only (the tensor cores would
//   take f32 only through TF32, which the port never uses), so f32 FMA
//   operations bound it: 67 TFLOP/s on the H100.  The block is the bf16
//   kernel's: 64 position-major rows of one kv head, so rep does not bound
//   it.  256 threads form a 32 x 8 grid; a thread computes S = Q K^T for 2
//   rows x (key tile / 8) keys as register outer products over the head dim
//   (f32_tiles.cuh), reading each 16-byte chunk of Q or K once for 4 or 8
//   FMAs against one in a dot product, with a warp's 4 row groups and 8 key
//   lanes reading 4 and 8 distinct chunks (broadcasts, no bank conflict).
//   The online softmax is exp2f with scale * log2 e folded into the scores;
//   a row's tile max takes three __shfl_xor steps over its 8 lanes.  P goes
//   through shared memory rows that only its warp writes and reads
//   (__syncwarp), and O += P V runs as outer products again: each thread
//   owns its 2 rows x hd / 8 dims of O in registers (64 at hd 256).  Q stays
//   resident; K and V tiles of 64 keys (32 above hd 64, key_tile in the
//   wrapper) come by 16-byte cp.async into padded shared memory, two tiles
//   in flight, in dynamic shared memory above 48 KB.  Blocks start in
//   reverse query order across all (batch, kv head): the longest causal
//   blocks first.  As compiled on the H100 (PERF.md): 256 threads; at hd
//   256 168 registers and 205 KB of shared memory, one block of 8 warps
//   per SM; at hd 64 and 128 128 registers (the launch bound) and 103 and
//   109 KB, two blocks per SM.
// - Decode (split-KV): when the grid, B * KV * query tiles, is too small to
//   fill the card, the wrapper asks for `splits` > 1.  Each block then
//   covers one of `splits` contiguous ranges of whole key tiles of its
//   visible range (causal and window trimming first) and writes its rows'
//   partial (m, l, unnormalised O) in f32 to a workspace; a second kernel,
//   flash_split_combine_kernel, merges the partials of each row in split
//   order (rescale by exp(m_s - max m) and sum, no atomics, so two launches
//   give the same bits) and writes O and lse.  A split that sees no key of
//   a row (m = -inf) adds nothing to it.  With per-row offsets each batch
//   row cuts its own visible range into the same `splits` (chosen by the
//   host from the largest offset), so a row near the start of its cache
//   may leave some splits empty: those write the empty partial.
// - Key tiles outside [first key any row may see, last key any row may see]
//   are never loaded; keys >= Skv are masked explicitly, so a ragged cache
//   needs no padding.
//
// Operands are read through strides (batch, head, position; the head
// dimension is contiguous), so the model's (B, S, H, hd) activations and its
// (B, S_max, KV, hd) cache are read in place, without a transposing copy.
// Both kernels copy rows 16 bytes at a time, so they need every operand's
// base and strides 16-byte aligned: the wrapper copies a view that is not
// into a new tensor first.
#include <math.h>

#include "common.cuh"
#include "f32_tiles.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 128;  // threads per block of the bf16 and combine kernels (four warps)
constexpr int MAX_REP = 64;  // query heads per kv head (MAX_REP in the wrapper)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // (B, H, Sq) contiguous, or null: not written
  float* ws;    // splits > 1: partial O (splits, R, hd), then m and l (splits, R)
  const int* q_offsets;  // (B,) int32: batch row b's query offset; null: q_offset for all
  int64_t q_sb, q_sh, q_ss;  // element strides: batch, head, position
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t R;    // rows of the output, B * H * Sq, in lse's order
  int Sq, Skv, KV;
  int rep;      // query heads per kv head
  int causal;   // 0 or 1
  int window;   // 0: no window; else key j is visible iff j > q - window
  int q_offset; // absolute position of query 0 (of every row, when q_offsets is null)
  int splits;   // key ranges per (query tile, batch, kv head); 1: no split
  float scale;
};

__device__ __forceinline__ bool visible(const FlashArgs& a, int qabs, int kj) {
  return kj < a.Skv && (!a.causal || kj <= qabs) && (a.window <= 0 || kj > qabs - a.window);
}

// absolute position of batch row b's query 0
__device__ __forceinline__ int row_offset(const FlashArgs& a, int b) {
  return a.q_offsets != nullptr ? a.q_offsets[b] : a.q_offset;
}

// This split's key tiles [t_lo, t_hi) of n_tiles: contiguous, as even as
// whole tiles allow.
__device__ __forceinline__ void split_tiles(int n_tiles, int split, int splits, int& t_lo,
                                            int& t_hi) {
  t_lo = static_cast<int>(static_cast<int64_t>(split) * n_tiles / splits);
  t_hi = static_cast<int>(static_cast<int64_t>(split + 1) * n_tiles / splits);
}

// The workspace of a split launch: partial O (splits, R, hd), then m and l
// (splits, R) each; row = (b * H + h) * Sq + i.
__device__ __forceinline__ float* ws_acc(const FlashArgs& a, int split, int64_t row, int hd) {
  return a.ws + (split * a.R + row) * hd;
}
__device__ __forceinline__ float* ws_m(const FlashArgs& a, int split, int64_t row, int hd) {
  return a.ws + a.splits * a.R * hd + split * a.R + row;
}
__device__ __forceinline__ float* ws_l(const FlashArgs& a, int split, int64_t row, int hd) {
  return a.ws + a.splits * a.R * (hd + 1) + split * a.R + row;
}

// a row's log-sum-exp (natural units) from its max m and sum l
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? m + logf(l) : -INFINITY;
}

// ---------------------------------------------------------------------------
// f32: register micro-tiles of IEEE FMA (f32_tiles.cuh)
// ---------------------------------------------------------------------------

template <int HD>
struct F32Tiles {
  static constexpr int ROWS = 64;                 // query rows per block, position-major
  static constexpr int THREADS = 256;             // a GR x GC grid of threads
  static constexpr int GC = 8, GR = THREADS / GC; // 8 threads share a row group's keys
  static constexpr int TR = ROWS / GR;            // rows a thread: 2
  static constexpr int BKV = HD <= 64 ? 64 : 32;  // keys per tile (key_tile in the wrapper)
  static constexpr int TC = BKV / GC;             // keys a thread: 8 or 4
  static constexpr int LD = HD + 4;               // padded row of Q, K, V, in floats
  static constexpr int LDP = BKV + 8;             // padded row of P: a warp's 4 row groups
                                                  // write 32 distinct banks
  using CH = f32t::Chunks<HD, GC>;                // head dims of O a thread owns
  static constexpr int STAGES = 2;                // key/value tiles in flight
  static constexpr int SMEM = (ROWS * LD + STAGES * 2 * BKV * LD + ROWS * LDP) * 4;
};

// Thread (gr, gc) owns rows gr + 32 i (i < 2) of the block: their scores
// against keys gc + 8 j of each tile, their softmax state (m, and its share
// of l), and their output's head dims in chunks gc + 8 c.  A row's eight
// threads are neighbouring lanes: the tile's max is three __shfl_xor steps,
// and P goes through shared memory rows that only this warp writes and
// reads (a __syncwarp, no block barrier).
template <int HD>
__global__ void __launch_bounds__(F32Tiles<HD>::THREADS, HD > 128 ? 1 : 2)
    flash_fwd_f32_kernel(const FlashArgs a) {
  using TL = F32Tiles<HD>;
  constexpr int ROWS = TL::ROWS, NTH = TL::THREADS, GC = TL::GC, GR = TL::GR, TR = TL::TR;
  constexpr int BKV = TL::BKV, TC = TL::TC, LD = TL::LD, LDP = TL::LDP, ST = TL::STAGES;
  constexpr int CW = TL::CH::CW, NCH = TL::CH::N, CH4 = HD / 4;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;               // ROWS x LD
  float* Ks = Qs + ROWS * LD;      // ST stages x BKV keys
  float* Vs = Ks + ST * BKV * LD;  // ST stages x BKV keys
  float* Ps = Vs + ST * BKV * LD;  // ROWS x LDP: this tile's probabilities

  const int tid = threadIdx.x, gc = tid % GC, gr = tid / GC;
  // the grid is (query tiles x splits, KV, B); blocks are handed out in
  // the order of their linear index, which here runs over the query tiles
  // slowest and in reverse, so that under a causal mask the blocks with the
  // most keys start first across every (batch, kv head)
  int b, kvh, split, tile;
  {
    const int units = a.splits * a.KV * static_cast<int>(gridDim.z);  // blocks a query tile
    const int64_t lin =
        blockIdx.x + static_cast<int64_t>(gridDim.x) * (blockIdx.y + gridDim.y * blockIdx.z);
    const int rem = static_cast<int>(lin % units);
    tile = static_cast<int>(gridDim.x) / a.splits - 1 - static_cast<int>(lin / units);
    split = rem % a.splits;
    kvh = rem / a.splits % a.KV;
    b = rem / a.splits / a.KV;
  }
  // rows f = position * rep + head of this kv head, fewer than 2^31 (the
  // launch checks)
  const int n_rows = a.Sq * a.rep;
  const int f0 = tile * ROWS;
  const int rows_ok = min(ROWS, n_rows - f0);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int idx = tid; idx < ROWS * CH4; idx += NTH) {
    const int r = idx / CH4, c = idx % CH4;
    const bool ok = r < rows_ok;
    const int i = ok ? (f0 + r) / a.rep : 0;
    const int h = kvh * a.rep + (ok ? f0 + r - i * a.rep : 0);
    f32t::copy_chunk(Qs + r * LD, qb + h * a.q_sh + static_cast<int64_t>(i) * a.q_ss, c, ok);
  }

  // keys any row of this block may see: [k_begin, k_end), in tiles; this
  // split's share
  const int q_offset = row_offset(a, b);
  const int blk_first = f0 / a.rep + q_offset;
  const int blk_last = (f0 + rows_ok - 1) / a.rep + q_offset;
  const int k_end = a.causal ? min(a.Skv, blk_last + 1) : a.Skv;
  int k_begin = a.window > 0 ? max(0, blk_first - a.window + 1) : 0;
  k_begin = (k_begin / BKV) * BKV;
  int t_lo, t_hi;
  split_tiles(k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0, split, a.splits, t_lo,
              t_hi);
  const int n_tiles = t_hi - t_lo;
  const int kt_first = k_begin + t_lo * BKV;

  auto load_keys = [&](int t, int stage) {
    const int kt0 = kt_first + t * BKV;
    for (int idx = tid; idx < BKV * CH4; idx += NTH) {
      const int j = idx / CH4, c = idx % CH4, kj = kt0 + j;
      const bool ok = kj < a.Skv;
      const int64_t off = static_cast<int64_t>(ok ? kj : 0);
      f32t::copy_chunk(Ks + (stage * BKV + j) * LD, kb + off * a.k_ss, c, ok);
      f32t::copy_chunk(Vs + (stage * BKV + j) * LD, vb + off * a.v_ss, c, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {  // Q and the first ST - 1 key tiles
    if (t < n_tiles) load_keys(t, t);
    tc::cp_async_commit();
  }

  // this thread's rows: absolute positions, -1 for a row past the last
  int qa[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = gr + GR * i;
    qa[i] = r < rows_ok ? (f0 + r) / a.rep + q_offset : -1;
  }
  const float scale_log2 = a.scale * LOG2E;
  float m2[TR], l[TR];  // running max of scaled scores (log2 units), this lane's share of l
  float acc[TR][CW * NCH];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m2[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < CW * NCH; ++d) acc[i][d] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<ST - 2>();
    __syncthreads();  // tile t (and Q) has landed; every warp is done with tile t - 1
    if (t + ST - 1 < n_tiles) load_keys(t + ST - 1, (t + ST - 1) % ST);  // t - 1's stage
    tc::cp_async_commit();
    const int stage = t % ST;
    const float* Kt = Ks + stage * BKV * LD;
    const float* Vt = Vs + stage * BKV * LD;
    const int kt0 = kt_first + t * BKV;

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.0f;
    f32t::abt<HD, TR, TC, GR, GC, LD>(s, Qs, Kt, gr, gc);  // S = Q K^T

    // a tile whose every key every row of the block sees needs no mask
    const bool full = rows_ok == ROWS && kt0 + BKV <= a.Skv &&
                      (!a.causal || kt0 + BKV - 1 <= blk_first) &&
                      (a.window <= 0 || kt0 > blk_last - a.window);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = m2[i];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        float x = s[i][j] * scale_log2;
        if (!full && (qa[i] < 0 || !visible(a, qa[i], kt0 + gc + GC * j))) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float base = mx == -INFINITY ? 0.0f : mx;  // a row with no key yet
      const float alpha = exp2f(m2[i] - base);         // 0 while m2 is -inf
      m2[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < CW * NCH; ++d) acc[i][d] *= alpha;
      float* prow = Ps + (gr + GR * i) * LDP + gc;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = exp2f(s[i][j] - base);  // 0 where masked
        l[i] += p;
        prow[GC * j] = p;
      }
    }
    __syncwarp();  // P's rows of this warp are written
    f32t::pb<BKV, TR, GR, GC, CW, NCH, LDP, LD>(acc, Ps, Vt, gr, gc);  // O += P V
  }
  tc::cp_async_wait<0>();

  float* ob = static_cast<float*>(a.o) + b * a.o_sb;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float lh = l[i];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    lh += __shfl_xor_sync(0xffffffffu, lh, 4);
    if (qa[i] < 0) continue;
    const int f = f0 + gr + GR * i;
    const int pos = f / a.rep;
    const int h = kvh * a.rep + f - pos * a.rep;
    const int64_t row = (static_cast<int64_t>(b) * a.KV * a.rep + h) * a.Sq + pos;
    const float m = m2[i] * LN2;  // natural units; -inf for a row that saw no key
    const bool part = a.splits > 1;
    // a split's partial is (m, l, unnormalised O); a row that sees no key gives 0
    const float inv = part ? 1.0f : (lh > 0.0f ? 1.0f / lh : 0.0f);
    float* dst = part ? ws_acc(a, split, row, HD)
                      : ob + h * a.o_sh + static_cast<int64_t>(pos) * a.o_ss;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      f32t::store_chunk<CW>(dst + CW * (gc + GC * c), acc[i] + c * CW, inv);
    if (gc != 0) continue;
    if (part) {
      *ws_m(a, split, row, HD) = m;
      *ws_l(a, split, row, HD) = lh;
    } else if (a.lse != nullptr) {
      a.lse[row] = row_lse(m, lh);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using tc::bf16;

template <int HD>
struct FwdTiles {
  static constexpr int ROWS = 64;                 // query rows per block: 4 warps x 16
  static constexpr int BKV = HD <= 64 ? 64 : 32;  // keys per tile
  static constexpr int LDS = HD + 8;              // shared row, in bf16: 16 bytes of padding
  static constexpr int CH = HD / 8;               // 16-byte chunks per row
  static constexpr int STAGES = 2;                // key/value tiles in flight
  static constexpr int SMEM = (ROWS + STAGES * 2 * BKV) * LDS * 2;
  // a warp keeps its Q fragments in registers for the whole key loop up to
  // hd 128; at hd 256 they stay in shared memory (see the note at the top)
  static constexpr bool Q_IN_REGS = HD <= 128;
};

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_mma_kernel(const FlashArgs a) {
  using TL = FwdTiles<HD>;
  constexpr int ROWS = TL::ROWS, BKV = TL::BKV, LDS = TL::LDS, CH = TL::CH, ST = TL::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + ROWS * LDS;      // ST stages x BKV keys
  bf16* Vs = Ks + ST * BKV * LDS;  // ST stages x BKV keys

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int split = blockIdx.x % a.splits;
  // rows f = position * rep + head of this kv head, fewer than 2^31 (the
  // launch checks); this block's are [f0, f0 + ROWS)
  const int n_rows = a.Sq * a.rep;
  const int f0 = blockIdx.x / a.splits * ROWS;
  const int rows_ok = min(ROWS, n_rows - f0);
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int idx = tid; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < rows_ok;
    const int i = ok ? (f0 + r) / a.rep : 0;
    const int h = kvh * a.rep + (ok ? f0 + r - i * a.rep : 0);
    tc::copy_row_chunk(Qs + r * LDS, qb + h * a.q_sh + static_cast<int64_t>(i) * a.q_ss, c,
                       ok);
  }

  // keys any row of this block may see: [k_begin, k_end), in tiles; this
  // split's share
  const int q_offset = row_offset(a, b);
  const int blk_first = f0 / a.rep + q_offset;
  const int blk_last = (f0 + rows_ok - 1) / a.rep + q_offset;
  const int k_end = a.causal ? min(a.Skv, blk_last + 1) : a.Skv;
  int k_begin = a.window > 0 ? max(0, blk_first - a.window + 1) : 0;
  k_begin = (k_begin / BKV) * BKV;
  int t_lo, t_hi;
  split_tiles(k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0, split, a.splits, t_lo,
              t_hi);
  const int n_tiles = t_hi - t_lo;
  const int kt_first = k_begin + t_lo * BKV;

  auto load_keys = [&](int t, int stage) {
    const int kt0 = kt_first + t * BKV;
    for (int idx = tid; idx < BKV * CH; idx += NT) {
      const int j = idx / CH, c = idx % CH, kj = kt0 + j;
      const bool ok = kj < a.Skv;
      const int64_t off = static_cast<int64_t>(ok ? kj : 0);
      tc::copy_row_chunk(Ks + (stage * BKV + j) * LDS, kb + off * a.k_ss, c, ok);
      tc::copy_row_chunk(Vs + (stage * BKV + j) * LDS, vb + off * a.v_ss, c, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {  // Q and the first ST - 1 key tiles
    if (t < n_tiles) load_keys(t, t);
    tc::cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of its warp's 16): absolute
  // positions, -1 for a row past the last
  const int g = lane / 4, tq = lane % 4;
  int qa[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8;
    qa[half] = r < rows_ok ? (f0 + r) / a.rep + q_offset : -1;
  }
  // positions of this warp's first and last rows (none if it has no row)
  const int r_first = warp * 16;
  const int r_last = min(r_first + 15, rows_ok - 1);
  const bool has_rows = r_first <= r_last;
  const int p_first = (f0 + r_first) / a.rep + q_offset;
  const int p_last = (f0 + r_last) / a.rep + q_offset;

  const float scale_log2 = a.scale * LOG2E;
  float m2[2] = {-INFINITY, -INFINITY};  // running max of scaled scores, in log2 units
  float l[2] = {0.0f, 0.0f};             // this lane's share of the running sum
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  uint32_t qf[TL::Q_IN_REGS ? HD / 16 : 1][4];  // Q's A fragments, loaded with the first tile

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<ST - 2>();
    __syncthreads();  // tile t (and Q) has landed; every warp is done with tile t - 1
    if (t + ST - 1 < n_tiles) load_keys(t + ST - 1, (t + ST - 1) % ST);  // t - 1's stage
    tc::cp_async_commit();
    const int stage = t % ST;
    if constexpr (TL::Q_IN_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          tc::load_a<LDS>(qf[kk], Qs + warp * 16 * LDS, kk, lane);
      }
    }

    const int kt0 = kt_first + t * BKV;
    const int kt_last = min(kt0 + BKV, a.Skv) - 1;
    const bool any = has_rows && (!a.causal || kt0 <= p_last) &&
                     (a.window <= 0 || kt_last > p_first - a.window);
    if (!any) continue;
    const bf16* Kt = Ks + stage * BKV * LDS;
    const bf16* Vt = Vs + stage * BKV * LDS;
    float s[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    if constexpr (TL::Q_IN_REGS) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) tc::qk_step<LDS, BKV / 8>(s, qf[kk], Kt, kk, lane);
    } else {
      tc::qk_product<HD, LDS, BKV / 8>(s, Qs + warp * 16 * LDS, Kt, lane);
    }

    // a tile whose every key this warp's rows see whole needs no mask
    const bool full = r_first + 15 < rows_ok && kt0 + BKV <= a.Skv &&
                      (!a.causal || kt0 + BKV - 1 <= p_first) &&
                      (a.window <= 0 || kt0 > p_last - a.window);
    if (!full) {
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = qa[e >> 1];
          if (qp < 0 || !visible(a, qp, kt0 + n * 8 + 2 * tq + (e & 1))) s[n][e] = -INFINITY;
        }
    }
    // online softmax, per row: the tile's max over the four lanes of a row
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e] * scale_log2);
    float base[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      base[half] = mx[half] == -INFINITY ? 0.0f : mx[half];  // a row with no key yet
      const float alpha = exp2f(m2[half] - base[half]);      // 0 while m2 is -inf
      m2[half] = mx[half];
      l[half] *= alpha;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * half] *= alpha;
        acc[n][2 * half + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], scale_log2, -base[e >> 1]));  // 0 where masked
        s[n][e] = p;
        l[e >> 1] += p;
      }
    tc::pv_product<HD, LDS, BKV / 16>(acc, s, Vt, lane);  // O += P V
  }
  tc::cp_async_wait<0>();

  bf16* ob = static_cast<bf16*>(a.o) + b * a.o_sb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lh = l[half];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    if (qa[half] < 0) continue;
    const int f = f0 + warp * 16 + g + half * 8;
    const int i = f / a.rep;
    const int h = kvh * a.rep + f - i * a.rep;
    const int64_t row = (static_cast<int64_t>(b) * a.KV * a.rep + h) * a.Sq + i;
    const float m = m2[half] * LN2;  // natural units; -inf for a row that saw no key
    if (a.splits > 1) {  // this split's partial: (m, l, unnormalised O)
      float* wa = ws_acc(a, split, row, HD);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(wa + n * 8 + 2 * tq) =
            make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
      if (tq == 0) {
        *ws_m(a, split, row, HD) = m;
        *ws_l(a, split, row, HD) = lh;
      }
      continue;
    }
    const float inv = lh > 0.0f ? 1.0f / lh : 0.0f;  // a row that sees no key gives 0
    bf16* orow = ob + h * a.o_sh + static_cast<int64_t>(i) * a.o_ss;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    if (a.lse != nullptr && tq == 0) a.lse[row] = row_lse(m, lh);
  }
}

// ---------------------------------------------------------------------------
// split-KV: the partials merged in split order
// ---------------------------------------------------------------------------

// One warp per output row (b, h, i), blocks over (i, h, b): M = max_s m_s,
// L = sum_s l_s e^(m_s - M), O = sum_s acc_s e^(m_s - M) / L, each sum taken
// over s = 0, 1, ... in turn.
template <typename T>
__global__ void __launch_bounds__(NT) flash_split_combine_kernel(const FlashArgs a, int hd) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (i >= a.Sq) return;  // whole warps leave
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t row = (static_cast<int64_t>(b) * gridDim.y + h) * a.Sq + i;
  const int splits = a.splits;
  const int64_t R = a.R;
  const float* wm = ws_m(a, 0, row, hd);    // split s at wm[s * R], likewise wl
  const float* wl = ws_l(a, 0, row, hd);
  const float* wa = ws_acc(a, 0, row, hd);  // split s at wa[s * R * hd]
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, wm[s * R]);
  float L = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float ms = wm[s * R];
    if (ms != -INFINITY) L += wl[s * R] * expf(ms - M);
  }
  const float inv = L > 0.0f ? 1.0f / L : 0.0f;  // a row that sees no key gives 0
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + static_cast<int64_t>(i) * a.o_ss;
  for (int d = lane; d < hd; d += 32) {
    float o = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float ms = wm[s * R];
      if (ms != -INFINITY) o = fmaf(wa[s * R * hd + d], expf(ms - M), o);
    }
    store_to(op + d, o * inv);
  }
  if (a.lse != nullptr && lane == 0) a.lse[row] = row_lse(M, L);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;  // more must be asked for (per device)
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int HD>
int launch_f32(const FlashArgs& a, int B, cudaStream_t stream) {
  using TL = F32Tiles<HD>;
  const int e = set_smem(reinterpret_cast<const void*>(flash_fwd_f32_kernel<HD>), TL::SMEM);
  if (e != 0) return e;
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.rep;
  const int64_t blocks = (n_rows + TL::ROWS - 1) / TL::ROWS * a.splits;
  if (n_rows >= (int64_t{1} << 31) || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_f32_kernel<HD>
      <<<dim3(static_cast<unsigned>(blocks), a.KV, B), TL::THREADS, TL::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const FlashArgs& a, int B, cudaStream_t stream) {
  using TL = FwdTiles<HD>;
  const int e = set_smem(reinterpret_cast<const void*>(flash_fwd_mma_kernel<HD>), TL::SMEM);
  if (e != 0) return e;
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.rep;
  const int64_t blocks = (n_rows + TL::ROWS - 1) / TL::ROWS * a.splits;
  if (n_rows >= (int64_t{1} << 31) || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_mma_kernel<HD>
      <<<dim3(static_cast<unsigned>(blocks), a.KV, B), NT, TL::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, const FlashArgs& a, int B, cudaStream_t s) {
  return dtype == REPRO_BF16 ? launch_bf16<HD>(a, B, s) : launch_f32<HD>(a, B, s);
}

template <typename T>
int launch_combine(const FlashArgs& a, int B, int hd, cudaStream_t s) {
  const int H = a.KV * a.rep;
  if (H > 65535) return static_cast<int>(cudaErrorInvalidValue);  // gridDim.y
  const dim3 grid((a.Sq + NT / 32 - 1) / (NT / 32), H, B);
  flash_split_combine_kernel<T><<<grid, NT, 0, s>>>(a, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the forward kernel and, when splits > 1, the combine kernel after
// it on the same stream; ws then holds splits * B * H * Sq * (hd + 2) floats.
// rep, the query heads per kv head, is at most MAX_REP.
// q_offsets, when not null, is a device array of B int32 offsets >= 0, one
// per batch row, read in place of q_offset; the host chose `splits` from the
// largest of them.
extern "C" int repro_flash_attention(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o, float* lse,
    float* ws, const int* q_offsets, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int B, int KV, int Sq, int Skv, int rep, int causal,
    int window, int q_offset, int splits, float scale, void* stream) {
  if (rep < 1 || rep > MAX_REP) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || (splits > 1 && ws == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a{q, k, v, o, lse, ws, q_offsets, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
              v_ss, o_sb, o_sh, o_ss, static_cast<int64_t>(B) * KV * rep * Sq, Sq, Skv, KV, rep,
              causal, window, q_offset, splits, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  switch (hd) {
    case 16: e = launch_hd<16>(dtype, a, B, s); break;
    case 32: e = launch_hd<32>(dtype, a, B, s); break;
    case 64: e = launch_hd<64>(dtype, a, B, s); break;
    case 128: e = launch_hd<128>(dtype, a, B, s); break;
    case 256: e = launch_hd<256>(dtype, a, B, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != 0 || splits == 1) return e;
  return dtype == REPRO_BF16 ? launch_combine<bf16>(a, B, hd, s)
                             : launch_combine<float>(a, B, hd, s);
}
