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
// - a dQ kernel: one block per (batch, kv head, tile of query positions);
//   its rows are the rep heads at each position, as in the forward.  It
//   walks the key tiles its rows can see.
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
// - f32 (dkv_kernel, dq_kernel): scalar IEEE f32 FMA (the tensor cores
//   would take f32 only through TF32, which the port never uses).  A
//   thread owns a 32-wide slice of the head dim of one key (dK/dV) or row
//   (dQ) in registers; the other operand is staged as f32 tiles in shared
//   memory and read by all threads at once (16-row tiles at hd 256, so the
//   two stay within the 48 KB of static shared memory).
//
// Operands are read through strides (batch, head, position; the head
// dimension is contiguous), so the model's (B, S, H, hd) activations are
// read and the gradients written in place, without transposing copies.
// The bf16 kernels copy rows 16 bytes at a time, so they need every
// operand's base and strides 16-byte aligned: the wrapper copies a view
// that is not into a new tensor first.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 128;  // threads per block (four warps)

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
  int bq;        // query positions per dq block
  int causal;    // 0 or 1
  int window;    // 0: no window; else key j is visible iff j > q - window
  int q_offset;  // absolute position of query 0
  float scale;
};

// head dims per thread, and threads per key (dkv) or per row (dq)
__host__ __device__ constexpr int slice_width(int hd) { return hd < 32 ? hd : 32; }
__host__ __device__ constexpr int slice_count(int hd) { return hd / slice_width(hd); }
// staged query rows (dkv) and staged keys (dq) per tile
__host__ __device__ constexpr int tile_rows(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 32 : 16; }

__device__ __forceinline__ bool visible(const BwdArgs& a, int qabs, int kj) {
  return kj < a.Skv && (!a.causal || kj <= qabs) && (a.window <= 0 || kj > qabs - a.window);
}

// sum over the SPLIT lanes that share a key or a row (neighbouring lanes)
template <int SPLIT>
__device__ __forceinline__ float split_sum(float x) {
#pragma unroll
  for (int w = SPLIT / 2; w > 0; w /= 2) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
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

template <typename T, int HD>
__global__ void __launch_bounds__(NT) dkv_kernel(const BwdArgs a) {
  constexpr int W = slice_width(HD);
  constexpr int SPLIT = slice_count(HD);
  constexpr int BK = NT / SPLIT;     // keys per block
  constexpr int QT = tile_rows(HD);  // query rows staged at once
  constexpr int LD = HD + 4;         // padded row, in floats (16-byte aligned)
  __shared__ float4 qs4[QT * LD / 4];
  __shared__ float4 dos4[QT * LD / 4];
  __shared__ float lse_s[QT], delta_s[QT];
  __shared__ int qabs_s[QT];
  float* Qs = reinterpret_cast<float*>(qs4);
  float* dOs = reinterpret_cast<float*>(dos4);

  const int tid = threadIdx.x;
  const int sl = tid % SPLIT;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int kj = k0 + tid / SPLIT;
  const bool key_ok = kj < a.Skv;

  float kr[W], vr[W], dk[W], dv[W];
  {
    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh +
                  static_cast<int64_t>(key_ok ? kj : 0) * a.k_ss + sl * W;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh +
                  static_cast<int64_t>(key_ok ? kj : 0) * a.v_ss + sl * W;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      kr[w] = key_ok ? to_f32(kp[w]) : 0.0f;
      vr[w] = key_ok ? to_f32(vp[w]) : 0.0f;
      dk[w] = 0.0f;
      dv[w] = 0.0f;
    }
  }

  // query positions that may see any key of this block: [i_lo, i_hi)
  const int k_last = min(k0 + BK, a.Skv) - 1;
  const int i_lo = a.causal ? max(0, k0 - a.q_offset) : 0;
  const int i_hi = a.window > 0 ? min(a.Sq, k_last + a.window - a.q_offset) : a.Sq;
  const int64_t f_end = static_cast<int64_t>(i_hi) * a.rep;  // rows: position-major, head-minor

  for (int64_t f0 = static_cast<int64_t>(i_lo) * a.rep; f0 < f_end; f0 += QT) {
    const int rows = f_end - f0 < QT ? static_cast<int>(f_end - f0) : QT;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < QT * HD; idx += NT) {
      const int r = idx / HD, d = idx % HD;
      float qv = 0.0f, dov = 0.0f;
      if (r < rows) {
        const int64_t f = f0 + r;
        const int i = static_cast<int>(f / a.rep);
        const int h = kvh * a.rep + static_cast<int>(f % a.rep);
        qv = to_f32(static_cast<const T*>(a.q)[b * a.q_sb + h * a.q_sh +
                                               static_cast<int64_t>(i) * a.q_ss + d]) * a.scale;
        dov = to_f32(static_cast<const T*>(a.dout)[b * a.do_sb + h * a.do_sh +
                                                   static_cast<int64_t>(i) * a.do_ss + d]);
      }
      Qs[r * LD + d] = qv;
      dOs[r * LD + d] = dov;
    }
    if (tid < rows) {
      const int64_t f = f0 + tid;
      const int i = static_cast<int>(f / a.rep);
      const int h = kvh * a.rep + static_cast<int>(f % a.rep);
      const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + i;
      lse_s[tid] = a.lse[row];
      delta_s[tid] = a.delta[row];
      qabs_s[tid] = i + a.q_offset;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float4* qr = reinterpret_cast<const float4*>(Qs + r * LD + sl * W);
      const float4* dr = reinterpret_cast<const float4*>(dOs + r * LD + sl * W);
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int w4 = 0; w4 < W / 4; ++w4) {
        const float4 qq = qr[w4], dd = dr[w4];
        s = fmaf(qq.x, kr[4 * w4], s);
        s = fmaf(qq.y, kr[4 * w4 + 1], s);
        s = fmaf(qq.z, kr[4 * w4 + 2], s);
        s = fmaf(qq.w, kr[4 * w4 + 3], s);
        dp = fmaf(dd.x, vr[4 * w4], dp);
        dp = fmaf(dd.y, vr[4 * w4 + 1], dp);
        dp = fmaf(dd.z, vr[4 * w4 + 2], dp);
        dp = fmaf(dd.w, vr[4 * w4 + 3], dp);
      }
      s = split_sum<SPLIT>(s);
      dp = split_sum<SPLIT>(dp);
      if (!visible(a, qabs_s[r], kj)) continue;
      const float p = expf(s - lse_s[r]);
      const float ds = p * (dp - delta_s[r]);  // times scale, which q carries
#pragma unroll
      for (int w4 = 0; w4 < W / 4; ++w4) {
        const float4 qq = qr[w4], dd = dr[w4];
        dv[4 * w4] = fmaf(p, dd.x, dv[4 * w4]);
        dv[4 * w4 + 1] = fmaf(p, dd.y, dv[4 * w4 + 1]);
        dv[4 * w4 + 2] = fmaf(p, dd.z, dv[4 * w4 + 2]);
        dv[4 * w4 + 3] = fmaf(p, dd.w, dv[4 * w4 + 3]);
        dk[4 * w4] = fmaf(ds, qq.x, dk[4 * w4]);
        dk[4 * w4 + 1] = fmaf(ds, qq.y, dk[4 * w4 + 1]);
        dk[4 * w4 + 2] = fmaf(ds, qq.z, dk[4 * w4 + 2]);
        dk[4 * w4 + 3] = fmaf(ds, qq.w, dk[4 * w4 + 3]);
      }
    }
  }

  if (!key_ok) return;
  T* dkp = static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh +
           static_cast<int64_t>(kj) * a.dk_ss + sl * W;
  T* dvp = static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh +
           static_cast<int64_t>(kj) * a.dv_ss + sl * W;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    store_to(dkp + w, dk[w]);
    store_to(dvp + w, dv[w]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) dq_kernel(const BwdArgs a) {
  constexpr int W = slice_width(HD);
  constexpr int SPLIT = slice_count(HD);
  constexpr int BC = tile_rows(HD);  // keys staged at once
  constexpr int LD = HD + 4;
  __shared__ float4 ks4[BC * LD / 4];
  __shared__ float4 vs4[BC * LD / 4];
  float* Ks = reinterpret_cast<float*>(ks4);
  float* Vs = reinterpret_cast<float*>(vs4);

  const int tid = threadIdx.x;
  const int sl = tid % SPLIT;
  const int r = tid / SPLIT;  // this thread's row: rep heads x bq positions
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * a.bq;
  const int pos_l = r / a.rep;
  const int qi = q0 + pos_l;
  const bool row_ok = pos_l < a.bq && qi < a.Sq;
  const int h = kvh * a.rep + r % a.rep;
  const int qabs = row_ok ? qi + a.q_offset : -1;

  float qr[W], dor[W], dq[W];
  float lse_r = 0.0f, delta_r = 0.0f;
  if (row_ok) {
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                  static_cast<int64_t>(qi) * a.q_ss + sl * W;
    const T* dp = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh +
                  static_cast<int64_t>(qi) * a.do_ss + sl * W;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      qr[w] = to_f32(qp[w]) * a.scale;
      dor[w] = to_f32(dp[w]);
    }
    const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + qi;
    lse_r = a.lse[row];
    delta_r = a.delta[row];
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) qr[w] = dor[w] = 0.0f;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) dq[w] = 0.0f;

  // keys any row of this block may see
  const int q_last = min(q0 + a.bq, a.Sq) - 1 + a.q_offset;
  int k_end = a.Skv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.q_offset - a.window + 1);
  k_begin = (k_begin / BC) * BC;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  for (int k0 = k_begin; k0 < k_end; k0 += BC) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BC * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      const int kj = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < a.Skv) {
        kv = to_f32(kb[static_cast<int64_t>(kj) * a.k_ss + d]);
        vv = to_f32(vb[static_cast<int64_t>(kj) * a.v_ss + d]);
      }
      Ks[j * LD + d] = kv;
      Vs[j * LD + d] = vv;
    }
    __syncthreads();
    const int n_keys = min(BC, k_end - k0);
    for (int j = 0; j < n_keys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * LD + sl * W);
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * LD + sl * W);
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int w4 = 0; w4 < W / 4; ++w4) {
        const float4 kk = kr[w4], vv = vr[w4];
        s = fmaf(qr[4 * w4], kk.x, s);
        s = fmaf(qr[4 * w4 + 1], kk.y, s);
        s = fmaf(qr[4 * w4 + 2], kk.z, s);
        s = fmaf(qr[4 * w4 + 3], kk.w, s);
        dp = fmaf(dor[4 * w4], vv.x, dp);
        dp = fmaf(dor[4 * w4 + 1], vv.y, dp);
        dp = fmaf(dor[4 * w4 + 2], vv.z, dp);
        dp = fmaf(dor[4 * w4 + 3], vv.w, dp);
      }
      s = split_sum<SPLIT>(s);
      dp = split_sum<SPLIT>(dp);
      if (!row_ok || !visible(a, qabs, k0 + j)) continue;
      const float ds = expf(s - lse_r) * (dp - delta_r);
#pragma unroll
      for (int w4 = 0; w4 < W / 4; ++w4) {
        const float4 kk = kr[w4];
        dq[4 * w4] = fmaf(ds, kk.x, dq[4 * w4]);
        dq[4 * w4 + 1] = fmaf(ds, kk.y, dq[4 * w4 + 1]);
        dq[4 * w4 + 2] = fmaf(ds, kk.z, dq[4 * w4 + 2]);
        dq[4 * w4 + 3] = fmaf(ds, kk.w, dq[4 * w4 + 3]);
      }
    }
  }

  if (!row_ok) return;
  T* dqp = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh +
           static_cast<int64_t>(qi) * a.dq_ss + sl * W;
#pragma unroll
  for (int w = 0; w < W; ++w) store_to(dqp + w, dq[w] * a.scale);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using namespace tc;  // bf16, cp.async, ldmatrix, mma (mma.cuh)

constexpr float LOG2E = 1.4426950408889634f;

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
  constexpr int BK = NT / slice_count(HD);
  const dim3 gkv((a.Skv + BK - 1) / BK, a.KV, a.B);
  dkv_kernel<float, HD><<<gkv, NT, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gq((a.Sq + a.bq - 1) / a.bq, a.KV, a.B);
  dq_kernel<float, HD><<<gq, NT, 0, stream>>>(a);
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

// Rows of a dQ block (rep heads x positions): the bf16 kernel's four warps of
// 16 rows; the f32 kernel's one thread per 32-wide slice of a row.  Keep in
// step with dq_rows in repro_torch/kernels/flash_attention_bwd.py.
int dq_block_rows(int dtype, int hd) {
  return dtype == REPRO_BF16 ? Tiles<64>::ROWS : NT / slice_count(hd);
}

}  // namespace

extern "C" int repro_flash_attention_bwd(
    int dtype, int hd, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh,
    int64_t dq_ss, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb,
    int64_t dv_sh, int64_t dv_ss, int B, int KV, int Sq, int Skv, int rep, int causal,
    int window, int q_offset, float scale, void* stream) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = dq_block_rows(dtype, hd);
  if (rep < 1 || rep > rows) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(Sq) * rep >= (int64_t{1} << 31))  // the bf16 dK/dV row index
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
            do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss,
            dv_sb, dv_sh, dv_ss, B, KV * rep, KV, Sq, Skv, rep, rows / rep, causal,
            window, q_offset, scale};
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
