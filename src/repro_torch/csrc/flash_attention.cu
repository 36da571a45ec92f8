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
// - f32 (flash_fwd_kernel): scalar IEEE f32 FMA (the tensor cores would
//   take f32 only through TF32, which the port never uses).  A block of 128
//   threads is rows x key groups; each thread keeps its row's output
//   accumulator in registers (and its query there too up to hd 64, in
//   shared memory above); with few rows the groups split each key tile and
//   are merged through shared memory at the end.  At hd 256 a row's
//   accumulator would not fit one thread's registers: flash_fwd_wide_kernel
//   splits the head dim over a group of four threads (64 dims each), which
//   reduce each q.k product with two __shfl_xor steps.
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
// The bf16 kernel copies rows 16 bytes at a time, so it needs every
// operand's base and strides 16-byte aligned: the wrapper copies a view that
// is not into a new tensor first.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 128;  // threads per block (four warps)
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
  int rows;     // f32: rows per block, a power of two <= NT
  int bq;       // f32: query positions per block, rows / rep
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
// f32: scalar FMA
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int key_tile(int hd) { return hd <= 64 ? 64 : 32; }
__host__ __device__ constexpr int key_chunk(int hd) { return hd <= 64 ? 16 : 8; }
// above hd 64 a thread's query and accumulator would not both fit its
// registers: the query rows live in shared memory
__host__ __device__ constexpr bool q_in_smem(int hd) { return hd > 64; }

template <int HD>
constexpr size_t smem_floats() {
  // max(two key/value tiles (and the query rows), the merge's per-thread states)
  constexpr size_t tiles = 2 * key_tile(HD) * (HD + 4) + (q_in_smem(HD) ? NT * (HD + 4) : 0);
  constexpr size_t merge = 2 * NT + NT * (HD + 1);
  return tiles > merge ? tiles : merge;
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const FlashArgs a) {
  constexpr int BC = key_tile(HD);   // keys per tile
  constexpr int CH = key_chunk(HD);  // keys per softmax update
  constexpr int LD = HD + 4;         // padded tile row, in floats (16-byte aligned)
  constexpr bool QS = q_in_smem(HD);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;
  float* Vs = smem + BC * LD;
  float* Qs = smem + 2 * BC * LD;    // QS: the block's query rows, scaled

  const int tid = threadIdx.x;
  const int G = NT / a.rows;         // key groups
  const int r = tid % a.rows;        // this thread's row ...
  const int g = tid / a.rows;        // ... and key group
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int split = blockIdx.x % a.splits;
  const int q0 = blockIdx.x / a.splits * a.bq;
  const int pos_l = r / a.rep;
  const int qpos = q0 + pos_l;
  const bool row_ok = pos_l < a.bq && qpos < a.Sq;
  const int h = kvh * a.rep + r % a.rep;
  const int q_offset = row_offset(a, b);
  const int qabs = qpos + q_offset;

  float qr[QS ? 1 : HD];
  {
    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh +
                      static_cast<int64_t>(qpos) * a.q_ss;
    if constexpr (QS) {
      if (g == 0)
        for (int d = 0; d < HD; ++d) Qs[r * LD + d] = row_ok ? qp[d] * a.scale : 0.0f;
    } else {
#pragma unroll
      for (int d = 0; d < HD; ++d) qr[d] = row_ok ? qp[d] * a.scale : 0.0f;
    }
  }

  // keys any row of this block may see, in tiles; this split's share
  const int q_last = min(q0 + a.bq, a.Sq) - 1 + q_offset;
  int k_end = a.Skv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + q_offset - a.window + 1);
  k_begin = (k_begin / BC) * BC;
  int t_lo, t_hi;
  split_tiles(k_end > k_begin ? (k_end - k_begin + BC - 1) / BC : 0, split, a.splits, t_lo,
              t_hi);

  // this row's visible keys: [lo, hi)
  int hi = a.Skv;
  if (a.causal) hi = min(hi, qabs + 1);
  const int lo = a.window > 0 ? qabs - a.window + 1 : 0;

  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float m = -INFINITY, l = 0.0f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;

  for (int k0 = k_begin + t_lo * BC; k0 < k_begin + t_hi * BC; k0 += BC) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BC * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const int kj = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < a.Skv) {
        kv = kb[static_cast<int64_t>(kj) * a.k_ss + d];
        vv = vb[static_cast<int64_t>(kj) * a.v_ss + d];
      }
      Ks[j * LD + d] = kv;
      Vs[j * LD + d] = vv;
    }
    __syncthreads();
    if (!row_ok) continue;
    const float4* qv = reinterpret_cast<const float4*>(Qs + r * LD);
    for (int j0 = g; j0 < BC; j0 += G * CH) {
      float s[CH];
      float mc = -INFINITY;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = j0 + c * G;
        const int kj = k0 + j;
        s[c] = -INFINITY;
        if (j < BC && kj >= lo && kj < hi) {
          const float4* kr = reinterpret_cast<const float4*>(Ks + j * LD);
          float dot = 0.0f;
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 kk = kr[d4];
            float4 qq;
            if constexpr (QS) {
              qq = qv[d4];
            } else {
              qq = make_float4(qr[4 * d4], qr[4 * d4 + 1], qr[4 * d4 + 2], qr[4 * d4 + 3]);
            }
            dot = fmaf(qq.x, kk.x, dot);
            dot = fmaf(qq.y, kk.y, dot);
            dot = fmaf(qq.z, kk.z, dot);
            dot = fmaf(qq.w, kk.w, dot);
          }
          s[c] = dot;
          mc = fmaxf(mc, dot);
        }
      }
      if (mc == -INFINITY) continue;  // no visible key in this chunk
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);  // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (s[c] == -INFINITY) continue;
        const float p = expf(s[c] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs + (j0 + c * G) * LD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  const int64_t row = (static_cast<int64_t>(b) * a.KV * a.rep + h) * a.Sq + qpos;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh +
              static_cast<int64_t>(qpos) * a.o_ss;
  if (G == 1) {
    if (!row_ok) return;
    if (a.splits > 1) {  // this split's partial: (m, l, unnormalised O)
      float* wa = ws_acc(a, split, row, HD);
#pragma unroll
      for (int d = 0; d < HD; ++d) wa[d] = acc[d];
      *ws_m(a, split, row, HD) = m;
      *ws_l(a, split, row, HD) = l;
      return;
    }
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // a row that sees no key gives 0
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = acc[d] * inv;
    if (a.lse != nullptr) a.lse[row] = row_lse(m, l);
    return;
  }

  // merge the groups' softmax states, row by row
  __syncthreads();  // the key/value tiles are no longer read
  float* pm = smem;
  float* pl = smem + NT;
  float* pacc = smem + 2 * NT;
  pm[tid] = m;
  pl[tid] = l;
#pragma unroll
  for (int d = 0; d < HD; ++d) pacc[tid * (HD + 1) + d] = acc[d];
  __syncthreads();
  if (!row_ok) return;
  float M = -INFINITY;
  for (int gg = 0; gg < G; ++gg) M = fmaxf(M, pm[gg * a.rows + r]);
  float L = 0.0f;
  for (int gg = 0; gg < G; ++gg) {
    const float mg = pm[gg * a.rows + r];
    if (mg != -INFINITY) L += pl[gg * a.rows + r] * expf(mg - M);
  }
  const bool part = a.splits > 1;
  const float inv = part ? 1.0f : (L > 0.0f ? 1.0f / L : 0.0f);
  if (g == 0) {
    if (part) {
      *ws_m(a, split, row, HD) = M;
      *ws_l(a, split, row, HD) = L;
    } else if (a.lse != nullptr) {
      a.lse[row] = row_lse(M, L);
    }
  }
  float* dst = part ? ws_acc(a, split, row, HD) : op;
  for (int d = g; d < HD; d += G) {  // this thread writes every G-th dim of its row
    float o = 0.0f;
    for (int gg = 0; gg < G; ++gg) {
      const int t = gg * a.rows + r;
      if (pm[t] != -INFINITY) o = fmaf(pacc[t * (HD + 1) + d], expf(pm[t] - M), o);
    }
    dst[d] = o * inv;
  }
}

// ---------------------------------------------------------------------------
// f32 at hd 256: a row's head dim split over a group of threads
// ---------------------------------------------------------------------------

constexpr int TPR = 4;               // threads per row
constexpr int WIDE_ROWS = NT / TPR;  // rows per block, rep x positions
constexpr int WIDE_BC = 32;          // keys per tile
constexpr int WIDE_CH = 8;           // keys per softmax update

template <int HD>
constexpr size_t wide_smem_floats() {  // two key/value tiles and the query rows
  return static_cast<size_t>(2 * WIDE_BC + WIDE_ROWS) * (HD + 4);
}

// Thread t of a row's group owns the float4 chunks t, t + TPR, ... of the
// head dim (neighbouring threads on neighbouring chunks): HD / TPR values of
// the accumulator, and the same share of each q.k product, which two
// __shfl_xor steps sum (in the same order on all four lanes, so they agree
// bitwise).  Every lane runs every product, masked rows too, so the
// shuffles always find the whole warp; a row's m and l are kept by all four.
template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_wide_kernel(const FlashArgs a) {
  constexpr int LD = HD + 4;          // padded row, in floats (16-byte aligned)
  constexpr int NV = HD / (4 * TPR);  // float4 chunks per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;
  float* Vs = smem + WIDE_BC * LD;
  float* Qs = smem + 2 * WIDE_BC * LD;  // the block's query rows, scaled

  const int tid = threadIdx.x;
  const int r = tid / TPR, t = tid % TPR;  // this thread's row and its place in the group
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int split = blockIdx.x % a.splits;
  const int q0 = blockIdx.x / a.splits * a.bq;
  const int pos_l = r / a.rep;
  const int qpos = q0 + pos_l;
  const bool row_ok = r < a.rows && pos_l < a.bq && qpos < a.Sq;
  const int h = kvh * a.rep + r % a.rep;
  const int q_offset = row_offset(a, b);
  const int qabs = qpos + q_offset;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb;
  for (int i = tid; i < WIDE_ROWS * HD; i += NT) {
    const int rr = i / HD, d = i % HD;
    const int pl = rr / a.rep, qp = q0 + pl;
    const bool ok = rr < a.rows && pl < a.bq && qp < a.Sq;
    const int hh = kvh * a.rep + rr % a.rep;
    Qs[rr * LD + d] =
        ok ? qb[hh * a.q_sh + static_cast<int64_t>(qp) * a.q_ss + d] * a.scale : 0.0f;
  }

  // keys any row of this block may see, in tiles; this split's share
  const int q_last = min(q0 + a.bq, a.Sq) - 1 + q_offset;
  int k_end = a.Skv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + q_offset - a.window + 1);
  k_begin = (k_begin / WIDE_BC) * WIDE_BC;
  int t_lo, t_hi;
  split_tiles(k_end > k_begin ? (k_end - k_begin + WIDE_BC - 1) / WIDE_BC : 0, split,
              a.splits, t_lo, t_hi);

  // this row's visible keys: [lo, hi), empty for a row past the last
  int hi = row_ok ? a.Skv : 0;
  if (a.causal) hi = min(hi, qabs + 1);
  const int lo = a.window > 0 ? qabs - a.window + 1 : 0;

  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float4* qv = reinterpret_cast<const float4*>(Qs + r * LD);

  float m = -INFINITY, l = 0.0f;
  float acc[4 * NV];
#pragma unroll
  for (int i = 0; i < 4 * NV; ++i) acc[i] = 0.0f;

  for (int k0 = k_begin + t_lo * WIDE_BC; k0 < k_begin + t_hi * WIDE_BC; k0 += WIDE_BC) {
    __syncthreads();  // the previous tile is consumed (and the query rows stored)
    for (int i = tid; i < WIDE_BC * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const int kj = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < a.Skv) {
        kv = kb[static_cast<int64_t>(kj) * a.k_ss + d];
        vv = vb[static_cast<int64_t>(kj) * a.v_ss + d];
      }
      Ks[j * LD + d] = kv;
      Vs[j * LD + d] = vv;
    }
    __syncthreads();
    for (int j0 = 0; j0 < WIDE_BC; j0 += WIDE_CH) {
      float s[WIDE_CH];
      float mc = -INFINITY;
#pragma unroll
      for (int c = 0; c < WIDE_CH; ++c) {
        const int j = j0 + c;
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * LD);
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 kk = kr[t + TPR * i];
          const float4 qq = qv[t + TPR * i];
          dot = fmaf(qq.x, kk.x, dot);
          dot = fmaf(qq.y, kk.y, dot);
          dot = fmaf(qq.z, kk.z, dot);
          dot = fmaf(qq.w, kk.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int kj = k0 + j;
        s[c] = kj >= lo && kj < hi ? dot : -INFINITY;
        mc = fmaxf(mc, s[c]);
      }
      if (mc == -INFINITY) continue;  // no visible key in this chunk (no shuffle follows)
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);  // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 4 * NV; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < WIDE_CH; ++c) {
        if (s[c] == -INFINITY) continue;
        const float p = expf(s[c] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs + (j0 + c) * LD);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 vv = vr[t + TPR * i];
          acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!row_ok) return;
  const int64_t row = (static_cast<int64_t>(b) * a.KV * a.rep + h) * a.Sq + qpos;
  const bool part = a.splits > 1;
  const float inv = part ? 1.0f : (l > 0.0f ? 1.0f / l : 0.0f);  // no key seen: 0
  float* dst = part ? ws_acc(a, split, row, HD)
                    : static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh +
                          static_cast<int64_t>(qpos) * a.o_ss;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[4 * (t + TPR * i) + e] = acc[4 * i + e] * inv;
  if (t != 0) return;
  if (part) {  // this split's partial: (m, l, unnormalised O)
    *ws_m(a, split, row, HD) = m;
    *ws_l(a, split, row, HD) = l;
  } else if (a.lse != nullptr) {
    a.lse[row] = row_lse(m, l);
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
  const int64_t blocks = static_cast<int64_t>((a.Sq + a.bq - 1) / a.bq) * a.splits;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), a.KV, B);
  if constexpr (HD > 128) {  // the head dim split over a group of threads
    if (a.rows > WIDE_ROWS) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = wide_smem_floats<HD>() * sizeof(float);
    const int e = set_smem(reinterpret_cast<const void*>(flash_fwd_wide_kernel<HD>), bytes);
    if (e != 0) return e;
    flash_fwd_wide_kernel<HD><<<grid, NT, bytes, stream>>>(a);
  } else {
    const size_t bytes = smem_floats<HD>() * sizeof(float);
    const int e = set_smem(reinterpret_cast<const void*>(flash_fwd_kernel<HD>), bytes);
    if (e != 0) return e;
    flash_fwd_kernel<HD><<<grid, NT, bytes, stream>>>(a);
  }
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
// `rows` (f32 only: rows per block, a power of two, at least rep) is at
// most NT, and at most WIDE_ROWS at hd 256.
// q_offsets, when not null, is a device array of B int32 offsets >= 0, one
// per batch row, read in place of q_offset; the host chose `splits` from the
// largest of them.
extern "C" int repro_flash_attention(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o, float* lse,
    float* ws, const int* q_offsets, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int B, int KV, int Sq, int Skv, int rep, int rows, int causal,
    int window, int q_offset, int splits, float scale, void* stream) {
  if (rows < 1 || rows > NT || (rows & (rows - 1)) != 0 || rows < rep)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || (splits > 1 && ws == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a{q, k, v, o, lse, ws, q_offsets, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
              v_ss, o_sb, o_sh, o_ss, static_cast<int64_t>(B) * KV * rep * Sq, Sq, Skv, KV, rep,
              rows, rows / rep, causal, window, q_offset, splits, scale};
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
