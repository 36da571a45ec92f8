// Flash attention forward for Hopper (sm_90a): grouped-query attention with
// a 1/sqrt(hd) scale, an online softmax over key tiles, causal masking with a
// query offset, an optional sliding window, and tiles that are wholly masked
// skipped.  f32 or bf16 in and out, f32 inside.  When given an lse buffer it
// also writes each row's log-sum-exp of scaled scores, lse = m + log(l), as
// (B, H, Sq) f32 (-inf for a row that sees no key): the backward
// (flash_attention_bwd.cu) recomputes the probabilities from it.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel).
//
// What bounds it on this card: at prefill, operations (about 4 * Sq * keys
// * hd per query head, against q, k and v read once); at decode (Sq = 1),
// bytes: the whole key/value cache is read for one query row per head.
//
// What the design does about it:
// - One block takes one (batch, kv head) pair and one tile of query
//   positions, and its rows are every query head that shares that kv head
//   at every position of the tile (rows = rep * bq).  Each key/value tile is
//   read from device memory once for all rep heads, not rep times: the
//   decode block has 5 live rows for hymba, not 1.
// - Key/value tiles are staged through shared memory in f32; each thread
//   keeps its row's query and output accumulator in registers, and its
//   running max and denominator in two registers (the TPU kernel's
//   (bq, 128) lane-broadcast scratch is a layout artifact of its vector
//   unit and has no counterpart here).
// - A block of 128 threads is rows x groups: with few rows (decode), the
//   groups split each key tile between them, each keeps its own softmax
//   state, and the groups are merged through shared memory at the end; with
//   128 rows (prefill) every thread owns a row and there is no merge.
// - Key tiles outside [first key any row may see, last key any row may see]
//   are never loaded (causal and window skipping); keys >= Skv are masked
//   explicitly, so a ragged cache needs no padding.
// - Arithmetic is scalar IEEE f32 FMA: right and simple first.  The tensor
//   cores (mma.sync / wgmma on bf16) are later work; PERF.md has the gap.
//
// Operands are read through strides (batch, head, position; the head
// dimension is contiguous), so the model's (B, S, H, hd) activations and its
// (B, S_max, KV, hd) cache are read in place, without a transposing copy.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads per block

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // (B, H, Sq) contiguous, or null: not written
  int64_t q_sb, q_sh, q_ss;  // element strides: batch, head, position
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int Sq, Skv, KV;
  int rep;      // query heads per kv head
  int rows;     // rows per block: a power of two <= NT
  int bq;       // query positions per block: rows / rep
  int causal;   // 0 or 1
  int window;   // 0: no window; else key j is visible iff j > q - window
  int q_offset; // absolute position of query 0
  float scale;
};

__host__ __device__ constexpr int key_tile(int hd) { return hd <= 64 ? 64 : 32; }
__host__ __device__ constexpr int key_chunk(int hd) { return hd <= 64 ? 16 : 8; }

template <int HD>
constexpr size_t smem_floats() {
  // max(two key/value tiles, the per-thread softmax states of the merge)
  return (2 * key_tile(HD) * (HD + 4) > 2 * NT + NT * (HD + 1))
             ? 2 * key_tile(HD) * (HD + 4)
             : 2 * NT + NT * (HD + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const FlashArgs a) {
  constexpr int BC = key_tile(HD);   // keys per tile
  constexpr int CH = key_chunk(HD);  // keys per softmax update
  constexpr int LD = HD + 4;         // padded tile row, in floats (16-byte aligned)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;
  float* Vs = smem + BC * LD;

  const int tid = threadIdx.x;
  const int G = NT / a.rows;         // key groups
  const int r = tid % a.rows;        // this thread's row ...
  const int g = tid / a.rows;        // ... and key group
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * a.bq;
  const int pos_l = r / a.rep;
  const int qpos = q0 + pos_l;
  const bool row_ok = pos_l < a.bq && qpos < a.Sq;
  const int h = kvh * a.rep + r % a.rep;
  const int qabs = qpos + a.q_offset;

  float qr[HD];
  if (row_ok) {
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                  static_cast<int64_t>(qpos) * a.q_ss;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_f32(qp[d]) * a.scale;
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.0f;
  }

  // keys any row of this block may see
  const int q_last = min(q0 + a.bq, a.Sq) - 1 + a.q_offset;
  int k_end = a.Skv;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 + a.q_offset - a.window + 1);
  k_begin = (k_begin / BC) * BC;

  // this row's visible keys: [lo, hi)
  int hi = a.Skv;
  if (a.causal) hi = min(hi, qabs + 1);
  const int lo = a.window > 0 ? qabs - a.window + 1 : 0;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float m = -INFINITY, l = 0.0f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BC) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BC * HD; i += NT) {
      const int j = i / HD, d = i % HD;
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
    if (!row_ok) continue;
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
            dot = fmaf(qr[4 * d4], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
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

  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + static_cast<int64_t>(qpos) * a.o_ss;
  float* lp = a.lse == nullptr ? nullptr
                               : a.lse + (static_cast<int64_t>(b) * a.KV * a.rep + h) * a.Sq + qpos;
  if (G == 1) {
    if (row_ok) {
      const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // a row that sees no key gives 0
#pragma unroll
      for (int d = 0; d < HD; ++d) store_to(op + d, acc[d] * inv);
      if (lp != nullptr) *lp = l > 0.0f ? m + logf(l) : -INFINITY;
    }
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
  const float inv = L > 0.0f ? 1.0f / L : 0.0f;
  if (lp != nullptr && g == 0) *lp = L > 0.0f ? M + logf(L) : -INFINITY;
  for (int d = g; d < HD; d += G) {  // this thread writes every G-th dim of its row
    float o = 0.0f;
    for (int gg = 0; gg < G; ++gg) {
      const int t = gg * a.rows + r;
      if (pm[t] != -INFINITY) o = fmaf(pacc[t * (HD + 1) + d], expf(pm[t] - M), o);
    }
    store_to(op + d, o * inv);
  }
}

template <typename T, int HD>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.Sq + a.bq - 1) / a.bq, a.KV, B);
  flash_fwd_kernel<T, HD><<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const FlashArgs& a, int B, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attention(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o, float* lse,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int B, int KV, int Sq, int Skv, int rep, int rows, int causal, int window,
    int q_offset, float scale, void* stream) {
  if (rows < 1 || rows > NT || (rows & (rows - 1)) != 0 || rows < rep)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a{q, k, v, o, lse, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
              o_sb, o_sh, o_ss, Sq, Skv, KV, rep, rows, rows / rep, causal, window,
              q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32: return launch_hd<float>(hd, a, B, s);
    case REPRO_BF16: return launch_hd<__nv_bfloat16>(hd, a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
