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
// - dkv_kernel: one block per (batch, kv head, tile of BK keys).  A thread
//   owns a slice of W head dims of one key: its slice of k and v and of the
//   dK and dV accumulators live in registers (SPLIT = HD / W threads share a
//   key and add their partial dot products with warp shuffles).  The block
//   walks the query rows that can see any of its keys -- every position of
//   the range at all rep heads of its kv head -- staged through shared
//   memory 32-64 rows at a time (q pre-scaled, dO, lse, delta), so every
//   staged row is read by all threads at once (a broadcast).
// - dq_kernel: one block per (batch, kv head, tile of query positions); its
//   rows are the rep heads at each position, as in the forward.  A thread
//   owns a slice of one row's q, dO and dQ accumulator in registers and walks
//   the key tiles, staged through shared memory.
// Both skip the tiles a causal mask or a window hides wholly, and mask
// queries >= Sq and keys >= Skv explicitly, so no length needs padding (the
// TPU wrapper requires Sq % bq == 0 and Skv % bk == 0).  A row that sees no
// key (lse = -inf) is never visible, so its gradients are exactly 0.
//
// What bounds it on this card: operations.  Per visible (query, key) pair
// and head the two kernels do 7 * hd FMAs (S and dP in both kernels, and the
// dV, dK and dQ updates) against q, k, v, O, dO read once or a few times
// per tile.  The arithmetic is scalar IEEE f32 FMA: right and simple first;
// the tensor cores (mma.sync / wgmma on bf16) are later work, PERF.md has the
// gap to scaled_dot_product_attention's backward.
//
// Operands are read through strides (batch, head, position; the head
// dimension is contiguous), so the model's (B, S, H, hd) activations are
// read and the gradients written in place, without transposing copies.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads per block

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
__host__ __device__ constexpr int tile_rows(int hd) { return hd <= 64 ? 64 : 32; }

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

template <typename T, int HD>
int launch_grads(const BwdArgs& a, cudaStream_t stream) {
  constexpr int BK = NT / slice_count(HD);
  const dim3 gkv((a.Skv + BK - 1) / BK, a.KV, a.B);
  dkv_kernel<T, HD><<<gkv, NT, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gq((a.Sq + a.bq - 1) / a.bq, a.KV, a.B);
  dq_kernel<T, HD><<<gq, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_all(int hd, const BwdArgs& a, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.Sq;
  const int64_t blocks = (rows + NT / 32 - 1) / (NT / 32);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), NT, 0, s>>>(a, hd);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (hd) {
    case 16: return launch_grads<T, 16>(a, s);
    case 32: return launch_grads<T, 32>(a, s);
    case 64: return launch_grads<T, 64>(a, s);
    case 128: return launch_grads<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = NT / slice_count(hd);  // rows per dq block: rep heads x bq positions
  if (rep < 1 || rep > rows) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
            do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss,
            dv_sb, dv_sh, dv_ss, B, KV * rep, KV, Sq, Skv, rep, rows / rep, causal,
            window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32: return launch_all<float>(hd, a, s);
    case REPRO_BF16: return launch_all<__nv_bfloat16>(hd, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
