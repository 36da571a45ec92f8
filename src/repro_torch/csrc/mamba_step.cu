// One decode step (S == 1) of the Mamba-1 block for Hopper (sm_90a), in two
// kernels around the x_proj product, each updating the serving cache in place:
//
//   conv_step:  c = conv_b + sum_i state[i] * w[i] + x * w[K-1];  out = silu(c);
//               the conv state (B, K-1, DI) shifts one position and takes x.
//   state_step: dt = softplus(rmsnorm(dt_low) . dt_proj[:, d] + dt_bias[d]),
//               h[n] <- exp(dt * A[d, n]) * h[n] + dt * B[n] * x,  A = -exp(A_log),
//               y = (sum_n h[n] * C[n] + D[d] * x) * silu(z),
//               with (dt_low | B | C) = x_proj's output, each RMS-normalised
//               where the model has the norms (Jamba); h is the SSM state
//               (B, DI, N) f32, written back where it was read.
//
// Replaces no TPU kernel: the reference's decode step is plain JAX
// (src/repro/models/ssm.py, the S == 1 branch).  The port ran it as some 65
// torch launches a layer, each a round trip through device memory, with dA,
// dBx and h built as (B, DI, N) f32 temporaries; the host could not issue
// them as fast as the card ran them.
//
// What bounds it on this card: bytes.  The SSM state row is read once and
// written once (8 * B * DI * N bytes); dt_proj (R x DI) is read once; the
// rest (x, z, the conv state, y) is N times smaller.  Every element takes a
// few dozen flops.
//
// What the design does about it: nothing but the state row and the step's
// inputs and outputs touches device memory.  The conv kernel is one thread a
// (row, channel), coalesced over channels, reading the x half of in_proj's
// output through its row stride.  x_proj's sum over all of DI is a grid-wide
// barrier, so it stays a product between the two kernels.  The state kernel
// gives each block a slice of channels and UB batch rows: thread (c, n) owns
// state lane n of channel c, like mamba_scan.cu, so each row's (channels, N)
// slab is one contiguous, coalesced load and store, and the sum over n is a
// butterfly of __shfl_xor_sync.  The block reads its columns of dt_proj into
// shared memory (with the dt norm's scale folded in) and uses each value for
// all its rows; the other row blocks of the slice read them again from L2, so
// device memory serves dt_proj about once.  The rows' dt_low, B and C are
// staged in shared memory and their RMS norms reduced there.  Everything
// accumulates in f32.
//
// Measured on an H100 at jamba-decode-32's shapes (B 32, DI 8192, N 16, R 256,
// bf16): 0.058 ms a call against a byte bound of 0.012 ms.  Issuing
// instructions sets the time, not bytes: the folded dt product (R multiply-adds
// a row and channel) and the per-lane recurrence take ~1200 a thread.  A block
// that walked all 32 rows, with the softplus in every lane, took 0.087 ms (1.3
// waves of blocks on the card); 4 or 16 rows a block, a tile pitch without
// store conflicts, or the copies into shared memory issued 8 at a time took as
// long or longer.
#include "common.cuh"

namespace {

constexpr int CONV_NT = 256;   // threads per conv block
constexpr int K = 4;           // every model's conv width; keep in step with mamba_step.py
constexpr int STATE_NT = 256;  // threads per state block, at most
constexpr int MAX_DT_RANK = 1024;  // keep in step with kernels/mamba_step.py

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// torch.nn.functional.softplus with beta 1 and threshold 20
__device__ __forceinline__ float softplus(float v) { return v > 20.0f ? v : log1pf(expf(v)); }

template <typename T>
__global__ void __launch_bounds__(CONV_NT) conv_step_kernel(
    const T* __restrict__ x, int64_t ldx, T* __restrict__ state, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out, int DI) {
  const int d = blockIdx.x * CONV_NT + threadIdx.x;
  if (d >= DI) return;
  const int64_t b = blockIdx.y;
  T* st = state + b * (K - 1) * DI + d;
  T s[K];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) s[i] = st[static_cast<int64_t>(i) * DI];
  s[K - 1] = x[b * ldx + d];
  float acc = to_f32(bias[d]);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    acc = fmaf(to_f32(s[i]), to_f32(w[static_cast<int64_t>(i) * DI + d]), acc);
  }
#pragma unroll
  for (int i = 0; i < K - 1; ++i) st[static_cast<int64_t>(i) * DI] = s[i + 1];
  store_to(out + b * DI + d, silu(acc));
}

// the channels a block of the state kernel owns: 256 / N, at most 32
__host__ __device__ constexpr int channels(int N) { return STATE_NT / N < 32 ? STATE_NT / N : 32; }

// the batch rows a block of the state kernel owns: 8, or N where N < 8, so
// that each row's dt and y fall to one lane of its channel
__host__ __device__ constexpr int rows_per_block(int N) { return N < 8 ? N : 8; }

// row pitch of the dt_proj tile in shared memory: lane n of channel c reads
// element c * pitch + n + k * N, so a pitch of N mod 32 puts the lanes of a
// warp on distinct banks
__host__ __device__ constexpr int tile_pitch(int R, int N) { return (R + 31) / 32 * 32 + N % 32; }

template <int N>
__host__ __device__ constexpr size_t state_smem_bytes(int R) {
  constexpr int UB = rows_per_block(N);
  return sizeof(float) * (static_cast<size_t>(channels(N)) * tile_pitch(R, N)
                          + static_cast<size_t>(UB) * (R + 2 * N) + UB * 3);
}

// sum over the N lanes of a channel (neighbouring lanes of one warp)
template <int N>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

// v[i] for an index known only at run time, without spilling v to local memory
template <int U>
__device__ __forceinline__ float pick(const float (&v)[U], int i) {
  float out = v[0];
#pragma unroll
  for (int u = 1; u < U; ++u) out = i == u ? v[u] : out;
  return out;
}

// A block owns DC channels and UB batch rows (blockIdx.y).  Lane n of a
// channel takes the dot product for dt over its slice of R for all UB rows at
// once, each tile value read once; the softplus of row u runs in lane u alone
// and reaches the channel's other lanes by a shuffle, and lane u writes row
// u's y, so no lane repeats another's transcendentals.
template <typename T, int N>
__global__ void __launch_bounds__(STATE_NT) state_step_kernel(
    const T* __restrict__ proj, int64_t ldp, const T* __restrict__ x,
    const T* __restrict__ z, int64_t ldz, const T* __restrict__ dt_proj,
    const T* __restrict__ dt_bias, const T* __restrict__ A_log, const T* __restrict__ Dp,
    const T* __restrict__ dt_norm, const T* __restrict__ b_norm, const T* __restrict__ c_norm,
    float* __restrict__ h, T* __restrict__ y, int B, int DI, int R, float eps) {
  constexpr int DC = channels(N);
  constexpr int NT = DC * N;
  constexpr int NW = NT / 32;
  constexpr int UB = rows_per_block(N);
  extern __shared__ float smem[];
  const int P = tile_pitch(R, N);
  const int W = R + 2 * N;  // one row of x_proj's output
  float* tile = smem;                                  // (DC, P): dt_proj's columns
  float* rows = tile + DC * P;                         // (UB, W): dt_low | B | C
  float* inv = rows + UB * W;                          // (UB, 3): 1 / rms of each
  const bool norms = dt_norm != nullptr;

  const int c = threadIdx.x / N;
  const int n = threadIdx.x % N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d0 = blockIdx.x * DC;
  const int d = d0 + c;
  const bool ok = d < DI;
  const int b0 = blockIdx.y * UB;
  const int64_t slab = static_cast<int64_t>(DI) * N;

  float hv[UB], xv[UB], zv[UB];  // this row slice's loads, issued first
#pragma unroll
  for (int u = 0; u < UB; ++u) {
    const bool live = ok && b0 + u < B;
    const int64_t b = b0 + u;
    hv[u] = live ? h[b * slab + static_cast<int64_t>(d) * N + n] : 0.0f;
    xv[u] = live ? to_f32(x[b * DI + d]) : 0.0f;
    zv[u] = live ? to_f32(z[b * ldz + d]) : 0.0f;
  }
  for (int i = threadIdx.x; i < R * DC; i += NT) {
    const int r = i / DC, cc = i % DC;
    float v = 0.0f;
    if (d0 + cc < DI) {
      v = to_f32(dt_proj[static_cast<int64_t>(r) * DI + d0 + cc]);
      if (norms) v *= 1.0f + to_f32(dt_norm[r]);
    }
    tile[cc * P + r] = v;
  }
#pragma unroll
  for (int u = 0; u < UB; ++u) {
    const T* src = proj + static_cast<int64_t>(b0 + u) * ldp;
    for (int j = threadIdx.x; j < W; j += NT) {
      rows[u * W + j] = b0 + u < B ? to_f32(src[j]) : 0.0f;
    }
  }
  const float a = ok ? -expf(to_f32(A_log[static_cast<int64_t>(d) * N + n])) : 0.0f;
  const float bias = ok ? to_f32(dt_bias[d]) : 0.0f;
  const float dd = ok ? to_f32(Dp[d]) : 0.0f;
  const float gb = norms ? 1.0f + to_f32(b_norm[n]) : 1.0f;
  const float gc = norms ? 1.0f + to_f32(c_norm[n]) : 1.0f;
  __syncthreads();
  if (norms) {
    for (int u = warp; u < UB; u += NW) {
      const float* row = rows + u * W;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      for (int j = lane; j < R; j += 32) s0 = fmaf(row[j], row[j], s0);
      for (int j = lane; j < N; j += 32) {
        s1 = fmaf(row[R + j], row[R + j], s1);
        s2 = fmaf(row[R + N + j], row[R + N + j], s2);
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, w);
        s1 += __shfl_xor_sync(0xffffffffu, s1, w);
        s2 += __shfl_xor_sync(0xffffffffu, s2, w);
      }
      if (lane == 0) {
        inv[u * 3 + 0] = 1.0f / sqrtf(s0 / R + eps);
        inv[u * 3 + 1] = 1.0f / sqrtf(s1 / N + eps);
        inv[u * 3 + 2] = 1.0f / sqrtf(s2 / N + eps);
      }
    }
    __syncthreads();
  }

  // dt_low . dt_proj[:, d] for every row: each tile value read once
  float acc[UB];
#pragma unroll
  for (int u = 0; u < UB; ++u) acc[u] = 0.0f;
  const float* tcol = tile + c * P;
  for (int r = n; r < R; r += N) {
    const float w = tcol[r];
#pragma unroll
    for (int u = 0; u < UB; ++u) acc[u] = fmaf(rows[u * W + r], w, acc[u]);
  }
#pragma unroll
  for (int u = 0; u < UB; ++u) acc[u] = lane_sum<N>(acc[u]);
  // dt of row u: lane u computes it, the channel's other lanes take it
  const int mine = min(n, UB - 1);
  const float sp = softplus(fmaf(pick(acc, mine), norms ? inv[mine * 3] : 1.0f, bias));
  const int base = lane - n;  // the channel's first lane in the warp
  float p[UB];
#pragma unroll
  for (int u = 0; u < UB; ++u) {
    const float dt = __shfl_sync(0xffffffffu, sp, base + u);
    const float* row = rows + u * W;
    const float bn = row[R + n] * (norms ? inv[u * 3 + 1] : 1.0f) * gb;
    const float cn = row[R + N + n] * (norms ? inv[u * 3 + 2] : 1.0f) * gc;
    const float hn = fmaf(expf(dt * a), hv[u], dt * bn * xv[u]);
    p[u] = lane_sum<N>(hn * cn);
    if (ok && b0 + u < B) {
      h[static_cast<int64_t>(b0 + u) * slab + static_cast<int64_t>(d) * N + n] = hn;
    }
  }
  // y of row u is written by lane u of the channel
  if (ok && n < UB && b0 + n < B) {
    const float xu = pick(xv, n), zu = pick(zv, n);
    store_to(y + static_cast<int64_t>(b0 + n) * DI + d, fmaf(dd, xu, pick(p, n)) * silu(zu));
  }
}

template <typename T>
int conv_launch(const void* x, int64_t ldx, void* state, const void* w, const void* bias,
                void* out, int B, int DI, cudaStream_t stream) {
  const dim3 grid((DI + CONV_NT - 1) / CONV_NT, B);
  conv_step_kernel<T><<<grid, CONV_NT, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<T*>(state), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), DI);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int state_launch(const void* proj, int64_t ldp, const void* x, const void* z, int64_t ldz,
                 const void* dt_proj, const void* dt_bias, const void* A_log, const void* D,
                 const void* dt_norm, const void* b_norm, const void* c_norm, float* h, void* y,
                 int B, int DI, int R, float eps, cudaStream_t stream) {
  constexpr int DC = channels(N);
  constexpr int UB = rows_per_block(N);
  const size_t smem = state_smem_bytes<N>(R);
  auto kernel = state_step_kernel<T, N>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((DI + DC - 1) / DC, (B + UB - 1) / UB);
  kernel<<<grid, DC * N, smem, stream>>>(
      static_cast<const T*>(proj), ldp, static_cast<const T*>(x), static_cast<const T*>(z), ldz,
      static_cast<const T*>(dt_proj), static_cast<const T*>(dt_bias),
      static_cast<const T*>(A_log), static_cast<const T*>(D), static_cast<const T*>(dt_norm),
      static_cast<const T*>(b_norm), static_cast<const T*>(c_norm), h, static_cast<T*>(y), B,
      DI, R, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int state_dispatch(const void* proj, int64_t ldp, const void* x, const void* z, int64_t ldz,
                   const void* dt_proj, const void* dt_bias, const void* A_log, const void* D,
                   const void* dt_norm, const void* b_norm, const void* c_norm, float* h,
                   void* y, int B, int DI, int R, int N, float eps, cudaStream_t s) {
#define REPRO_STATE_CASE(NN)                                                                  \
  case NN:                                                                                    \
    return state_launch<T, NN>(proj, ldp, x, z, ldz, dt_proj, dt_bias, A_log, D, dt_norm,     \
                               b_norm, c_norm, h, y, B, DI, R, eps, s);
  switch (N) {
    REPRO_STATE_CASE(1)
    REPRO_STATE_CASE(2)
    REPRO_STATE_CASE(4)
    REPRO_STATE_CASE(8)
    REPRO_STATE_CASE(16)
    REPRO_STATE_CASE(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_STATE_CASE
}

}  // namespace

// x: (B, DI) with row stride ldx (the x half of in_proj's output); state
// (B, K-1, DI), w (K, DI), bias (DI), out (B, DI), all of one dtype
extern "C" int repro_mamba_conv_step(const void* x, int64_t ldx, void* state, const void* w,
                                     const void* bias, void* out, int B, int DI, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32: return conv_launch<float>(x, ldx, state, w, bias, out, B, DI, s);
    case REPRO_BF16: return conv_launch<__nv_bfloat16>(x, ldx, state, w, bias, out, B, DI, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// proj: (B, R + 2N) with row stride ldp; x (B, DI) contiguous; z (B, DI) with
// row stride ldz; dt_proj (R, DI); dt_bias, D (DI); A_log (DI, N); the norms
// (R), (N), (N) or all null; all of one dtype.  h: (B, DI, N) f32, in place;
// y: (B, DI)
extern "C" int repro_mamba_state_step(const void* proj, int64_t ldp, const void* x,
                                      const void* z, int64_t ldz, const void* dt_proj,
                                      const void* dt_bias, const void* A_log, const void* D,
                                      const void* dt_norm, const void* b_norm,
                                      const void* c_norm, void* h, void* y, int B, int DI, int R,
                                      int N, float eps, int dtype, void* stream) {
  if (R < 1 || R > MAX_DT_RANK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hh = static_cast<float*>(h);
  switch (dtype) {
    case REPRO_F32:
      return state_dispatch<float>(proj, ldp, x, z, ldz, dt_proj, dt_bias, A_log, D, dt_norm,
                                   b_norm, c_norm, hh, y, B, DI, R, N, eps, s);
    case REPRO_BF16:
      return state_dispatch<__nv_bfloat16>(proj, ldp, x, z, ldz, dt_proj, dt_bias, A_log, D,
                                           dt_norm, b_norm, c_norm, hh, y, B, DI, R, N, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
