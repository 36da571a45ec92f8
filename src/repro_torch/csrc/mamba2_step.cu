// One decode step (S == 1) of the Mamba-2 (SSD) mixer for Hopper (sm_90a),
// after the causal conv over x, B and C (mamba_step.cu's conv kernel) and
// before out_proj, updating the serving cache's SSM state in place:
//
//   state_kernel: dt = softplus(dt_raw[h] + dt_bias[h]),  a = exp(-dt * exp(A_log[h])),
//                 S[h][p][n] <- a * S[h][p][n] + dt * x[h][p] * B[g][n],
//                 g[h][p] = (sum_n S[h][p][n] * C[g][n] + D[h] * x[h][p]) * silu(z[h][p]),
//                 with g = h / (H / G) the head's group; S is the state (B, H, P, N)
//                 f32, written back where it was read, and g an f32 row (B, H * P).
//   norm_kernel:  y = g / sqrt(mean(g^2) + eps) * (1 + scale), the gated RMSNorm over
//                 all H * P channels of a row, in the activation dtype.
//
// Replaces no TPU kernel: the reference has no Mamba-2 at all.  The plain
// version (kernels/mamba2_step.py::state_step_ref) builds the decayed state,
// the rank-1 update and the products as (B, H, P, N) f32 temporaries.
//
// What bounds it on this card: bytes.  Each row's state, H * P * N f32 (4 MiB
// at 128 heads of 64 x 128), is read once and written once; everything else
// a step reads or writes is N times smaller or less.  Two fused
// multiply-adds an element.
//
// What the design does about it: a block owns one (row, head) slab of P x N
// f32, 256 threads, each of which loads P * N / 1024 float4s of it at once
// (8 at P 64, N 128) before any arithmetic, so every thread has its whole
// share in flight; a warp's load is 512 contiguous bytes.  The head's dt,
// decay and D, and the thread's four B and C values, are the same for all
// its float4s.  The sum over n is a butterfly of __shfl_xor_sync within the
// N / 4 lanes that share a state row p.  The norm spans every head of a row,
// so it is a second kernel over the f32 row g (8192 values, from L2).
#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads per state block
constexpr int NORM_NT = 1024;  // threads per norm block

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// torch.nn.functional.softplus with beta 1 and threshold 20
__device__ __forceinline__ float softplus(float v) { return v > 20.0f ? v : log1pf(expf(v)); }

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT) mamba2_state_kernel(
    const T* __restrict__ xbc, int64_t ldxbc, const T* __restrict__ dt, int64_t lddt,
    const T* __restrict__ z, int64_t ldz, const T* __restrict__ dt_bias,
    const T* __restrict__ A_log, const T* __restrict__ Dp, float* __restrict__ h,
    float* __restrict__ g, int H, int G) {
  constexpr int LN = N / 4;                   // lanes that share one state row p
  constexpr int ROWS = NT / LN;               // state rows a pass covers
  constexpr int PASSES = P / ROWS;
  static_assert(P % ROWS == 0, "P must be a multiple of the rows a pass covers");
  const int hd = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int DI = H * P;
  const int grp = hd / (H / G);
  const int n0 = (threadIdx.x % LN) * 4;
  const int p0 = threadIdx.x / LN;
  float* slab = h + (b * H + hd) * static_cast<int64_t>(P) * N;
  const T* row = xbc + b * ldxbc;

  float4 s[PASSES];
  float xv[PASSES], zv[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int p = i * ROWS + p0;
    s[i] = *reinterpret_cast<const float4*>(slab + p * N + n0);
    xv[i] = to_f32(row[hd * P + p]);
    zv[i] = to_f32(z[b * ldz + hd * P + p]);
  }
  float bn[4], cn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bn[k] = to_f32(row[DI + grp * N + n0 + k]);
    cn[k] = to_f32(row[DI + G * N + grp * N + n0 + k]);
  }
  const float step = softplus(to_f32(dt[b * lddt + hd]) + to_f32(dt_bias[hd]));
  const float decay = expf(step * -expf(to_f32(A_log[hd])));
  const float skip = to_f32(Dp[hd]);

#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int p = i * ROWS + p0;
    const float u = step * xv[i];
    float4 v = s[i];
    v.x = fmaf(decay, v.x, u * bn[0]);
    v.y = fmaf(decay, v.y, u * bn[1]);
    v.z = fmaf(decay, v.z, u * bn[2]);
    v.w = fmaf(decay, v.w, u * bn[3]);
    *reinterpret_cast<float4*>(slab + p * N + n0) = v;
    float y = fmaf(v.x, cn[0], fmaf(v.y, cn[1], fmaf(v.z, cn[2], v.w * cn[3])));
#pragma unroll
    for (int w = LN / 2; w > 0; w /= 2) y += __shfl_xor_sync(0xffffffffu, y, w);
    if (n0 == 0) g[b * DI + hd * P + p] = fmaf(skip, xv[i], y) * silu(zv[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NORM_NT) mamba2_norm_kernel(
    const float* __restrict__ g, const T* __restrict__ scale, T* __restrict__ y, int DI,
    float eps) {
  __shared__ float part[NORM_NT / 32];
  const int64_t b = blockIdx.x;
  const float* gr = g + b * DI;
  float ss = 0.0f;
  for (int j = threadIdx.x; j < DI; j += NORM_NT) ss = fmaf(gr[j], gr[j], ss);
#pragma unroll
  for (int w = 16; w > 0; w /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, w);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    ss = part[threadIdx.x];
#pragma unroll
    for (int w = 16; w > 0; w /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, w);
    if (threadIdx.x == 0) part[0] = 1.0f / sqrtf(ss / DI + eps);
  }
  __syncthreads();
  const float inv = part[0];
  for (int j = threadIdx.x; j < DI; j += NORM_NT) {
    store_to(y + b * DI + j, gr[j] * inv * (1.0f + to_f32(scale[j])));
  }
}

template <typename T, int P, int N>
int launch(const void* xbc, int64_t ldxbc, const void* dt, int64_t lddt, const void* z,
           int64_t ldz, const void* dt_bias, const void* A_log, const void* D,
           const void* scale, float* h, float* g, void* y, int B, int H, int G, float eps,
           cudaStream_t stream) {
  mamba2_state_kernel<T, P, N><<<dim3(H, B), NT, 0, stream>>>(
      static_cast<const T*>(xbc), ldxbc, static_cast<const T*>(dt), lddt,
      static_cast<const T*>(z), ldz, static_cast<const T*>(dt_bias),
      static_cast<const T*>(A_log), static_cast<const T*>(D), h, g, H, G);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba2_norm_kernel<T><<<B, NORM_NT, 0, stream>>>(g, static_cast<const T*>(scale),
                                                   static_cast<T*>(y), H * P, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* xbc, int64_t ldxbc, const void* dt, int64_t lddt, const void* z,
             int64_t ldz, const void* dt_bias, const void* A_log, const void* D,
             const void* scale, float* h, float* g, void* y, int B, int H, int P, int N, int G,
             float eps, cudaStream_t s) {
#define REPRO_MAMBA2_CASE(PP, NN)                                                       \
  if (P == PP && N == NN)                                                               \
    return launch<T, PP, NN>(xbc, ldxbc, dt, lddt, z, ldz, dt_bias, A_log, D, scale, h, \
                             g, y, B, H, G, eps, s);
  REPRO_MAMBA2_CASE(64, 64)
  REPRO_MAMBA2_CASE(64, 128)
#undef REPRO_MAMBA2_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// xbc: (B, H * P + 2 * G * N) with row stride ldxbc, the conv's output (x | B | C);
// dt: (B, H) with row stride lddt; z: (B, H * P) with row stride ldz; dt_bias, A_log,
// D (H); scale (H * P), the gated norm's; all of one dtype.  h: (B, H, P, N) f32, in
// place, 16-byte aligned; g: (B, H * P) f32 workspace; y: (B, H * P) contiguous
extern "C" int repro_mamba2_state_step(const void* xbc, int64_t ldxbc, const void* dt,
                                       int64_t lddt, const void* z, int64_t ldz,
                                       const void* dt_bias, const void* A_log, const void* D,
                                       const void* scale, void* h, void* g, void* y, int B,
                                       int H, int P, int N, int G, float eps, int dtype,
                                       void* stream) {
  if (G < 1 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hh = static_cast<float*>(h);
  float* gg = static_cast<float*>(g);
  switch (dtype) {
    case REPRO_F32:
      return dispatch<float>(xbc, ldxbc, dt, lddt, z, ldz, dt_bias, A_log, D, scale, hh, gg,
                             y, B, H, P, N, G, eps, s);
    case REPRO_BF16:
      return dispatch<__nv_bfloat16>(xbc, ldxbc, dt, lddt, z, ldz, dt_bias, A_log, D, scale,
                                     hh, gg, y, B, H, P, N, G, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
