// Fused GLM elementwise pass for Hopper (sm_90a): mu = sigmoid(z),
// c = mu - y, w = mu * (1 - mu), all three written in f32.
//
// Replaces: src/repro/kernels/glm_fused.py::glm_fused_pallas (body
// _glm_kernel).
//
// What bounds it on this card: bytes.  Per element it reads z and y and
// writes three f32 values, against a handful of operations, so it sits far
// below the card's operations-per-byte balance point.
//
// What the design does about it: one pass, no intermediate in device memory
// (mu never round-trips before c and w are formed); neighbouring threads
// touch neighbouring elements so every load and store is coalesced; a
// grid-stride loop masks the tail itself, so there is no row-tile search or
// padding (the reference wrapper's row-tile search divides n for the TPU's
// BlockSpec grid, which this card does not need).  The sigmoid is the
// two-sided form, exact to f32 rounding without fast-math intrinsics.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sigmoid_f32(float z) {
  if (z >= 0.0f) return 1.0f / (1.0f + expf(-z));
  const float e = expf(z);
  return e / (1.0f + e);
}

template <typename T>
__global__ void glm_fused_kernel(const T* __restrict__ z, const T* __restrict__ y,
                                 float* __restrict__ mu, float* __restrict__ c,
                                 float* __restrict__ w, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float m = sigmoid_f32(to_f32(z[i]));
    mu[i] = m;
    c[i] = m - to_f32(y[i]);
    w[i] = m * (1.0f - m);
  }
}

template <typename T>
int launch(const void* z, const void* y, float* mu, float* c, float* w, int64_t n,
           cudaStream_t stream) {
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  glm_fused_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(y), mu, c, w, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_glm_fused(int dtype, const void* z, const void* y, void* mu, void* c,
                               void* w, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* cc = static_cast<float*>(c);
  float* ww = static_cast<float*>(w);
  switch (dtype) {
    case REPRO_F32: return launch<float>(z, y, m, cc, ww, n, s);
    case REPRO_F64: return launch<double>(z, y, m, cc, ww, n, s);
    case REPRO_BF16: return launch<__nv_bfloat16>(z, y, m, cc, ww, n, s);
    case REPRO_F16: return launch<__half>(z, y, m, cc, ww, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
