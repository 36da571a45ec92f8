// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel is exported through a plain C function that launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with repro_torch/kernels/*.py
enum ReproDtype : int {
  REPRO_F32 = 0,
  REPRO_F64 = 1,
  REPRO_BF16 = 2,
  REPRO_F16 = 3,
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// accumulator type of an element type: f64 for f64, f32 for everything else
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// element -> accumulator
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

// accumulator -> element (round to nearest even for bf16)
__device__ __forceinline__ void store_to(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_to(double* p, double x) { *p = x; }
__device__ __forceinline__ void store_to(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// IEEE fused multiply-add in the accumulator type (never TF32)
__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }
