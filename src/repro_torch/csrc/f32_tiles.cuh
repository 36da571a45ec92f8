// Register micro-tile products in IEEE f32 FMA, shared by the f32 attention
// kernels (flash_attention.cu, flash_attention_bwd.cu).  The tensor cores
// would take f32 only through TF32, which the port never uses, so those
// kernels are bound by the card's f32 FMA rate (67 TFLOP/s on the H100).
// What keeps them near it is reuse in registers: a thread computes a
// micro-tile of TR x TC outputs by outer products, so every value it reads
// from shared memory feeds TR or TC FMAs (one, in a dot product a thread).
//
// A block's threads form a GR x GC grid, thread (gr, gc) = (tid / GC,
// tid % GC), GC dividing 32: the GC threads of a row group share a warp.
// Thread (gr, gc) owns rows gr + GR * i (i < TR) of a product, and either
// columns gc + GC * j (j < TC) of a score tile (`abt`), or the chunks
// gc + GC * c of the head dim of an accumulator (`pb`).  Rows strided by GR
// and columns by GC put a warp's threads on neighbouring rows of a tile
// padded to HD + 4 floats a row (16 bytes), whose 16-byte chunks at one
// head-dim index then fall in distinct banks; a value many threads of a
// warp read is one broadcast.
#pragma once

#include "common.cuh"
#include "mma.cuh"  // cp.async

namespace f32t {

// 16-byte chunk c of one f32 row into shared memory, or zeros where !ok
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, int c, bool ok) {
  tc::cp_async16(dst + c * 4, ok ? src + c * 4 : src, ok ? 16 : 0);
}

// The head dims of an accumulator a thread owns when GC threads share a
// row: N chunks of CW contiguous dims (16 bytes, or what HD / GC leaves).
template <int HD, int GC>
struct Chunks {
  static constexpr int DT = HD / GC;
  static constexpr int CW = DT < 4 ? DT : 4;
  static constexpr int N = DT / CW;
};

template <int CW>
__device__ __forceinline__ void load_chunk(float* v, const float* p) {
  if constexpr (CW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (CW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// p[0:CW] = v[0:CW] * s
template <int CW>
__device__ __forceinline__ void store_chunk(float* p, const float* v, float s) {
  if constexpr (CW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s);
  } else if constexpr (CW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0] * s, v[1] * s);
  } else {
    *p = v[0] * s;
  }
}

// c[i][j] += sum_{d < HD} A[r0 + GR * i][d] * B[c0 + GC * j][d]: A and B
// row-major tiles in shared memory with rows of LD floats, read 16 bytes at
// a time; over d in order, so the sum's order is fixed.
template <int HD, int TR, int TC, int GR, int GC, int LD>
__device__ __forceinline__ void abt(float (&c)[TR][TC], const float* A, const float* B, int r0,
                                    int c0) {
  const float* a_row = A + r0 * LD;
  const float* b_row = B + c0 * LD;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[TR], b[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_row + i * GR * LD + d);
#pragma unroll
    for (int j = 0; j < TC; ++j)
      b[j] = *reinterpret_cast<const float4*>(b_row + j * GC * LD + d);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
}

// acc[i][dims] += sum_{n < N} P[r0 + GR * i][n] * B[n][dims], where this
// thread's dims are chunks c0 + GC * c (c < NCH) of CW dims: P row-major
// with rows of LDP floats (read 4 columns at a time), B row-major with rows
// of LD floats; over n in order.
template <int N, int TR, int GR, int GC, int CW, int NCH, int LDP, int LD>
__device__ __forceinline__ void pb(float (&acc)[TR][CW * NCH], const float* P, const float* B,
                                   int r0, int c0) {
  const float* p_row = P + r0 * LDP;
  const float* b_col = B + CW * c0;
#pragma unroll 2
  for (int n = 0; n < N; n += 4) {
    float p[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(p_row + i * GR * LDP + n);
      p[i][0] = t.x; p[i][1] = t.y; p[i][2] = t.z; p[i][3] = t.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float bv[CW];
        load_chunk<CW>(bv, b_col + (n + e) * LD + CW * GC * c);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int w = 0; w < CW; ++w)
            acc[i][c * CW + w] = fmaf(p[i][e], bv[w], acc[i][c * CW + w]);
      }
  }
}

}  // namespace f32t
