// Tensor-core and asynchronous-copy building blocks shared by the bf16
// attention kernels (flash_attention.cu, flash_attention_bwd.cu): 16-byte
// cp.async copies into shared memory, ldmatrix fragment loads, and
// mma.sync m16n8k16 bf16 x bf16 -> f32 with the two products of
// FlashAttention-2 built on it (S = A B^T over the head dim, and acc += P B
// with P taken straight from the accumulators of the last product).
//
// Tiles in shared memory are bf16 rows of HD values padded to LDS = HD + 8
// (16 bytes), so the eight rows an ldmatrix reads fall in distinct banks.
#pragma once

#include "common.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared, asynchronously, or a zero where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte chunk c of one row of bf16 into shared memory, or zeros where !ok
__device__ __forceinline__ void copy_row_chunk(bf16* dst, const bf16* src, int c, bool ok) {
  cp_async16(dst + c * 8, ok ? src + c * 8 : src, ok ? 16 : 0);
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand (16 x 16) of the next product from the accumulators of
// n-tiles 2j and 2j + 1 (16 x 8 each) of the last one.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The A fragment (16 rows x 16 of the head dim, k-step kk) of the 16 rows
// at As, row-major [row][LDS] in shared memory.
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* As, int kk, int lane) {
  ldsm_x4(a, As + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8);
}

// S += A B^T for one k-step kk of the head dim: A given as its fragment,
// B the NT8 * 8 rows at Bs, row-major [row][LDS] in shared memory.
template <int LDS, int NT8>
__device__ __forceinline__ void qk_step(float (&s)[NT8][4], const uint32_t (&a)[4],
                                        const bf16* Bs, int kk, int lane) {
#pragma unroll
  for (int n2 = 0; n2 < NT8 / 2; ++n2) {
    uint32_t b[4];
    ldsm_x4(b, Bs + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16 +
                   ((lane >> 3) & 1) * 8);
    mma(s[2 * n2], a, b[0], b[1]);
    mma(s[2 * n2 + 1], a, b[2], b[3]);
  }
}

// S += A (16 rows of As) B^T (NT8 * 8 rows of Bs), over the head dim HD:
// A and B both row-major [row][LDS] in shared memory
template <int HD, int LDS, int NT8>
__device__ __forceinline__ void qk_product(float (&s)[NT8][4], const bf16* As, const bf16* Bs,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    load_a<LDS>(a, As, kk, lane);
    qk_step<LDS, NT8>(s, a, Bs, kk, lane);
  }
}

// acc (16 x HD) += P (16 x 16 * KT16, in accumulator fragments) Bs (rows of
// the contraction, [row][LDS] in shared memory, read by ldmatrix.trans)
template <int HD, int LDS, int KT16>
__device__ __forceinline__ void pv_product(float (&acc)[HD / 8][4],
                                           const float (&p)[2 * KT16][4], const bf16* Bs,
                                           int lane) {
#pragma unroll
  for (int kq = 0; kq < KT16; ++kq) {
    uint32_t a[4];
    acc_to_a(a, p[2 * kq], p[2 * kq + 1]);
#pragma unroll
    for (int d2 = 0; d2 < HD / 16; ++d2) {
      uint32_t b[4];
      ldsm_x4_t(b, Bs + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + d2 * 16 +
                       (lane >> 4) * 8);
      mma(acc[2 * d2], a, b[0], b[1]);
      mma(acc[2 * d2 + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace tc
