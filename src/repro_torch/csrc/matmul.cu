// Split-K tiled matrix product C = A @ B for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (body _matmul_kernel),
// the Pallas kernel behind every 2-D block product of the reference's pallas
// backend.  Same function: f32, bf16 (f32 accumulation) and f64 (f64
// accumulation), output in the input dtype.  f32 uses IEEE fmaf, never TF32.
//
// What bounds it on this card.  The Newton loop's block products have a huge
// contraction (K = 131072 rows of one X block) and very few output tiles:
// X^T (w*X) is a 256x256 output, X^T (mu-y) is 256x1.  The TPU ran its grid
// in order on one core and carried the sum across K steps in VMEM; here a
// one-block-per-output-tile kernel would occupy 16 (or 2) of 132 SMs.  At
// that shape the work is bound by operations (f64: 17 GFLOP per block
// product), while X @ beta (K = 256, N = 1) is bound by the bytes of X.
//
// What the design does about it.
//  * Split-K: blockIdx.z walks a slice of K, so tiles x slices fill the card.
//    Each slice writes its partial tile to a workspace the wrapper allocates;
//    a second kernel sums the slices in a fixed order (slice 0, 1, 2, ...).
//    There are no float atomics, so the same inputs give the same bits on
//    every run (the runtime's pipelined==sync and plan-cache on==off
//    contracts rely on that).
//  * Operands are read through their strides: a transposed block (X^T) is
//    never materialised.  The tile loader walks the operand's unit-stride
//    axis fastest so global reads stay coalesced either way.
//  * Ragged edges are masked in the loader and the store; there is no
//    padding copy.
//  * Two tile shapes: 64x64 for wide outputs, 128x8 for outputs of at most 8
//    columns (matrix-vector products), which wastes less work on the empty
//    columns of a skinny output.
// This is the simple shared-memory version; wgmma/TMA pipelining is later
// work.
#include "common.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_tile_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, typename AccOf<T>::type* __restrict__ part,
                   int64_t M, int64_t N, int64_t K,
                   int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
                   int64_t k_chunk) {
  using Acc = typename AccOf<T>::type;
  constexpr int RY = BM / TM;  // thread rows
  constexpr int RX = BN / TN;  // thread columns
  constexpr int NT = RX * RY;
  __shared__ Acc As[BK][BM + 1];
  __shared__ Acc Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % RX;
  const int ty = tid / RX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * k_chunk;
  const int64_t k_end = (k_begin + k_chunk < K) ? k_begin + k_chunk : K;
  const bool a_k_fast = (sak == 1);
  const bool b_n_fast = (sbn == 1);

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      int mm, kk;
      if (a_k_fast) { kk = e % BK; mm = e / BK; } else { mm = e % BM; kk = e / BM; }
      const int64_t gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < k_end) ? to_acc(A[gm * sam + gk * sak]) : Acc(0);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      int kk, nn;
      if (b_n_fast) { nn = e % BN; kk = e / BN; } else { kk = e % BK; nn = e / BK; }
      const int64_t gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < k_end && gn < N) ? to_acc(B[gk * sbk + gn * sbn]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * RY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * RX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_acc(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  Acc* slice = part ? part + static_cast<int64_t>(blockIdx.z) * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty + i * RY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx + j * RX;
      if (gn >= N) continue;
      if (slice) slice[gm * N + gn] = acc[i][j];
      else store_to(&C[gm * N + gn], acc[i][j]);
    }
  }
}

// Sum the split-K partials in slice order: deterministic, no atomics.
template <typename T>
__global__ void splitk_reduce_kernel(const typename AccOf<T>::type* __restrict__ part,
                                     T* __restrict__ C, int64_t MN, int splits) {
  using Acc = typename AccOf<T>::type;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < MN;
       i += stride) {
    Acc s = part[i];
    for (int z = 1; z < splits; ++z) s += part[static_cast<int64_t>(z) * MN + i];
    store_to(&C[i], s);
  }
}

// tile shapes; keep in step with _CONFIGS in repro_torch/kernels/matmul.py
constexpr int WIDE_BM = 64, WIDE_BN = 64, WIDE_BK = 16, WIDE_TM = 4, WIDE_TN = 4;
constexpr int SKINNY_BM = 128, SKINNY_BN = 8, SKINNY_BK = 32, SKINNY_TM = 4, SKINNY_TN = 2;

template <typename T>
int launch(int config, const void* A, const void* B, void* C, void* part, int64_t M,
           int64_t N, int64_t K, int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
           int64_t k_chunk, int splits, cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  T* c = static_cast<T*>(C);
  Acc* p = splits > 1 ? static_cast<Acc*>(part) : nullptr;
  if (config == 0) {
    dim3 grid((M + WIDE_BM - 1) / WIDE_BM, (N + WIDE_BN - 1) / WIDE_BN, splits);
    matmul_tile_kernel<T, WIDE_BM, WIDE_BN, WIDE_BK, WIDE_TM, WIDE_TN>
        <<<grid, (WIDE_BM / WIDE_TM) * (WIDE_BN / WIDE_TN), 0, stream>>>(
            a, b, c, p, M, N, K, sam, sak, sbk, sbn, k_chunk);
  } else {
    dim3 grid((M + SKINNY_BM - 1) / SKINNY_BM, (N + SKINNY_BN - 1) / SKINNY_BN, splits);
    matmul_tile_kernel<T, SKINNY_BM, SKINNY_BN, SKINNY_BK, SKINNY_TM, SKINNY_TN>
        <<<grid, (SKINNY_BM / SKINNY_TM) * (SKINNY_BN / SKINNY_TN), 0, stream>>>(
            a, b, c, p, M, N, K, sam, sak, sbk, sbn, k_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t MN = M * N;
  const int threads = 256;
  const int64_t want = (MN + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  splitk_reduce_kernel<T><<<blocks, threads, 0, stream>>>(p, c, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_matmul(int dtype, int config, const void* A, const void* B, void* C,
                            void* part, int64_t M, int64_t N, int64_t K, int64_t sam,
                            int64_t sak, int64_t sbk, int64_t sbn, int64_t k_chunk,
                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(config, A, B, C, part, M, N, K, sam, sak, sbk, sbn, k_chunk, splits, s);
    case REPRO_F64:
      return launch<double>(config, A, B, C, part, M, N, K, sam, sak, sbk, sbn, k_chunk, splits, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(config, A, B, C, part, M, N, K, sam, sak, sbk, sbn, k_chunk,
                                   splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
