// Selective scan backward for Hopper (sm_90a): the vector-Jacobian product of
// mamba_scan.cu's recurrence
//     h_t = dA_t * h_{t-1} + dBx_t,   y_t[d] = sum_n h_t[d, n] * C_t[n]
// (h_{-1} = 0, final carry h_S = h_{S-1}).  Given dy (B, S, DI) and an
// optional seed dh_S (B, DI, N), the gradient g_t = dL/dh_t runs backward,
//     g_t = dy_t[d] * C_t[n] + dA_{t+1} * g_{t+1},   g_{S-1} = dy C + dh_S,
// and the kernel writes
//     d(dBx)_t = g_t,   d(dA)_t = g_t * h_{t-1}   (both (B, S, DI, N) f32),
//     dC_t[n] = sum_d h_t[d, n] * dy_t[d]          ((B, S, N) f32).
//
// Replaces: nothing on the TPU.  The reference differentiates its SSM with
// jax autodiff through jax.lax.associative_scan (src/repro/models/ssm.py);
// no Pallas kernel does this work.  It is the gradient of
// src/repro/kernels/mamba_scan.py::mamba_scan_pallas, which the port's
// forward kernel replaces, and training needs it: autograd cannot see into
// the forward kernel.
//
// What bounds it on this card: bytes.  Per element and step it must read dA
// and dBx and write d(dA) and d(dBx) (4 * B * S * DI * N * 4 bytes); dy, C
// and dC are N or DI times smaller.
//
// What the design does about it, on the forward kernel's layout (one thread
// per state element (b, d, n), time walked inside the kernel, coalesced
// loads of each step's (DI, N) slab):
// - h_{t-1} is needed in reverse order.  It is never recovered by dividing
//   by dA (dA = exp(dt * A) underflows to 0).  It is recomputed from
//   checkpoints, h_{t0-1} at every K-th step t0, (B, ceil(S/K), DI, N), 1/K
//   of the state's bytes.  Training takes them from the forward kernel
//   (mamba_scan.cu writes them when autograd will need them), so phase 1
//   is skipped; called without them, phase 1 runs the recurrence forward
//   and stores them into a workspace, the same fmaf chain, so both routes
//   give the same bits.  Phase 2 walks the chunks of K steps backward,
//   recomputes each chunk's h from its checkpoint into registers (with the
//   chunk's dA kept for the g recurrence), then runs g backward through it:
//   one read of dA and dBx and one write of d(dA) and d(dBx), the bound's 4
//   passes of the state's bytes (6 with phase 1).
// - The reverse loop reads dy_t and C_t at every step; they are staged for
//   the chunk in shared memory first, so no step waits on device memory.
// - dC is a sum over DI.  Each block adds its channels' terms by warp
//   shuffles and then across its warps in shared memory, in a fixed order,
//   and writes one partial sum per (block, b, t, n) to a workspace; a second
//   kernel adds the partial sums in block order.  No atomics: two runs give
//   the same bits.
#include "common.cuh"

namespace {

constexpr int NT = 256;    // threads per block
constexpr int WARPS = NT / 32;
constexpr int K = 16;      // steps per checkpoint chunk (kept in registers); see mamba_scan.cu

template <int N>
__global__ void __launch_bounds__(NT) scan_bwd_kernel(
    const float* __restrict__ dA, const float* __restrict__ dBx,
    const float* __restrict__ C, const float* __restrict__ dy,
    const float* __restrict__ dh, float* __restrict__ ckpt, int ckpt_ready,
    float* __restrict__ d_dA, float* __restrict__ d_dBx, float* __restrict__ dC_part, int S,
    int DI) {
  __shared__ float red[K][WARPS][N];
  __shared__ float dys[K][NT / N];  // a chunk's dy_t of this block's NT / N channels
  __shared__ float cs[K][N];        // and its C_t
  const int b = blockIdx.y, B = gridDim.y;
  const int e = blockIdx.x * NT + threadIdx.x;  // element (d, n) of the (DI, N) slab
  const int n = threadIdx.x % N;
  const int d = e / N;
  const bool ok = d < DI;  // whole groups of N lanes are in or out
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t slab = static_cast<int64_t>(DI) * N;
  const int64_t base = static_cast<int64_t>(b) * S * slab + e;
  const int chunks = (S + K - 1) / K;
  float* ck = ckpt + static_cast<int64_t>(b) * chunks * slab + e;

  // phase 1 (no checkpoints given): the recurrence forward, h_{t0-1}
  // stored at every chunk start t0
  float h = 0.0f;
  for (int c = 0; c < (ckpt_ready ? 0 : chunks); ++c) {
    if (ok) ck[c * slab] = h;
    const int steps = min(K, S - c * K);
    float a[K], bx[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const bool live = ok && u < steps;
      const int64_t off = base + static_cast<int64_t>(c * K + u) * slab;
      a[u] = live ? dA[off] : 1.0f;
      bx[u] = live ? dBx[off] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < K; ++u) h = fmaf(a[u], h, bx[u]);
  }

  // phase 2: chunks backward; within a chunk, h recomputed, then g backward
  float g = (ok && dh != nullptr) ? dh[static_cast<int64_t>(b) * slab + e] : 0.0f;
  float a_next = 1.0f;  // dA_{t+1}; the seed dh_S enters g_{S-1} with weight 1
  const int d0 = blockIdx.x * (NT / N);  // this block's first channel
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * K;
    const int steps = min(K, S - t0);
    // the chunk's dy and C into shared memory first: the reverse loop below
    // then waits on no load from device memory at any step
    for (int i = threadIdx.x; i < K * (NT / N); i += NT) {
      const int u = i / (NT / N), dd = i % (NT / N);
      dys[u][dd] = u < steps && d0 + dd < DI
                       ? dy[(static_cast<int64_t>(b) * S + t0 + u) * DI + d0 + dd] : 0.0f;
    }
    for (int i = threadIdx.x; i < K * N; i += NT) {
      const int u = i / N;
      cs[u][i % N] = u < steps ? C[(static_cast<int64_t>(b) * S + t0 + u) * N + i % N] : 0.0f;
    }
    __syncthreads();  // dys and cs are filled; red is no longer read
    const float h_start = ok ? ck[c * slab] : 0.0f;  // h_{t0-1}
    float a[K], hh[K];  // dA_t and h_t of the chunk's steps
    float hc = h_start;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const bool live = ok && u < steps;
      const int64_t off = base + static_cast<int64_t>(t0 + u) * slab;
      a[u] = live ? dA[off] : 1.0f;
      hc = fmaf(a[u], hc, live ? dBx[off] : 0.0f);
      hh[u] = hc;
    }
#pragma unroll
    for (int u = K - 1; u >= 0; --u) {
      if (u < steps) {  // uniform across the block
        const int t = t0 + u;
        const float dyv = dys[u][threadIdx.x / N];  // 0 outside DI
        g = fmaf(a_next, g, dyv * cs[u][n]);
        if (ok) {
          const int64_t off = base + static_cast<int64_t>(t) * slab;
          d_dBx[off] = g;
          d_dA[off] = g * (u > 0 ? hh[u - 1] : h_start);
        }
        float p = hh[u] * dyv;
#pragma unroll
        for (int w = 16; w >= N; w /= 2) p += __shfl_xor_sync(0xffffffffu, p, w);
        if (lane < N) red[u][warp][lane] = p;
        a_next = a[u];
      }
    }
    __syncthreads();  // red is filled; dys and cs are no longer read
    // this block's partial dC of the chunk, warps added in order
    for (int i = threadIdx.x; i < steps * N; i += NT) {
      const int u = i / N, nn = i % N;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[u][w][nn];
      dC_part[((static_cast<int64_t>(blockIdx.x) * B + b) * S + t0 + u) * N + nn] = s;
    }
  }
}

// dC[i] = sum over blocks of dC_part[blk][i], i over (B, S, N), in block order
__global__ void __launch_bounds__(NT) dc_sum_kernel(const float* __restrict__ part,
                                                    float* __restrict__ dC, int64_t count,
                                                    int blocks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += part[k * count + i];
  dC[i] = s;
}

template <int N>
int launch(const float* dA, const float* dBx, const float* C, const float* dy,
           const float* dh, float* ckpt, int ckpt_ready, float* d_dA, float* d_dBx,
           float* dC_part, float* dC, int B, int S, int DI, cudaStream_t stream) {
  const int64_t elems = static_cast<int64_t>(DI) * N;
  const int blocks = static_cast<int>((elems + NT - 1) / NT);
  scan_bwd_kernel<N><<<dim3(blocks, B), NT, 0, stream>>>(dA, dBx, C, dy, dh, ckpt, ckpt_ready,
                                                          d_dA, d_dBx, dC_part, S, DI);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t count = static_cast<int64_t>(B) * S * N;
  dc_sum_kernel<<<static_cast<unsigned>((count + NT - 1) / NT), NT, 0, stream>>>(
      dC_part, dC, count, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Workspace size, in floats: partial sums of dC, ceil(DI * N / NT) * B * S * N.
extern "C" int64_t repro_mamba_scan_bwd_part_floats(int B, int S, int DI, int N) {
  return ((static_cast<int64_t>(DI) * N + NT - 1) / NT) * B * S * N;
}

// ckpt: (B, ceil(S / K), DI, N) f32, the forward's checkpoints when
// ckpt_ready is 1, else a workspace phase 1 fills.
extern "C" int repro_mamba_scan_bwd(const void* dA, const void* dBx, const void* C,
                                    const void* dy, const void* dh, void* ckpt, int ckpt_ready,
                                    void* d_dA, void* d_dBx, void* dC_part, void* dC, int B,
                                    int S, int DI, int N, void* stream) {
  const float* a = static_cast<const float*>(dA);
  const float* bx = static_cast<const float*>(dBx);
  const float* c = static_cast<const float*>(C);
  const float* gy = static_cast<const float*>(dy);
  const float* gh = static_cast<const float*>(dh);
  float* ck = static_cast<float*>(ckpt);
  float* ga = static_cast<float*>(d_dA);
  float* gb = static_cast<float*>(d_dBx);
  float* part = static_cast<float*>(dC_part);
  float* gc = static_cast<float*>(dC);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(a, bx, c, gy, gh, ck, ckpt_ready, ga, gb, part, gc, B, S, DI, s);
    case 2: return launch<2>(a, bx, c, gy, gh, ck, ckpt_ready, ga, gb, part, gc, B, S, DI, s);
    case 4: return launch<4>(a, bx, c, gy, gh, ck, ckpt_ready, ga, gb, part, gc, B, S, DI, s);
    case 8: return launch<8>(a, bx, c, gy, gh, ck, ckpt_ready, ga, gb, part, gc, B, S, DI, s);
    case 16: return launch<16>(a, bx, c, gy, gh, ck, ckpt_ready, ga, gb, part, gc, B, S, DI, s);
    case 32: return launch<32>(a, bx, c, gy, gh, ck, ckpt_ready, ga, gb, part, gc, B, S, DI, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
