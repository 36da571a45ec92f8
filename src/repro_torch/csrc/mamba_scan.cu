// Selective scan (the Mamba-1 recurrence) for Hopper (sm_90a):
//   h_t = dA_t * h_{t-1} + dBx_t,   y_t[d] = sum_n h_t[d, n] * C_t[n],
// with dA, dBx (B, S, DI, N), C (B, S, N) and y (B, S, DI), all f32.  It
// also writes the final carry h_S (B, DI, N), which the model keeps as its
// SSM state for decoding, and, when given a buffer (B, ceil(S / 16), DI, N),
// the state h_{t0-1} before every 16th step t0: the checkpoints the
// backward (mamba_scan_bwd.cu) recomputes each chunk of 16 steps from, so
// training need not run the recurrence a second time.  They are the values
// of the same fmaf chain, so the backward gives the same bits with them as
// without.
//
// Replaces: src/repro/kernels/mamba_scan.py::mamba_scan_pallas (body
// _scan_kernel).  The TPU kernel keeps the carry in its scratch h_ref and
// never writes it; this kernel writes it as a second output (the same
// recurrence, so the model need not recompute h).
//
// What bounds it on this card: bytes.  Every step reads dA_t and dBx_t once
// (2 * B * S * DI * N * 4 bytes in all) for two FMAs per element; y and C
// are N times smaller.
//
// What the design does about it: the channels and state lanes are
// independent and only time is sequential (the TPU kernel's fori_loop over
// chunks with a (bd, N) carry).  Here every state element (b, d, n) is one
// thread, its h lives in a register, and the thread walks t inside the
// kernel.  For fixed (b, t) the (DI, N) slab is contiguous, so the
// neighbouring threads' loads of each step are coalesced; the loop is
// unrolled so that several steps' loads are in flight at once.  The N lanes
// of a channel are neighbouring lanes of one warp, and the sum over n is a
// butterfly of __shfl_xor_sync.  C_t is staged through shared memory, a chunk
// of steps at a time.  A ragged S needs no padding: the loop stops at S.
#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads per block
constexpr int CSTEPS = 64;  // steps of C staged in shared memory at once
constexpr int UNROLL = 8;   // steps whose loads are issued together
constexpr int CKPT = 16;    // steps per checkpoint; keep in step with mamba_scan_bwd.cu
static_assert(CSTEPS % CKPT == 0 && CKPT % UNROLL == 0, "checkpoints at unrolled steps");

template <int N>
__global__ void __launch_bounds__(NT) mamba_scan_kernel(
    const float* __restrict__ dA, const float* __restrict__ dBx,
    const float* __restrict__ C, float* __restrict__ y, float* __restrict__ h_out,
    float* __restrict__ ckpt, int S, int DI) {
  __shared__ float Cs[CSTEPS * N];
  const int b = blockIdx.y;
  const int e = blockIdx.x * NT + threadIdx.x;  // element (d, n) of the (DI, N) slab
  const int n = threadIdx.x % N;
  const int d = e / N;
  const bool ok = d < DI;  // whole groups of N lanes are in or out
  const int64_t slab = static_cast<int64_t>(DI) * N;
  const float* pa = dA + static_cast<int64_t>(b) * S * slab + e;
  const float* pb = dBx + static_cast<int64_t>(b) * S * slab + e;
  const float* pc = C + static_cast<int64_t>(b) * S * N;
  float* py = y + static_cast<int64_t>(b) * S * DI + d;
  float* ck = ckpt == nullptr ? nullptr
                              : ckpt + static_cast<int64_t>(b) * ((S + CKPT - 1) / CKPT) * slab + e;

  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += CSTEPS) {
    const int steps = min(CSTEPS, S - t0);
    __syncthreads();  // the previous chunk of C is consumed
    for (int i = threadIdx.x; i < steps * N; i += NT) Cs[i] = pc[static_cast<int64_t>(t0) * N + i];
    __syncthreads();
    for (int t = 0; t < steps; t += UNROLL) {
      if (ck != nullptr && ok && (t0 + t) % CKPT == 0) ck[(t0 + t) / CKPT * slab] = h;
      float a[UNROLL], bx[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t off = static_cast<int64_t>(t0 + t + u) * slab;
        const bool live = ok && t + u < steps;
        a[u] = live ? pa[off] : 1.0f;
        bx[u] = live ? pb[off] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (t + u < steps) {  // uniform across the block
          h = fmaf(a[u], h, bx[u]);
          float p = h * Cs[(t + u) * N + n];
#pragma unroll
          for (int w = N / 2; w > 0; w /= 2) p += __shfl_xor_sync(0xffffffffu, p, w);
          if (ok && n == 0) py[static_cast<int64_t>(t0 + t + u) * DI] = p;
        }
      }
    }
  }
  if (ok) h_out[static_cast<int64_t>(b) * slab + e] = h;
}

template <int N>
int launch(const float* dA, const float* dBx, const float* C, float* y, float* h,
           float* ckpt, int B, int S, int DI, cudaStream_t stream) {
  const int64_t elems = static_cast<int64_t>(DI) * N;
  const dim3 grid(static_cast<unsigned>((elems + NT - 1) / NT), B);
  mamba_scan_kernel<N><<<grid, NT, 0, stream>>>(dA, dBx, C, y, h, ckpt, S, DI);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ckpt: null, or (B, ceil(S / 16), DI, N) f32 for the checkpoints
extern "C" int repro_mamba_scan(const void* dA, const void* dBx, const void* C, void* y,
                                void* h, void* ckpt, int B, int S, int DI, int N,
                                void* stream) {
  const float* a = static_cast<const float*>(dA);
  const float* bx = static_cast<const float*>(dBx);
  const float* c = static_cast<const float*>(C);
  float* yy = static_cast<float*>(y);
  float* hh = static_cast<float*>(h);
  float* ck = static_cast<float*>(ckpt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(a, bx, c, yy, hh, ck, B, S, DI, s);
    case 2: return launch<2>(a, bx, c, yy, hh, ck, B, S, DI, s);
    case 4: return launch<4>(a, bx, c, yy, hh, ck, B, S, DI, s);
    case 8: return launch<8>(a, bx, c, yy, hh, ck, B, S, DI, s);
    case 16: return launch<16>(a, bx, c, yy, hh, ck, B, S, DI, s);
    case 32: return launch<32>(a, bx, c, yy, hh, ck, B, S, DI, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
