"""Run the f32 attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) on the CPU, through their own wrappers,
against their plain versions: a check of the kernels' index arithmetic,
masks, splits and reductions where there is no card and no ``nvcc``.

    python scripts/cpu_emulate_kernels.py            # ~4 min on a few cores
    python scripts/cpu_emulate_kernels.py --quick    # the first three cases

Each source is compiled with the host's g++ (C++20) against small stand-in
CUDA headers written under ``build/cpu_emulation/``: a kernel launch runs
its blocks one after another, each block as one ``std::thread`` per CUDA
thread; ``__syncthreads`` and ``__syncwarp`` are ``std::barrier``s of the
block and of its warp, ``__shfl_xor_sync`` an exchange through memory
between two warp barriers; ``cp.async`` copies at once (a stricter order
than the card's, so a missing wait goes unseen); dynamic shared memory is
filled with garbage before each block.  The bf16 kernels compile against
empty tensor-core stubs and are not run.  Timing means nothing here.
"""
import argparse
import contextlib
import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "cpu_emulation"

RUNTIME_H = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <barrier>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
namespace emu {
inline thread_local uint3 tidx;
inline uint3 bidx;
inline dim3 gdim, bdim;
inline std::barrier<>* block_bar = nullptr;
inline std::vector<std::barrier<>*> warp_bar;
inline float shfl_buf[1024];
alignas(16) inline unsigned char dyn_smem[232448];
inline cudaError_t err = 0;
inline void launch(dim3 g, dim3 b, size_t smem, std::function<void()> body) {
  if (smem > sizeof(dyn_smem) || b.x > 1024) { err = 1; return; }
  gdim = g; bdim = b;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        bidx = {x, y, z};
        memset(dyn_smem, 0xff, smem);
        std::barrier<> bar(b.x);
        block_bar = &bar;
        std::vector<std::barrier<>*> wb;
        for (unsigned w = 0; w < (b.x + 31) / 32; ++w) wb.push_back(new std::barrier<>(32));
        warp_bar = wb;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < b.x; ++t) ts.emplace_back([t, &body] { tidx = {t, 0, 0}; body(); });
        for (auto& th : ts) th.join();
        for (auto* p : wb) delete p;
      }
}
}  // namespace emu
#define threadIdx emu::tidx
#define blockIdx emu::bidx
#define gridDim emu::gdim
#define blockDim emu::bdim
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m, int = 32) {
  const unsigned t = threadIdx.x;
  emu::shfl_buf[t] = v;
  __syncwarp();
  const float r = emu::shfl_buf[(t & ~31u) | ((t & 31u) ^ m)];
  __syncwarp();
  return r;
}
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { cudaError_t e = emu::err; emu::err = 0; return e; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int64_t min(int64_t a, int64_t b) { return a < b ? a : b; }
inline int64_t max(int64_t a, int64_t b) { return a > b ? a : b; }
"""

BF16_H = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16) { return 0; }
inline __nv_bfloat16 __float2bfloat16_rn(float) { return {}; }
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { return {}; }
"""

FP16_H = r"""
#pragma once
struct __half { unsigned short x; };
inline float __half2float(__half) { return 0; }
"""

MMA_CUH = r"""
#pragma once
#include "common.cuh"
namespace tc {
using bf16 = __nv_bfloat16;
inline void cp_async16(void* dst, const void* src, int n) { if (n) memcpy(dst, src, 16); else memset(dst, 0, 16); }
inline void cp_async4(float* dst, const float* src, bool ok) { *dst = ok ? *src : 0.0f; }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline void copy_row_chunk(bf16*, const bf16*, int, bool) {}
template <int LDS> inline void load_a(uint32_t (&)[4], const bf16*, int, int) {}
template <int LDS, int NT8> inline void qk_step(float (&)[NT8][4], const uint32_t (&)[4], const bf16*, int, int) {}
template <int HD, int LDS, int NT8> inline void qk_product(float (&)[NT8][4], const bf16*, const bf16*, int) {}
template <int HD, int LDS, int KT16> inline void pv_product(float (&)[HD / 8][4], const float (&)[2 * KT16][4], const bf16*, int) {}
}  // namespace tc
"""


def build(name: str) -> ctypes.CDLL:
    """g++ build of csrc/<name>.cu against the stand-in headers."""
    OUT.mkdir(parents=True, exist_ok=True)
    for fname, text in (("cuda_runtime.h", RUNTIME_H), ("cuda_bf16.h", BF16_H),
                        ("cuda_fp16.h", FP16_H), ("mma.cuh", MMA_CUH)):
        (OUT / fname).write_text(text)
    for header in ("common.cuh", "f32_tiles.cuh"):
        (OUT / header).write_text((CSRC / header).read_text())
    src = (CSRC / f"{name}.cu").read_text()
    src = re.sub(r"extern __shared__ __align__\(16\) (float|unsigned char) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::dyn_smem);", src)
    src = re.sub(r"([\w:]+(?:<[^<>]*>)?)\s*<<<(.*?)>>>\((.*?)\);",
                 lambda m: (f"emu::launch({m.group(2).rsplit(',', 1)[0]}, "
                            f"[&] {{ {m.group(1)}({m.group(3)}); }});"), src, flags=re.S)
    (OUT / f"{name}.cpp").write_text(src)
    lib = OUT / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
                    "-I", str(OUT), "-o", str(lib), str(OUT / f"{name}.cpp")], check=True)
    return ctypes.CDLL(str(lib))


def rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


CASES = [  # B, H, KV, Sq, Skv, hd, causal, window, q_offset, per-row offsets, strided
    (2, 8, 2, 64, 64, 32, True, None, 0, None, False),
    (1, 25, 5, 70, 90, 64, True, 30, 0, None, False),
    (1, 66, 2, 20, 40, 256, True, 16, 7, None, False),      # rep 33 at hd 256
    (2, 4, 2, 32, 128, 128, True, None, 96, None, False),
    (1, 4, 2, 128, 128, 16, True, 32, 0, None, False),
    (2, 25, 5, 1, 333, 64, True, 100, 300, None, False),    # decode: split-KV
    (1, 2, 1, 1, 300, 256, True, None, 299, None, False),
    (2, 6, 3, 40, 40, 32, False, None, 0, None, False),     # no mask
    (1, 4, 2, 45, 70, 128, False, None, 0, None, False),
    (1, 64, 1, 9, 40, 128, True, None, 20, None, False),    # rep 64
    (4, 8, 8, 300, 300, 16, True, None, 0, None, False),    # a grid the dK/dV split skips
    (3, 10, 5, 5, 200, 64, True, 60, 0, (0, 100, 190), False),
    (2, 10, 2, 33, 50, 64, True, None, 10, None, True),     # (B, S, H, hd) views
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fb = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
    # the wrappers' own launches, on the emulated libraries, with the CUDA
    # device and stream calls made no-ops
    fwd = build("flash_attention").repro_flash_attention
    bwd = build("flash_attention_bwd").repro_flash_attention_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 12
                    + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 24
                    + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fa._fn, fb._fn = fwd, bwd

    class Stream:
        cuda_stream = 0

    torch.cuda.device = lambda d: contextlib.nullcontext()
    torch.cuda.current_stream = lambda d=None: Stream()
    ok = True
    for case in CASES[:3] if args.quick else CASES:
        B, H, KV, Sq, Skv, hd, causal, window, off, per_row, strided = case
        g = torch.Generator().manual_seed(0)

        def u(*shape):
            return torch.rand(shape, generator=g) * 2 - 1

        if strided:
            q, k, v = (u(B, S, X, hd).transpose(1, 2) for S, X in ((Sq, H), (Skv, KV), (Skv, KV)))
        else:
            q, k, v = u(B, H, Sq, hd), u(B, KV, Skv, hd), u(B, KV, Skv, hd)
        offsets = None if per_row is None else torch.tensor(per_row, dtype=torch.int32)
        host_off = off if per_row is None else max(per_row)
        o, lse = fa.flash_attention_cuda(q, k, v, causal, window, host_off, True, offsets)
        want, want_lse = fa.flash_attention_ref(q, k, v, causal, window,
                                                off if offsets is None else offsets, True)
        seen = torch.isfinite(want_lse)
        errs = [rel(o, want)]
        good = torch.equal(seen, torch.isfinite(lse)) and errs[0] <= 2e-5
        if seen.any():
            good &= (lse - want_lse)[seen].abs().max().item() <= \
                1e-5 * want_lse[seen].abs().max().item()
        if per_row is None:
            do = u(B, H, Sq, hd)
            got = fb.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window, off)
            errs += [rel(a, b) for a, b in zip(got, fb.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal, window, off))]
            good &= max(errs) <= 2e-5
        ok &= good
        print(("ok  " if good else "FAIL"), case, " ".join(f"{e:.1e}" for e in errs), flush=True)
    print("all cases match" if ok else "some cases differ")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
