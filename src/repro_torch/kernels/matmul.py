"""Block matrix product: the Hopper kernel (``csrc/matmul.cu``) and its plain
PyTorch version.

Counterpart of ``repro.kernels.matmul.matmul_pallas`` (the kernel) and
``repro.kernels.ref.matmul_ref`` (the oracle).  The kernel is split-K: the
contraction is cut into slices so that output tiles x slices fill the card,
each slice writes a partial tile to a workspace allocated here, and a second
pass sums the slices in a fixed order — no float atomics, so results are
bitwise reproducible.  Operands are passed by strides: a transposed view
(``X.T``) is read in place.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import build

#: tile shapes (BM, BN, BK) per config; keep in step with csrc/matmul.cu
_CONFIGS = {
    0: (64, 64, 16),    # wide outputs
    1: (128, 8, 32),    # outputs of at most 8 columns (matrix-vector)
}
#: split-K aims for this many thread blocks: two per SM of an H100's 132.
#: A constant (not the queried SM count) keeps the summation order, and so
#: the result bits, the same on every card.
TARGET_BLOCKS = 264
#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_fn = None


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f64 for f64 inputs, f32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: accumulate in f32 (f64 for f64), output in a's dtype."""
    acc = acc_dtype(a.dtype)
    return (a.to(acc) @ b.to(acc)).to(a.dtype)


def split_plan(M: int, N: int, K: int) -> Tuple[int, int, int]:
    """(config, k_chunk, splits) for an (M, K) @ (K, N) product."""
    config = 1 if N <= 8 else 0
    bm, bn, bk = _CONFIGS[config]
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    k_steps = math.ceil(K / bk)
    splits = min(max(1, math.ceil(TARGET_BLOCKS / tiles)), k_steps)
    k_chunk = math.ceil(k_steps / splits) * bk
    return config, k_chunk, math.ceil(K / k_chunk)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("matmul").repro_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int64] * 8 + [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors the wrapper (``ops.matmul``) has
    checked; allocates the output and the split-K workspace."""
    M, K = a.shape
    N = b.shape[1]
    config, k_chunk, splits = split_plan(M, N, K)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    part = (torch.empty((splits, M, N), dtype=acc_dtype(a.dtype), device=a.device)
            if splits > 1 else None)
    with torch.cuda.device(a.device):
        err = _kernel()(
            DTYPE_CODES[a.dtype], config, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), part.data_ptr() if part is not None else None,
            M, N, K, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            k_chunk, splits, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    return out
