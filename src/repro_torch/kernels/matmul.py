"""Block matrix product: the Hopper kernels (``csrc/matmul.cu``) and their
plain PyTorch version.

Counterpart of ``repro.kernels.matmul.matmul_pallas`` (the kernel) and
``repro.kernels.ref.matmul_ref`` (the oracle).  The kernels are split-K: the
contraction is cut into slices so that output tiles x slices fill the card,
each slice writes a partial tile to a workspace allocated here, and a second
pass sums the slices in a fixed order — no float atomics, so results are
bitwise reproducible.  Operands are passed by strides: a transposed view
(``X.mT``) is read in place.  By dtype and output width: f64 with N > 8 on
the FP64 tensor cores, f32 with N > 8 on register-blocked IEEE FMA, f64 and
f32 with N <= 8 on a kernel that streams A; bf16 on the first tile kernel.
f64 with N > 8 fills its ring by TMA where both operands allow it
(``tma_loads``); the other kernels copy 16 bytes at a time by cp.async
(``vector_loads``); any of them copies element by element where an operand
is not aligned for that (``choose_loader`` decides, ``loaders`` counts).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from . import build

#: block tiles (BM, BN, BK) by (config, dtype); config 0 is N > 8, 1 is
#: N <= 8.  Keep in step with csrc/matmul.cu.  For N <= 8 in f64 and f32, BM
#: is 32 rows where A's unit stride is along k (eight warps of four rows)
#: and 32 x (16 bytes / element) where it is along m (a warp's 16-byte reads).
#: f64 with N > 8 takes one of F64_TILES by shape (``f64_tile``).
_WIDE = {torch.float32: (128, 128, 16), torch.bfloat16: (64, 64, 16)}
_SKINNY_BF16 = (128, 8, 32)
#: an H100's SMs.  Split-K aims for at most one wave of thread blocks (SMS x
#: the blocks of the tile an SM holds), so that the split grid runs with no
#: straggling block.  A constant (not the queried SM count) keeps the
#: summation order, and so the result bits, the same on every card.
SMS = 132
#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


class F64Tile(NamedTuple):
    bm: int
    bn: int
    bk: int
    stages: int  # depth of the ring of (A, B) tiles in shared memory
    per_sm: int  # blocks an SM holds at once


#: dmma_kernel's block tiles (csrc/matmul.cu's DTileNarrow and DTileWide):
#: 128 x 64 over four warps, 128 x 128 over eight
F64_TILES = {"128x64": F64Tile(128, 64, 32, 2, 2), "128x128": F64Tile(128, 128, 32, 3, 1)}
#: launches by the loader they took since the last ``reset_loaders``
loaders: Dict[str, int] = {"vector": 0, "scalar": 0, "tma": 0}
#: the loader codes of csrc/matmul.cu
LOADER_CODES = {"scalar": 0, "vector": 1, "tma": 2}
#: f64 wide launches by the block tile they took since the last ``reset_loaders``
tiles: Dict[str, int] = {name: 0 for name in F64_TILES}


class Plan(NamedTuple):
    config: int   # 0: N > 8, 1: N <= 8
    bm: int
    bn: int
    bk: int
    k_chunk: int  # K per split, a multiple of bk
    splits: int
    wave: int     # blocks of the tile the card runs at once: the split's limit


def f64_tile(M: int, N: int, kfast: bool) -> str:
    """The f64 block tile of an (M, K) @ (K, N) product with N > 8: 128 x 128
    where A is read along m (a transposed view, as in Newton's X^T (w * X))
    and both output sides exceed 64, else 128 x 64.  Measured on an H100
    (PERF.md): each is the faster on its side, and 128 x 64 leaves less of a
    narrow output's tile empty."""
    return "128x128" if not kfast and M > 64 and N > 64 else "128x64"


def tile(dtype: torch.dtype, M: int, N: int, kfast: bool) -> Tuple[int, int, int, int]:
    """(config, BM, BN, BK) of the kernel that takes an (M, K) @ (K, N) product
    of ``dtype`` whose A has its unit stride along k (``kfast``) or along m."""
    if N > 8:
        if dtype == torch.float64:
            return (0, *F64_TILES[f64_tile(M, N, kfast)][:3])
        return (0, *_WIDE[dtype])
    if dtype == torch.bfloat16:
        return (1, *_SKINNY_BF16)
    return (1, 32 if kfast else 32 * (16 // dtype.itemsize), 8, 32)


def reset_loaders() -> None:
    for counts in (loaders, tiles):
        for name in counts:
            counts[name] = 0


_fn = None


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f64 for f64 inputs, f32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: accumulate in f32 (f64 for f64), output in a's dtype."""
    acc = acc_dtype(a.dtype)
    return (a.to(acc) @ b.to(acc)).to(a.dtype)


def split_plan(M: int, N: int, K: int, dtype: torch.dtype = torch.float64,
               kfast: bool = True) -> Plan:
    """The tile and the split of K for an (M, K) @ (K, N) product."""
    config, bm, bn, bk = tile(dtype, M, N, kfast)
    wave = SMS * (F64_TILES[f"{bm}x{bn}"].per_sm if dtype == torch.float64 and config == 0
                  else 2)
    n_tiles = math.ceil(M / bm) * math.ceil(N / bn)
    k_steps = math.ceil(K / bk)
    splits = min(max(1, wave // n_tiles), k_steps)  # one wave: no straggling block
    k_chunk = math.ceil(k_steps / splits) * bk
    return Plan(config, bm, bn, bk, k_chunk, math.ceil(K / k_chunk), wave)


def a_kfast(a: torch.Tensor) -> bool:
    """Whether the kernel reads A (M, K) along k (its unit stride is k's)."""
    return a.stride(1) == 1


def vector_loads(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the f32/f64 kernels may copy 16 bytes at a time (f64 with
    N > 8: whether TMA may, see ``tma_loads``): each operand they stage (A,
    and B for N > 8) has a unit stride along the axis they read fastest, a
    16-byte aligned base and a leading stride of whole 16 bytes.  bf16
    (element by element) never does."""
    if a.dtype == torch.bfloat16:
        return False

    def aligned(t, fast):
        other = 1 - fast
        return (t.stride(fast) == 1 and t.data_ptr() % 16 == 0
                and (t.shape[other] == 1 or t.stride(other) % (16 // t.element_size()) == 0))

    return aligned(a, 1 if a_kfast(a) else 0) and (
        b.shape[1] <= 8 or aligned(b, 1 if b.stride(1) == 1 else 0))


def tma_loads(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether an f64 product with N > 8 fills dmma_kernel's ring by TMA:
    both operands pass ``vector_loads`` (a 16-byte aligned base, a unit
    stride along the axis read fastest, a leading stride of whole 16 bytes)
    and their rows do not coincide (a leading stride of 0, a broadcast: left
    to the element loader)."""
    def rows_apart(t, fast):
        return t.shape[1 - fast] == 1 or t.stride(1 - fast) > 0

    return (a.dtype == torch.float64 and b.shape[1] > 8 and vector_loads(a, b)
            and rows_apart(a, 1 if a_kfast(a) else 0)
            and rows_apart(b, 1 if b.stride(1) == 1 else 0))


def choose_loader(a: torch.Tensor, b: torch.Tensor) -> str:
    """How the kernel fills shared memory for ``a @ b``: "tma" (f64 with
    N > 8), "vector" (16-byte cp.async copies, the other kernels) or
    "scalar" (one copy an element, where the operands allow neither)."""
    if a.dtype == torch.float64 and b.shape[1] > 8:
        return "tma" if tma_loads(a, b) else "scalar"
    return "vector" if vector_loads(a, b) else "scalar"


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("matmul").repro_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int64] * 8 + [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors the wrapper (``ops.matmul``) has
    checked; allocates the output and the split-K workspace."""
    M, K = a.shape
    N = b.shape[1]
    plan = split_plan(M, N, K, a.dtype, a_kfast(a))
    how = choose_loader(a, b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    part = (torch.empty((plan.splits, M, N), dtype=acc_dtype(a.dtype), device=a.device)
            if plan.splits > 1 else None)
    with torch.cuda.device(a.device):
        err = _kernel()(
            DTYPE_CODES[a.dtype], plan.config, plan.bm, plan.bn, LOADER_CODES[how],
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None,
            M, N, K, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            plan.k_chunk, plan.splits, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    loaders[how] += 1
    if a.dtype == torch.float64 and plan.config == 0:
        tiles[f"{plan.bm}x{plan.bn}"] += 1
    return out
