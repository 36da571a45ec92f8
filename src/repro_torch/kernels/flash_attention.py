"""Flash attention forward: the Hopper kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas`` (the
kernel) and ``repro.kernels.ref.flash_attention_ref`` (the oracle).  Layout
q (B, H, Sq, hd), k/v (B, KV, Skv, hd); query head h reads kv head
h // (H / KV).  Key j is visible to query i iff j < Skv and, when causal,
j <= i + q_offset and, with a window, j > i + q_offset - window.  A query
that sees no key gets 0 (the Pallas kernel's safe denominator).  The
softmax runs in f32; the output has q's dtype.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build

#: dtype codes of csrc/common.cuh that the kernel takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: threads per block; keep in step with csrc/flash_attention.cu
THREADS = 128

_fn = None


def visible(q_len: int, kv_len: int, causal: bool, window: Optional[int],
            q_offset: int, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask of the keys each query sees."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Plain version: the same online-softmax arithmetic in one pass, in f32."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rep = H // KV
    qg = q.reshape(B, KV, rep, Sq, hd).float()
    s = torch.einsum("bkrqd,bksd->bkrqs", qg, k.float()) / math.sqrt(hd)
    mask = visible(Sq, Skv, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == -math.inf, 0.0, m)  # a row that sees no key
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrqs,bksd->bkrqd", p, v.float())
    out = out / torch.where(denom == 0.0, 1.0, denom)
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def block_rows(rep: int, Sq: int) -> Tuple[int, int]:
    """(rows, bq): rows per block — the rep query heads of one kv head at bq
    positions — a power of two of at most THREADS."""
    rows = min(THREADS, 1 << max(0, rep * Sq - 1).bit_length())
    return rows, rows // rep


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").repro_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int64] * 12 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int],
                         q_offset: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors the wrapper (``ops.flash_attention``)
    has checked.  The output is a (B, H, Sq, hd) view of a buffer laid out
    (B, Sq, H, hd), the layout the model consumes next."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rep = H // KV
    rows, _ = block_rows(rep, Sq)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        err = _kernel()(
            DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            B, KV, Sq, Skv, rep, rows, int(causal), window or 0, q_offset,
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return out
