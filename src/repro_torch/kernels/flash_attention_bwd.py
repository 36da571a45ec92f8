"""Flash attention backward: the Hopper kernels (``csrc/flash_attention_bwd.cu``),
their plain PyTorch version, and the autograd Function that joins the
forward and backward kernels.

Counterpart of ``repro.kernels.flash_attention_bwd``: the Pallas kernels
``_dkv_kernel`` and ``_dq_kernel`` (through ``_vjp_bwd``) and the custom_vjp
``flash_attention_vjp``.  Given q (B, H, Sq, hd), k, v (B, KV, Skv, hd), the
forward's output o and log-sum-exp lse (B, H, Sq) and the output gradient
do, the backward recomputes P = exp(s - lse) (scores s scaled by 1/sqrt(hd)
and masked as in the forward) and returns

    dv = P^T do,  dp = do v^T,  ds = P * (dp - delta) / sqrt(hd),
    dk = ds^T q (summed over the rep query heads of a kv head),  dq = ds k,

with delta = rowsum(do * o), each in its input's dtype.  A row that sees
no key (lse = -inf) contributes nothing.  Unlike the reference, the forward
kernel writes lse itself; ``_fwd_with_lse`` recomputes it with a dense
(B, KV, rep, Sq, Skv) einsum.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build
from .flash_attention import DTYPE_CODES, visible

#: threads per block; keep in step with csrc/flash_attention_bwd.cu
THREADS = 128

_fn = None


def dq_rows(hd: int) -> int:
    """Rows of a dq block (rep query heads x positions): one thread per
    32-wide slice of the head dim, THREADS threads."""
    return THREADS // max(1, hd // 32)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True, window: Optional[int] = None,
                            q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the same recompute formulas over the whole score
    matrix, in f32."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rep = H // KV
    scale = 1.0 / math.sqrt(hd)

    def grouped(t):
        return t.reshape(B, KV, rep, Sq, hd).float()

    qg, dog, og = grouped(q), grouped(do), grouped(o)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkrqd,bksd->bkrqs", qg, kf) * scale
    mask = visible(Sq, Skv, causal, window, q_offset, q.device)
    lse_g = lse.reshape(B, KV, rep, Sq, 1).float()
    p = torch.exp(torch.where(mask, s - lse_g, -math.inf))
    delta = (dog * og).sum(-1, keepdim=True)
    dv = torch.einsum("bkrqs,bkrqd->bksd", p, dog)
    dp = torch.einsum("bkrqd,bksd->bkrqs", dog, vf)
    ds = p * (dp - delta) * scale
    dk = torch.einsum("bkrqs,bkrqd->bksd", ds, qg)
    dq = torch.einsum("bkrqs,bksd->bkrqd", ds, kf)
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention_bwd").repro_flash_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int64] * 24 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _like_model(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, X, S, hd) tensor laid out (B, S, X, hd): the layout of the
    model's activations, so the gradient reaches them without a copy."""
    B, X, S, hd = t.shape
    return torch.empty((B, S, X, hd), dtype=t.dtype, device=t.device).transpose(1, 2)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool, window: Optional[int],
                             q_offset: int):
    """Launch the kernels on CUDA tensors the wrapper
    (``ops.flash_attention_bwd``) has checked; allocates dq, dk, dv and the
    (B, H, Sq) f32 delta scratch."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    dq, dk, dv = _like_model(q), _like_model(k), _like_model(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel()(
            DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *_strides(q), *_strides(k), *_strides(v),
            *_strides(o), *_strides(do), *_strides(dq), *_strides(dk), *_strides(dv),
            B, KV, Sq, Skv, H // KV, int(causal), window or 0, q_offset,
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the flash kernels both ways (counterpart of
    ``flash_attention_vjp``): the forward saves (q, k, v, o, lse), the
    backward calls ``ops.flash_attention_bwd``.  Both route by device, so on
    CPU tensors they run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        from . import ops

        out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        from . import ops

        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                             window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None
