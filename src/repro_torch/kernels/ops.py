"""Public wrappers of the port's kernels (counterpart of ``repro.kernels.ops``).

Each wrapper checks its inputs, then routes by the device the tensors lie
on: a CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor
launches the hand-written kernel (or the wrapper raises).  There is no
fallback from one to the other.  ``launches`` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels.

Attention and the scan are differentiable: when an input requires grad
(and grad mode is on), their wrappers return through the autograd Functions
``FlashAttention`` and ``MambaScan``, whose backward calls
``flash_attention_bwd`` and ``mamba_scan_bwd`` here, so the backward routes
by device too (the hand-written backward kernels on the card, their plain
versions on the CPU).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .flash_attention import DTYPE_CODES as _FLASH_DTYPES
from .flash_attention import HEAD_DIMS, THREADS, flash_attention_cuda, flash_attention_ref
from .flash_attention_bwd import (FlashAttention, dq_rows, flash_attention_bwd_cuda,
                                  flash_attention_bwd_ref)
from .glm_fused import DTYPE_CODES as _GLM_DTYPES
from .glm_fused import glm_fused_cuda, glm_fused_ref
from .matmul import DTYPE_CODES as _MATMUL_DTYPES
from .mamba_scan import (STATE_DIMS, MambaScan, mamba_scan_bwd_cuda, mamba_scan_bwd_ref,
                         mamba_scan_cuda, mamba_scan_ref)
from .matmul import _CONFIGS, matmul_cuda, matmul_ref, split_plan

#: kernel launches per wrapper since the last ``reset_launches``
launches: Dict[str, int] = {"matmul": 0, "glm_fused": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "mamba_scan": 0,
                            "mamba_scan_bwd": 0}

_GRID_LIMIT = 65535  # CUDA's limit on gridDim.y and gridDim.z


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _device_kind(name: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = a @ b for 2-D ``a`` (M, K) and ``b`` (K, N) of one dtype (f32,
    bf16 or f64); accumulates in f32 (f64 for f64), returns a's dtype.
    Transposed operands are passed as views (``x.mT``) and read in place."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"matmul: 2-D operands required, got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _MATMUL_DTYPES:
        raise TypeError(f"matmul: dtypes {a.dtype}/{b.dtype}; need one of "
                        f"{sorted(map(str, _MATMUL_DTYPES))} on both")
    if _device_kind("matmul", a, b) == "cpu":
        return matmul_ref(a, b)
    M, K = a.shape
    N = b.shape[1]
    if 0 in (M, N, K):
        raise ValueError(f"matmul: empty operand {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if 1 not in t.stride() and 1 not in t.shape:
            raise ValueError(f"matmul: operand {name} has strides {t.stride()}; "
                             "the kernel needs a unit stride on one axis")
    config, _, splits = split_plan(M, N, K)
    if -(-N // _CONFIGS[config][1]) > _GRID_LIMIT or splits > _GRID_LIMIT:
        raise ValueError(f"matmul: ({M}, {K}) @ ({K}, {N}) exceeds the "
                         "kernel's launch grid")
    launches["matmul"] += 1
    return matmul_cuda(a, b)


def glm_fused(z: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mu, c, w) = (sigmoid(z), mu - y, mu(1 - mu)) in f32 for (n, d) z and
    y of one float dtype."""
    if z.ndim != 2 or z.shape != y.shape:
        raise ValueError(f"glm_fused: z and y must be (n, d) of one shape, got "
                         f"{tuple(z.shape)} and {tuple(y.shape)}")
    if z.dtype != y.dtype or z.dtype not in _GLM_DTYPES:
        raise TypeError(f"glm_fused: dtypes {z.dtype}/{y.dtype}; need one of "
                        f"{sorted(map(str, _GLM_DTYPES))} on both")
    if _device_kind("glm_fused", z, y) == "cpu":
        return glm_fused_ref(z, y)
    if not (z.is_contiguous() and y.is_contiguous()):
        raise ValueError("glm_fused: the kernel needs contiguous z and y")
    if z.numel() == 0:
        raise ValueError("glm_fused: empty input")
    launches["glm_fused"] += 1
    return glm_fused_cuda(z, y)


def _check_attention(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: Optional[int], q_offset: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: need q (B, H, Sq, hd) and k, v "
                         f"(B, KV, Skv, hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree (batch, head dim, or H not a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; need "
                        f"one of {sorted(map(str, _FLASH_DTYPES))} on all three")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"{name}: window must be None or an int >= 1, got {window!r}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"{name}: q_offset must be an int >= 0, got {q_offset!r}")


def _check_attention_launch(name: str, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take beyond the plain versions."""
    q, k = tensors[0], tensors[1]
    B, H, Sq, _ = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if 0 in (B, Sq, Skv):
        raise ValueError(f"{name}: empty input")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError(f"{name}: the kernel needs a contiguous head dim")
    if Sq >= 2**31 or Skv >= 2**31:
        raise ValueError(f"{name}: positions beyond the kernel's range")
    if KV > _GRID_LIMIT or B > _GRID_LIMIT:
        raise ValueError(f"{name}: B={B}, KV={KV} exceed the launch grid")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, return_lse: bool = False):
    """Grouped-query attention of q (B, H, Sq, hd) over k, v (B, KV, Skv, hd)
    with a 1/sqrt(hd) scale: causal from absolute query position
    ``q_offset``, and with a sliding ``window`` (key j visible to query
    position p iff j > p - window) when one is given.  f32 or bf16; the
    output has q's dtype.  Operands may be strided views whose head dim is
    contiguous.  ``return_lse`` also returns each row's log-sum-exp (B, H,
    Sq) f32.  Differentiable (``FlashAttention``) when an input requires
    grad."""
    _check_attention("flash_attention", q, k, v, window, q_offset)
    if _wants_grad(q, k, v):
        if return_lse:
            raise ValueError("flash_attention: return_lse is for the forward of "
                             "FlashAttention; lse is not differentiable")
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    if _device_kind("flash_attention", q, k, v) == "cpu":
        return flash_attention_ref(q, k, v, causal, window, q_offset, return_lse)
    _check_attention_launch("flash_attention", q, k, v)
    if q.shape[1] // k.shape[1] > THREADS or q.shape[2] + q_offset >= 2**31:
        raise ValueError(f"flash_attention: {q.shape[1] // k.shape[1]} query heads per "
                         "kv head or positions beyond the kernel's range")
    launches["flash_attention"] += 1
    return flash_attention_cuda(q, k, v, causal, window, q_offset, return_lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, ...)`` from its output
    ``o``, its log-sum-exp ``lse`` (B, H, Sq) f32 and the output gradient
    ``do``; each in its input's dtype.  o and do have q's shape and dtype."""
    _check_attention("flash_attention_bwd", q, k, v, window, q_offset)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if tuple(lse.shape) != tuple(q.shape[:3]) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be (B, H, Sq) f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if _device_kind("flash_attention_bwd", q, k, v, o, lse, do) == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window, q_offset)
    _check_attention_launch("flash_attention_bwd", q, k, v, o, do)
    rep, hd = q.shape[1] // k.shape[1], q.shape[3]
    if rep > dq_rows(hd) or q.shape[2] + q_offset >= 2**31:
        raise ValueError(f"flash_attention_bwd: {rep} query heads per kv head (at most "
                         f"{dq_rows(hd)} at head dim {hd}) or positions beyond the "
                         "kernel's range")
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: the kernel needs a contiguous lse")
    launches["flash_attention_bwd"] += 1
    return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window, q_offset)


def _check_scan(name: str, dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor) -> None:
    if dA.ndim != 4 or dBx.shape != dA.shape:
        raise ValueError(f"{name}: dA and dBx must be (B, S, DI, N) of one shape, "
                         f"got {tuple(dA.shape)} and {tuple(dBx.shape)}")
    B, S, DI, N = dA.shape
    if tuple(C.shape) != (B, S, N):
        raise ValueError(f"{name}: C must be (B, S, N) = {(B, S, N)}, "
                         f"got {tuple(C.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"{name}: state width {N} not in {STATE_DIMS}")
    if any(t.dtype != torch.float32 for t in (dA, dBx, C)):
        raise TypeError(f"{name}: need f32 inputs, got {dA.dtype}/{dBx.dtype}/"
                        f"{C.dtype}")


def _check_scan_launch(name: str, *tensors: torch.Tensor) -> None:
    B, S, DI, N = tensors[0].shape
    if 0 in (B, S, DI):
        raise ValueError(f"{name}: empty input")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel needs contiguous inputs")
    if B > _GRID_LIMIT or S >= 2**31 or DI * N >= 2**31:
        raise ValueError(f"{name}: {(B, S, DI, N)} exceeds the kernel's range")


def mamba_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_S) of the recurrence h_t = dA_t * h_{t-1} + dBx_t from h_0 = 0,
    y_t = sum_n h_t[:, n] * C_t[n], for f32 dA, dBx (B, S, DI, N) and C
    (B, S, N): y is (B, S, DI) and the final carry h_S is (B, DI, N).
    Differentiable (``MambaScan``) when an input requires grad."""
    _check_scan("mamba_scan", dA, dBx, C)
    if _wants_grad(dA, dBx, C):
        return MambaScan.apply(dA, dBx, C)
    if _device_kind("mamba_scan", dA, dBx, C) == "cpu":
        return mamba_scan_ref(dA, dBx, C)
    _check_scan_launch("mamba_scan", dA, dBx, C)
    launches["mamba_scan"] += 1
    return mamba_scan_cuda(dA, dBx, C)


def mamba_scan_bwd(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                   dy: torch.Tensor, dh: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d(dA), d(dBx), dC) of ``mamba_scan(dA, dBx, C)`` from the gradient of
    y, dy (B, S, DI) f32, and optionally of the final carry, dh (B, DI, N)
    f32, which seeds the reverse recurrence."""
    _check_scan("mamba_scan_bwd", dA, dBx, C)
    B, S, DI, N = dA.shape
    if tuple(dy.shape) != (B, S, DI) or dy.dtype != torch.float32:
        raise ValueError(f"mamba_scan_bwd: dy must be (B, S, DI) = {(B, S, DI)} f32, "
                         f"got {tuple(dy.shape)} {dy.dtype}")
    if dh is not None and (tuple(dh.shape) != (B, DI, N) or dh.dtype != torch.float32):
        raise ValueError(f"mamba_scan_bwd: dh must be (B, DI, N) = {(B, DI, N)} f32, "
                         f"got {tuple(dh.shape)} {dh.dtype}")
    given = (dA, dBx, C, dy) + (() if dh is None else (dh,))
    if _device_kind("mamba_scan_bwd", *given) == "cpu":
        return mamba_scan_bwd_ref(dA, dBx, C, dy, dh)
    _check_scan_launch("mamba_scan_bwd", *given)
    launches["mamba_scan_bwd"] += 1
    return mamba_scan_bwd_cuda(dA, dBx, C, dy, dh)
