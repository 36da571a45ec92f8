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

The Mamba decode step (``mamba_conv_step``, then the caller's ``x_proj``
product, then ``mamba_state_step``) updates the serving cache in place on
both routes and returns the cache tensors it was given; so does the Mamba-2
decode step (``mamba_conv_step`` over x, B and C, then
``mamba2_state_step``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from .flash_attention import DTYPE_CODES as _FLASH_DTYPES
from .flash_attention import (HEAD_DIMS, MAX_REP, Offset, flash_attention_cuda,
                              flash_attention_ref)
from .flash_attention_bwd import FlashAttention
from .flash_attention_bwd import check_launch as check_bwd_launch
from .flash_attention_bwd import flash_attention_bwd_cuda, flash_attention_bwd_ref
from .glm_fused import DTYPE_CODES as _GLM_DTYPES
from .glm_fused import glm_fused_cuda, glm_fused_ref
from .matmul import DTYPE_CODES as _MATMUL_DTYPES
from .mamba_scan import (STATE_DIMS, MambaScan, checkpoint_shape, mamba_scan_bwd_cuda,
                         mamba_scan_bwd_ref, mamba_scan_cuda, mamba_scan_ref)
from .mamba_step import CONV_WIDTH, MAX_DT_RANK
from .mamba_step import DTYPE_CODES as _STEP_DTYPES
from .mamba_step import conv_step_cuda, conv_step_ref, state_step_cuda, state_step_ref
from .mamba2_step import DTYPE_CODES as _STEP2_DTYPES
from .mamba2_step import SHAPES as _STEP2_SHAPES
from .mamba2_step import groups_of
from .mamba2_step import state_step_cuda as state_step2_cuda
from .mamba2_step import state_step_ref as state_step2_ref
from .matmul import a_kfast, matmul_cuda, matmul_ref, reset_loaders, split_plan

#: kernel launches per wrapper since the last ``reset_launches``
launches: Dict[str, int] = {"matmul": 0, "glm_fused": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "mamba_scan": 0,
                            "mamba_scan_bwd": 0, "mamba_step": 0, "mamba2_step": 0}

_GRID_LIMIT = 65535  # CUDA's limit on gridDim.y and gridDim.z


def reset_launches() -> None:
    """Set every launch count to 0, and matmul's counts by loader."""
    for name in launches:
        launches[name] = 0
    reset_loaders()


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _device_kind(name: str, *tensors: torch.Tensor) -> str:
    """"cuda" (launch the kernel) or "cpu" (its plain version) for inputs on
    one device.  A ``meta`` tensor (shapes only: a dry run) takes the plain
    version too: it holds no data, so nothing is computed and no kernel
    result is stood in for.  A DTensor raises: a kernel runs on a rank's
    local shard, inside ``local_map`` (``models.partitioning.local_call``),
    and is never handed a whole sharded tensor (the autograd Functions'
    forwards come here too)."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; a kernel runs on local shards "
                        "(call it through models.partitioning.local_call)")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "meta":
        return "cpu"
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
    plan = split_plan(M, N, K, a.dtype, a_kfast(a))
    if -(-N // plan.bn) > _GRID_LIMIT or plan.splits > _GRID_LIMIT:
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
                     window: Optional[int], q_offset: Offset) -> None:
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
    if isinstance(q_offset, torch.Tensor):
        if (q_offset.dtype != torch.int32 or tuple(q_offset.shape) != (B,)
                or q_offset.device != q.device):
            raise ValueError(f"{name}: per-row q_offset must be a ({B},) int32 tensor on "
                             f"{q.device}, got {tuple(q_offset.shape)} {q_offset.dtype} "
                             f"on {q_offset.device}")
    elif not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"{name}: q_offset must be an int >= 0 or a (B,) int32 tensor, "
                         f"got {q_offset!r}")


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
                    q_offset: Offset = 0, max_offset: Optional[int] = None,
                    return_lse: bool = False, scale: Optional[float] = None):
    """Grouped-query attention of q (B, H, Sq, hd) over k, v (B, KV, Skv, hd)
    with a 1/sqrt(hd) scale: causal from absolute query position
    ``q_offset``, and with a sliding ``window`` (key j visible to query
    position p iff j > p - window) when one is given.  ``q_offset`` is an
    int >= 0 for the whole batch or a (B,) int32 tensor on q's device, one
    offset >= 0 per batch row (continuous batching); with a tensor on the
    card, ``max_offset`` must give the largest of them as a host int (the
    launch is planned from it, and the device tensor is never read on the
    host).  f32 or bf16; the
    output has q's dtype.  Operands may be strided views whose head dim is
    contiguous.  ``return_lse`` also returns each row's log-sum-exp (B, H,
    Sq) f32.  Differentiable (``FlashAttention``) when an input requires
    grad.  On the card one call counts one launch, though a call whose grid
    is too small to fill the card (every decode step) runs two device
    kernels: partials over ``kv_splits`` key ranges, then their merge.
    ``scale``, where given, multiplies the scores in place of 1/sqrt(hd)
    (not under autograd: the backward takes 1/sqrt(hd))."""
    _check_attention("flash_attention", q, k, v, window, q_offset)
    per_row = isinstance(q_offset, torch.Tensor)
    if _wants_grad(q, k, v):
        if scale is not None:
            raise NotImplementedError("flash_attention: a softmax scale other than "
                                      "1/sqrt(hd) is for serving; the backward takes 1/sqrt(hd)")
        if per_row:
            raise NotImplementedError(
                "flash_attention: per-row query offsets are for serving (ROADMAP Queue 1 "
                "item 6.1, serve/batcher.py); FlashAttention's backward takes one offset")
        if return_lse:
            raise ValueError("flash_attention: return_lse is for the forward of "
                             "FlashAttention; lse is not differentiable")
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    if _device_kind("flash_attention", q, k, v) == "cpu":
        return flash_attention_ref(q, k, v, causal, window, q_offset, return_lse, scale)
    _check_attention_launch("flash_attention", q, k, v)
    host_offset = q_offset
    if per_row:
        if not isinstance(max_offset, int) or max_offset < 0:
            raise ValueError("flash_attention: a per-row q_offset on the card needs "
                             f"max_offset, the largest offset as an int >= 0, got "
                             f"{max_offset!r}")
        host_offset = max_offset
    rep = q.shape[1] // k.shape[1]
    if rep > MAX_REP:
        raise ValueError(f"flash_attention: {rep} query heads per kv head; the kernels take "
                         f"at most {MAX_REP} at head dim {q.shape[3]}")
    if q.shape[1] > _GRID_LIMIT or q.shape[2] + host_offset >= 2**31 \
            or q.shape[2] * rep >= 2**31:
        raise ValueError(f"flash_attention: {q.shape[1]} query heads ({rep} per kv head) "
                         "or positions beyond the kernel's range")
    launches["flash_attention"] += 1
    return flash_attention_cuda(q, k, v, causal, window, host_offset, return_lse,
                                q_offset.contiguous() if per_row else None, scale)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, ...)`` from its output
    ``o``, its log-sum-exp ``lse`` (B, H, Sq) f32 and the output gradient
    ``do``; each in its input's dtype.  o and do have q's shape and dtype."""
    _check_attention("flash_attention_bwd", q, k, v, window, q_offset)
    if isinstance(q_offset, torch.Tensor):
        raise NotImplementedError(
            "flash_attention_bwd: per-row query offsets are for serving (ROADMAP Queue 1 "
            "item 6.1, serve/batcher.py); the backward takes one offset")
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
    check_bwd_launch(q, k)
    if q.shape[2] + q_offset >= 2**31:
        raise ValueError("flash_attention_bwd: positions beyond the kernel's range")
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


def mamba_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor, *,
               checkpoints: bool = False):
    """(y, h_S) of the recurrence h_t = dA_t * h_{t-1} + dBx_t from h_0 = 0,
    y_t = sum_n h_t[:, n] * C_t[n], for f32 dA, dBx (B, S, DI, N) and C
    (B, S, N): y is (B, S, DI) and the final carry h_S is (B, DI, N).
    ``checkpoints`` also returns the states the backward recomputes from,
    (B, ceil(S / 16), DI, N) f32 (``MambaScan``'s forward asks for them).
    Differentiable (``MambaScan``) when an input requires grad."""
    _check_scan("mamba_scan", dA, dBx, C)
    if _wants_grad(dA, dBx, C):
        if checkpoints:
            raise ValueError("mamba_scan: checkpoints are for the forward of MambaScan; "
                             "they are not differentiable")
        return MambaScan.apply(dA, dBx, C)
    if _device_kind("mamba_scan", dA, dBx, C) == "cpu":
        return mamba_scan_ref(dA, dBx, C, checkpoints)
    _check_scan_launch("mamba_scan", dA, dBx, C)
    launches["mamba_scan"] += 1
    return mamba_scan_cuda(dA, dBx, C, checkpoints)


def mamba_scan_bwd(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                   dy: torch.Tensor, dh: Optional[torch.Tensor] = None, *,
                   checkpoints: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d(dA), d(dBx), dC) of ``mamba_scan(dA, dBx, C)`` from the gradient of
    y, dy (B, S, DI) f32, and optionally of the final carry, dh (B, DI, N)
    f32, which seeds the reverse recurrence.  ``checkpoints``, the
    forward's, spare the backward a pass over dA and dBx; the result is
    the same bits with them as without."""
    _check_scan("mamba_scan_bwd", dA, dBx, C)
    B, S, DI, N = dA.shape
    if tuple(dy.shape) != (B, S, DI) or dy.dtype != torch.float32:
        raise ValueError(f"mamba_scan_bwd: dy must be (B, S, DI) = {(B, S, DI)} f32, "
                         f"got {tuple(dy.shape)} {dy.dtype}")
    if dh is not None and (tuple(dh.shape) != (B, DI, N) or dh.dtype != torch.float32):
        raise ValueError(f"mamba_scan_bwd: dh must be (B, DI, N) = {(B, DI, N)} f32, "
                         f"got {tuple(dh.shape)} {dh.dtype}")
    want = checkpoint_shape(B, S, DI, N)
    if checkpoints is not None and (tuple(checkpoints.shape) != want
                                    or checkpoints.dtype != torch.float32):
        raise ValueError(f"mamba_scan_bwd: checkpoints must be {want} f32, got "
                         f"{tuple(checkpoints.shape)} {checkpoints.dtype}")
    given = (dA, dBx, C, dy) + tuple(t for t in (dh, checkpoints) if t is not None)
    if _device_kind("mamba_scan_bwd", *given) == "cpu":
        return mamba_scan_bwd_ref(dA, dBx, C, dy, dh, checkpoints)
    _check_scan_launch("mamba_scan_bwd", *given)
    launches["mamba_scan_bwd"] += 1
    return mamba_scan_bwd_cuda(dA, dBx, C, dy, dh, checkpoints)


def _check_same_dtype(name: str, *tensors: torch.Tensor) -> None:
    dt = tensors[0].dtype
    if dt not in _STEP_DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name}: dtypes {[str(t.dtype) for t in tensors]}; need one of "
                        f"{sorted(map(str, _STEP_DTYPES))} on all")


def _check_step_launch(name: str, B: int, DI: int, contiguous, unit_stride) -> None:
    if 0 in (B, DI):
        raise ValueError(f"{name}: empty input")
    if not all(t.is_contiguous() for t in contiguous):
        raise ValueError(f"{name}: the kernel needs a contiguous cache row and parameters")
    if any(t.stride(-1) != 1 for t in unit_stride):
        raise ValueError(f"{name}: the kernel needs a unit stride on the channel dim")
    if B > _GRID_LIMIT or DI >= 2**31:
        raise ValueError(f"{name}: B={B}, DI={DI} exceed the kernel's range")


def mamba_conv_step(x: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor,
                    conv_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba decode step's causal conv: x (B, 1, DI), the x half of
    in_proj's output (a view; its channel dim contiguous), over the carried
    conv_state (B, d_conv - 1, DI), which shifts one position and takes x in
    place; conv_w (d_conv, DI), conv_b (DI,), all of one dtype (f32 or
    bf16).  Returns (silu(conv) (B, 1, DI), conv_state).  Its launch is
    counted with ``mamba_state_step``'s, as one ``mamba_step``."""
    if x.ndim != 3 or x.shape[1] != 1 or conv_state.ndim != 3:
        raise ValueError(f"mamba_conv_step: need x (B, 1, DI) and conv_state (B, d_conv - 1, "
                         f"DI), got {tuple(x.shape)} and {tuple(conv_state.shape)}")
    B, _, DI = x.shape
    K = conv_state.shape[1] + 1
    if (conv_state.shape[0] != B or conv_state.shape[2] != DI
            or tuple(conv_w.shape) != (K, DI) or tuple(conv_b.shape) != (DI,)):
        raise ValueError(f"mamba_conv_step: conv_state {tuple(conv_state.shape)}, conv_w "
                         f"{tuple(conv_w.shape)}, conv_b {tuple(conv_b.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if K != CONV_WIDTH:
        raise ValueError(f"mamba_conv_step: conv width {K}; the kernel takes {CONV_WIDTH}")
    _check_same_dtype("mamba_conv_step", x, conv_state, conv_w, conv_b)
    if _device_kind("mamba_conv_step", x, conv_state, conv_w, conv_b) == "cpu":
        return conv_step_ref(x, conv_state, conv_w, conv_b)
    _check_step_launch("mamba_conv_step", B, DI, (conv_state, conv_w, conv_b), (x,))
    return conv_step_cuda(x, conv_state, conv_w, conv_b)


def mamba_state_step(proj: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                     ssm_state: torch.Tensor, dt_proj: torch.Tensor, dt_bias: torch.Tensor,
                     A_log: torch.Tensor, D: torch.Tensor,
                     dt_norm: Optional[torch.Tensor] = None,
                     b_norm: Optional[torch.Tensor] = None,
                     c_norm: Optional[torch.Tensor] = None, *, eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rest of the Mamba decode step after ``x_proj``: proj (B, 1, R + 2N)
    is x_proj's output (dt_low | B | C), x (B, 1, DI) the conv's output, z
    (B, 1, DI) the gate half of in_proj's (a view; its channel dim
    contiguous); the carried ssm_state (B, DI, N) f32 is updated in place.
    dt_proj (R, DI), dt_bias and D (DI,), A_log (DI, N), and the RMSNorm
    scales dt_norm (R,), b_norm and c_norm (N,) where the model has them (all
    three or none), all in x's dtype (f32 or bf16).  Returns (y (B, 1, DI),
    ssm_state).  On the card one call counts one ``mamba_step``: this
    kernel and the conv kernel before it."""
    norms = (dt_norm, b_norm, c_norm)
    given = [t is not None for t in norms]
    if any(given) and not all(given):
        raise ValueError("mamba_state_step: give dt_norm, b_norm and c_norm together or none")
    if ssm_state.ndim != 3 or proj.ndim != 3 or proj.shape[1] != 1:
        raise ValueError(f"mamba_state_step: need ssm_state (B, DI, N) and proj (B, 1, R + 2N), "
                         f"got {tuple(ssm_state.shape)} and {tuple(proj.shape)}")
    B, DI, N = ssm_state.shape
    if N not in STATE_DIMS:
        raise ValueError(f"mamba_state_step: state width {N} not in {STATE_DIMS}")
    R = proj.shape[2] - 2 * N
    want = {"proj": (B, 1, R + 2 * N), "x": (B, 1, DI), "z": (B, 1, DI), "dt_proj": (R, DI),
            "dt_bias": (DI,), "A_log": (DI, N), "D": (DI,)}
    if all(given):
        want.update(dt_norm=(R,), b_norm=(N,), c_norm=(N,))
    got = dict(proj=proj, x=x, z=z, dt_proj=dt_proj, dt_bias=dt_bias, A_log=A_log, D=D,
               dt_norm=dt_norm, b_norm=b_norm, c_norm=c_norm)
    bad = {k: tuple(got[k].shape) for k, shape in want.items() if tuple(got[k].shape) != shape}
    if R < 1 or bad:
        raise ValueError(f"mamba_state_step: shapes {bad} do not fit ssm_state "
                         f"{tuple(ssm_state.shape)} and dt_rank {R}; need {want}")
    if ssm_state.dtype != torch.float32:
        raise TypeError(f"mamba_state_step: the SSM state must be f32, got {ssm_state.dtype}")
    params = [t for t in (dt_proj, dt_bias, A_log, D) + norms if t is not None]
    _check_same_dtype("mamba_state_step", x, proj, z, *params)
    if _device_kind("mamba_state_step", proj, x, z, ssm_state, *params) == "cpu":
        return state_step_ref(proj, x, z, ssm_state, dt_proj, dt_bias, A_log, D, *norms,
                              eps=eps)
    if R > MAX_DT_RANK:
        raise ValueError(f"mamba_state_step: dt_rank {R} > {MAX_DT_RANK}, the most the "
                         "kernel's shared memory holds")
    _check_step_launch("mamba_state_step", B, DI, [x, ssm_state, *params], (proj, z))
    launches["mamba_step"] += 1
    return state_step_cuda(proj, x, z, ssm_state, dt_proj, dt_bias, A_log, D, norms, eps)


def mamba2_state_step(xbc: torch.Tensor, dt: torch.Tensor, z: torch.Tensor,
                      ssm_state: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                      D: torch.Tensor, norm: torch.Tensor, *, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 decode step after its conv: xbc (B, 1, H*P + 2*G*N) the
    conv's output (x | B | C), dt (B, 1, H) and z (B, 1, H*P) the raw dt and
    gate of in_proj's output (views; their channel dims contiguous); the
    carried ssm_state (B, H, P, N) f32 is updated in place.  dt_bias, A_log
    and D (H,), norm (H*P,), the gated RMSNorm's scale, all in xbc's dtype
    (f32 or bf16).  Returns (y (B, 1, H*P), the normed output, and
    ssm_state).  On the card one call counts one ``mamba2_step``: the state
    kernel and the norm kernel after it."""
    if ssm_state.ndim != 4 or xbc.ndim != 3 or xbc.shape[1] != 1:
        raise ValueError(f"mamba2_state_step: need ssm_state (B, H, P, N) and xbc (B, 1, "
                         f"H*P + 2*G*N), got {tuple(ssm_state.shape)} and {tuple(xbc.shape)}")
    B, H, P, N = ssm_state.shape
    G = groups_of(xbc.shape[2], H, P, N)
    want = {"dt": (B, 1, H), "z": (B, 1, H * P), "dt_bias": (H,), "A_log": (H,), "D": (H,),
            "norm": (H * P,)}
    got = dict(dt=dt, z=z, dt_bias=dt_bias, A_log=A_log, D=D, norm=norm)
    bad = {k: tuple(got[k].shape) for k, shape in want.items() if tuple(got[k].shape) != shape}
    if xbc.shape[0] != B or G == 0 or H % G or bad:
        raise ValueError(f"mamba2_state_step: xbc {tuple(xbc.shape)} and {bad} do not fit "
                         f"ssm_state {tuple(ssm_state.shape)}; need {want} and G dividing H")
    if ssm_state.dtype != torch.float32:
        raise TypeError(f"mamba2_state_step: the SSM state must be f32, got {ssm_state.dtype}")
    dtype = xbc.dtype
    params = (dt_bias, A_log, D, norm)
    if dtype not in _STEP2_DTYPES or any(t.dtype != dtype for t in (dt, z) + params):
        raise TypeError(f"mamba2_state_step: dtypes {[str(t.dtype) for t in (xbc, dt, z)]} and "
                        f"{[str(t.dtype) for t in params]}; need one of "
                        f"{sorted(map(str, _STEP2_DTYPES))} on all")
    if _device_kind("mamba2_state_step", xbc, dt, z, ssm_state, *params) == "cpu":
        return state_step2_ref(xbc, dt, z, ssm_state, *params, eps=eps)
    if (P, N) not in _STEP2_SHAPES:
        raise ValueError(f"mamba2_state_step: head dim {P}, state width {N}; the kernel takes "
                         f"{_STEP2_SHAPES}")
    _check_step_launch("mamba2_state_step", B, H * P, [ssm_state, *params], (xbc, dt, z))
    if ssm_state.data_ptr() % 16:
        raise ValueError("mamba2_state_step: the kernel needs a 16-byte aligned state")
    launches["mamba2_step"] += 1
    return state_step2_cuda(xbc, dt, z, ssm_state, *params, eps)
