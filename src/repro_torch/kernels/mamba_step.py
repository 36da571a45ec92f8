"""One decode step (S == 1) of the Mamba-1 block: the Hopper kernels
(``csrc/mamba_step.cu``) and their plain PyTorch versions.

The step is cut in two at ``x_proj``, whose sum over all of d_inner is a
barrier between them (the caller computes it, ``x @ x_proj``):

- ``conv_step``: the depthwise causal conv of the new position over the
  carried conv state (B, d_conv - 1, DI), then SiLU; the state shifts one
  position and takes x, in place.
- ``state_step``: from x_proj's output (dt_low | B | C), each RMS-normalised
  where the model has the norms (Jamba), dt = softplus(dt_low @ dt_proj +
  dt_bias), the recurrence h = exp(dt * A) * h + dt * B * x on the carried SSM
  state (B, DI, N) f32, written back in place, and y = (h . C + D * x) *
  silu(z).

Both return the cache tensors they were given (and the step's output), so a
caller can tell that the state is already where it belongs.  The plain
versions are the torch code the model ran before the kernels, with the same
in-place contract; they round to the activation dtype wherever that code did,
where the kernels keep f32 from the inputs to the outputs.  Neither replaces
a TPU kernel: the reference's decode step is plain JAX.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

#: the conv width the kernel is built for, every model's d_conv; keep in step
#: with csrc/mamba_step.cu
CONV_WIDTH = 4
#: the largest dt_rank the state kernel's shared memory holds; keep in step
#: with csrc/mamba_step.cu
MAX_DT_RANK = 1024
#: dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}

_lib = None


def _rmsnorm(v: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``models.layers.rmsnorm``: scaled by (1 + scale), in f32, back to v's
    dtype."""
    v32 = v.float()
    out = v32 * torch.rsqrt(v32.square().mean(dim=-1, keepdim=True) + eps)
    return (out * (1.0 + scale.float())).to(v.dtype)


def conv_step_ref(x: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor,
                  conv_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (B, 1, DI), conv_state (B, d_conv - 1, DI), shifted in
    place.  Returns (silu(conv) (B, 1, DI), conv_state)."""
    xc = torch.cat([conv_state, x], dim=1)
    out = sum(xc[:, i:i + 1, :] * conv_w[i][None, None, :] for i in range(conv_w.shape[0])) \
        + conv_b[None, None, :]
    conv_state.copy_(xc[:, 1:])
    return F.silu(out), conv_state


def state_step_ref(proj: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   ssm_state: torch.Tensor, dt_proj: torch.Tensor, dt_bias: torch.Tensor,
                   A_log: torch.Tensor, D: torch.Tensor, dt_norm: Optional[torch.Tensor] = None,
                   b_norm: Optional[torch.Tensor] = None, c_norm: Optional[torch.Tensor] = None,
                   *, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: proj (B, 1, R + 2N), x and z (B, 1, DI), ssm_state
    (B, DI, N) f32, updated in place.  Returns (y (B, 1, DI), ssm_state)."""
    N = ssm_state.shape[-1]
    dt, Bm, Cm = torch.split(proj, [proj.shape[-1] - 2 * N, N, N], dim=-1)
    if dt_norm is not None:
        dt = _rmsnorm(dt, dt_norm, eps)
        Bm = _rmsnorm(Bm, b_norm, eps)
        Cm = _rmsnorm(Cm, c_norm, eps)
    dt = F.softplus(dt @ dt_proj + dt_bias)                 # (B, 1, DI)
    A = -torch.exp(A_log.float())                           # (DI, N)
    dA = torch.exp(dt[..., None].float() * A[None, None])   # (B, 1, DI, N)
    dBx = (dt[..., None] * Bm[:, :, None, :] * x[..., None]).float()
    h = dA * ssm_state[:, None] + dBx
    ssm_state.copy_(h[:, 0])
    y = torch.einsum("bsdn,bsn->bsd", h, Cm.float()).to(x.dtype)
    y = y + D[None, None, :] * x
    return y * F.silu(z), ssm_state


def _library():
    global _lib
    if _lib is None:
        lib = build.load("mamba_step")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.repro_mamba_conv_step.restype = i32
        lib.repro_mamba_conv_step.argtypes = [p, i64, p, p, p, p, i32, i32, i32, p]
        lib.repro_mamba_state_step.restype = i32
        lib.repro_mamba_state_step.argtypes = ([p, i64, p, p, i64] + [p] * 9
                                               + [i32] * 4 + [ctypes.c_float, i32, p])
        _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def conv_step_cuda(x: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the conv kernel on CUDA tensors the wrapper
    (``ops.mamba_conv_step``) has checked; allocates the output."""
    B, _, DI = x.shape
    out = torch.empty((B, 1, DI), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().repro_mamba_conv_step(
            x.data_ptr(), x.stride(0), conv_state.data_ptr(), conv_w.data_ptr(),
            conv_b.data_ptr(), out.data_ptr(), B, DI, DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"mamba_conv_step kernel launch failed: CUDA error {err}")
    return out, conv_state


def state_step_cuda(proj: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                    ssm_state: torch.Tensor, dt_proj: torch.Tensor, dt_bias: torch.Tensor,
                    A_log: torch.Tensor, D: torch.Tensor, norms: Tuple, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the state kernel on CUDA tensors the wrapper
    (``ops.mamba_state_step``) has checked; ``norms`` is (dt_norm, b_norm,
    c_norm) or three Nones.  Allocates y."""
    B, DI, N = ssm_state.shape
    y = torch.empty((B, 1, DI), dtype=x.dtype, device=x.device)
    ptrs = [None if t is None else t.data_ptr() for t in norms]
    with torch.cuda.device(x.device):
        err = _library().repro_mamba_state_step(
            proj.data_ptr(), proj.stride(0), x.data_ptr(), z.data_ptr(), z.stride(0),
            dt_proj.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(), *ptrs,
            ssm_state.data_ptr(), y.data_ptr(), B, DI, dt_proj.shape[0], N, eps,
            DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"mamba_state_step kernel launch failed: CUDA error {err}")
    return y, ssm_state
