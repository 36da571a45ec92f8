"""One decode step (S == 1) of the Mamba-2 (SSD) mixer after its causal conv:
the Hopper kernels (``csrc/mamba2_step.cu``) and their plain PyTorch version.

From the conv's output xBC = (x | B | C), x of H heads of P channels and B,
C of G groups of N, the raw dt (one a head) and the gate z (the slices of
in_proj's output), each head h of group g = h // (H / G) takes
dt = softplus(dt_raw + dt_bias), the decay a = exp(-dt exp(A_log)), the state
update S <- a S + dt x B^T on its (P, N) f32 state, in place, and
y = S C + D x; the row's y * silu(z) then goes through the gated RMSNorm over
all H * P channels (scaled by 1 + scale, the port's norm convention).  The
conv itself is ``ops.mamba_conv_step`` (``csrc/mamba_step.cu``), which takes
xBC's channels as it takes Mamba-1's x.

Both routes return the cache tensor they were given beside the step's
output, and keep f32 from the inputs to the norm, rounding once to the
activation dtype at the end.  Neither replaces a TPU kernel: the reference
has no Mamba-2.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

#: (head dim, state width) pairs the kernel is built for: Granite 4.0-H's
#: (64, 128), and (64, 64) for the launch test at reduced width; keep in step
#: with csrc/mamba2_step.cu
SHAPES = ((64, 64), (64, 128))
#: dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}

_lib = None


def groups_of(xbc_width: int, heads: int, head_dim: int, d_state: int) -> int:
    """G, the groups of B and C, from the width of the conv's output
    (H * P + 2 * G * N); 0 where the width fits no whole number."""
    rest = xbc_width - heads * head_dim
    return rest // (2 * d_state) if rest > 0 and rest % (2 * d_state) == 0 else 0


def state_step_ref(xbc: torch.Tensor, dt: torch.Tensor, z: torch.Tensor,
                   ssm_state: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                   D: torch.Tensor, norm: torch.Tensor, *, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: xbc (B, 1, H*P + 2*G*N), dt (B, 1, H), z (B, 1, H*P),
    ssm_state (B, H, P, N) f32, updated in place.  Returns (y (B, 1, H*P),
    ssm_state)."""
    B, H, P, N = ssm_state.shape
    G = groups_of(xbc.shape[-1], H, P, N)
    x, Bm, Cm = torch.split(xbc[:, 0].float(), [H * P, G * N, G * N], dim=-1)
    x = x.reshape(B, H, P)
    Bm = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1)        # (B, H, N)
    Cm = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    step = F.softplus(dt[:, 0].float() + dt_bias.float())            # (B, H)
    decay = torch.exp(step * -torch.exp(A_log.float()))
    h = decay[..., None, None] * ssm_state \
        + (step[..., None] * x)[..., None] * Bm[:, :, None, :]
    ssm_state.copy_(h)
    y = (h @ Cm[..., None])[..., 0] + D.float()[:, None] * x         # (B, H, P)
    y = y.reshape(B, H * P) * F.silu(z[:, 0].float())
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps) * (1.0 + norm.float())
    return y.to(xbc.dtype)[:, None], ssm_state


def _library():
    global _lib
    if _lib is None:
        lib = build.load("mamba2_step")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.repro_mamba2_state_step.restype = i32
        lib.repro_mamba2_state_step.argtypes = ([p, i64, p, i64, p, i64] + [p] * 7
                                                + [i32] * 5 + [ctypes.c_float, i32, p])
        _lib = lib
    return _lib


def state_step_cuda(xbc: torch.Tensor, dt: torch.Tensor, z: torch.Tensor,
                    ssm_state: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                    D: torch.Tensor, norm: torch.Tensor, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels on CUDA tensors the wrapper (``ops.mamba2_state_step``)
    has checked.  Allocates y and the (B, H*P) f32 row the norm reads."""
    B, H, P, N = ssm_state.shape
    G = groups_of(xbc.shape[-1], H, P, N)
    y = torch.empty((B, 1, H * P), dtype=xbc.dtype, device=xbc.device)
    g = torch.empty((B, H * P), dtype=torch.float32, device=xbc.device)
    with torch.cuda.device(xbc.device):
        err = _library().repro_mamba2_state_step(
            xbc.data_ptr(), xbc.stride(0), dt.data_ptr(), dt.stride(0), z.data_ptr(),
            z.stride(0), dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(), norm.data_ptr(),
            ssm_state.data_ptr(), g.data_ptr(), y.data_ptr(), B, H, P, N, G, eps,
            DTYPE_CODES[xbc.dtype], torch.cuda.current_stream(xbc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba2_state_step kernel launch failed: CUDA error {err}")
    return y, ssm_state
