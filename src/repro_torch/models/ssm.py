"""Mamba-1 selective state-space block (counterpart of ``repro.models.ssm``;
hymba's SSM branch).

Prefill and training run the recurrence h_t = dA_t * h_{t-1} + dBx_t over
the whole sequence.  On the kernel route (``impl="kernel"``, the default)
that is ``kernels.ops.mamba_scan`` — the hand-written scan on a CUDA tensor,
its plain version on a CPU tensor, and under autograd the same with its
backward kernel — which also returns the final carry h_S, the SSM state
decoding continues from.  The plain route (``impl="plain"``) is
that kernel's plain version, ``kernels.mamba_scan.mamba_scan_ref``, called
directly: the reference's ``ssm_scan`` followed by the C contraction, without
keeping every h_t.  Decode (S == 1) carries (conv_state, ssm_state) and does
one torch step.  A config with ``ssm_inner_norms`` (Jamba) applies an
RMSNorm to each of dt, B and C after ``x_proj`` (leaves ``dt_norm``,
``b_norm``, ``c_norm``).  A prefill in chunks (``transformer.prefill``) passes
each chunk the conv and SSM state the one before left in the cache, so dA
and dBx are built for one chunk at a time.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.mamba_scan import mamba_scan_ref
from .layers import IMPLS, rmsnorm
from .partitioning import constrain, local_call


def _ssm_core(params, xz, cfg, conv_state=None, ssm_state=None, impl: str = "kernel"):
    """xz: (B, S, 2*DI) projected input.  Returns (y, new_conv, new_ssm)."""
    if impl not in IMPLS:
        raise ValueError(f"_ssm_core: impl must be one of {IMPLS}, got {impl!r}")
    s = cfg.ssm
    B, S, _ = xz.shape
    N = s.d_state
    R = s.resolved_dt_rank(cfg.d_model)
    x, z = torch.chunk(xz, 2, dim=-1)                     # (B, S, DI) each

    # depthwise causal conv along seq (kernel d_conv)
    w = params["conv_w"]                                  # (d_conv, DI)
    if conv_state is not None:
        xc = torch.cat([conv_state, x], dim=1)            # (B, d_conv-1+S, DI)
    else:  # d_conv - 1 zeros before the first position: F.pad's values, as a
        # cat, since some versions' DTensor pads only over a 1-D mesh
        xc = torch.cat([x.new_zeros((B, s.d_conv - 1, x.shape[-1])), x], dim=1)
    new_conv = xc[:, xc.shape[1] - (s.d_conv - 1):, :]
    x = sum(xc[:, i:i + S, :] * w[i][None, None, :] for i in range(s.d_conv)) \
        + params["conv_b"][None, None, :]
    x = F.silu(x)

    # input-dependent (selective) parameters
    # (B, S, R+2N), contracted over d_inner: summed over the ranks that
    # split it before dt, B and C are used
    proj = constrain(x @ params["x_proj"], "batch", "seq", None)
    dt, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)
    if getattr(cfg, "ssm_inner_norms", False):
        dt = rmsnorm(dt, params["dt_norm"], cfg.norm_eps)
        Bm = rmsnorm(Bm, params["b_norm"], cfg.norm_eps)
        Cm = rmsnorm(Cm, params["c_norm"], cfg.norm_eps)
    dt = F.softplus(dt @ params["dt_proj"] + params["dt_bias"])   # (B, S, DI)
    A = -torch.exp(params["A_log"].float())               # (DI, N)
    dA = torch.exp(dt[..., None].float() * A[None, None])  # (B, S, DI, N)
    dBx = (dt[..., None] * Bm[:, :, None, :] * x[..., None]).float()

    C32 = Cm.float()
    if ssm_state is not None and S == 1:
        h = dA * ssm_state[:, None] + dBx                 # (B, 1, DI, N)
        new_ssm = h[:, 0]
        y = torch.einsum("bsdn,bsn->bsd", h, C32)
    else:
        if ssm_state is not None:  # continue a scan from carried state
            dBx[:, 0] += dA[:, 0] * ssm_state
        scan = ops.mamba_scan if impl == "kernel" else mamba_scan_ref
        # on each rank's shard of the batch and of d_inner
        y, new_ssm = local_call(lambda *t: scan(*(a.contiguous() for a in t)),
                                (dA, dBx, C32), ((0, 2), (0, 2), (0, None)),
                                ((0, 2), (0, 1)))
    y = y.to(x.dtype)
    y = y + params["D"][None, None, :] * x
    y = y * F.silu(z)
    return y, new_conv, new_ssm


def ssm_block(
    params: Dict,
    x: torch.Tensor,              # (B, S, D)
    cfg,
    cache: Optional[Dict] = None,  # {"conv": (B, d_conv-1, DI), "ssm": (B, DI, N)}
    impl: str = "kernel",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    xz = constrain(x @ params["in_proj"], "batch", "seq", "ff")
    conv_state = cache["conv"] if cache is not None else None
    ssm_state = cache["ssm"] if cache is not None else None
    y, new_conv, new_ssm = _ssm_core(params, xz, cfg, conv_state, ssm_state, impl)
    out = constrain(y @ params["out_proj"], "batch", "seq", "embed")
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssm": new_ssm}
    return out, new_cache
