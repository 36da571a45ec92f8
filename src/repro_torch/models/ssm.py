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
keeping every h_t.  Decode (S == 1 with a cache) is one step on the
carried (conv_state, ssm_state): ``kernels.ops.mamba_conv_step``, the
``x_proj`` product, then ``kernels.ops.mamba_state_step`` on the kernel
route (their plain versions, called directly, on the plain route), which
update the cache's conv and SSM state in place and hand the same tensors
back, so the caller has nothing to copy.  A config with ``ssm_inner_norms``
(Jamba) applies an RMSNorm to each of dt, B and C after ``x_proj`` (leaves
``dt_norm``, ``b_norm``, ``c_norm``).  A prefill in chunks
(``transformer.prefill``) passes each chunk the conv and SSM state the one
before left in the cache, so dA and dBx are built for one chunk at a time.
The module owns the mixer's parameter shapes (``param_shapes``), its cache
(``cache_shapes``) and its span (``SPAN``), which ``transformer`` takes from
the module of the config's SSM (``models/ssd.py`` for Mamba-2).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.trace import LM_MAMBA
from ..kernels import ops
from ..kernels.mamba_scan import mamba_scan_ref
from ..kernels.mamba_step import conv_step_ref, state_step_ref
from .layers import IMPLS, rmsnorm
from .partitioning import constrain, local_call


#: the norms' leaves, in the order the decode step takes them
_INNER_NORMS = ("dt_norm", "b_norm", "c_norm")
#: the span a Mamba-1 layer opens while the profiler records
SPAN = LM_MAMBA


def param_shapes(cfg) -> Dict[str, tuple]:
    """One layer's leaves and their shapes."""
    s = cfg.ssm
    D = cfg.d_model
    DI = s.d_inner(D)
    N, R = s.d_state, s.resolved_dt_rank(D)
    shapes = {
        "in_proj": (D, 2 * DI),
        "conv_w": (s.d_conv, DI),
        "conv_b": (DI,),
        "x_proj": (DI, R + 2 * N),
        "dt_proj": (R, DI),
        "dt_bias": (DI,),
        "A_log": (DI, N),
        "D": (DI,),
        "out_proj": (DI, D),
    }
    if getattr(cfg, "ssm_inner_norms", False):
        shapes.update({"dt_norm": (R,), "b_norm": (N,), "c_norm": (N,)})
    return shapes


def cache_shapes(cfg) -> Dict[str, Tuple[tuple, Optional[torch.dtype], tuple]]:
    """A row's serving cache: each leaf's shape, dtype (None: the model's)
    and logical axes."""
    s = cfg.ssm
    DI = s.d_inner(cfg.d_model)
    return {"conv": ((s.d_conv - 1, DI), None, (None, "ff")),
            "ssm": ((DI, s.d_state), torch.float32, ("ff", None))}


def _decode_step(params, xz, cfg, conv_state, ssm_state, impl):
    """S == 1 on a carried cache: (y, conv_state, ssm_state), the states
    updated in place; under sharding rules each kernel runs on the local
    shards (batch rows and d_inner are independent), and x_proj's sum over
    d_inner between them is the DTensor product's."""
    x, z = torch.chunk(xz, 2, dim=-1)                     # (B, 1, DI) each
    conv, step = ((ops.mamba_conv_step, ops.mamba_state_step) if impl == "kernel"
                  else (conv_step_ref, state_step_ref))
    x, new_conv = local_call(conv, (x, conv_state, params["conv_w"], params["conv_b"]),
                             ((0, 2), (0, 2), (None, 1), (None, 0)), ((0, 2), (0, 2)))
    proj = constrain(x @ params["x_proj"], "batch", "seq", None)
    norms = _INNER_NORMS if getattr(cfg, "ssm_inner_norms", False) else ()
    args = (proj, x, z, ssm_state, params["dt_proj"], params["dt_bias"], params["A_log"],
            params["D"], *(params[k] for k in norms))
    dims = ((0, None), (0, 2), (0, 2), (0, 1), (None, 1), (None, 0), (None, 0),
            (None, 0)) + ((None, None),) * len(norms)
    y, new_ssm = local_call(step, args, dims, ((0, 2), (0, 1)), eps=cfg.norm_eps)
    return y, new_conv, new_ssm


def _ssm_core(params, xz, cfg, conv_state=None, ssm_state=None, impl: str = "kernel"):
    """xz: (B, S, 2*DI) projected input.  Returns (y, new_conv, new_ssm)."""
    if impl not in IMPLS:
        raise ValueError(f"_ssm_core: impl must be one of {IMPLS}, got {impl!r}")
    if ssm_state is not None and xz.shape[1] == 1:
        return _decode_step(params, xz, cfg, conv_state, ssm_state, impl)
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

    if ssm_state is not None:  # continue a scan from carried state
        dBx[:, 0] += dA[:, 0] * ssm_state
    scan = ops.mamba_scan if impl == "kernel" else mamba_scan_ref
    # on each rank's shard of the batch and of d_inner
    y, new_ssm = local_call(lambda *t: scan(*(a.contiguous() for a in t)),
                            (dA, dBx, Cm.float()), ((0, 2), (0, 2), (0, None)),
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


block = ssm_block
