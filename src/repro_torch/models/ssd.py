"""Mamba-2 mixer: the state-space duality (SSD) layer of Dao & Gu
(arXiv:2405.21060), as Granite 4.0-H, Nemotron-H, Falcon-H1 and Zamba2 run
it (HF's ``Mamba2Mixer``; ``GraniteMoeHybridMambaLayer``).

in_proj gives (z | xBC | dt) of widths (H*P, H*P + 2*G*N, H); xBC goes
through a causal depthwise conv of width ``d_conv`` with bias and SiLU and
splits into x (H heads of P), B and C (G groups of N, each shared by H / G
heads); dt = softplus(dt + dt_bias) and A = -exp(A_log), one of each a head.
Each head h carries a (P, N) state, S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,
and reads y_t = S_t C_t + D x_t.  Then y * silu(z) goes through an RMSNorm
over all H*P channels (scaled by 1 + ``norm``, the port's convention), and
out_proj.

Prefill and training take the chunked SSD form (``ssd_chunked``): within a
chunk of ``chunk_size`` positions the outputs are one masked product
(C B^T weighted by the decays between positions) with x dt; each chunk's
contribution to the state at its end is another product; the states pass
from chunk to chunk in order, starting from the carried state, and each
chunk's outputs add what its entering state gives.  All of it is batched
torch products in float32, on any length (the last chunk is padded with
positions that neither decay nor add).  Decode (S == 1 with a cache) is one
step on the carried (conv, ssm) state: ``kernels.ops.mamba_conv_step`` over
xBC, then ``kernels.ops.mamba2_state_step`` (the kernels on the card; their
plain versions on the CPU and on the plain route), which update the cache
in place and hand its tensors back.  As ``models/ssm.py`` for Mamba-1, the
module owns the mixer's parameter shapes, cache and span.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.trace import LM_MAMBA2
from ..kernels import ops
from ..kernels.mamba2_step import state_step_ref
from ..kernels.mamba_step import conv_step_ref
from .layers import IMPLS

#: the span a Mamba-2 layer opens while the profiler records
SPAN = LM_MAMBA2


def param_shapes(cfg) -> Dict[str, tuple]:
    """One layer's leaves and their shapes."""
    s, D = cfg.ssm, cfg.d_model
    H, DI, CC = s.n_heads, s.d_inner, s.conv_channels
    return {"in_proj": (D, DI + CC + H), "conv_w": (s.d_conv, CC), "conv_b": (CC,),
            "dt_bias": (H,), "A_log": (H,), "D": (H,), "norm": (DI,), "out_proj": (DI, D)}


def cache_shapes(cfg) -> Dict[str, Tuple[tuple, Optional[torch.dtype], tuple]]:
    """A row's serving cache: each leaf's shape, dtype (None: the model's)
    and logical axes."""
    s = cfg.ssm
    return {"conv": ((s.d_conv - 1, s.conv_channels), None, (None, "ff")),
            "ssm": ((s.n_heads, s.head_dim, s.d_state), torch.float32, ("ff", None, None))}


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, initial: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence over x (B, S, H, P), dt (B, S, H) (after softplus)
    and A (H,) (negative), with B and C (B, S, G, N), in chunks of ``chunk``
    positions, all in float32, from the state ``initial`` (B, H, P, N) (zero
    where None).  Returns y (B, S, H, P), without the D skip, and the state
    after the last position."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    c = -(-S // chunk)
    pad = c * chunk - S
    if pad:  # positions with dt 0: no decay, nothing added
        x, dt, Bm, Cm = (F.pad(t, (0,) * (2 * t.ndim - 4) + (0, pad)) for t in (x, dt, Bm, Cm))
    a = (dt * A).reshape(Bsz, c, chunk, H).permute(0, 3, 1, 2)        # (B, H, c, l)
    acum = a.cumsum(-1)
    xdt = (x * dt[..., None]).reshape(Bsz, c, chunk, H, P)
    Bc = Bm.reshape(Bsz, c, chunk, G, N)
    Cc = Cm.reshape(Bsz, c, chunk, G, N)
    # within a chunk: y_l = sum_{s <= l} (C_l . B_s) exp(acum_l - acum_s) x_s dt_s
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = (acum[..., :, None] - acum[..., None, :]).masked_fill(~causal, -float("inf"))
    cb = torch.einsum("bclgn,bcsgn->bgcls", Cc, Bc).repeat_interleave(rep, dim=1)
    y = (torch.exp(seg) * cb) @ xdt.permute(0, 3, 1, 2, 4)             # (B, H, c, l, P)
    # each chunk's own part of the state at its end
    Bh = Bc.repeat_interleave(rep, dim=3)                              # (B, c, l, H, N)
    to_end = torch.exp(acum[..., -1:] - acum)                          # (B, H, c, l)
    own = torch.einsum("bhcs,bcshp,bcshn->bchpn", to_end, xdt, Bh)
    # the states passed from chunk to chunk, each entering the next
    run = x.new_zeros(Bsz, H, P, N) if initial is None else initial.to(x.dtype)
    whole = torch.exp(acum[..., -1])                                   # (B, H, c)
    entering = []
    for k in range(c):
        entering.append(run)
        run = whole[:, :, k, None, None] * run + own[:, k]
    Ch = Cc.repeat_interleave(rep, dim=3)
    y_in = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, torch.stack(entering, 1),
                        torch.exp(acum))
    y = y.permute(0, 2, 3, 1, 4) + y_in                                # (B, c, l, H, P)
    return y.reshape(Bsz, c * chunk, H, P)[:, :S], run


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float
               ) -> torch.Tensor:
    """RMSNorm of y * silu(z) over the last axis, scaled by 1 + scale, in f32."""
    g = y.float() * F.silu(z.float())
    return g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def mamba2_block(params: Dict, x: torch.Tensor, cfg, cache: Optional[Dict] = None,
                 impl: str = "kernel") -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, D) -> (out (B, S, D), new cache or None).  ``cache``:
    {"conv": (B, d_conv - 1, H*P + 2*G*N), "ssm": (B, H, P, N) f32}, the
    state before x's first position."""
    if impl not in IMPLS:
        raise ValueError(f"mamba2_block: impl must be one of {IMPLS}, got {impl!r}")
    s = cfg.ssm
    H, P, N, G = s.n_heads, s.head_dim, s.d_state, s.n_groups
    DI = s.d_inner
    B, S, _ = x.shape
    z, xbc, dt = torch.split(x @ params["in_proj"], [DI, DI + 2 * G * N, H], dim=-1)
    if cache is not None and S == 1:
        conv, step = ((ops.mamba_conv_step, ops.mamba2_state_step) if impl == "kernel"
                      else (conv_step_ref, state_step_ref))
        xbc, new_conv = conv(xbc, cache["conv"], params["conv_w"], params["conv_b"])
        y, new_ssm = step(xbc, dt, z, cache["ssm"], params["dt_bias"], params["A_log"],
                          params["D"], params["norm"], eps=cfg.norm_eps)
        return y @ params["out_proj"], {"conv": new_conv, "ssm": new_ssm}
    w = params["conv_w"]                                   # (d_conv, H*P + 2*G*N)
    front = (cache["conv"] if cache is not None
             else xbc.new_zeros((B, s.d_conv - 1, xbc.shape[-1])))
    xc = torch.cat([front, xbc], dim=1)
    new_conv = xc[:, xc.shape[1] - (s.d_conv - 1):]
    xbc = F.silu(sum(xc[:, i:i + S] * w[i] for i in range(s.d_conv)) + params["conv_b"])
    xs, Bm, Cm = torch.split(xbc.float(), [DI, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, new_ssm = ssd_chunked(xs, dt, A, Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N),
                             s.chunk_size, None if cache is None else cache["ssm"])
    y = (y + params["D"].float()[:, None] * xs).reshape(B, S, DI)
    y = gated_norm(y, z, params["norm"], cfg.norm_eps).to(x.dtype)
    new_cache = None if cache is None else {"conv": new_conv, "ssm": new_ssm}
    return y @ params["out_proj"], new_cache


block = mamba2_block
