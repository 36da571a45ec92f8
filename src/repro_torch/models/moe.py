"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``):
GShard/Switch-style grouped dispatch.

Tokens are processed in groups of Sg tokens (GShard's G axis), so the
dispatch and combine tensors stay O(Sg * E * C) with per-group capacity
C = ceil(top_k * Sg / E * capacity_factor); a (token, choice) pair past its
expert's capacity is dropped.  Two dispatch modes, as in the reference:

  * "einsum"  -- dense one-hot dispatch and combine products (GShard);
  * "gather"  -- routing by a scatter of slot -> token index and gathers.

The router runs in float32; the gates are the top-k probabilities,
renormalised; the Switch load-balancing loss (its eq. 4) times
``load_balance_coef`` is returned beside the output.  The expert products
are plain batched products (``torch.bmm``), as the reference's are ``jnp``
einsums: no Pallas kernel of the reference covers this layer.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import _ACT
from .partitioning import constrain

_GROUP_TOKENS = 2048  # target tokens per dispatch group
DISPATCH_MODES = ("einsum", "gather")


def _expert_mlp(params: Dict, xin: torch.Tensor, cfg) -> torch.Tensor:
    """Batched expert MLP over stacked weights; xin: (E, C_total, D)."""
    act = _ACT[cfg.act]
    if cfg.gated_mlp:
        h = act(torch.bmm(xin, params["w_gate"])) * torch.bmm(xin, params["w_up"])
    else:
        h = act(torch.bmm(xin, params["w_up"]))
    h = constrain(h, "experts", None, "ff")
    return constrain(torch.bmm(h, params["w_down"]), "experts", None, "embed")


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, largest first, the lower index
    first among equal values (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(
    params: Dict,
    x: torch.Tensor,          # (B, S, D)
    cfg,
    capacity_factor: float = 1.25,
    dispatch_mode: str = "einsum",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux loss: an f32 scalar)."""
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"moe_block: dispatch_mode must be one of {DISPATCH_MODES}, "
                         f"got {dispatch_mode!r}")
    e = cfg.moe
    B, S, D = x.shape
    E, K = e.num_experts, e.top_k
    N = B * S
    # group tokens: G groups of Sg tokens (Sg divides N by construction)
    Sg = min(_GROUP_TOKENS, N)
    while N % Sg:
        Sg //= 2
    Sg = max(Sg, 1)
    G = N // Sg
    xg = x.reshape(G, Sg, D)

    logits = torch.einsum("gsd,de->gse", xg.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)                          # (G, Sg, E)

    gate_vals, gate_idx = _top_k(probs, K)                         # (G, Sg, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch aux loss over the whole batch
    me = probs.mean(dim=(0, 1))                                    # (E,)
    ce = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce) * e.load_balance_coef

    C = max(1, int(math.ceil(K * Sg / E * capacity_factor)))

    # position of each (token, k) within its expert's per-group capacity, in
    # token-major order over (token, k)
    sel = F.one_hot(gate_idx, E)                                   # (G, Sg, K, E)
    flat = sel.reshape(G, Sg * K, E)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(G, Sg, K, E)
    pos = torch.sum(pos_in_expert * sel, dim=-1)                   # (G, Sg, K)
    fits = pos < C

    if dispatch_mode == "gather":
        # scatter slot -> token index, then gather; a dropped pair goes to the
        # sentinel slot E*C (the only index written twice), which is cut off
        slot = torch.where(fits, gate_idx * C + pos, E * C)        # (G, Sg, K)
        tok_ids = torch.arange(Sg, device=x.device).view(1, Sg, 1).expand(G, Sg, K)
        token_of_slot = torch.full((G, E * C + 1), Sg, dtype=torch.long, device=x.device)
        token_of_slot.scatter_(1, slot.reshape(G, Sg * K), tok_ids.reshape(G, Sg * K))
        xg_pad = torch.cat([xg, xg.new_zeros(G, 1, D)], dim=1)
        xin = torch.gather(xg_pad, 1, token_of_slot[:, :-1, None].expand(G, E * C, D))
        xin = xin.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
        xin = constrain(xin, "experts", None, "embed")
        out_e = _expert_mlp(params, xin, cfg)
        out_slots = out_e.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
        out_pad = torch.cat([out_slots, out_slots.new_zeros(G, 1, D)], dim=1)
        gathered = torch.gather(out_pad, 1, slot.reshape(G, Sg * K, 1).expand(G, Sg * K, D))
        gathered = gathered.reshape(G, Sg, K, D)
        out = torch.sum(gathered * gate_vals[..., None].to(x.dtype), dim=2)
    else:
        sel_f = sel.float() * fits[..., None]                      # (G, Sg, K, E)
        # one_hot(pos, C) with a zero row for a dropped position, as jax's
        pos_oh = F.one_hot(pos.clamp(max=C - 1), C).float() * fits[..., None]
        dispatch = torch.einsum("gske,gskc->gsec", sel_f, pos_oh)
        # the reference's "gske,gskc,gsk->gsec" with the gates folded into
        # sel_f first: contracting K straight away never builds the
        # (G, Sg, K, E, C) product
        combine = torch.einsum("gske,gskc->gsec", sel_f * gate_vals[..., None], pos_oh)
        xin = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xg)
        xin = constrain(xin.reshape(E, G * C, D), "experts", None, "embed")
        out_e = _expert_mlp(params, xin, cfg).reshape(E, G, C, D)
        out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), out_e)

    out = out.reshape(B, S, D)
    return constrain(out, "batch", "seq", "embed"), aux
