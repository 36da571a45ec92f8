"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``):
GShard/Switch-style grouped dispatch.

Tokens are processed in groups of Sg tokens (GShard's G axis), so the
dispatch and combine tensors stay O(Sg * E * C) with per-group capacity
C = ceil(top_k * Sg / E * capacity_factor); a (token, choice) pair past its
expert's capacity is dropped.  Two dispatch modes, as in the reference:

  * "einsum"  -- dense one-hot dispatch and combine products (GShard);
  * "gather"  -- routing by a scatter of slot -> token index and gathers.

A config with ``moe_dropless`` set (Jamba, ``ScheduledModelConfig``) routes
without groups or capacity instead: every (token, choice) pair is sorted by
expert, each expert's MLP runs over exactly its rows as grouped products over
offsets on the device (``torch._grouped_mm``), and the outputs return to
their tokens by an inverse permutation.  Nothing is dropped, and on the card
nothing waits for the host (on the CPU a loop over experts takes the place
of the grouped products).

The router runs in float32; the gates are the top-k probabilities,
renormalised (the dropless route only where the config's ``moe_renormalize``
is on: Jamba keeps them as the softmax over all experts gave them); the
Switch load-balancing loss (its eq. 4) times ``load_balance_coef`` is
returned beside the output.  A config with a shared expert
(``ScheduledModelConfig.shared_d_ff``, Granite) adds to the routed output a gated MLP
over every token (leaves ``shared_w_gate``, ``shared_w_up``,
``shared_w_down``), which the router does not gate.  The
expert products of the capacity routes are plain batched products
(``torch.bmm``), as the reference's are ``jnp`` einsums: no Pallas kernel of
the reference covers this layer.  ``route_tap``, when given, is called with
each call's (N, K) expert choices and its (E,) tokens per expert (device
tensors).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import _ACT, mlp_block
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


def _expert_counts(choices: torch.Tensor, experts: int) -> torch.Tensor:
    """Pairs routed to each expert, (E,) int64, from any shape of choices
    (a scatter-add: ``bincount`` would read the largest index on the host)."""
    flat = choices.reshape(-1)
    return torch.zeros(experts, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _grouped_mlp(params: Dict, xs: torch.Tensor, offs: torch.Tensor, cfg) -> torch.Tensor:
    """Each expert's MLP over its rows of ``xs`` (rows grouped by expert;
    ``offs`` (E,) int32 the end of each group): grouped products on the
    card; on the CPU one product an expert over the host's counts (the CPU's
    grouped fallback is slower, and there is no device to wait for)."""
    act = _ACT[cfg.act]
    if xs.device.type == "cpu":
        outs, start = [], 0
        for e, end in enumerate(offs.tolist()):
            rows = xs[start:end]
            h = act(rows @ params["w_gate"][e]) * (rows @ params["w_up"][e]) \
                if cfg.gated_mlp else act(rows @ params["w_up"][e])
            outs.append(h @ params["w_down"][e])
            start = end
        return torch.cat(outs)
    if cfg.gated_mlp:
        h = act(torch._grouped_mm(xs, params["w_gate"], offs=offs)) \
            * torch._grouped_mm(xs, params["w_up"], offs=offs)
    else:
        h = act(torch._grouped_mm(xs, params["w_up"], offs=offs))
    return torch._grouped_mm(h, params["w_down"], offs=offs)


def _dropless(params: Dict, x: torch.Tensor, cfg, gate_vals: torch.Tensor,
              gate_idx: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """x (N, D) through the top-K experts of each token with no capacity:
    the N*K pairs sorted by expert (stably, so by token within an expert),
    the grouped MLP, then each token's K outputs gathered back and summed
    with their gates."""
    N, D = x.shape
    K = gate_idx.shape[1]
    order = torch.argsort(gate_idx.reshape(-1), stable=True)          # (N*K,)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    ys = _grouped_mlp(params, x[order // K], offs, cfg)                # (N*K, D)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    y = ys[inv].reshape(N, K, D)
    return torch.sum(y * gate_vals[..., None].to(x.dtype), dim=1)


def moe_block(
    params: Dict,
    x: torch.Tensor,          # (B, S, D)
    cfg,
    capacity_factor: float = 1.25,
    dispatch_mode: str = "einsum",
    route_tap: Optional[Callable[[torch.Tensor, torch.Tensor], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux loss: an f32 scalar).  A dropless
    config ignores ``capacity_factor`` and ``dispatch_mode``."""
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"moe_block: dispatch_mode must be one of {DISPATCH_MODES}, "
                         f"got {dispatch_mode!r}")
    e = cfg.moe
    B, S, D = x.shape
    E, K = e.num_experts, e.top_k
    N = B * S
    if getattr(cfg, "moe_dropless", False):
        xf = x.reshape(N, D)
        logits = xf.float() @ params["router"].float()
        probs = torch.softmax(logits, dim=-1)                      # (N, E)
        gate_vals, gate_idx = _top_k(probs, K)                     # (N, K)
        if cfg.moe_renormalize:
            gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
        counts = _expert_counts(gate_idx, E)
        if route_tap is not None:
            route_tap(gate_idx, counts)
        first = _expert_counts(gate_idx[:, 0], E).float() / N
        aux = E * torch.sum(probs.mean(dim=0) * first) * e.load_balance_coef
        out = _dropless(params, xf, cfg, gate_vals, gate_idx, counts).reshape(B, S, D)
        return constrain(_with_shared(params, x, out, cfg), "batch", "seq", "embed"), aux
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
    if route_tap is not None:
        route_tap(gate_idx.reshape(N, K), _expert_counts(gate_idx, E))

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

    out = _with_shared(params, x, out.reshape(B, S, D), cfg)
    return constrain(out, "batch", "seq", "embed"), aux


def _with_shared(params: Dict, x: torch.Tensor, out: torch.Tensor, cfg) -> torch.Tensor:
    """The routed output plus the shared expert's over every token, where
    the config has one."""
    if not getattr(cfg, "shared_d_ff", 0):
        return out
    shared = {k[len("shared_"):]: v for k, v in params.items() if k.startswith("shared_")}
    return out + mlp_block(shared, x, cfg)
