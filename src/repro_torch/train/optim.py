"""Optimizers for LM training (counterpart of ``repro.train.optim``): AdamW
with a warmup-cosine schedule and global gradient clipping, in plain torch
(the reference computes these in jnp, with no Pallas kernel).

The reference's update is functional; this one updates the parameters and
the moments in place, leaf by leaf, so a step holds one leaf's temporaries
and not a second copy of the whole train state (5.5 GB of f32 moments and
weights at hymba-1.5b's size).  The arithmetic is the reference's, in f32,
on the device the state lies on; leaves are visited in sorted key order, as
``jax.tree.leaves`` visits them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.transformer import _leaves, _tree_map


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _tree_leaves(tree):
    return [leaf for _, leaf in _leaves(tree)]


def lr_at(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init_opt_state(params) -> Dict[str, Any]:
    """Zero f32 moments shaped (and, for DTensor parameters, placed) like
    ``params`` and an int32 step counter, on the parameters' device."""
    device = _tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, a plain scalar tensor.  A
    DTensor leaf's sum is reduced over its mesh explicitly (``full_tensor``:
    an all-reduce where the leaf is sharded)."""
    def sq(g):
        s = torch.sum(torch.square(g.float()))
        return s.full_tensor() if isinstance(s, DTensor) else s

    return torch.sqrt(sum(sq(g) for g in _tree_leaves(tree)))


@torch.no_grad()
def adam_update(cfg: AdamConfig, params, grads, opt_state):
    """One AdamW step, in place: ``params`` and the moments of ``opt_state``
    are updated and returned, with metrics {grad_norm, lr}.  ``grads`` has
    the structure of ``params``.  Decoupled weight decay applies to leaves
    of two or more dimensions only (stacked per-layer vectors included), as
    in the reference."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for p, g, m, v in zip(_tree_leaves(params), _tree_leaves(grads),
                          _tree_leaves(opt_state["m"]), _tree_leaves(opt_state["v"])):
        g = g.float() * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
