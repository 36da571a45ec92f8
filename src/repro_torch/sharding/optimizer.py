"""LSHS as a sharding optimizer (counterpart of
``repro.sharding.optimizer``): choose the plan minimizing the paper's Eq. 2
objective (max memory + max net-in + max net-out over devices) subject to
the device memory capacity, over the candidate plan space — the SPMD
analogue of simulating every placement option of a frontier vertex.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig

from .estimator import LoadEstimate, estimate
from .hardware import H100_SXM, Hardware
from .plans import Plan, candidate_plans


@dataclass
class PlanChoice:
    plan: Plan
    est: LoadEstimate
    ranking: List[Tuple[str, float, bool]]  # (name, objective, fits)


def choose_plan(
    cfg: ModelConfig,
    mesh_axes: Dict[str, int],
    kind: str,
    global_batch: int,
    seq_len: int,
    mode: str = "time",
    plans: Optional[List[Plan]] = None,
    hw: Hardware = H100_SXM,
) -> PlanChoice:
    cands = plans if plans is not None else candidate_plans(cfg, kind)
    scored = []
    for plan in cands:
        est = estimate(cfg, plan, mesh_axes, kind, global_batch, seq_len, hw=hw)
        scored.append((plan, est))
    ranking = [(p.name, e.objective(mode), e.fits) for p, e in scored]
    fitting = [(p, e) for p, e in scored if e.fits]
    pool = fitting if fitting else scored  # the least bad if none fits
    best_plan, best_est = min(pool, key=lambda pe: pe[1].objective(mode))
    return PlanChoice(plan=best_plan, est=best_est,
                      ranking=sorted(ranking, key=lambda r: r[1]))
