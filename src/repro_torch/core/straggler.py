"""Straggler-mitigation simulation.

The GraphArray runtime dispatches block tasks to nodes; a straggling node
inflates the makespan of every barrier (reduction roots, ``to_numpy``
gathers).  This module simulates per-node task queues from an executed
context's lineage and evaluates *speculative re-execution*: once a node's
queue exceeds ``threshold``× the median finish time, its unstarted tasks are
duplicated on the least-loaded node (first-finisher wins, as in Ray/Spark
speculation).  Tests assert speculation recovers most of the straggler-free
makespan.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class SimResult:
    makespan: float
    per_node_busy: np.ndarray
    duplicated: int


def simulate_makespan(
    placements: List[int],
    task_costs: List[float],
    k: int,
    slow_nodes: Optional[Dict[int, float]] = None,
    speculative: bool = False,
    threshold: float = 1.5,
    mode: str = "duplicate",
) -> SimResult:
    """Greedy list-schedule of ``task_costs`` onto their assigned nodes.

    ``slow_nodes`` maps node -> slowdown factor (e.g. {3: 10.0}).  With
    ``speculative=True``, the unstarted tail of a node whose projected finish
    exceeds ``threshold`` x median is offered to the earliest-finishing other
    node, under one of two semantics:

    * ``mode="duplicate"`` (default, Ray/Spark speculation): the slow copy
      *stays queued* on ``j`` while a duplicate runs on the target; the first
      finisher wins and only the winner's clock advances — per task the
      effective completion is ``min(slow copy on j, dup on tgt)``.
    * ``mode="migrate"``: the tail is removed from ``j`` and runs only on the
      target (work stealing — no redundant compute, but no hedge either: a
      straggling *target* now gates completion).

    Historical note: this function once removed the tail from ``j`` while
    claiming first-finisher-wins semantics — the min() was never taken, so a
    "duplicate" that lost the race still charged the target and un-charged
    ``j``.  Both semantics are now explicit and regression-tested.
    """
    if mode not in ("duplicate", "migrate"):
        raise ValueError(f"unknown speculation mode {mode!r}")
    slow = slow_nodes or {}
    finish = np.zeros(k)
    queues: Dict[int, List[float]] = {j: [] for j in range(k)}
    for node, cost in zip(placements, task_costs):
        queues[node].append(cost * slow.get(node, 1.0))
    for j in range(k):
        finish[j] = sum(queues[j])
    duplicated = 0
    if speculative and k > 1:
        med = float(np.median(finish))
        others = np.arange(k)
        for j in range(k):
            if finish[j] > threshold * max(med, 1e-12) and queues[j]:
                # speculate on the unstarted tail of j's queue
                tail = queues[j][len(queues[j]) // 2 :]
                queues[j] = queues[j][: len(queues[j]) // 2]
                finish[j] = sum(queues[j])
                mask = others != j
                for cost in tail:
                    # earliest-finishing *other* node hosts the copy
                    tgt = int(others[mask][np.argmin(finish[mask])])
                    base = cost / slow.get(j, 1.0)  # original cost
                    dup_cost = base * slow.get(tgt, 1.0)
                    duplicated += 1
                    if mode == "migrate":
                        finish[tgt] += dup_cost
                        continue
                    # duplicate: both copies race; first finisher wins and
                    # the loser is cancelled, so only one clock advances —
                    # effective completion = min(slow copy on j, dup on tgt)
                    t_slow = finish[j] + cost
                    t_dup = finish[tgt] + dup_cost
                    if t_dup <= t_slow:
                        finish[tgt] = t_dup
                    else:
                        finish[j] = t_slow
    return SimResult(float(finish.max()), finish, duplicated)


def context_task_profile(ctx, element_rate: float = 1e9,
                         use_sim_times: bool = False) -> tuple:
    """Extract (placements, costs) from an executed ArrayContext's lineage:
    cost = output elements / element_rate (compute-proportional model).

    With ``use_sim_times=True``, per-task costs come from the scheduler's
    overlap-aware clock trace instead (``OpRecord.times``, seconds of
    simulated pipelined wall time including any serialized transfer wait) —
    stragglers then inflate the same durations the makespan model charges."""
    placements, costs = [], []
    for rec in ctx.executor.lineage.values():
        if rec.op.startswith("create:"):
            continue
        placements.append(rec.placement[0])
        if use_sim_times and rec.times is not None:
            costs.append(max(rec.times[1] - rec.times[0], 1e-12))
            continue
        shape = ctx.executor.shapes[rec.out_id]
        costs.append(max(float(np.prod(shape)) if shape else 1.0, 1.0) / element_rate)
    return placements, costs
