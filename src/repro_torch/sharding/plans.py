"""Sharding plans (counterpart of ``repro.sharding.plans``).

A :class:`Plan` fixes how the logical axes map onto a device mesh and how a
train step is run: remat policy, gradient accumulation, gradient dtype.
The port trains on one card, so only the step's own fields act here
(``remat``, ``accum_steps``, ``grad_dtype``); the mesh fields are kept so
that a plan reads as the reference's.  ``activation_rules`` and the plan
search wait for SPMD sharding, ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class Plan:
    name: str
    batch_axes: Tuple[str, ...] = ("pod", "data")
    tp_axis: Optional[str] = "model"       # heads / ff / vocab tensor-parallel
    fsdp_axis: Optional[Any] = None        # ZeRO-3 axis (str or tuple of axes)
    sp: bool = False                       # shard activation seq over tp_axis
    cache_sp: bool = False                 # shard KV-cache seq over tp_axis
    ep: bool = False                       # experts over tp_axis (MoE)
    remat: str = "dots"                    # none | dots | full
    dispatch_mode: str = "einsum"          # MoE dispatch: einsum | gather
    grad_dtype: str = "float32"            # bfloat16 = compressed all-reduce
    accum_steps: int = 1                   # gradient accumulation microbatches


#: the plan a single card trains with when none is given
SINGLE_CARD = Plan("single_card", batch_axes=(), tp_axis=None, remat="full")


def activation_rules(plan: Plan, mesh, cfg=None):
    raise NotImplementedError("activation sharding rules over a device mesh are not "
                              "ported yet: ROADMAP Queue 1 item 7 (SPMD sharding)")
