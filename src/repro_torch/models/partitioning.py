"""Logical-axis sharding annotations (counterpart of
``repro.models.partitioning``).

The model code annotates activations with logical axis names
(``constrain(x, "batch", "seq", "embed")``).  The port runs on one card, so
``constrain`` is the identity, as the reference's is outside a rules scope.
The rules themselves (``Rules``, ``use_rules``: logical names mapped onto a
device mesh) come with SPMD sharding, ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from typing import Optional

import torch

_SHARDING = "SPMD sharding rules are not ported yet: ROADMAP Queue 1 item 7"


class Rules:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_SHARDING)


class use_rules:
    def __init__(self, rules):
        if rules is not None:
            raise NotImplementedError(_SHARDING)

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The identity: no rules are active on one card."""
    return x
