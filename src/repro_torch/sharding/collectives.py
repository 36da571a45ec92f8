"""Collective bytes per step (counterpart of ``repro.sharding.hlo``).

The reference parses the compiled HLO for all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute instructions and sums their
operand bytes, multiplying loop bodies by their trip counts.  The port has
no HLO: a :class:`CollectiveCounter` is a ``TorchDispatchMode`` that sees
every ``torch.ops._c10d_functional`` collective a step issues (DTensor's
redistributions, explicit ``full_tensor``/``redistribute`` calls, local
shards' ops inside ``local_map``) and sums their operand bytes per kind, on
this rank: per-device bytes, as the reference's.  The layer loop is Python,
so every layer's collectives are seen and no trip count is needed.  A
broadcast counts as a collective-permute.

    with CollectiveCounter() as cc:
        step(state, batch)
    cc.result()  # {"all-reduce": bytes, ..., "total": bytes, "n_all-reduce": count, ...}
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

#: op-name prefix -> the reference's collective kind
_KINDS = (
    ("all_gather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"),
    ("broadcast", "collective-permute"),
)


def collective_kind(func) -> str:
    """The reference's kind of a ``_c10d_functional`` op, or "" for any
    other op (``wait_tensor`` included)."""
    if getattr(func, "namespace", None) != "_c10d_functional":
        return ""
    name = func._opname
    return next((kind for prefix, kind in _KINDS if name.startswith(prefix)), "")


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives issued while it is active: operand bytes and
    calls per kind."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # a DTensor op: let DTensor run it, so that its redistributions
            # and its ops on local shards come back through this mode
            return NotImplemented
        kind = collective_kind(func)
        if kind:
            self.bytes[kind] += _bytes(args[0])
            self.counts[kind] += 1
        return func(*args, **(kwargs or {}))

    def result(self) -> Dict[str, float]:
        """The reference's ``collective_bytes`` dict: bytes per kind,
        "total", and "n_<kind>" counts."""
        out: Dict[str, float] = dict(self.bytes)
        out["total"] = float(sum(self.bytes.values()))
        for k, c in self.counts.items():
            out[f"n_{k}"] = float(c)
        return out
