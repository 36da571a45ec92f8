"""Logical-axis sharding rules (counterpart of ``repro.models.partitioning``).

Model code annotates activations with *logical* axis names
(``constrain(x, "batch", "seq", "embed")``).  A :class:`Rules` object maps
logical names to mesh axes (or None); the LSHS plan optimizer
(``repro_torch.sharding``) picks among candidate Rules and the launcher
installs the winner.  Outside an active rules scope, or on a plain tensor,
every annotation is the identity, so one card runs the same model code.

The reference hands a ``PartitionSpec`` to GSPMD; the port runs on
``torch.distributed`` DTensors: ``Rules.spec`` gives the reference's
per-tensor-dim tuple of mesh axes and ``Rules.placements`` the same as one
DTensor placement per mesh dim, and ``constrain`` redistributes a DTensor
to them (a collective where the placements differ).

Ops that must run on each rank's own shard (the hand-written kernels)
go through ``local_call``: it picks, from the operands' own placements,
the dims the op is local in, redistributes the rest to ``Replicate`` and
calls the op on the local tensors inside ``local_map``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

AxisVal = Union[None, str, Tuple[str, ...]]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a dict that already is
    one (the estimator's meshes hold no devices)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass
class Rules:
    mesh: Any                      # a DeviceMesh, or {axis name: size}
    table: Dict[str, AxisVal] = field(default_factory=dict)

    def spec(self, *names: Optional[str]) -> Tuple[AxisVal, ...]:
        """The reference's ``PartitionSpec`` as a tuple: per tensor dim None,
        one mesh axis, or a tuple of them; a mesh axis is used once, by the
        first name that claims it."""
        axes = []
        used = set()
        for n in names:
            v = self.table.get(n) if n is not None else None
            if v is None:
                axes.append(None)
                continue
            vt = (v,) if isinstance(v, str) else tuple(v)
            vt = tuple(a for a in vt if a not in used)
            used.update(vt)
            if not vt:
                axes.append(None)
            elif len(vt) == 1:
                axes.append(vt[0])
            else:
                axes.append(vt)
        return tuple(axes)

    def placements(self, *names: Optional[str]) -> Tuple[Any, ...]:
        """``spec(*names)`` as DTensor placements, one per mesh dim."""
        return spec_placements(self.mesh, self.spec(*names))


def spec_placements(mesh, spec: Sequence[AxisVal]) -> Tuple[Any, ...]:
    """Placements of a spec tuple: ``Shard(d)`` on every mesh dim that
    tensor dim d is split over (a dim over two axes is split over both, the
    outer first, as the mesh orders them), ``Replicate()`` elsewhere."""
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


_TLS = threading.local()


def set_rules(rules: Optional[Rules]) -> None:
    _TLS.rules = rules


def get_rules() -> Optional[Rules]:
    return getattr(_TLS, "rules", None)


class use_rules:
    """Install ``rules`` for the block.  With rules, a plain tensor the
    model makes itself (positions, rotary tables, masks: the same on every
    rank) meets DTensors as a replicated one (``implicit_replication``)."""

    def __init__(self, rules: Optional[Rules]):
        self.rules = rules
        self.replicate = implicit_replication() if rules is not None else None

    def __enter__(self):
        self.prev = get_rules()
        set_rules(self.rules)
        if self.replicate is not None:
            self.replicate.__enter__()
        return self.rules

    def __exit__(self, *exc):
        if self.replicate is not None:
            self.replicate.__exit__(*exc)
        set_rules(self.prev)


def fit_spec(mesh, spec: Sequence[AxisVal], shape: Sequence[int]) -> Tuple[AxisVal, ...]:
    """``spec`` with each dim split only over the longest prefix of its axes
    whose sizes divide it (a decode step's one position is not split over
    a sequence axis)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        kept, n = [], 1
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            if dim % (n * sizes.get(a, 1)):
                break
            kept.append(a)
            n *= sizes.get(a, 1)
        out.append(None if not kept else kept[0] if len(kept) == 1 else tuple(kept))
    return tuple(out)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements the active rules give
    ``names`` (each dim split only as far as the mesh divides it:
    ``fit_spec``); the identity without rules or on a plain tensor."""
    rules = get_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    want = spec_placements(rules.mesh, fit_spec(rules.mesh, rules.spec(*names), x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gather_weights(tree):
    """A layer's weights as it computes with them (ZeRO-3): under rules,
    each DTensor leaf keeps only its splits over the tensor-parallel axis
    (the axis the rules give "ff", which ``activation_rules`` maps to the
    plan's ``tp_axis``); its other splits, FSDP's, are all-gathered for the
    use, and autograd reduce-scatters the gradient back onto them.  The
    identity without rules or on plain tensors."""
    rules = get_rules()
    if rules is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_weights(v) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    tp = rules.table.get("ff")
    names = list(axis_sizes(rules.mesh))
    keep = tuple(p if isinstance(p, Shard) and tp is not None and names[m] == tp
                 else Replicate() for m, p in enumerate(tree.placements))
    if tuple(tree.placements) == keep:
        return tree
    return tree.redistribute(tree.device_mesh, keep)


# ---------------------------------------------------------------------------
# Ops on local shards
# ---------------------------------------------------------------------------


def _shard_dim(p) -> Optional[int]:
    return p.dim if isinstance(p, Shard) else None


def local_call(fn: Callable, args: Sequence[torch.Tensor],
               dims: Sequence[Sequence[Optional[int]]],
               out_dims: Sequence[Sequence[Optional[int]]], **kwargs):
    """``fn(*local args, **kwargs)`` on each rank's shards of DTensor
    ``args``, its outputs DTensors again.

    Every operand names, per logical role (``dims[i][r]``: batch, heads,
    channels ...), the tensor dim that plays it, or None where it has no
    such dim; ``out_dims`` does the same for each output.  A mesh dim keeps
    its split only where every operand that has the role is ``Shard`` of
    that role's dim on it, and the dim's size divides evenly over the mesh
    dims that split it (so the op sees whole groups, e.g. query heads with
    their kv heads); every other split, and every ``Partial``, is
    redistributed to ``Replicate`` first.  Plain tensors call ``fn``
    directly."""
    sharded = [isinstance(a, DTensor) for a in args]
    if not any(sharded):
        return fn(*args, **kwargs)
    if not all(sharded):
        raise TypeError("local_call: operands must all be DTensors or all plain tensors")
    mesh = args[0].device_mesh
    n_roles = len(dims[0])
    keep = []  # per mesh dim: the role it splits, or None
    for m in range(mesh.ndim):
        role = None
        for r in range(n_roles):
            ok = all(dims[i][r] is None or _shard_dim(a.placements[m]) == dims[i][r]
                     for i, a in enumerate(args))
            if ok and any(dims[i][r] is not None for i in range(len(args))):
                role = r
                break
        keep.append(role)
    for r in range(n_roles):  # whole groups only: every split of a role even
        ways = 1
        for m in range(mesh.ndim):
            if keep[m] == r:
                ways *= mesh.size(m)
        if any(dims[i][r] is not None and a.shape[dims[i][r]] % ways
               for i, a in enumerate(args)):
            keep = [None if k == r else k for k in keep]

    def placements(role_dims):
        return tuple(Replicate() if k is None or role_dims[k] is None else Shard(role_dims[k])
                     for k in keep)

    in_p = tuple(placements(d) for d in dims)
    args = [a.redistribute(mesh, p) if tuple(a.placements) != p else a
            for a, p in zip(args, in_p)]
    out_p = tuple(placements(d) for d in out_dims)
    # local_map reads a tuple as one placement list per output: one output's
    # is passed as a list
    wrapped = local_map(lambda *a: fn(*a, **kwargs),
                        out_placements=out_p if len(out_p) > 1 else list(out_p[0]),
                        in_placements=in_p, device_mesh=mesh)
    return wrapped(*args)
