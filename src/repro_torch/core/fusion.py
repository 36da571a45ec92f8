"""Operator fusion for GraphArrays (beyond-paper; the paper lists "reducing
RFC overhead by introducing operator fusion" as future work, §9).

Chains of unary / scalar block ops are collapsed into a single ``fused``
block-level op, reducing the number of remote function calls (the γ dispatch
term of §7) by the chain length without changing placement semantics: a fused
chain has a single operand, hence a single placement option, exactly like the
unary vertex it replaces.

Chain semantics live in ``graph_array.apply_chain``: the numpy backend
interprets the chain step by step, while the torch/cuda backends
(``repro_torch.backend``) run the same chain through one memoized callable
over torch op tables, so a fused vertex is one dispatch per block.

Already-``fused`` children (from a previous ``fuse_graph`` pass over a
shared, not-yet-computed subgraph) are inlined and the walk *continues*
below them, so a chain interrupted by earlier fusion boundaries still
collapses to one vertex.  Absorbed vertices are detached from their
children's parent lists — a dangling parent link would otherwise let the
scheduler's ``_wake_parents`` resurrect a dead vertex as frontier work (a
wasted RFC), and it would pessimize the single-parent fusability test for
later passes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .graph_array import GraphArray, Vertex

_FUSABLE = {"neg", "exp", "log", "sqrt", "abs", "square", "sigmoid", "tanh",
            "identity", "relu", "rsqrt", "reciprocal"}


def _chain_step(v: Vertex) -> Tuple:
    if v.op == "scalar":
        return ("scalar", v.meta["op"], v.meta["scalar"], bool(v.meta.get("reverse")))
    return ("unary", v.op)


def _fusable(v: Vertex) -> bool:
    return v.kind == "op" and (v.op in _FUSABLE or v.op == "scalar")


def fuse_graph(ga: GraphArray) -> int:
    """In-place fusion over every block subgraph.  Returns the number of
    vertices eliminated."""
    eliminated = 0
    seen: Dict[int, bool] = {}

    def walk(v: Vertex) -> None:
        nonlocal eliminated
        if v.vid in seen:
            return
        seen[v.vid] = True
        # First fuse descendants so chains are maximal.
        for c in list(v.children):
            walk(c)
        if not _fusable(v):
            return
        # collapse v's child chain into v, inlining already-fused children
        # and continuing below them (no break: trailing chains collapse too)
        chain: List[Tuple] = [_chain_step(v)]
        absorbed: List[Vertex] = []
        cur = v.children[0]
        while len(cur.parents) == 1 and cur.kind == "op" and (_fusable(cur) or cur.op == "fused"):
            if cur.op == "fused":
                chain.extend(reversed(cur.meta["chain"]))
            else:
                chain.append(_chain_step(cur))
            eliminated += 1
            absorbed.append(cur)
            cur = cur.children[0]
        if len(chain) == 1:
            return
        chain.reverse()  # apply bottom-up
        old_child = v.children[0]
        v.op = "fused"
        # a tuple (not list) chain keeps the meta hashable, so the plan
        # fingerprint can memoize it
        v.meta = {"chain": tuple(chain)}
        v.children = [cur]
        if v in old_child.parents:
            old_child.parents.remove(v)
        # detach absorbed vertices so they can never re-enter the frontier
        for a in absorbed:
            for c in a.children:
                if a in c.parents:
                    c.parents.remove(a)
        if v not in cur.parents:
            cur.parents.append(v)

    for idx in ga.grid.iter_indices():
        walk(ga.block(idx))
    return eliminated
