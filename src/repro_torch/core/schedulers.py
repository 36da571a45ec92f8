"""Schedulers: LSHS (paper §5, Alg. 1) and dynamic baselines for the ablation.

LSHS executes a GraphArray by sequentially scheduling *frontier* vertices
(operation vertices all of whose children are leaves).  A vertex is sampled
from the frontier; every placement option is simulated against the
ClusterState (in one vectorized pass, ``ClusterState.simulate_cost_batch``);
the option minimizing Eq. 2 is chosen; the GraphArray is transitioned
(Reduce vertices update their remaining operands, op vertices become leaves)
and the block operation is dispatched to the executor.

The final operation of every output subgraph is forced onto the node given by
the hierarchical data layout, so every scheduled GraphArray ends up with a
hierarchical layout (paper §5: "implicitly handled within the transition
function").

A cold run may be captured by a ``plan.PlanRecorder`` (the ``recorder``
hooks below): every dispatch and alias decision is recorded in canonical
vertex-id space so a structurally identical problem can later skip this
module entirely and be replayed by ``plan.replay_plan``.
"""
from __future__ import annotations

import random
from time import perf_counter
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .cluster import ClusterState
from .graph_array import Vertex


class _Frontier:
    """Uniform O(1) sampling and O(1) removal over the scheduling frontier.

    Replaces the seed's per-step ``sorted(frontier)`` (an O(F log F) resort
    on every scheduling step, O(V·F log F) per schedule): vertices live in a
    flat list with a vid->index map, removal swaps with the tail, and
    sampling indexes the list directly.  Membership adds are idempotent, so
    ``_wake_parents`` may offer the same parent repeatedly."""

    __slots__ = ("_items", "_pos")

    def __init__(self):
        self._items: List[Vertex] = []
        self._pos: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, vid: int) -> bool:
        return vid in self._pos

    def add(self, v: Vertex) -> None:
        if v.vid not in self._pos:
            self._pos[v.vid] = len(self._items)
            self._items.append(v)

    def sample(self, rng: random.Random) -> Vertex:
        return self._items[rng.randrange(len(self._items))]

    def remove(self, vid: int) -> None:
        i = self._pos.pop(vid)
        last = self._items.pop()
        if i < len(self._items):
            self._items[i] = last
            self._pos[last.vid] = i


class SchedulerBase:
    name = "base"

    def schedule(
        self,
        roots: Sequence[Vertex],
        forced: Dict[int, Tuple[int, int]],
        state: ClusterState,
        executor,
        rng: random.Random,
        recorder=None,
        stats=None,
    ) -> None:
        frontier = _Frontier()
        visited: Set[int] = set()

        def visit(v: Vertex) -> None:
            if v.vid in visited:
                return
            visited.add(v.vid)
            for c in v.children:
                visit(c)
            if v.kind != "leaf" and v.ready():
                frontier.add(v)

        for r in roots:
            visit(r)

        while frontier:
            v = frontier.sample(rng)
            if v.kind == "reduce" and len(v.children) > 2:
                self._reduce_step(v, forced, state, executor, rng, recorder, stats)
                # v stays on the frontier until it collapses to a leaf
                if v.kind == "leaf":
                    frontier.remove(v.vid)
                    self._wake_parents(v, frontier)
                continue
            frontier.remove(v.vid)
            if v.kind == "reduce":
                # 1 or 2 children left: the final add IS this vertex's output
                self._finalize_reduce(v, forced, state, executor, rng, recorder, stats)
            else:
                self._place_op(v, forced, state, executor, rng, recorder, stats)
            self._wake_parents(v, frontier)

    # -- shared helpers ------------------------------------------------------
    def _wake_parents(self, v: Vertex, frontier: _Frontier) -> None:
        for p in v.parents:
            if p.kind != "leaf" and p.ready():
                frontier.add(p)

    def _dispatch(
        self,
        v: Vertex,
        node: int,
        state: ClusterState,
        executor,
        worker: Optional[int] = None,
        recorder=None,
        stats=None,
        n_options: int = 1,
    ) -> Tuple[int, int]:
        in_ids = [c.vid for c in v.children]
        if worker is None:
            worker = state.pick_worker(node)
        if recorder is not None:
            recorder.dispatched(v, node, worker)
        if executor.tracer is not None:
            # deferred args tuple (FlightRecorder._materialize builds the dict)
            executor.tracer.record("sched", v.op or "add", node, worker,
                                   0.0, 0.0, (v.vid, n_options))
        t0 = perf_counter() if stats is not None else 0.0
        eta = state.transition(node, v.vid, v.elements, in_ids, worker=worker,
                               kind=v.op)
        executor.run_op(v.vid, v.op, v.meta, in_ids, (node, worker), eta=eta)
        # the vertex object is the reachability root for its block: while any
        # leaf referencing the vid is alive the block stays resident (GC)
        executor.note_handle(v)
        if stats is not None:
            stats.dispatch_s += perf_counter() - t0
        return node, worker

    def _placement_options(self, v: Vertex, state: ClusterState) -> List[int]:
        """Paper §4 last ¶: unary-like ops have a single option; binary
        elementwise on co-located operands collapses to one option; algebra
        ops — and ``concat_blocks`` assembly vertices from the reshard
        subsystem, whose pieces may be cached on several nodes — offer the
        union of all nodes on which any operand resides."""
        homes = [state.home[c.vid][0] for c in v.children]
        if v.op in ("matmul", "tensordot", "einsum", "concat_blocks"):
            opts: Set[int] = set()
            for c in v.children:
                opts |= state.nodes_of(c.vid)
            return sorted(opts)
        if len(set(homes)) == 1:
            return [homes[0]]
        return sorted(set(homes))

    def _choose(
        self, v: Vertex, options: Sequence[int], state: ClusterState, rng: random.Random
    ) -> int:
        raise NotImplementedError

    # -- vertex handlers -------------------------------------------------------
    def _place_op(self, v, forced, state, executor, rng, recorder=None, stats=None) -> None:
        if v.vid in forced:
            node, worker = forced[v.vid]
            n_options = 1
        else:
            options = self._placement_options(v, state)
            node = self._choose(v, options, state, rng)
            worker = None
            n_options = len(options)
        node, worker = self._dispatch(v, node, state, executor, worker,
                                      recorder, stats, n_options=n_options)
        v.to_leaf(node, worker)

    def _pair(self, v: Vertex, rng: random.Random) -> Tuple[Vertex, Vertex]:
        """Locality pairing (paper §4): same worker first, then same node;
        cross-node operands are paired FIFO (new partials append to the end of
        the child list), which yields the balanced tree reduce of §8.4."""
        by_worker: Dict[Tuple[int, int], List[Vertex]] = {}
        by_node: Dict[int, List[Vertex]] = {}
        for c in v.children:
            by_worker.setdefault(c.placement, []).append(c)
            by_node.setdefault(c.placement[0], []).append(c)
        for group in by_worker.values():
            if len(group) >= 2:
                return group[0], group[1]
        for group in by_node.values():
            if len(group) >= 2:
                return group[0], group[1]
        return v.children[0], v.children[1]

    def _reduce_step(self, v, forced, state, executor, rng, recorder=None, stats=None) -> None:
        a, b = self._pair(v, rng)
        tmp = Vertex("op", v.op or "add", a.shape, [a, b])
        # tmp was appended as a parent of a/b; it replaces them inside v
        options = sorted(state.nodes_of(a.vid) | state.nodes_of(b.vid))
        if getattr(self, "dest_hint", False) and "dest" in v.meta:
            options = sorted(set(options) | {v.meta["dest"]})
        node = self._choose(tmp, options, state, rng)
        node, worker = self._dispatch(tmp, node, state, executor,
                                      recorder=recorder, stats=stats,
                                      n_options=len(options))
        tmp.to_leaf(node, worker)
        kids = [c for c in v.children if c is not a and c is not b]
        kids.append(tmp)
        v.children = kids
        if len(v.children) == 1:
            only = v.children[0]
            # alias: the reduce's output is its single remaining child
            executor.alias(v.vid, only.vid)
            state.add_object(v.vid, only.placement[0], only.placement[1],
                             v.elements, ready_of=only.vid)
            if recorder is not None:
                recorder.aliased(v, only)
            v.to_leaf(*only.placement)
            executor.note_handle(v)

    def _finalize_reduce(self, v, forced, state, executor, rng, recorder=None, stats=None) -> None:
        if len(v.children) == 1:
            only = v.children[0]
            executor.alias(v.vid, only.vid)
            state.add_object(v.vid, only.placement[0], only.placement[1],
                             v.elements, ready_of=only.vid)
            if recorder is not None:
                recorder.aliased(v, only)
            v.to_leaf(*only.placement)
            executor.note_handle(v)
            return
        if v.vid in forced:
            node, worker = forced[v.vid]
            n_options = 1
        else:
            a, b = v.children
            options = sorted(state.nodes_of(a.vid) | state.nodes_of(b.vid))
            node = self._choose(v, options, state, rng)
            worker = None
            n_options = len(options)
        v.op = v.op or "add"
        node, worker = self._dispatch(v, node, state, executor, worker,
                                      recorder, stats, n_options=n_options)
        v.to_leaf(node, worker)


class LSHS(SchedulerBase):
    """Load Simulated Hierarchical Scheduling (Alg. 1): greedy argmin of the
    Eq. 2 objective over the vertex's placement options.  Ties are broken by
    least transferred bytes, then by earliest estimated finish time on the
    pipelined clock track (overlap-aware: prefers nodes whose workers and
    links free up soonest), then by least node load.

    All options are scored in one vectorized pass
    (``ClusterState.simulate_cost_batch``); the stable lexsort reproduces the
    removed per-option Python loop's first-strictly-smaller-key argmin
    exactly, including its lowest-node-id tie rule.

    ``dest_hint=True`` (beyond-paper, "LSHS+") additionally offers each
    algebra/reduce vertex its output subgraph's final layout node as a
    placement option, letting the greedy discover output-stationary
    schedules (SUMMA-like) when they win on cost.
    """

    name = "lshs"

    def __init__(self, dest_hint: bool = False):
        self.dest_hint = dest_hint

    def _placement_options(self, v, state):
        opts = super()._placement_options(v, state)
        if self.dest_hint and "dest" in v.meta and len(opts) > 1:
            opts = sorted(set(opts) | {v.meta["dest"]})
        return opts

    def _choose(self, v, options, state, rng):
        if len(options) == 1:
            return options[0]
        in_ids = [c.vid for c in v.children]
        objective, moved, est, load = state.simulate_cost_batch(
            options, v.elements, in_ids, kind=v.op)
        # min over lexicographic keys returns the first minimum, matching the
        # scalar loop's strict-< update rule (lowest option index on ties)
        keys = zip(objective.tolist(), moved.tolist(), est.tolist(), load.tolist())
        return options[min(enumerate(keys), key=lambda t: t[1])[0]]


class RoundRobinScheduler(SchedulerBase):
    """Dask-like baseline: independent tasks round-robin over nodes,
    locality-blind (placement options are ignored)."""

    name = "roundrobin"

    def __init__(self, k: int):
        self.k = k
        self._i = 0

    def _choose(self, v, options, state, rng):
        node = self._i % self.k
        self._i += 1
        return node

    def _placement_options(self, v, state):  # all nodes are fair game
        return list(range(state.k))

    def _pair(self, v, rng):  # locality-blind pairing (paper §8.1 Dask note)
        return v.children[0], v.children[1]


class DynamicScheduler(SchedulerBase):
    """Ray-like baseline: place on the node with least memory load,
    ignoring data locality (bottom-up heuristic, paper §2/§8.5)."""

    name = "dynamic"

    def _choose(self, v, options, state, rng):
        from .cluster import MEM

        loads = state.S[:, MEM]
        return int(np.argmin(loads))

    def _placement_options(self, v, state):
        return list(range(state.k))

    def _pair(self, v, rng):
        return v.children[0], v.children[1]


def chaos_placement(state: ClusterState, engine, op,
                    candidates: Sequence[int]) -> int:
    """Runtime re-placement under chaos (speculative duplicates, dead-node
    re-routing, escalated retries, lineage replays): candidate nodes are
    scored with the *same* vectorized LSHS cost pass cold scheduling uses
    (``ClusterState.simulate_cost_batch`` — Eq. 2 objective, then moved
    bytes), with the chaos clocks' projected finish as the leading key so a
    straggling or congested survivor loses to an equally-cheap healthy one.
    Speculation options thereby flow through the LSHS cost simulation rather
    than a separate heuristic.  Deterministic: ties fall to the lowest node
    id, and every input is simulated state."""
    if len(candidates) == 1:
        return candidates[0]
    ex = engine.executor
    in_ids = [ex.resolve(i) for i in op.in_ids]
    known = [i for i in in_ids if i in state.M]
    shape = ex.shapes.get(op.out_id)
    out_elements = int(np.prod(shape)) if shape else 1
    objective, moved, _est, load = state.simulate_cost_batch(
        candidates, out_elements, known, kind=getattr(op, "op", None))
    proj = [engine.project(op, placement=(c, None)) for c in candidates]
    keys = zip(proj, objective.tolist(), moved.tolist(), load.tolist(),
               candidates)
    return candidates[min(enumerate(keys), key=lambda t: t[1])[0]]


def make_scheduler(name: str, k: int) -> SchedulerBase:
    if name == "lshs":
        return LSHS()
    if name == "lshs+":
        return LSHS(dest_hint=True)
    if name == "roundrobin":
        return RoundRobinScheduler(k)
    if name == "dynamic":
        return DynamicScheduler()
    raise ValueError(f"unknown scheduler {name!r}")
