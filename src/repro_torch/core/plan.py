"""Scheduling-plan cache: schedule once, replay forever (paper §7).

The paper's overhead analysis identifies per-operation system overhead — the
γ dispatch term — as the scalability limiter once block placement is good,
and every flagship workload (logistic regression, Newton's method, the
tensor-factorization inner loop) re-builds and re-schedules a *structurally
identical* block graph each iteration.  This module amortizes that repeated
scheduling tax:

* ``fingerprint`` computes a canonical *structural fingerprint* of one
  GraphArray scheduling problem: graph topology (preorder DFS with
  back-references), op kinds and metadata, block shapes, leaf placements and
  residency sets, forced output placements, plus the cluster/scheduler
  configuration signature.  Two problems with equal fingerprints present the
  scheduler with byte-for-byte the same decision input.
* ``PlanRecorder`` captures the (vertex, node, worker) decision sequence of
  one cold scheduler run in canonical-vertex-id space, including the
  temporary partial-sum vertices a reduce materializes and the alias
  collapses at the end of each reduction tree.
* ``replay_plan`` applies a recorded plan to a *new* (structurally
  identical) graph: it still drives ``ClusterState.transition`` and
  ``Executor.run_op`` for every op — so load accounting, the dual clock
  tracks, pipelined dispatch queues, and fault-tolerance lineage stay
  exactly as they would after a cold schedule — while skipping frontier
  management, placement-option enumeration, cost simulation, and reduce
  pairing entirely.

Replay correctness does not depend on the cluster's drifted load state: the
plan fixes the reduction-tree *structure* (which determines floating-point
summation order, hence values) and the placements (which determine loads).
A replayed schedule is bit-identical to the run that recorded it; staleness
can only cost placement *quality*, the classic plan-cache trade-off, and a
changed structure (block shape, cluster size, leaf placement, scheduler)
changes the fingerprint and misses the cache.

``ArrayContext.compute`` additionally seeds the frontier-sampling RNG from
the fingerprint and resets the worker round-robin cursor per schedule, so
cold scheduling is deterministic given (structure, current load state).  On
structurally repeating loops — where per-iteration load growth is symmetric
enough that no cost argmin flips — a cold re-schedule therefore repeats the
recorded decisions exactly, which is what makes plan_cache=True runs
bit-identical to plan_cache=False runs on the iterative GLM/Newton
workloads (regression-tested).  If load drift *does* flip an argmin, a cold
schedule may pick different placements (and hence a different, equally
valid summation order) than the replayed plan; replay itself stays
deterministic and correct either way.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph_array import Vertex, _next_id

# step tags (plain ints keep plan steps as small tuples)
_OP, _TEMP, _ALIAS = 0, 1, 2


class _Interner(dict):
    """Strings -> small ints, stable for the lifetime of the process (ids are
    assigned in first-seen order, independent of str-hash randomization)."""

    def __missing__(self, key: str) -> int:
        v = len(self) + 1
        self[key] = v
        return v


_intern = _Interner()


@dataclass
class Fingerprint:
    """Canonicalization of one scheduling problem.

    ``key`` is the full structural token stream as a flat int tuple — the
    plan-cache key (tuple hashing/equality run at C speed, and int-tuple
    hashes are deterministic across processes).  ``verts`` maps canonical
    id -> Vertex for the graph it was computed over (replay uses it to
    translate a recorded plan onto a new, structurally identical graph);
    ``cid_of`` is the inverse vid map.
    """

    key: Tuple[int, ...]
    verts: List[Vertex]
    cid_of: Dict[int, int]
    # intern-free structural summary: seeds the frontier-sampling RNG, so the
    # sampling stream is a pure function of (context seed, problem structure)
    # — stable across processes and graph-construction orders, unlike
    # hash(key), whose interned op ids depend on first-seen order
    rng_key: int = 0


def fingerprint(roots: Sequence[Vertex], forced: Dict[int, Tuple[int, int]],
                state, config_sig: int) -> Fingerprint:
    """Structural fingerprint of ``schedule(roots, forced, state)``.

    Preorder DFS; revisited vertices encode as back-references, so the DAG
    shape (shared subexpressions included) is captured exactly.  Leaves
    contribute their shape, placement, and residency set (the node copies
    ``state.M`` knows about — more copies mean more placement options, so
    residency is part of the problem).  Op/reduce vertices contribute op
    kind, canonical metadata (minus the layout-derived ``dest`` annotation,
    which is re-derivable from ``forced``), and child count; op shapes are
    omitted because ``infer_shape`` derives them deterministically from leaf
    shapes, topology, and metadata.

    One composite token per vertex (tuples concatenate and hash at C speed;
    strings and floats are interned to ints, so key hashes are
    process-stable).  Every token kind starts with a distinct tag, so the
    stream is prefix-decodable and distinct problems get distinct keys.
    """
    toks: list = [config_sig or 0]
    ap = toks.append
    cid_of: Dict[int, int] = {}
    setdef = cid_of.setdefault
    verts: List[Vertex] = []
    intern = _intern
    meta_memo = _META_MEMO
    M = state.M
    stack = list(reversed(roots))
    pop = stack.pop
    n_leaves = 0
    n_edges = 0
    while stack:
        v = pop()
        nv = len(verts)
        cid = setdef(v.vid, nv)
        if cid != nv:  # back-reference: shared subexpression
            ap(~cid)
            continue
        verts.append(v)
        if v.kind == "leaf":
            n_leaves += 1
            # leaf tokens are cached on the vertex: shape and placement are
            # immutable once a block is a leaf, and persistent operands (the
            # X blocks of an iterative loop) are re-fingerprinted many times
            t = v.ftok
            if t is None:
                t = (-1,) + (v.placement or (-1, -1)) + v.shape
                v.ftok = t
            ap(t)
            res = M.get(v.vid)
            if res is not None and len(res) > 1:
                ap((-3,) + tuple(sorted(res)))
        else:
            children = v.children
            nc = len(children)
            n_edges += nc
            ap((-4 if v.kind == "op" else -5, intern[v.op], nc))
            meta = v.meta
            if meta:
                # memo canonical meta tokens by (keys, values, value types)
                # — the handful of distinct op metadatas (matmul transpose
                # flags, scalar constants) recur thousands of times; the
                # type tuple keeps 1 / 1.0 / True from sharing an entry
                # (equal under ==, but _hashable type-tags them apart)
                try:
                    vals = tuple(meta.values())
                    mk = (tuple(meta), vals, tuple(map(type, vals)))
                    mt = meta_memo.get(mk)
                    if mt is None:
                        mt = _meta_token(meta)
                        meta_memo[mk] = mt
                except TypeError:  # unhashable value (e.g. fused chain list)
                    mt = _meta_token(meta)
                if mt:
                    ap(mt)
            if nc == 1:
                stack.append(children[0])
            elif nc == 2:
                stack.append(children[1])
                stack.append(children[0])
            else:
                stack.extend(reversed(children))
    for r in roots:
        f = forced.get(r.vid)
        if f is not None:
            ap((-6, cid_of[r.vid]) + f)
    rng_key = _rng_key(len(verts), n_leaves, n_edges)
    return Fingerprint(tuple(toks), verts, cid_of, rng_key)


def _rng_key(n_verts: int, n_leaves: int, n_edges: int) -> int:
    return (n_verts * 1000003 + n_leaves * 8191 + n_edges) * 2654435761


def structure_counts(roots: Sequence[Vertex]) -> int:
    """``Fingerprint.rng_key`` without building the token stream.

    The ``plan_cache=False`` path only needs the structural RNG seed, not a
    cache key, so it skips token construction, interning, metadata
    canonicalization and residency sorting.  MUST count exactly what
    ``fingerprint`` counts — cache-on and cache-off runs of the same problem
    have to draw the same sampling stream for their schedules (and hence
    their outputs) to coincide; the shared-key regression tests guard this.
    """
    seen = set()
    add = seen.add
    stack = list(roots)
    pop = stack.pop
    n_verts = n_leaves = n_edges = 0
    while stack:
        v = pop()
        vid = v.vid
        if vid in seen:
            continue
        add(vid)
        n_verts += 1
        if v.kind == "leaf":
            n_leaves += 1
        else:
            children = v.children
            n_edges += len(children)
            stack.extend(children)
    return _rng_key(n_verts, n_leaves, n_edges)


# derived-value memo; bounded (unlike _intern it is safe to clear: values
# are pure functions of the keys, so a rebuilt entry is identical)
_META_MEMO: Dict[tuple, tuple] = {}
_META_MEMO_MAX = 4096


def _meta_token(meta: Dict) -> tuple:
    """Canonical hashable token for a vertex's metadata (minus ``dest``)."""
    if len(_META_MEMO) > _META_MEMO_MAX:
        _META_MEMO.clear()
    return tuple(
        ((_intern[k], _hashable(meta[k])) for k in sorted(meta) if k != "dest")
    )


def _hashable(val):
    """Metadata value -> hashable token (type-tagged).  Floats embed their
    value directly (float hashing is deterministic, and interning their
    reprs would grow the intern table without bound on workloads with
    varying scalar constants); only strings — a finite set of op/key names
    — go through the interner."""
    if isinstance(val, (bool, int)):
        return val
    if isinstance(val, np.integer):  # reshard offsets etc. may be numpy ints
        return int(val)
    if isinstance(val, float):
        return (-13, val)
    if isinstance(val, str):
        return (-14, _intern[val])
    if val is None:
        return (-15,)
    if isinstance(val, (tuple, list)):
        return (-16,) + tuple(_hashable(x) for x in val)
    return (-18, _intern[repr(val)])


@dataclass
class PlacementPlan:
    """The decision record of one scheduler run, in canonical-id space.

    Steps (tuples, in dispatch order; ``pl`` is a (node, worker) pair):
      (0, cid, in_cids, pl, elements)       op / reduce-final dispatch
      (1, cid, op, in_cids, pl, elements)   scheduler-created reduce partial
      (2, cid, src_cid, pl, elements)       reduce alias collapse
    """

    n_struct: int                  # canonical ids [0, n_struct) are graph vertices
    n_total: int                   # including scheduler-created temporaries
    steps: List[tuple] = field(default_factory=list)

    @property
    def n_ops(self) -> int:
        return sum(1 for s in self.steps if s[0] != _ALIAS)


class PlanRecorder:
    """Hooks called by ``SchedulerBase`` during a cold run to capture the
    plan.  Temporary reduce partials get fresh canonical ids in creation
    order — replay re-creates them in the same order, so ids line up."""

    def __init__(self, cid_of: Dict[int, int]):
        self.cid_of = dict(cid_of)
        self.n_struct = len(cid_of)
        self._next = self.n_struct
        self.steps: List[tuple] = []

    def dispatched(self, v: Vertex, node: int, worker: int) -> None:
        cid_of = self.cid_of
        cid = cid_of.get(v.vid)
        in_cids = tuple([cid_of[c.vid] for c in v.children])
        if cid is None:  # scheduler-created reduce partial
            cid = self._next
            self._next += 1
            cid_of[v.vid] = cid
            self.steps.append((_TEMP, cid, v.op, in_cids, (node, worker), v.elements))
        else:
            self.steps.append((_OP, cid, in_cids, (node, worker), v.elements))

    def aliased(self, v: Vertex, only: Vertex) -> None:
        self.steps.append((_ALIAS, self.cid_of[v.vid], self.cid_of[only.vid],
                           only.placement, v.elements))

    def plan(self) -> PlacementPlan:
        return PlacementPlan(self.n_struct, self._next, self.steps)


def replay_plan(plan: PlacementPlan, verts: List[Vertex], state, executor,
                stats: Optional["SchedStats"] = None) -> None:
    """Apply a recorded plan to a structurally identical graph.

    Every op still flows through ``state.transition`` (load matrix, clock
    tracks, transfer records) and ``executor.run_op`` (dispatch, lineage,
    pipelined queues), in the recorded dispatch order, so post-replay cluster
    and executor state match a cold schedule of the same problem exactly.
    """
    vid_of = [v.vid for v in verts]
    vid_of.extend([0] * (plan.n_total - plan.n_struct))
    transition = state.transition
    run_op = executor.run_op
    dispatch_s = 0.0
    for step in plan.steps:
        tag = step[0]
        if tag == _OP:
            _tag, cid, in_cids, pl, elements = step
            v = verts[cid]
            out_vid, op, meta = v.vid, v.op, v.meta
        elif tag == _TEMP:
            _tag, cid, op, in_cids, pl, elements = step
            out_vid = _next_id()
            vid_of[cid] = out_vid
            v, meta = None, {}
        else:  # _ALIAS
            _tag, cid, src_cid, pl, elements = step
            v = verts[cid]
            src_vid = vid_of[src_cid]
            executor.alias(v.vid, src_vid)
            state.add_object(v.vid, pl[0], pl[1], elements, ready_of=src_vid)
            v.to_leaf(pl[0], pl[1])
            executor.note_handle(v)
            continue
        in_vids = [vid_of[c] for c in in_cids]
        t0 = perf_counter()
        eta = transition(pl[0], out_vid, elements, in_vids, worker=pl[1],
                         kind=op)
        run_op(out_vid, op, meta, in_vids, pl, eta=eta)
        dispatch_s += perf_counter() - t0
        if v is not None:
            v.to_leaf(pl[0], pl[1])
            # same reachability root the cold path registers in _dispatch;
            # replay temporaries have no vertex and free on last-consumer
            # retire instead
            executor.note_handle(v)
    if stats is not None:
        stats.dispatch_s += dispatch_s


class PlanCache:
    """LRU cache fingerprint-key -> PlacementPlan.

    Invalidation is implicit: any structural change (block shape, grid,
    cluster size, leaf placement or residency, scheduler, seed, op metadata)
    changes the fingerprint, so a stale plan is simply never looked up.  A
    cache may be shared between contexts with compatible configuration —
    the configuration signature is folded into every key.
    """

    def __init__(self, max_plans: int = 256):
        self.max_plans = max_plans
        self._plans: "OrderedDict[Tuple[int, ...], PlacementPlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._plans)

    def get(self, key) -> Optional[PlacementPlan]:
        plan = self._plans.get(key)
        if plan is None:
            self.misses += 1
            return None
        self._plans.move_to_end(key)
        self.hits += 1
        return plan

    def put(self, key, plan: PlacementPlan) -> None:
        self._plans[key] = plan
        self._plans.move_to_end(key)
        if len(self._plans) > self.max_plans:
            self._plans.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._plans.clear()

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclass
class SchedStats:
    """Per-context scheduling cost accounting (always on).

    ``dispatch_s`` is the time inside ``transition`` + ``run_op`` — the γ
    term — on both the cold and the replay path; everything else a schedule
    spends (frontier, option enumeration, cost simulation, pairing,
    fingerprinting, plan walking) is *scheduling overhead*, the quantity the
    plan cache amortizes.
    """

    computes: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    fingerprint_s: float = 0.0
    sched_cold_s: float = 0.0   # wall time of cold schedule() calls (incl dispatch)
    replay_s: float = 0.0       # wall time of plan replays (incl dispatch)
    dispatch_s: float = 0.0     # transition + run_op time inside either path
    # pipelined-drain wall time (``Executor.flush``): ``run_op`` only
    # *enqueues* in pipelined mode, so dispatch_s alone under-reports what
    # dispatch actually costs — the queue drain is accounted here, refreshed
    # by ``note_exec`` (``ArrayContext.loads`` calls it)
    drain_s: float = 0.0
    # reshard subsystem accounting (``core.reshard``): move-graph schedules,
    # move ops emitted, and the network elements those schedules transferred
    reshards: int = 0
    reshard_ops: int = 0
    reshard_moved_elements: float = 0.0
    # communication-bound accounting (``core.bounds`` moved-element floors):
    # per linalg op, the measured ``ClusterState`` network elements a
    # scheduled subgraph moved, the matching lower bound, and their ratio —
    # the CI-gated comm-avoidance metric
    comm_moved: Dict[str, float] = field(default_factory=dict)
    comm_lower: Dict[str, float] = field(default_factory=dict)
    comm_ratios: Dict[str, float] = field(default_factory=dict)
    # memory-budget accounting (``core.memory``): the manager's snapshot —
    # watermarks, per-node peak residency, GC/spill/backpressure counters —
    # refreshed by ``note_memory`` (``ArrayContext.loads`` calls it)
    mem: Dict[str, float] = field(default_factory=dict)

    def note_comm(self, op: str, moved_elements: float,
                  lower_elements: float) -> None:
        """Record one op's measured network elements against its
        moved-element floor (``bounds.comm_ratio``); repeated calls for the
        same op accumulate both sides so iterative loops report an overall
        ratio rather than the last iteration's."""
        from .bounds import comm_ratio
        self.comm_moved[op] = self.comm_moved.get(op, 0.0) + float(moved_elements)
        self.comm_lower[op] = self.comm_lower.get(op, 0.0) + float(lower_elements)
        self.comm_ratios[op] = comm_ratio(self.comm_moved[op], self.comm_lower[op])

    def note_exec(self, exec_stats) -> None:
        """Refresh the pipelined-drain time from an ``ExecStats`` (wall time
        inside ``Executor.flush``; 0 for sync contexts)."""
        self.drain_s = exec_stats.drain_s

    def note_memory(self, manager) -> None:
        """Refresh the memory-budget counters from a ``MemoryManager``."""
        self.mem = manager.snapshot()

    @property
    def scheduling_overhead_s(self) -> float:
        return self.fingerprint_s + self.sched_cold_s + self.replay_s - self.dispatch_s

    def hit_rate(self) -> float:
        total = self.plan_hits + self.plan_misses
        return self.plan_hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "computes": self.computes,
            "plan_hits": self.plan_hits,
            "plan_misses": self.plan_misses,
            "plan_hit_rate": self.hit_rate(),
            "fingerprint_s": self.fingerprint_s,
            "sched_cold_s": self.sched_cold_s,
            "replay_s": self.replay_s,
            "dispatch_s": self.dispatch_s,
            "drain_s": self.drain_s,
            "sched_overhead_s": self.scheduling_overhead_s,
            "reshards": self.reshards,
            "reshard_ops": self.reshard_ops,
            "reshard_moved_elements": self.reshard_moved_elements,
        }
        for op in self.comm_ratios:
            out[f"comm_moved_{op}"] = self.comm_moved[op]
            out[f"comm_lower_{op}"] = self.comm_lower[op]
            out[f"comm_ratio_{op}"] = self.comm_ratios[op]
        out.update(self.mem)
        return out

    def reset(self) -> None:
        self.computes = 0
        self.plan_hits = 0
        self.plan_misses = 0
        self.fingerprint_s = 0.0
        self.sched_cold_s = 0.0
        self.replay_s = 0.0
        self.dispatch_s = 0.0
        self.drain_s = 0.0
        self.reshards = 0
        self.reshard_ops = 0
        self.reshard_moved_elements = 0.0
        self.comm_moved.clear()
        self.comm_lower.clear()
        self.comm_ratios.clear()
        self.mem = {}
