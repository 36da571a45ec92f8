"""Chaos runtime: seeded, deterministic fault injection for the live executor.

The ROADMAP's "elastic autoscaling + straggler scenarios under load" item:
instead of fault tolerance living only in hand-driven tests
(``Executor.fail_node``/``recover``) and passive post-hoc models
(``core.straggler``, ``core.elastic``), a ``ChaosEngine`` attached to an
``ArrayContext`` injects faults *while the pipelined event loop runs*:

* **stragglers** — per-node compute slowdown factors on the engine's own
  ``WorkerClocks`` track (``WorkerClocks.set_chaos``);
* **link degradation** — a global transfer-time multiplier (the α-β-γ view is
  ``bounds.CommModel.degraded``);
* **transient op faults** — each dispatch draws a seeded number of failed
  attempts; the executor retries with exponential backoff up to the
  ``RetryPolicy`` budget, then escalates by migrating the op to the best
  surviving node;
* **node death at simulated time t** — the first time the drain would start
  an op on the node at or after *t* (or at end of drain if *t* falls inside
  the drain's makespan), the node is killed: its blocks are dropped
  (``Executor._drop_node_blocks``), lost blocks are eagerly replayed from
  lineage on survivors, and queued ops stranded on the node are re-routed;
* **speculative re-execution** — ``core.straggler``'s model moved into the
  live drain: a ready op whose chaos-projected finish exceeds ``threshold``×
  the median is offered a duplicate on the best surviving node (placement
  scored by the same vectorized LSHS cost pass cold scheduling uses, via
  ``schedulers.chaos_placement``); the projected first finisher wins and the
  loser is cancelled before it charges any clock.

**Bit-identity invariant.**  The engine never perturbs scheduling: LSHS plans
against the *nominal* clock tracks, so placements, reduce-tree pairing —
and therefore float summation order and output bits — are identical with
chaos on or off.  Chaos only changes where and when *pure* block ops execute
at drain time (retry, speculation, re-routing, lineage replay), which cannot
change values.  Corollary determinism contract: same seed + same ChaosPlan ⇒
same schedule, same retry counts, same speculation decisions, same chaos
makespan — across runs and across backends.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from . import bounds
from .cluster import WorkerClocks


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential-backoff budget for transient op faults: failed attempt
    ``a`` (0-based) waits ``backoff_base * backoff_factor**a`` simulated
    seconds before retrying; more than ``max_retries`` failures escalates
    (the op migrates to the best surviving node for its final attempt).
    The default base is µs-scale to match the CostModel clock magnitudes
    (one block op simulates at ~0.1 µs); scenario drivers scale it to their
    workload."""

    max_retries: int = 3
    backoff_base: float = 1e-6
    backoff_factor: float = 2.0

    def backoff(self, attempt: int) -> float:
        return self.backoff_base * self.backoff_factor ** attempt

    def total_backoff(self, attempts: int) -> float:
        return sum(self.backoff(a)
                   for a in range(min(attempts, self.max_retries)))


def _pairs(mapping) -> Tuple[Tuple[int, float], ...]:
    return tuple(sorted((int(k), float(v)) for k, v in dict(mapping).items()))


@dataclass(frozen=True)
class ChaosPlan:
    """Declarative seeded fault scenario (hashable: mappings are stored as
    sorted tuples; dicts are accepted and normalized).

    ``node_failures`` maps node -> simulated failure time (seconds on the
    chaos clock); ``stragglers`` maps node -> compute slowdown factor (>= 1);
    ``transient_fault_prob`` is the per-dispatch probability that an op
    attempt fails transiently; ``link_degradation`` (>= 1) multiplies every
    transfer time; ``speculation``/``spec_threshold`` control live
    speculative re-execution of projected stragglers.

    ``oom_events`` are ``(node, time, capacity_factor)`` triples: at chaos
    time *t* the node's memory budget shrinks to ``factor`` × its current
    capacity (factor in (0, 1]) and the MemoryManager evicts down to the low
    watermark of the new budget.  ``correlated_failures`` are
    ``(time, (nodes...))`` groups — a rack/AZ-style blast radius: when any
    member dies, the whole group is killed in the same recovery pass and
    their blocks are replayed together from the last checkpoint frontier."""

    node_failures: Tuple[Tuple[int, float], ...] = ()
    stragglers: Tuple[Tuple[int, float], ...] = ()
    transient_fault_prob: float = 0.0
    link_degradation: float = 1.0
    speculation: bool = True
    spec_threshold: float = 1.5
    oom_events: Tuple[Tuple[int, float, float], ...] = ()
    correlated_failures: Tuple[Tuple[float, Tuple[int, ...]], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "node_failures", _pairs(self.node_failures))
        object.__setattr__(self, "stragglers", _pairs(self.stragglers))
        if any(f < 1.0 for _n, f in self.stragglers):
            raise ValueError("straggler slowdown factors must be >= 1")
        if self.link_degradation < 1.0:
            raise ValueError("link_degradation must be >= 1")
        ooms = tuple(sorted((int(n), float(t), float(f))
                            for n, t, f in self.oom_events))
        if any(not 0.0 < f <= 1.0 for _n, _t, f in ooms):
            raise ValueError("oom capacity_factor must be in (0, 1]")
        object.__setattr__(self, "oom_events", ooms)
        groups = tuple(sorted((float(t), tuple(sorted(int(n) for n in grp)))
                              for t, grp in self.correlated_failures))
        object.__setattr__(self, "correlated_failures", groups)
        if groups:
            # a correlated group is sugar over node_failures: every member
            # gets a failure entry at the group time (earliest entry wins,
            # so explicit per-node times can pre-empt the group)
            merged = dict(self.node_failures)
            for t, grp in groups:
                for n in grp:
                    merged[n] = min(merged.get(n, t), t)
            object.__setattr__(self, "node_failures", _pairs(merged))

    @property
    def failure_groups(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(grp for _t, grp in self.correlated_failures)

    @property
    def failures(self) -> Dict[int, float]:
        return dict(self.node_failures)

    @property
    def slowdowns(self) -> Dict[int, float]:
        return dict(self.stragglers)


@dataclass
class ChaosStats:
    transient_faults: int = 0   # failed attempts drawn (seeded)
    retries: int = 0            # backed-off retry attempts charged
    escalations: int = 0        # retry budget exhausted -> migrated off node
    backoff_s: float = 0.0      # simulated seconds spent backing off
    speculated: int = 0         # duplicates considered (enqueued on a target)
    spec_wins: int = 0          # duplicate projected to finish first (won)
    spec_cancelled: int = 0     # original finished first (duplicate cancelled)
    nodes_failed: int = 0
    blocks_lost: int = 0
    blocks_replayed: int = 0    # lineage replays charged to survivors
    rerouted_ops: int = 0       # queued ops moved off a dead node
    oom_events: int = 0         # budget-shrink events fired
    oom_evicted: int = 0        # blocks evicted (spill or drop) by OOMs

    def as_dict(self) -> Dict[str, float]:
        return {"chaos_" + k: v for k, v in self.__dict__.items()}


class ChaosEngine:
    """Runtime fault injector attached to one ArrayContext/Executor.

    The engine owns a third ``WorkerClocks`` track (pipelined, with the
    plan's straggler/link factors installed) plus its own residency map:
    together they model what *actually* happens under faults, while the
    scheduler keeps planning against the untouched nominal tracks — the
    bit-identity invariant (module docstring).  All randomness flows through
    one ``numpy`` generator seeded at construction and consumed in dispatch
    order, so a (seed, ChaosPlan) pair fully determines the chaos run.
    """

    def __init__(self, plan: ChaosPlan, seed: int = 0,
                 retry: Optional[RetryPolicy] = None):
        self.plan = plan
        self.seed = seed
        self.retry = retry or RetryPolicy()
        self.rng = np.random.default_rng(seed)
        self.stats = ChaosStats()
        # α-β-γ view of the degraded links (bounds reporting)
        self.comm_model = bounds.CommModel().degraded(plan.link_degradation)
        self.ctx = None
        self.state = None
        self.executor = None
        self.clocks: Optional[WorkerClocks] = None
        self.dead: Set[int] = set()
        self._fail_at: Dict[int, float] = plan.failures
        # pending OOM injections, ascending by time: (time, node, factor)
        self._oom_pending: List[Tuple[float, int, float]] = sorted(
            (t, n, f) for n, t, f in plan.oom_events)
        # chaos-side residency: obj -> surviving nodes holding a copy
        self.resident: Dict[int, Set[int]] = {}
        # where an op actually ran when chaos moved it (spec win, re-route,
        # escalation, replay) — overrides the planned ``block_home``
        self.actual_home: Dict[int, Tuple[int, int]] = {}
        # pending speculative winners: out_id -> duplicate placement
        self.spec_target: Dict[int, Tuple[int, int]] = {}
        # planned op sizes observed via the ClusterState.transition hook
        self.sizes: Dict[int, float] = {}

    # -- wiring ------------------------------------------------------------
    def _make_clocks(self, k: int, w: int, cost_model) -> WorkerClocks:
        clocks = WorkerClocks(k, w, cost_model, overlap=True)
        slow = np.ones(k)
        for n, f in self.plan.stragglers:
            if 0 <= n < k:
                slow[n] = f
        clocks.set_chaos(slow, self.plan.link_degradation)
        return clocks

    def attach(self, ctx) -> "ChaosEngine":
        if ctx.executor.mode == "sim":
            raise ValueError(
                "chaos needs a data-holding backend (numpy/torch/cuda): "
                "the sim executor has nothing to lose or replay")
        if self._fail_at and not ctx.pipeline:
            raise ValueError(
                "node_failures require pipeline=True: death is triggered by "
                "the live drain (sync dispatch has no in-flight window)")
        if self.plan.oom_events and not ctx.pipeline:
            raise ValueError(
                "oom_events require pipeline=True: budget shrinks fire on "
                "the live drain's chaos clock")
        if self.plan.oom_events and not ctx.executor.memory.enabled:
            raise ValueError(
                "oom_events need an active MemoryManager: construct the "
                "ArrayContext with mem_capacity=... or gc=True")
        k = ctx.state.k
        named = (list(self._fail_at)
                 + [n for n, _f in self.plan.stragglers]
                 + [n for n, _t, _f in self.plan.oom_events])
        for n in named:
            if not 0 <= n < k:
                raise ValueError(
                    f"chaos plan names node {n} outside the {k}-node cluster")
        self._bind(ctx)
        return self

    def _bind(self, ctx) -> None:
        self.ctx = ctx
        self.state = ctx.state
        self.executor = ctx.executor
        self.clocks = self._make_clocks(
            ctx.state.k, ctx.cluster.workers_per_node, ctx.state.cost_model)
        ctx.state.transition_hook = self._on_transition
        ctx.executor.chaos = self
        ctx.chaos_engine = self
        # flight recorder: tap the chaos clock track too, so traced runs see
        # every charge/replay placement as an ``op`` event on track "chaos"
        tracer = getattr(ctx, "tracer", None)
        if tracer is not None:
            tracer.attach_clocks(self.clocks, "chaos")

    def rebind(self, new_ctx) -> None:
        """Carry the engine across an ``elastic_relayout``: clock rows and
        residency for surviving node ids persist; nodes removed by a
        scale-down leave the dead set (they exited the cluster — their
        failure entries can no longer fire)."""
        old = self.clocks
        self._bind(new_ctx)
        k = self.clocks.k
        if old is not None:
            kk, ww = min(old.k, k), min(old.workers_per_node,
                                        self.clocks.workers_per_node)
            self.clocks.busy[:kk, :ww] = old.busy[:kk, :ww]
            self.clocks.net_in[:kk] = old.net_in[:kk]
            self.clocks.net_out[:kk] = old.net_out[:kk]
            self.clocks.ready = dict(old.ready)
        self.dead = {n for n in self.dead if n < k}
        for holders in self.resident.values():
            holders.intersection_update(range(k))

    def _on_transition(self, node, out_obj, out_elements, inputs, worker,
                       eta) -> None:
        # observe planned ops as the scheduler transitions them: op sizes
        # feed the chaos-side transfer/work model without re-deriving shapes
        self.sizes[out_obj] = float(out_elements)

    # -- seeded fault draws -------------------------------------------------
    def draw_faults(self) -> int:
        """Number of consecutive failed attempts for one dispatch (0 = clean).
        Drawn at *dispatch* time, so the sequence is a function of the
        schedule alone — drain order, speculation and replay never shift it."""
        p = self.plan.transient_fault_prob
        if p <= 0.0:
            return 0
        n = 0
        while n <= self.retry.max_retries and self.rng.random() < p:
            n += 1
        return n

    # -- chaos-side residency / projection ---------------------------------
    def _home(self, vid: int) -> Tuple[int, int]:
        pl = self.actual_home.get(vid)
        if pl is None:
            pl = self.state.home.get(vid) or self.executor.block_home[vid]
        return pl

    def holders(self, obj: int) -> Set[int]:
        h = self.resident.get(obj)
        if h is None:
            node = self._home(obj)[0]
            h = set() if (node in self.dead or node >= self.clocks.k) else {node}
            self.resident[obj] = h
        return h

    def _obj_elements(self, vid: int) -> float:
        size = self.sizes.get(vid)
        if size is None:
            shape = self.executor.shapes.get(vid)
            size = float(np.prod(shape)) if shape else 1.0
            self.sizes[vid] = size
        return size

    def _op_profile(self, op, node: int):
        """(work, in_objs, xfers) for executing ``op`` (anything with
        ``out_id``/``in_ids``: a PendingOp or an OpRecord) on ``node``,
        against chaos-side residency."""
        ex = self.executor
        out_elems = self._obj_elements(op.out_id)
        in_objs: List[Tuple[int, float]] = []
        xfers: List[Tuple[int, int, float]] = []
        for i in op.in_ids:
            r = ex.resolve(i)
            size = self._obj_elements(r)
            in_objs.append((r, size))
            holders = self.holders(r)
            if holders and node not in holders:
                src = min(holders, key=lambda h: (self.clocks.net_out[h], h))
                xfers.append((src, r, size))
        work = out_elems + sum(s for _o, s in in_objs)
        return work, in_objs, xfers

    def project(self, op, placement: Optional[Tuple[int, int]] = None) -> float:
        """Chaos-projected finish of ``op`` at ``placement`` (non-mutating),
        including the backoff its drawn transient faults will cost."""
        node, worker = placement if placement is not None else op.placement
        work, in_objs, xfers = self._op_profile(op, node)
        est = self.clocks.estimate_finish(node, work, in_objs, xfers,
                                          worker=worker,
                                          kind=getattr(op, "op", None))
        return est + self.retry.total_backoff(getattr(op, "faults", 0))

    def projected_start(self, op,
                        placement: Optional[Tuple[int, int]] = None) -> float:
        node, worker = placement if placement is not None else op.placement
        _work, in_objs, xfers = self._op_profile(op, node)
        return self.clocks.estimate_finish(node, 0.0, in_objs, xfers,
                                           worker=worker)

    def charge(self, op, node: int, worker: int) -> Tuple[float, float]:
        """Advance the chaos clocks for actually executing ``op`` at
        ``(node, worker)``: backoff for its transient faults serializes on
        the worker, operand transfers move chaos-side residency, and the
        output becomes resident at the execution node."""
        faults = getattr(op, "faults", 0)
        if faults:
            wait = self.retry.total_backoff(faults)
            self.stats.transient_faults += faults
            self.stats.retries += min(faults, self.retry.max_retries)
            self.stats.backoff_s += wait
            self.clocks.busy[node, worker] += wait
            tr = self.executor.tracer
            if tr is not None:
                t1 = float(self.clocks.busy[node, worker])
                tr.record("retry", getattr(op, "op", "?"), node, worker,
                          t0=t1 - wait, t1=t1,
                          args={"out": op.out_id, "faults": faults,
                                "backoff_s": wait})
        work, in_objs, xfers = self._op_profile(op, node)
        for _src, obj, _size in xfers:
            self.holders(obj).add(node)
        start, end = self.clocks.place(node, worker, op.out_id, work,
                                       in_objs, xfers,
                                       kind=getattr(op, "op", None))
        self.resident[op.out_id] = {node}
        self.actual_home[op.out_id] = (node, worker)
        return start, end

    # -- survivor placement (flows through LSHS cost simulation) ------------
    def survivors(self) -> List[int]:
        return [n for n in range(self.clocks.k) if n not in self.dead]

    def pick_worker(self, node: int) -> int:
        return int(np.argmin(self.clocks.busy[node]))

    def pick_node(self, op, exclude: Iterable[int] = ()) -> Tuple[int, int]:
        """Best surviving placement for a chaos re-execution (speculative
        duplicate, dead-node re-route, escalated retry, lineage replay):
        LSHS-cost-scored via ``schedulers.chaos_placement``."""
        from .schedulers import chaos_placement

        alive = self.survivors()
        if not alive:
            raise RuntimeError("chaos: every node is dead; nothing can run")
        cands = [n for n in alive if n not in set(exclude)]
        if not cands:
            cands = alive  # nothing else left: stay among survivors
        node = chaos_placement(self.state, self, op, cands)
        return node, self.pick_worker(node)

    # -- OOM injection ------------------------------------------------------
    def apply_ooms(self, now: float) -> None:
        """Fire every pending OOM event whose time has passed: shrink the
        node's budget through the MemoryManager (evicting down to the low
        watermark of the new budget) and charge the eviction stall to the
        node's chaos clocks."""
        while self._oom_pending and self._oom_pending[0][0] <= now:
            _t, node, factor = self._oom_pending.pop(0)
            if node in self.dead:
                continue
            mm = self.executor.memory
            before = mm.stats.spills + mm.stats.recompute_drops
            mm.oom(node, factor)
            self.stats.oom_events += 1
            self.stats.oom_evicted += (
                mm.stats.spills + mm.stats.recompute_drops - before)
            tr = self.executor.tracer
            if tr is not None:
                tr.record("oom", "oom", node, -1, t0=_t, t1=_t,
                          args={"node": node, "factor": factor,
                                "evicted": mm.stats.spills
                                + mm.stats.recompute_drops - before})
            # the eviction storm is local d2h write-back (stats-only); any
            # nested fault-in pauses every worker on the node
            busy_s, _net_s = mm.drain_stalls()
            if busy_s:
                if tr is not None:
                    for w in range(self.clocks.workers_per_node):
                        t1 = float(self.clocks.busy[node, w]) + busy_s
                        tr.record("mem_stall", "oom", node, w,
                                  t0=t1 - busy_s, t1=t1,
                                  args={"stall_s": busy_s})
                self.clocks.busy[node, :] += busy_s

    # -- node death ---------------------------------------------------------
    def failure_group(self, node: int) -> Set[int]:
        """Blast radius of ``node``'s death: its correlated-failure group if
        it belongs to one, else just itself."""
        for grp in self.plan.failure_groups:
            if node in grp:
                return set(grp)
        return {node}

    def pending_failure(self, node: int, t: float) -> bool:
        ft = self._fail_at.get(node)
        return node not in self.dead and ft is not None and t >= ft

    def kill_node(self, node: int) -> List[int]:
        """Declare ``node`` dead: remove it from chaos residency and drop
        every block whose (chaos-actual) home it was.  Returns the lost
        block ids; the executor replays them on survivors."""
        self.dead.add(node)
        self.stats.nodes_failed += 1
        for holders in self.resident.values():
            holders.discard(node)
        lost = self.executor._drop_node_blocks(node, home_fn=self._home)
        self.stats.blocks_lost += len(lost)
        tr = self.executor.tracer
        if tr is not None:
            t = self._fail_at.get(node, self.clocks.makespan())
            tr.record("node_death", f"node{node}", node, -1, t0=t, t1=t,
                      args={"node": node, "lost": len(lost)})
        return lost

    # -- lineage replay -----------------------------------------------------
    def replay_placement(self, rec) -> Tuple[int, int]:
        """Where a lineage replay of ``rec`` should run: its last actual home
        if that node survives, else the best survivor (LSHS-cost-scored)."""
        node, worker = self.actual_home.get(rec.out_id, rec.placement)
        if node in self.dead or node >= self.clocks.k:
            return self.pick_node(rec, exclude=self.dead)
        return node, worker % self.clocks.workers_per_node

    def note_replayed(self, vid: int, placement: Tuple[int, int], rec) -> None:
        node, worker = placement
        work, in_objs, xfers = self._op_profile(rec, node)
        for _src, obj, _size in xfers:
            self.holders(obj).add(node)
        self.clocks.place(node, worker, vid, work, in_objs, xfers,
                          kind=getattr(rec, "op", None))
        self.resident[vid] = {node}
        self.actual_home[vid] = (node, worker)
        self.stats.blocks_replayed += 1

    # -- reporting ----------------------------------------------------------
    def makespan(self) -> float:
        return self.clocks.makespan() if self.clocks is not None else 0.0

    def summary(self) -> Dict[str, float]:
        d = self.stats.as_dict()
        d["chaos_makespan"] = self.makespan()
        d["chaos_dead_nodes"] = sorted(self.dead)
        return d
