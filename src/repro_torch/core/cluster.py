"""Cluster state and the LSHS optimization objective (paper §5.1).

``S`` is a ``k x 3`` matrix tracking per-node loads: memory (column ``MEM``),
network-in (``NET_IN``) and network-out (``NET_OUT``).  ``M`` maps every
object id to the set of nodes that hold a (cached) copy, reflecting the
paper's assumption that a block need only be transmitted to a node once,
after which it is cached by Ray's object store.

Loads are measured in *array elements* (paper-faithful).  A beyond-paper
time-normalized objective (seconds, using per-channel bandwidths) is offered
via ``CostModel``.

Beyond the Eq. 2 load matrix, ``ClusterState`` keeps two simulated-time
clock tracks (``WorkerClocks``): a *sync* track where operand transfers
serialize on the destination worker (the seed executor's dispatch model) and
a *pipelined* track where transfers occupy only the per-node link channels
and may overlap the previous op's compute on that worker (the async runtime
model of Ray/Dask).  Both tracks advance on every transition, so one
scheduled run yields the sync-vs-pipelined makespan ablation, and scheduling
decisions (which consult the pipelined track's finish estimate as a cost
tie-break) are identical in both executor modes — the property that makes
pipelined execution bit-identical to sync execution.
"""
from __future__ import annotations

from dataclasses import dataclass
from time import perf_counter
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .layout import ClusterSpec

MEM, NET_IN, NET_OUT = 0, 1, 2


@dataclass
class CostModel:
    """Unit model for the objective.

    ``paper`` mode reproduces Eq. 2 exactly: loads are element counts and the
    objective is ``max_j mem + max_j in + max_j out``.

    ``time`` mode (beyond-paper) divides memory load by HBM bandwidth and
    network load by link bandwidth so heterogeneous channels are
    commensurable; with intra-node transfers discounted by
    ``intra_node_coeff`` (the paper's Dask coefficient).

    A measured-cost calibration (``repro_torch.obs.calibrate``) may install fitted
    affine coefficients: ``transfer_coeffs = (alpha_s, s_per_byte)`` replaces
    the pure-bandwidth transfer formula and ``compute_coeffs`` maps an op
    kind to ``(alpha_s, s_per_element)`` with ``compute_default`` as the
    fallback pair for kinds the harness never profiled.  All three fields
    default to ``None``, in which case every formula below reduces exactly
    to the hand-picked constants — uncalibrated runs are bit-identical to
    the seed behavior.
    """

    mode: str = "paper"  # "paper" | "time"
    bytes_per_element: int = 8
    # The reference package's simulated-clock constants, kept bit-for-bit so
    # both packages' simulated clocks and schedules agree.  They are not
    # rates of any card this package runs on; fitted constants for a card
    # enter through a calibration profile.
    hbm_bw: float = 819e9       # bytes/s, simulated memory channel
    link_bw: float = 50e9       # bytes/s, simulated per-link channel
    # -- measured-cost calibration (None => hand-picked constants) ---------
    compute_coeffs: Optional[Dict[str, Tuple[float, float]]] = None
    compute_default: Optional[Tuple[float, float]] = None
    transfer_coeffs: Optional[Tuple[float, float]] = None
    calibration_sig: Optional[str] = None

    @property
    def calibrated(self) -> bool:
        return (self.compute_coeffs is not None
                or self.transfer_coeffs is not None)

    def objective(self, S: np.ndarray) -> float:
        if self.mode == "paper":
            return float(S[:, MEM].max() + S[:, NET_IN].max() + S[:, NET_OUT].max())
        b = self.bytes_per_element
        return float(
            S[:, MEM].max() * b / self.hbm_bw
            + S[:, NET_IN].max() * b / self.link_bw
            + S[:, NET_OUT].max() * b / self.link_bw
        )

    def objective_batch(self, S: np.ndarray) -> np.ndarray:
        """Vectorized ``objective`` over a stacked ``(n, k, 3)`` load tensor
        (one hypothetical load matrix per placement option).  Arithmetic is
        ordered exactly as the scalar path so values are bit-identical."""
        mx = S.max(axis=1)  # (n, 3) per-option column maxima
        if self.mode == "paper":
            return mx[:, MEM] + mx[:, NET_IN] + mx[:, NET_OUT]
        b = self.bytes_per_element
        return (
            mx[:, MEM] * b / self.hbm_bw
            + mx[:, NET_IN] * b / self.link_bw
            + mx[:, NET_OUT] * b / self.link_bw
        )

    # -- simulated-time channel costs (clock tracks, independent of ``mode``)
    def transfer_seconds(self, elements: float) -> float:
        tc = self.transfer_coeffs
        if tc is not None:
            return tc[0] + elements * self.bytes_per_element * tc[1]
        return elements * self.bytes_per_element / self.link_bw

    def compute_seconds(self, elements_touched: float,
                        kind: Optional[str] = None) -> float:
        """Memory-bound block-op model: time to stream every input and the
        output through HBM once (roofline floor for elementwise/GEMM tiles).
        With a calibration installed, a fitted per-op-kind affine model
        replaces the roofline floor (``compute_default`` covers unprofiled
        kinds, including ``kind=None``)."""
        cc = self.compute_coeffs
        if cc is not None:
            pair = cc.get(kind) if kind is not None else None
            if pair is None:
                pair = self.compute_default
            if pair is not None:
                return pair[0] + elements_touched * pair[1]
        return elements_touched * self.bytes_per_element / self.hbm_bw


class WorkerClocks:
    """Per-channel busy-until clocks for one simulated execution timeline.

    Channels: one compute channel per (node, worker), one net-in and one
    net-out channel per node.  ``overlap=True`` models a pipelined runtime —
    an operand transfer occupies only the link channels and may proceed while
    the destination worker computes its previous op.  ``overlap=False``
    models the synchronous executor: the destination worker blocks while
    fetching operands, so transfer time lands on its compute chain.
    """

    def __init__(self, k: int, workers_per_node: int, cost_model: CostModel,
                 overlap: bool):
        self.k = k
        self.workers_per_node = workers_per_node
        self.cost_model = cost_model
        self.overlap = overlap
        self.busy = np.zeros((k, workers_per_node))
        self.net_in = np.zeros(k)
        self.net_out = np.zeros(k)
        self.ready: Dict[int, float] = {}  # obj -> simulated availability time
        # chaos factors (core.chaos): per-node compute slowdown (stragglers)
        # and a global transfer-time multiplier (link degradation).  The
        # defaults are exact identities, so nominal tracks are unaffected.
        self.node_slowdown = np.ones(k)
        self.link_factor = 1.0
        # flight-recorder tap (core.trace.FlightRecorder.attach_clocks): a
        # (recorder, track) pair; every place() appends one ``op`` event
        # with the full start-time breakdown.
        # Read-only: the recorder never mutates clocks, so tracing cannot
        # perturb simulated time.  Clones never record (what-if simulations
        # are not real placements).
        self.recorder = None

    def set_chaos(self, node_slowdown, link_factor: float = 1.0) -> None:
        """Install chaos factors: ``node_slowdown[j]`` (>= 1) multiplies
        compute time on node ``j``; ``link_factor`` (>= 1) multiplies every
        transfer time (bandwidth degradation).  Only chaos-engine clock
        tracks ever set these; scheduler-facing tracks stay nominal so
        placement decisions — and output bits — are chaos-independent."""
        self.node_slowdown = np.asarray(node_slowdown, dtype=np.float64)
        self.link_factor = float(link_factor)

    def clone(self) -> "WorkerClocks":
        c = WorkerClocks(self.k, self.workers_per_node, self.cost_model, self.overlap)
        c.busy = self.busy.copy()
        c.net_in = self.net_in.copy()
        c.net_out = self.net_out.copy()
        c.ready = dict(self.ready)
        c.node_slowdown = self.node_slowdown.copy()
        c.link_factor = self.link_factor
        c.recorder = None
        return c

    def reset(self) -> None:
        self.busy[:] = 0.0
        self.net_in[:] = 0.0
        self.net_out[:] = 0.0
        self.ready.clear()

    def note_alias(self, obj: int, src_obj: int) -> None:
        """An alias becomes available exactly when its source does."""
        self.ready[obj] = self.ready.get(src_obj, 0.0)

    def place(
        self,
        node: int,
        worker: int,
        out_obj: int,
        work_elements: float,
        in_objs: Sequence[Tuple[int, int]],
        xfers: Sequence[Tuple[int, int, float]],
        kind: Optional[str] = None,
    ) -> Tuple[float, float]:
        """Advance the clocks for executing one op on ``(node, worker)``.

        ``in_objs`` is ``[(obj, elements), ...]`` over every operand;
        ``xfers`` is ``[(src_node, obj, elements), ...]`` over the operands
        that must be transferred first.  ``kind`` selects the calibrated
        per-op-kind compute coefficients when a calibration is installed
        (ignored otherwise).  Returns the op's simulated ``(start, finish)``.
        """
        cm = self.cost_model
        rec = self.recorder
        w_busy0 = self.busy.item(node, worker) if rec is not None else 0.0
        xlog = [] if rec is not None else None
        t_ready = 0.0
        for obj, _elements in in_objs:
            t_ready = max(t_ready, self.ready.get(obj, 0.0))
        t_xfer = 0.0
        for src, obj, elements in xfers:
            t0 = max(self.ready.get(obj, 0.0), self.net_out[src], self.net_in[node])
            if not self.overlap:
                t0 = max(t0, self.busy[node, worker])
            t1 = t0 + cm.transfer_seconds(elements) * self.link_factor
            self.net_out[src] = t1
            self.net_in[node] = t1
            if not self.overlap:
                self.busy[node, worker] = t1
            if xlog is not None:
                xlog.append((src, obj, elements, t0, t1))
            t_xfer = max(t_xfer, t1)
        start = max(self.busy[node, worker], t_ready, t_xfer)
        end = start + (cm.compute_seconds(work_elements, kind)
                       * self.node_slowdown[node])
        self.busy[node, worker] = end
        self.ready[out_obj] = end
        if rec is not None:  # FlightRecorder.record, inlined (see its comment)
            tr, track = rec
            ev = tr.events
            if len(ev) == tr.capacity:
                tr.dropped += 1
            ev.append(("op", track, node, worker, start, end, perf_counter(),
                       (self, out_obj, work_elements, in_objs, xlog,
                        w_busy0, t_ready, t_xfer)))
        return start, end

    def estimate_finish(
        self,
        node: int,
        work_elements: float,
        in_objs: Sequence[Tuple[int, int]],
        xfers: Sequence[Tuple[int, int, float]],
        worker: Optional[int] = None,
        kind: Optional[str] = None,
    ) -> float:
        """Non-mutating ``place``: the finish time a hypothetical placement
        would reach.  ``worker=None`` assumes the node's earliest-free worker
        (the optimistic choice ``pick_worker`` rotates toward)."""
        cm = self.cost_model
        w_busy = self.busy[node, worker] if worker is not None else float(
            self.busy[node].min())
        t_ready = 0.0
        for obj, _elements in in_objs:
            t_ready = max(t_ready, self.ready.get(obj, 0.0))
        t_xfer = 0.0
        net_out = {}
        net_in = self.net_in[node]
        for src, obj, elements in xfers:
            t0 = max(self.ready.get(obj, 0.0), net_out.get(src, self.net_out[src]),
                     net_in)
            if not self.overlap:
                t0 = max(t0, w_busy)
            t1 = t0 + cm.transfer_seconds(elements) * self.link_factor
            net_out[src] = t1
            net_in = t1
            if not self.overlap:
                w_busy = t1
            t_xfer = max(t_xfer, t1)
        start = max(w_busy, t_ready, t_xfer)
        return start + (cm.compute_seconds(work_elements, kind)
                        * self.node_slowdown[node])

    def makespan(self) -> float:
        return float(self.busy.max()) if self.busy.size else 0.0


@dataclass
class TransferRecord:
    obj: int
    src: int
    dst: int
    elements: int
    intra_node: bool = False


class ClusterState:
    """Simulated load state of a ``k``-node cluster (paper §5.1).

    ``system="ray"`` uses node-granular residency (shared-memory object store:
    any worker on a node can read any local object for free).  ``system="dask"``
    uses worker-granular residency; worker->worker transfers within a node are
    charged at ``cluster.intra_node_coeff`` times their size (paper footnote 1).
    """

    def __init__(
        self,
        cluster: ClusterSpec,
        cost_model: Optional[CostModel] = None,
        system: str = "ray",
    ):
        self.cluster = cluster
        self.system = system
        self.k = cluster.num_nodes
        self.S = np.zeros((self.k, 3), dtype=np.float64)
        # obj -> set of nodes with a cached copy
        self.M: Dict[int, Set[int]] = {}
        # obj -> set of (node, worker) with a copy (dask granularity)
        self.Mw: Dict[int, Set[Tuple[int, int]]] = {}
        # obj -> (home_node, worker): the placement that produced the object
        self.home: Dict[int, Tuple[int, int]] = {}
        self.obj_size: Dict[int, int] = {}
        self.cost_model = cost_model or CostModel()
        self.transfers: List[TransferRecord] = []
        self._worker_rr: List[int] = [0] * self.k
        # dual simulated-time tracks: sync (serialized fetch) vs pipelined
        # (transfer/compute overlap).  Both advance on every transition so a
        # single scheduled run yields the full overlap ablation.
        w = cluster.workers_per_node
        self.clocks_sync = WorkerClocks(self.k, w, self.cost_model, overlap=False)
        self.clocks_pipe = WorkerClocks(self.k, w, self.cost_model, overlap=True)
        # observer called after every transition with
        # (node, out_obj, out_elements, inputs, worker, (start, end)) — the
        # chaos engine registers here to track planned ops without ever
        # influencing scheduling (clones never fire it: what-if simulations
        # are not real transitions)
        self.transition_hook = None
        # flight recorder (core.trace): when set, every transition records
        # the operand transfers it caused (with byte counts).  Separate from
        # ``transition_hook`` — the chaos engine owns that single slot.
        self.tracer = None
        # optional per-node memory budget in elements (core.memory enforces
        # it at the executor layer; recorded here for reporting only — the
        # scheduling objective is deliberately budget-blind so budgeted and
        # unbudgeted runs place identically)
        self.mem_capacity: Optional[float] = None

    def set_mem_capacity(self, capacity: Optional[float]) -> None:
        self.mem_capacity = capacity

    # -- bookkeeping -------------------------------------------------------
    def clone(self) -> "ClusterState":
        c = ClusterState.__new__(ClusterState)
        c.cluster = self.cluster
        c.system = self.system
        c.k = self.k
        c.S = self.S.copy()
        c.M = {o: set(n) for o, n in self.M.items()}
        c.Mw = {o: set(w) for o, w in self.Mw.items()}
        c.home = dict(self.home)
        c.obj_size = dict(self.obj_size)
        c.cost_model = self.cost_model
        c.transfers = []  # clones are what-if simulations; don't carry history
        c._worker_rr = list(self._worker_rr)
        c.clocks_sync = self.clocks_sync.clone()
        c.clocks_pipe = self.clocks_pipe.clone()
        c.transition_hook = None
        c.tracer = None
        return c

    def add_object(
        self, obj: int, node: int, worker: int, elements: int,
        ready_of: Optional[int] = None,
    ) -> None:
        """Register a freshly created object placed on (node, worker).

        ``ready_of`` marks the object as an alias of an existing one for the
        clock tracks: it becomes available when its source does, rather than
        at time zero (reduce outputs alias their last partial)."""
        self.M.setdefault(obj, set()).add(node)
        self.Mw.setdefault(obj, set()).add((node, worker))
        self.home[obj] = (node, worker)
        self.obj_size[obj] = int(elements)
        self.S[node, MEM] += elements
        if ready_of is not None:
            self.clocks_sync.note_alias(obj, ready_of)
            self.clocks_pipe.note_alias(obj, ready_of)

    def nodes_of(self, obj: int) -> Set[int]:
        return self.M.get(obj, set())

    def pick_worker(self, node: int) -> int:
        w = self._worker_rr[node] % self.cluster.workers_per_node
        self._worker_rr[node] += 1
        return w

    def begin_schedule(self, start: int = 0) -> None:
        """Reset the per-node worker round-robin cursor to ``start``.
        Called at the top of every schedule/replay so worker assignment is a
        function of the structural problem rather than of global dispatch
        history — required for a replayed plan to reproduce a cold schedule
        exactly.  ``start`` (derived from the problem's structural RNG)
        spreads successive *different* small computes across workers instead
        of piling them all on worker 0."""
        self._worker_rr = [start] * self.k

    # -- transition function T (paper §5.1) ---------------------------------
    def transition(
        self,
        node: int,
        out_obj: int,
        out_elements: int,
        inputs: Sequence[int],
        worker: Optional[int] = None,
        kind: Optional[str] = None,
    ) -> Tuple[float, float]:
        """Simulate executing an op on ``node``: transfer any non-resident
        inputs (charging net-out at a source and net-in at ``node``), then
        account the output's memory on ``node``.  Advances both clock tracks
        and returns the op's (start, finish) on the *pipelined* track.
        ``kind`` (the op name) routes calibrated per-op-kind compute
        coefficients into both tracks; a no-op without a calibration."""
        if worker is None:
            worker = self.pick_worker(node)
        tracer = self.tracer
        xfers: List[Tuple[int, int, float]] = []  # (src, obj, elements)
        for obj in inputs:
            holders = self.M.get(obj)
            if holders is None:
                raise KeyError(f"unknown object {obj}")
            if node in holders:
                if self.system == "dask":
                    wholders = self.Mw.get(obj, set())
                    if (node, worker) not in wholders:
                        # intra-node worker->worker transfer (discounted)
                        coeff = self.cluster.intra_node_coeff
                        size = self.obj_size[obj] * coeff
                        self.S[node, NET_OUT] += size
                        self.S[node, NET_IN] += size
                        wholders.add((node, worker))
                        self.transfers.append(
                            TransferRecord(obj, node, node, int(size), intra_node=True)
                        )
                        xfers.append((node, obj, size))
                continue
            # choose the least net-out-loaded holder as the source
            src = min(holders, key=lambda h: (self.S[h, NET_OUT], h))
            size = self.obj_size[obj]
            self.S[src, NET_OUT] += size
            self.S[node, NET_IN] += size
            # §5.1: memory load includes elements *transmitted to* the node
            self.S[node, MEM] += size
            holders.add(node)
            self.Mw.setdefault(obj, set()).add((node, worker))
            self.transfers.append(TransferRecord(obj, src, node, size))
            xfers.append((src, obj, size))
        self.add_object(out_obj, node, worker, out_elements)
        in_objs = [(obj, self.obj_size[obj]) for obj in inputs]
        work = out_elements + sum(e for _o, e in in_objs)
        eta_sync = self.clocks_sync.place(node, worker, out_obj, work,
                                          in_objs, xfers, kind=kind)
        eta = self.clocks_pipe.place(node, worker, out_obj, work, in_objs,
                                     xfers, kind=kind)
        if tracer is not None and xfers:
            # one TransferRecord was appended per entry of xfers
            tracer.on_transition(self, node, worker, out_obj, out_elements,
                                 self.transfers[-len(xfers):], eta_sync, eta)
        if self.transition_hook is not None:
            self.transition_hook(node, out_obj, out_elements, inputs, worker, eta)
        return eta

    def simulate_cost(
        self,
        node: int,
        out_elements: int,
        inputs: Sequence[int],
        worker: Optional[int] = None,
        kind: Optional[str] = None,
    ) -> float:
        """Objective value (Eq. 2) after a hypothetical placement on ``node``."""
        return self.simulate_cost_detail(node, out_elements, inputs, worker,
                                         kind=kind)[0]

    def simulate_cost_detail(
        self,
        node: int,
        out_elements: int,
        inputs: Sequence[int],
        worker: Optional[int] = None,
        kind: Optional[str] = None,
    ) -> Tuple[float, float, float, float]:
        """(Eq.2 objective, transfer elements, est. finish, node load) for a
        hypothetical placement — the trailing entries are LSHS tie-breakers
        (the paper leaves ties unspecified).  Among equal-objective options,
        minimizing transferred bytes is the communication-avoiding choice;
        among those, the earliest *pipelined* finish estimate prefers nodes
        whose workers and links free up soonest (overlap-aware)."""
        S = self.S.copy()
        moved = 0.0
        xfers: List[Tuple[int, int, float]] = []
        for obj in inputs:
            holders = self.M.get(obj, set())
            if node in holders:
                if self.system == "dask" and worker is not None:
                    if (node, worker) not in self.Mw.get(obj, set()):
                        size = self.obj_size[obj] * self.cluster.intra_node_coeff
                        S[node, NET_OUT] += size
                        S[node, NET_IN] += size
                        moved += size
                        xfers.append((node, obj, size))
                continue
            src = min(holders, key=lambda h: (S[h, NET_OUT], h))
            size = self.obj_size[obj]
            S[src, NET_OUT] += size
            S[node, NET_IN] += size
            S[node, MEM] += size  # §5.1: transmission adds memory at dst
            moved += size
            xfers.append((src, obj, size))
        S[node, MEM] += out_elements
        in_objs = [(obj, self.obj_size[obj]) for obj in inputs]
        work = out_elements + sum(e for _o, e in in_objs)
        est_finish = self.clocks_pipe.estimate_finish(
            node, work, in_objs, xfers, worker=worker, kind=kind)
        return self.cost_model.objective(S), moved, est_finish, float(S[node].sum())

    def simulate_cost_batch(
        self,
        nodes: Sequence[int],
        out_elements: int,
        inputs: Sequence[int],
        kind: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized ``simulate_cost_detail`` over *all* placement options.

        One numpy pass over the load table ``S``: a stacked ``(n, k, 3)``
        copy receives the incremental transfer/memory deltas of every
        hypothetical placement at once, instead of re-simulating per option
        in Python.  Inputs are processed in order (a transfer's source is the
        least-net-out holder *after* earlier inputs' deltas, ties to the
        lowest node id — exactly the scalar path), so each returned array
        entry is bit-identical to the corresponding
        ``simulate_cost_detail(node, ...)`` tuple entry.

        Worker-granular (dask) residency surcharges are not modeled here;
        LSHS option scoring never passes a worker, so the scalar path skips
        them identically.  Returns ``(objective, moved, est_finish,
        node_load)`` arrays aligned with ``nodes``.  Transfer deltas (a
        handful of scalar scatter-adds per non-resident input) are applied
        per option; the objective maxima and tie-break load sums reduce over
        the whole option stack in single numpy passes.
        """
        n = len(nodes)
        S = np.repeat(self.S[None, :, :], n, axis=0)  # (n, k, 3)
        moved = [0.0] * n
        xfers: List[List[Tuple[int, int, float]]] = [[] for _ in range(n)]
        obj_size = self.obj_size
        for obj in inputs:
            holders = self.M.get(obj)
            if holders is None:
                raise KeyError(f"unknown object {obj}")
            size = obj_size[obj]
            if len(holders) == self.k:
                continue  # resident everywhere: no option pays a transfer
            miss = [i for i in range(n) if nodes[i] not in holders]
            if not miss:
                continue
            hl = sorted(holders)
            h0 = hl[0]
            rest = hl[1:]
            for i in miss:
                row = S[i]
                # least-net-out holder; strict < over the sorted holder list
                # keeps the lowest id on ties == min(key=(net_out, id))
                src, best = h0, row[h0, NET_OUT]
                for h in rest:
                    val = row[h, NET_OUT]
                    if val < best:
                        src, best = h, val
                dst = nodes[i]
                row[src, NET_OUT] += size
                row[dst, NET_IN] += size
                row[dst, MEM] += size  # §5.1: transmission adds memory at dst
                moved[i] += size
                xfers[i].append((src, obj, size))
        ar = np.arange(n)
        nodes_arr = np.asarray(nodes, dtype=np.intp)
        S[ar, nodes_arr, MEM] += out_elements
        in_objs = [(obj, obj_size[obj]) for obj in inputs]
        work = out_elements + sum(e for _o, e in in_objs)
        est = np.empty(n)
        estimate = self.clocks_pipe.estimate_finish
        for i in range(n):
            est[i] = estimate(nodes[i], work, in_objs, xfers[i], kind=kind)
        return (
            self.cost_model.objective_batch(S),
            np.asarray(moved),
            est,
            S[ar, nodes_arr, :].sum(axis=1),
        )

    def objective(self) -> float:
        return self.cost_model.objective(self.S)

    def makespan(self, pipeline: bool = True) -> float:
        """Simulated completion time of everything scheduled so far, under
        the pipelined (overlapped) or sync (serialized-fetch) model."""
        return (self.clocks_pipe if pipeline else self.clocks_sync).makespan()

    def reset_clocks(self) -> None:
        self.clocks_sync.reset()
        self.clocks_pipe.reset()

    # -- reporting -----------------------------------------------------------
    def network_elements(self) -> int:
        return int(sum(t.elements for t in self.transfers))

    def summary(self) -> Dict[str, float]:
        mk_sync = self.makespan(pipeline=False)
        mk_pipe = self.makespan(pipeline=True)
        if self.mem_capacity is not None:
            return {**self._summary_base(mk_sync, mk_pipe),
                    "mem_capacity_per_node": float(self.mem_capacity)}
        return self._summary_base(mk_sync, mk_pipe)

    def _summary_base(self, mk_sync: float, mk_pipe: float) -> Dict[str, float]:
        return {
            "max_mem": float(self.S[:, MEM].max()),
            "max_net_in": float(self.S[:, NET_IN].max()),
            "max_net_out": float(self.S[:, NET_OUT].max()),
            "total_net": float(self.S[:, NET_IN].sum()),
            "mem_imbalance": float(self.S[:, MEM].max() / max(self.S[:, MEM].mean(), 1e-12)),
            "objective": self.objective(),
            "makespan_sync": mk_sync,
            "makespan_pipelined": mk_pipe,
            "overlap_speedup": mk_sync / max(mk_pipe, 1e-12),
        }
