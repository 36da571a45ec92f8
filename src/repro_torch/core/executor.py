"""Block executors: the "underlying distributed system" of Fig. 1.

Execution is delegated to a ``repro_torch.backend.BlockBackend`` (the
block-kernel subsystem):

* ``numpy``  — blocks are host numpy arrays, ops run through the per-op
  interpreter (``graph_array.execute_block_op``) — the bit-exact reference.
* ``torch``  — blocks stay ``torch.Tensor``s end-to-end on their
  placement's device; every op is one lookup in a table of eager torch
  ops, and ``fused`` chains run as a single call.  No host round-trips
  between ops.
* ``cuda``   — the torch backend with every 2-D ``matmul`` routed through
  the hand-written Hopper matmul kernel (its plain PyTorch version for
  tensors on the CPU).
* ``sim``    — metadata-only: tracks shapes and dispatch/transfer counts so
  terabyte-scale graphs can be *scheduled* (load benchmarks) without
  allocating data.  (No backend: there is nothing to execute.)

Two dispatch modes share one interface:

* sync (``pipeline=False``) — ``run_op`` executes eagerly at schedule time,
  the seed behavior.
* pipelined (``pipeline=True``) — ``run_op`` enqueues a ``PendingOp`` future
  onto the per-(node, worker) dispatch queue and returns immediately; a
  simulated-time event loop (``flush``) later drains the queues in earliest-
  finish order, the order an async runtime that overlaps operand transfers
  with compute would retire them (the clock model lives in
  ``cluster.WorkerClocks``).  Because block ops are pure and dependencies are
  respected, drain order never changes values: pipelined results are
  bit-identical to sync results.  ``assemble``/``get`` flush on demand.
  The drain is event-driven: ready queue heads sit on an eta-keyed heap and
  blocked heads register a waiter on their first unmet dependency, so each
  retirement costs O(log Q) instead of rescanning every queue.

The executor also implements task-lineage replay for fault tolerance
(``fail_node``/``recover``): every op's recipe is recorded so lost blocks can
be re-executed idempotently — the GraphArray analogue of checkpoint/restart.
Replay runs on the *same* backend as the original execution (same
kernels, same dtype), so recovered blocks are bit-identical to the lost
ones.  Pending queues are flushed before a failure is injected or a replay
starts, so lineage always reflects a quiesced system.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from time import perf_counter
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph_array import GraphArray, infer_shape
from .memory import MemoryManager
from .trace import EXEC_DRAIN, LayerSpan, profiling

_MODES = ("numpy", "sim", "torch", "cuda")


@dataclass
class OpRecord:
    out_id: int
    op: str
    meta: Dict[str, Any]
    in_ids: Tuple[int, ...]
    placement: Tuple[int, int]
    times: Optional[Tuple[float, float]] = None  # simulated (start, finish)


@dataclass
class PendingOp:
    """A dispatched-but-not-executed block op: the executor's future."""

    out_id: int
    op: str
    meta: Dict[str, Any]
    in_ids: Tuple[int, ...]
    placement: Tuple[int, int]
    eta: float  # simulated finish time (event-loop drain priority)
    seq: int    # dispatch order (deterministic tie-break)
    faults: int = 0          # chaos: seeded failed attempts to retry through
    spec_checked: bool = False  # chaos: speculation evaluated once per op


@dataclass
class ExecStats:
    n_rfc: int = 0          # remote function calls dispatched (the γ term)
    n_creates: int = 0
    elements_computed: int = 0
    n_queued: int = 0       # ops that went through the pipelined queues
    n_flushes: int = 0      # event-loop drains
    peak_queue: int = 0     # max total ops pending at once
    dispatch_s: float = 0.0  # wall time inside run_op — the γ term in seconds
    drain_s: float = 0.0    # wall time inside flush() — pipelined queue drain
    execute_s: float = 0.0  # wall time inside backend.execute() — drain_s less
    #                         execute_s is the executor's own bookkeeping

    def reset(self) -> None:
        self.n_rfc = 0
        self.n_creates = 0
        self.elements_computed = 0
        self.n_queued = 0
        self.n_flushes = 0
        self.peak_queue = 0
        self.dispatch_s = 0.0
        self.drain_s = 0.0
        self.execute_s = 0.0


class Executor:
    def __init__(
        self,
        mode: str = "numpy",
        seed: int = 0,
        devices: Optional[list] = None,
        pipeline: bool = False,
        dtype: Optional[str] = None,
    ):
        if mode not in _MODES:
            raise ValueError(f"unknown executor mode {mode!r}")
        self.mode = mode
        self.pipeline = pipeline
        self.store: Dict[int, Any] = {}
        self.shapes: Dict[int, Tuple[int, ...]] = {}
        self.aliases: Dict[int, int] = {}
        self.lineage: Dict[int, OpRecord] = {}
        self.block_home: Dict[int, Tuple[int, int]] = {}
        self.stats = ExecStats()
        self.rng = np.random.default_rng(seed)
        # pipelined dispatch state: per-(node, worker) FIFO queues plus the
        # set of output ids whose values are still futures
        self.queues: Dict[Tuple[int, int], Deque[PendingOp]] = {}
        self._pending_ids: set = set()
        self._seq = 0
        # optional retire-order capture (set to a list to record out_ids in
        # the order flush() executes them — the drain-order regression hook)
        self.retire_log: Optional[List[int]] = None
        self._flush_depth = 0  # drain_s accumulates at the outermost flush
        # chaos runtime (core.chaos.ChaosEngine.attach installs itself here):
        # when set, dispatch draws seeded transient faults and flush() drains
        # through the fault-injecting event loop instead of the fast path
        self.chaos = None
        # flight recorder (core.trace.FlightRecorder): when set, dispatch,
        # retirement, replay and memory events are recorded.  None keeps
        # every hot path at one attribute load + is-None test.
        self.tracer = None
        # measured-cost hooks (repro_torch.obs.calibrate / repro_torch.obs.controller):
        # ``profile_sync`` blocks on the backend after every op so retire
        # wall times are truly per-op (async backends dispatch eagerly) —
        # harness-only, it changes wall timing, never values or simulated
        # clocks.  ``drain_hook`` is called with each retired out_id during
        # a drain (observed-load controller sampling); None keeps the drain
        # at one is-None test per retirement.
        self.profile_sync = False
        self.drain_hook = None
        if mode == "sim":
            self.backend = None
            self.dtype = dtype or "float64"
        else:
            from repro_torch.backend import make_backend

            self.backend = make_backend(mode, dtype=dtype, devices=devices)
            self.dtype = self.backend.dtype
        # block residency manager: peak accounting always on; refcount GC,
        # spill/recompute eviction and per-node budgets activate via
        # ``memory.configure`` (ArrayContext's gc/mem_capacity parameters)
        self.memory = MemoryManager(self)

    def note_handle(self, vertex) -> None:
        """Register a live Vertex leaf as a reachability root for its block
        (refcount GC); no-op unless the memory manager is enabled."""
        self.memory.note_handle(vertex)

    # -- creation ---------------------------------------------------------
    def create(
        self,
        vid: int,
        shape: Tuple[int, ...],
        placement: Tuple[int, int],
        kind: str = "zeros",
        value: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
        ckpt: Optional[Tuple[str, str]] = None,
    ) -> None:
        self.stats.n_creates += 1
        self.stats.n_rfc += 1
        self.shapes[vid] = tuple(shape)
        self.block_home[vid] = placement
        meta: Dict[str, Any] = {"seed": seed, "value": value}
        if ckpt is not None:
            meta["path"], meta["key"] = ckpt
        self.lineage[vid] = OpRecord(vid, f"create:{kind}", meta, (), placement)
        elements = int(np.prod(shape)) if shape else 1
        if self.tracer is not None:
            self.tracer.record("create", f"create:{kind}", placement[0],
                               placement[1],
                               args={"out": vid, "elements": elements})
        if self.mode == "sim":
            self.store[vid] = None
            self.memory.on_materialize(vid, placement[0], elements)
            return
        self.memory.admit(placement[0], elements)
        # block values are generated on the host with numpy for every
        # backend (identical bits), then committed to backend storage once
        if value is not None:
            arr = np.asarray(value, dtype=np.float64)
        elif kind == "zeros":
            arr = np.zeros(shape)
        elif kind == "ones":
            arr = np.ones(shape)
        elif kind == "random":
            arr = np.random.default_rng(seed).standard_normal(shape)
        elif kind == "uniform":
            arr = np.random.default_rng(seed).random(shape)
        elif kind == "restore":
            # lineage-checkpoint root: the block's bits come from the atomic
            # checkpoint archive, truncating any deeper replay
            arr = self.memory.ckpt_block(meta["path"], meta["key"])
        else:
            raise ValueError(f"unknown creation kind {kind!r}")
        self.store[vid] = self._commit(arr, placement)
        self.memory.on_materialize(vid, placement[0], elements)

    def _commit(self, arr: np.ndarray, placement: Tuple[int, int]):
        return self.backend.from_host(arr, placement)

    # -- ops ----------------------------------------------------------------
    def resolve(self, vid: int) -> int:
        while vid in self.aliases:
            vid = self.aliases[vid]
        return vid

    def get(self, vid: int):
        vid = self.resolve(vid)
        if vid in self._pending_ids:
            self.flush()
        mm = self.memory
        if mm.enabled and self.mode != "sim":
            mm._touch(vid)
            if self.store.get(vid) is None:
                # transparent fault-in: spilled blocks reload over h2d,
                # GC-dropped blocks replay from lineage — both bitwise
                value = mm.revive(vid)
                if value is not None:
                    return value
        return self.store[vid]

    def run_op(
        self,
        out_id: int,
        op: str,
        meta: Dict[str, Any],
        in_ids: Sequence[int],
        placement: Tuple[int, int],
        eta: Optional[Tuple[float, float]] = None,
    ) -> None:
        """Dispatch one block op.  ``eta`` is the scheduler's simulated
        (start, finish) for the op (from ``ClusterState.transition``); in
        pipelined mode it orders the event-loop drain.  Wall time spent here
        accumulates in ``stats.dispatch_s`` (the per-op γ overhead, Fig. 8)."""
        t0 = perf_counter()
        self.stats.n_rfc += 1
        lineage_rec = OpRecord(
            out_id, op, dict(meta), tuple(in_ids), placement, times=eta
        )
        self.lineage[out_id] = lineage_rec
        self.block_home[out_id] = placement
        in_shapes = [self.shapes[self.resolve(i)] for i in in_ids]
        out_shape = infer_shape(op, meta, in_shapes)
        self.shapes[out_id] = out_shape
        tr = self.tracer
        if tr is not None:
            # FlightRecorder.record, inlined in its compact dispatch layout
            # (core/trace.py): the lineage record holds the event's fields
            ev = tr.events
            if len(ev) == tr.capacity:
                tr.dropped += 1
            ev.append(("dispatch", lineage_rec, self.pipeline, perf_counter()))
        if self.mode == "sim":
            self.store[out_id] = None
            self.memory.on_materialize(out_id, placement[0],
                                       int(np.prod(out_shape)) if out_shape
                                       else 1)
            self.stats.dispatch_s += perf_counter() - t0
            return
        # refcount GC: each dispatched consumer pins its operands until it
        # retires (unpinned in _execute) — a pinned block is never evicted
        self.memory.pin(in_ids)
        # chaos: transient-fault attempts are drawn at dispatch time, so the
        # seeded sequence is a function of the schedule alone — drain order,
        # speculation and replay never shift which op draws which faults
        faults = self.chaos.draw_faults() if self.chaos is not None else 0
        if self.pipeline:
            pending = PendingOp(
                out_id, op, dict(meta), tuple(in_ids), placement,
                eta=eta[1] if eta else 0.0, seq=self._seq, faults=faults,
            )
            self._seq += 1
            self.queues.setdefault(placement, deque()).append(pending)
            self._pending_ids.add(out_id)
            self.stats.n_queued += 1
            self.stats.peak_queue = max(self.stats.peak_queue, len(self._pending_ids))
            self.stats.dispatch_s += perf_counter() - t0
            return
        # sync mode: dispatch accounting stops before the block math itself
        self.stats.dispatch_s += perf_counter() - t0
        if self.chaos is not None:
            head = PendingOp(out_id, op, dict(meta), tuple(in_ids), placement,
                             eta=eta[1] if eta else 0.0, seq=self._seq,
                             faults=faults)
            self._seq += 1
            self._execute_chaos(head)
            return
        self._execute(out_id, op, meta, in_ids, placement)

    def _execute(
        self,
        out_id: int,
        op: str,
        meta: Dict[str, Any],
        in_ids: Sequence[int],
        placement: Tuple[int, int],
    ) -> float:
        # memory gate first: over the high watermark the drain stalls here
        # (backpressure) while victims spill/drop, before the op materializes
        out_shape = self.shapes[out_id]
        out_elements = int(np.prod(out_shape)) if out_shape else 1
        stall = self.memory.admit(
            placement[0], out_elements,
            protect=tuple(self.resolve(i) for i in in_ids))
        tr = self.tracer
        if stall and tr is not None:
            tr.record("backpressure", op, placement[0], placement[1],
                      args={"out": out_id, "stall_s": stall})
        # operands flow to the backend in their resident representation
        # (numpy arrays / torch device tensors) — no host round-trip here
        ins = [self.get(i) for i in in_ids]
        w0 = perf_counter()
        out = self.backend.execute(op, meta, ins, placement)
        w1 = perf_counter()
        self.stats.execute_s += w1 - w0
        if tr is not None:
            # measured wall time per op: the calibration/drift signal.
            # profile_sync blocks async backends so the window covers the
            # kernel, not just its dispatch.
            if self.profile_sync:
                self.backend.wait(out)
                w1 = perf_counter()
            wall_s = w1 - w0
        self.stats.elements_computed += out_elements
        self.store[out_id] = out
        self.memory.on_materialize(out_id, placement[0], out_elements)
        self.memory.unpin(in_ids)
        if tr is not None:
            # FlightRecorder.record, inlined in its compact retire layout
            # (core/trace.py), which sums ``work`` — the clock model's
            # elements-touched measure (output + every input), so retire
            # events pair one-to-one with simulated op durations for
            # calibration fits / drift reports — when the event is read
            ev = tr.events
            if len(ev) == tr.capacity:
                tr.dropped += 1
            ev.append(("retire", op, placement, perf_counter(), out_id,
                       out_elements, in_ids, wall_s, self))
        if self.chaos is None:
            self.memory.drain_stalls()  # stats keep them; nominal clocks don't
        return stall

    def pending_count(self) -> int:
        return len(self._pending_ids)

    def wait_blocks(self, ga: GraphArray) -> None:
        """Flush pending dispatches and block until every block value of
        ``ga`` is materialized and ready — async backends (torch on a GPU) dispatch
        eagerly and return futures, so wall-time measurements need this
        barrier; on numpy it is flush-only."""
        if self.mode == "sim":
            return
        self.flush()
        for idx in ga.grid.iter_indices():
            self.backend.wait(self.get(ga.block(idx).vid))

    def flush(self) -> int:
        """Drain the dispatch queues: an event loop that repeatedly retires,
        among queue heads whose operands are materialized, the one with the
        earliest simulated finish time.  FIFO order per worker is preserved
        (a worker is a serial resource); the scheduler's topological dispatch
        order guarantees progress.  Returns the number of ops executed.

        Ready heads sit on a heap keyed (eta, seq) — the same ordering the
        former every-queue rescan minimized over, so the retire order is
        identical (regression-tested) at O(log Q) per retirement.  A blocked
        head registers as a waiter on its first still-pending dependency and
        is re-examined exactly when that dependency retires; each queue is
        always in exactly one of {on the heap, waiting, empty}.

        Wall time spent draining accumulates in ``stats.drain_s`` — kept
        separate from ``dispatch_s`` (enqueue-side ``run_op`` overhead) so
        the scheduler-vs-dispatch overhead split in ``bench_overhead``
        accounts pipelined queue time instead of under-reporting it.

        While a profiler records, the outermost drain is the span
        ``repro_torch.exec.drain`` and the backend opens one per op."""
        if not self._pending_ids:
            return 0
        t_drain = perf_counter()
        self._flush_depth += 1
        try:
            if self._flush_depth == 1 and profiling():
                with LayerSpan(EXEC_DRAIN, self.backend):
                    return self._flush_inner()
            return self._flush_inner()
        finally:
            self._flush_depth -= 1
            if self._flush_depth == 0:
                self.stats.drain_s += perf_counter() - t_drain

    def _flush_inner(self) -> int:
        executed = 0
        if self.chaos is not None:
            return self._flush_chaos()
        ready: List[Tuple[float, int, Tuple[int, int]]] = []
        waiting: Dict[int, List[Tuple[int, int]]] = {}
        pending = self._pending_ids

        def offer(qkey: Tuple[int, int]) -> None:
            q = self.queues.get(qkey)
            if not q:
                return
            head = q[0]
            for i in head.in_ids:
                r = self.resolve(i)
                if r in pending:
                    waiting.setdefault(r, []).append(qkey)
                    return
            heapq.heappush(ready, (head.eta, head.seq, qkey))

        for qkey in list(self.queues):
            offer(qkey)
        while pending:
            if not ready:  # pragma: no cover - topological order precludes this
                raise RuntimeError(
                    f"pipelined executor deadlock: {len(pending)} ops "
                    "pending but no queue head is ready"
                )
            _eta, _seq, qkey = heapq.heappop(ready)
            head = self.queues[qkey].popleft()
            # retire before executing: _execute->get must not re-enter flush
            pending.discard(head.out_id)
            self._execute(head.out_id, head.op, head.meta, head.in_ids, head.placement)
            if self.retire_log is not None:
                self.retire_log.append(head.out_id)
            if self.drain_hook is not None:
                self.drain_hook(head.out_id)
            executed += 1
            offer(qkey)
            for waiter in waiting.pop(head.out_id, ()):
                offer(waiter)
        if executed:
            self.stats.n_flushes += 1
        return executed

    # -- chaos dispatch (core.chaos) -----------------------------------------
    def _execute_chaos(self, head: PendingOp,
                       placement: Optional[Tuple[int, int]] = None) -> None:
        """Execute one op through the chaos engine: re-route off dead nodes,
        escalate exhausted transient-fault budgets to the best survivor,
        charge the chaos clocks (backoff + straggler-slowed compute +
        degraded transfers), then run the pure block op."""
        eng = self.chaos
        tr = self.tracer
        node, worker = placement if placement is not None else head.placement
        if node in eng.dead:
            node, worker = eng.pick_node(head, exclude=eng.dead)
            eng.stats.rerouted_ops += 1
            if tr is not None:
                tr.record("reroute", head.op, node, worker,
                          args={"out": head.out_id,
                                "from": head.placement[0]})
        if head.faults > eng.retry.max_retries:
            # per-op retry budget exhausted on this node: the final attempt
            # migrates to the best surviving node (timeout escalation)
            node, worker = eng.pick_node(head, exclude=eng.dead | {node})
            eng.stats.escalations += 1
        eng.charge(head, node, worker)
        self._execute(head.out_id, head.op, head.meta, head.in_ids,
                      (node, worker))
        # backpressure lands on the chaos clock track only (nominal tracks
        # never move, so scheduling stays unperturbed): a fault-in blocks
        # this worker until the h2d completes; spill write-backs are
        # fire-and-forget local d2h (no link contention, stats-only)
        busy_s, _net_s = self.memory.drain_stalls()
        if busy_s:
            eng.clocks.busy[node, worker] += busy_s
            if tr is not None:
                t1 = float(eng.clocks.busy[node, worker])
                tr.record("mem_stall", head.op, node, worker,
                          t0=t1 - busy_s, t1=t1,
                          args={"out": head.out_id, "stall_s": busy_s})

    def _kill_and_replay(self, node: int) -> None:
        """A node died mid-drain: drop its blocks (object-store loss), then
        eagerly replay every lost block from lineage on surviving nodes —
        queued ops depending on them must find operands materialized when
        they retire.  Replay placement and clock charges go through the
        chaos engine.  A *correlated* failure (rack loss) takes the whole
        group down first, so no replay lands on a doomed group member."""
        lost: List[int] = []
        for n in sorted(self.chaos.failure_group(node)):
            if n not in self.chaos.dead:
                lost.extend(self.chaos.kill_node(n))
        if lost:
            self.recover(lost, _flush=False)

    def _flush_chaos(self) -> int:
        """Chaos-mode drain: like ``flush`` but every retirement passes
        through the ChaosEngine.  Per event-loop step: (1) collect ready
        queue heads; (2) re-route heads stranded on dead nodes; (3) project
        each head's finish on the chaos clocks and offer projected
        stragglers (> threshold × median) a speculative duplicate on the
        best survivor — the projected first finisher wins and the loser is
        cancelled before charging anything; (4) retire the earliest
        projected finisher, triggering a planned node failure first if that
        op would start at or after the node's failure time.  Retire order
        follows *chaos-projected* finishes (nominal etas no longer reflect
        reality), which is safe for any dependency-respecting order: block
        ops are pure, so values — and output bits — are unchanged."""
        eng = self.chaos
        pending = self._pending_ids
        executed = 0
        while pending:
            heads: List[Tuple[Tuple[int, int], PendingOp]] = []
            for qkey in sorted(self.queues):
                q = self.queues[qkey]
                if not q:
                    continue
                head = q[0]
                if any(self.resolve(i) in pending for i in head.in_ids):
                    continue
                heads.append((qkey, head))
            if not heads:  # pragma: no cover - topological order precludes this
                raise RuntimeError(
                    f"chaos drain deadlock: {len(pending)} ops pending but "
                    "no queue head is ready")
            for _qkey, head in heads:
                tgt = eng.spec_target.get(head.out_id) or head.placement
                if tgt[0] in eng.dead:
                    eng.spec_target[head.out_id] = eng.pick_node(
                        head, exclude=eng.dead)
                    eng.stats.rerouted_ops += 1
                    if self.tracer is not None:
                        nn, nw = eng.spec_target[head.out_id]
                        self.tracer.record(
                            "reroute", head.op, nn, nw,
                            args={"out": head.out_id, "from": tgt[0]})
            projs = [
                eng.project(h, placement=eng.spec_target.get(h.out_id)
                            or h.placement)
                for _q, h in heads
            ]
            if eng.plan.speculation and len(heads) > 1:
                thresh = eng.plan.spec_threshold * max(
                    float(np.median(projs)), 1e-12)
                for i, (_qkey, head) in enumerate(heads):
                    if head.spec_checked or projs[i] <= thresh:
                        continue
                    head.spec_checked = True
                    cur = eng.spec_target.get(head.out_id) or head.placement
                    dup = eng.pick_node(head, exclude=eng.dead | {cur[0]})
                    dup_proj = eng.project(head, placement=dup)
                    eng.stats.speculated += 1
                    if dup_proj < projs[i]:
                        # the duplicate is projected to finish first: it
                        # wins; the slow original is cancelled (its node is
                        # never charged — loads reconciled)
                        eng.spec_target[head.out_id] = dup
                        eng.stats.spec_wins += 1
                        projs[i] = dup_proj
                        if self.tracer is not None:
                            self.tracer.record(
                                "spec_win", head.op, dup[0], dup[1],
                                args={"out": head.out_id, "from": cur[0],
                                      "proj": dup_proj})
                    else:
                        # original wins the race; duplicate cancelled
                        eng.stats.spec_cancelled += 1
                        if self.tracer is not None:
                            self.tracer.record(
                                "spec_loss", head.op, cur[0], cur[1],
                                args={"out": head.out_id, "dup": dup[0],
                                      "proj": projs[i]})
            i = min(range(len(heads)), key=lambda j: (projs[j], heads[j][1].seq))
            qkey, head = heads[i]
            tgt = eng.spec_target.get(head.out_id) or head.placement
            # OOM injections scheduled before this op's start fire first:
            # the node's budget shrinks and eviction runs under backpressure
            eng.apply_ooms(eng.projected_start(head, placement=tgt))
            if eng.pending_failure(tgt[0], eng.projected_start(head,
                                                               placement=tgt)):
                self._kill_and_replay(tgt[0])
                continue  # re-scan: residency and queues changed
            self.queues[qkey].popleft()
            pending.discard(head.out_id)
            self._execute_chaos(head, placement=eng.spec_target.pop(
                head.out_id, None))
            if self.retire_log is not None:
                self.retire_log.append(head.out_id)
            if self.drain_hook is not None:
                self.drain_hook(head.out_id)
            executed += 1
        # end-of-drain sweeps: OOMs and failures timed inside this drain's
        # makespan fire even if no op ever started on the node after t
        eng.apply_ooms(eng.clocks.makespan())
        for node, t in eng._fail_at.items():
            if (node not in eng.dead and node < eng.clocks.k
                    and t <= eng.clocks.makespan()):
                self._kill_and_replay(node)
        if executed:
            self.stats.n_flushes += 1
        return executed

    def alias(self, new_id: int, old_id: int) -> None:
        self.aliases[new_id] = old_id
        self.shapes[new_id] = self.shapes[self.resolve(old_id)]
        self.block_home[new_id] = self.block_home[self.resolve(old_id)]

    # -- gather ----------------------------------------------------------------
    def assemble(self, ga: GraphArray) -> np.ndarray:
        if self.mode == "sim":
            raise RuntimeError("sim executor holds no data")
        self.flush()
        if ga.ndim == 0:
            return self.backend.to_host(self.get(ga.block(()).vid))
        out = np.zeros(ga.shape, dtype=ga.grid.dtype)
        for idx in ga.grid.iter_indices():
            v = ga.block(idx)
            out[ga.grid.block_slices(idx)] = self.backend.to_host(self.get(v.vid))
        return out

    # -- fault tolerance: lineage replay ------------------------------------------
    def _drop_node_blocks(self, node: int, home_fn=None) -> List[int]:
        """Drop every materialized block homed on ``node`` and return the
        lost ids.  ``home_fn`` overrides the home lookup — the chaos engine
        passes its actual-home view, which tracks blocks that speculation,
        re-routing or replay moved off their planned placement."""
        if home_fn is None:
            home_fn = self.block_home.__getitem__
        lost = [
            vid
            for vid in self.block_home
            if vid not in self.aliases and self.store.get(vid) is not None
            and home_fn(vid)[0] == node
        ]
        for vid in lost:
            self.store[vid] = None
            self.memory.on_lost(vid)
        return lost

    def fail_node(self, node: int) -> List[int]:
        """Drop every block whose home is ``node`` (simulated node failure).
        Pending queues are flushed first: in-flight futures either complete
        before the failure or are lost with the node and replayed from
        lineage — flushing picks the former, keeping replay bookkeeping
        exact.  (The chaos runtime instead kills nodes *mid*-drain:
        ``core.chaos`` + ``_flush_chaos``.)"""
        self.flush()
        return self._drop_node_blocks(node)

    def recover(self, vids: Sequence[int], _flush: bool = True) -> int:
        """Recompute lost blocks from lineage (topological replay), on the
        same backend that originally executed them — torch recovery re-runs
        the memoized callables, so recovered blocks match the lost ones
        bit-for-bit.  Returns the number of re-executed tasks.

        With a chaos engine attached, replays whose recorded placement died
        re-home to the best surviving node (LSHS-cost-scored) and charge the
        chaos clocks; ``_flush=False`` is the engine's re-entrant path for
        deaths injected while the drain itself is running."""
        if _flush:
            self.flush()
        eng = self.chaos
        mm = self.memory
        replayed = 0

        def retire(vid: int, placement: Tuple[int, int], rec: OpRecord) -> None:
            nonlocal replayed
            replayed += 1
            if self.backend is not None:
                self.backend.stats.replays += 1
            if self.tracer is not None:
                self.tracer.record("replay", rec.op, placement[0],
                                   placement[1], args={"out": vid})
            if eng is not None:
                eng.note_replayed(vid, placement, rec)

        # iterative post-order worklist (the recursive ensure() overflowed
        # Python's stack on deep Newton/CP-ALS lineage chains): entries are
        # (vid, expanded); children push in reversed order so replay order —
        # and every stat/clock charge — matches the old recursion exactly.
        # Frees are deferred until the worklist completes: a replayed
        # intermediate shared by several lost consumers must survive all of
        # them, or each would replay it again (exponential blowup).
        mm._defer_free += 1
        try:
            self._recover_worklist(vids, eng, mm, retire)
        finally:
            mm._defer_free -= 1
            if mm._defer_free == 0:
                mm.flush_deferred()
        return replayed

    def _recover_worklist(self, vids, eng, mm, retire) -> None:
        def charge_mm(node: int) -> None:
            busy_s, _net_s = mm.drain_stalls()
            if eng is None:
                return  # stats keep the stall; nominal clocks never move
            if busy_s:
                worker = eng.pick_worker(node)
                eng.clocks.busy[node, worker] += busy_s
                if self.tracer is not None:
                    t1 = float(eng.clocks.busy[node, worker])
                    self.tracer.record("mem_stall", "recover", node, worker,
                                       t0=t1 - busy_s, t1=t1,
                                       args={"stall_s": busy_s})

        stack: List[Tuple[int, bool]] = [
            (v, False) for v in reversed([self.resolve(v) for v in vids])
        ]
        while stack:
            vid, expanded = stack.pop()
            if not expanded:
                vid = self.resolve(vid)
                if self.store.get(vid) is not None:
                    continue
                if mm.is_spilled(vid):
                    # spilled, not lost: the host-side copy survives node
                    # death — fault it in instead of replaying the lineage
                    mm.fault_in(vid)
                    charge_mm(mm.node_of.get(vid, 0))
                    continue
                rec = self.lineage[vid]
                placement = (rec.placement if eng is None
                             else eng.replay_placement(rec))
                if rec.op.startswith("create:"):
                    kind = rec.op.split(":", 1)[1]
                    ckpt = ((rec.meta["path"], rec.meta["key"])
                            if "path" in rec.meta else None)
                    self.store.pop(vid, None)
                    self.create(
                        vid, self.shapes[vid], placement, kind,
                        value=rec.meta.get("value"),
                        seed=rec.meta.get("seed"), ckpt=ckpt,
                    )
                    retire(vid, placement, rec)
                    continue
                stack.append((vid, True))
                # recovery-pin the pending replay's operands: the worklist
                # reads the store directly, so neither GC nor eviction may
                # reclaim them between materialization and use
                mm.pin(rec.in_ids, rec=True)
                for i in reversed(rec.in_ids):
                    stack.append((self.resolve(i), False))
                continue
            rec = self.lineage[vid]
            placement = (rec.placement if eng is None
                         else eng.replay_placement(rec))
            # operands come straight from the store: the worklist has just
            # materialized them, and get() must not re-enter flush when
            # the chaos drain replays mid-flush
            ins = [self.store[self.resolve(i)] for i in rec.in_ids]
            out_shape = self.shapes[vid]
            mm.admit(placement[0], int(np.prod(out_shape)) if out_shape else 1,
                     protect=tuple(self.resolve(i) for i in rec.in_ids))
            self.store[vid] = self.backend.execute(rec.op, rec.meta, ins,
                                                   placement)
            mm.on_materialize(vid, placement[0],
                              int(np.prod(out_shape)) if out_shape else 1)
            mm.unpin(rec.in_ids, rec=True)
            charge_mm(placement[0])
            retire(vid, placement, rec)
