"""Memory-budgeted block runtime: refcount GC, spill-vs-recompute eviction,
and per-node budget enforcement with backpressure (NumS §5 made *enforced*).

LSHS minimizes the *maximum memory load* per node, but ``ClusterState.S[:,
MEM]`` only ever accounts memory — nothing frees dead intermediates and
nothing stops a node from overshooting a physical budget.  The
``MemoryManager`` closes that gap at the executor layer, where block values
actually materialize:

* **Lifetime (refcount GC)** — a block stays resident while it is either
  *reachable* (some live ``Vertex`` leaf references it: GraphArray handles,
  tracked with ``weakref.finalize``) or *pending* (a dispatched-but-not-
  retired op consumes it: pin/unpin around dispatch).  When the last
  consumer retires and the last handle dies, the store entry is freed.  A
  freed block is indistinguishable from a lost one — its lineage record
  survives, so a late reader transparently replays it bit-exactly.
* **Budget + backpressure** — with a per-node ``capacity`` (elements), every
  materialization is gated: projected post-op residency above the *high*
  watermark triggers eviction down to the *low* watermark, and the eviction
  cost is charged as simulated backpressure stall (on the chaos clocks when
  an engine is attached) instead of silently overshooting.  Residency is
  tracked separately from ``S[:, MEM]`` (cumulative scheduler accounting):
  enforcement must never perturb placement, so budgeted runs stay
  bit-identical to unbudgeted ones.
* **Spill vs recompute** — each victim is priced with the same
  ``bounds.CommModel`` α-β-γ terms LSHS's cost pass uses: spilling pays a
  d2h/h2d round trip through the Ray shared-memory channel (``R``), while
  recompute pays a dispatch (``γ``) plus modeled compute, and is only viable
  while the victim's lineage inputs are themselves resident.  ``create:``
  roots always drop (replay is a seeded RNG call).  Spilled blocks live in a
  host-side store (driver memory — they survive node death) and fault back
  in on next use through the active backend's h2d path, bitwise.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from time import perf_counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import bounds


@dataclass
class MemStats:
    """Counters for the memory-budgeted runtime (``mem_*`` in reports)."""

    gc_freed_blocks: int = 0
    gc_freed_elements: int = 0
    spills: int = 0
    spill_elements: int = 0
    faultins: int = 0
    faultin_elements: int = 0
    recompute_drops: int = 0
    backpressure_events: int = 0
    backpressure_stall_s: float = 0.0
    violations: int = 0          # dispatches whose node exceeded capacity
    oom_events: int = 0          # chaos-injected budget shrinks applied
    checkpoints: int = 0
    checkpoint_blocks: int = 0
    peak_live_elements: int = 0  # max per-node resident elements seen
    peak_store_blocks: int = 0   # max resident blocks (all nodes)
    peak_store_elements: int = 0  # max total resident elements (all nodes)

    def reset(self) -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, 0.0 if f == "backpressure_stall_s" else 0)


class MemoryManager:
    """Per-executor block residency manager (see module docstring).

    Always constructed (peak accounting is cheap and always on); GC, pins,
    and budget enforcement activate only after ``configure(gc=True)`` or a
    capacity is set, so the default executor behaves exactly like the seed.
    """

    def __init__(self, executor):
        self.executor = executor
        self.enabled = False
        self.capacity: Optional[Dict[int, float]] = None
        self.high = 0.9
        self.low = 0.75
        self.comm = bounds.CommModel()
        self.cost_model = None  # cluster.CostModel, set by configure()
        self.stats = MemStats()
        # residency accounting (always on)
        self.live_set: set = set()            # materialized, node-resident vids
        self.node_of: Dict[int, int] = {}     # vid -> node it materialized on
        self.elems: Dict[int, int] = {}       # vid -> elements
        self.live: Dict[int, float] = {}      # node -> resident elements
        self.total_live: float = 0.0
        # lifetime state (enabled only)
        self.pins: Dict[int, int] = {}        # vid -> pending-consumer count
        self.rec_pins: Dict[int, int] = {}    # vid -> recovery-worklist pins
        self.handles: Dict[int, int] = {}     # vid -> live Vertex handle count
        self.spill_store: Dict[int, np.ndarray] = {}  # host-side spill store
        self.last_use: Dict[int, int] = {}    # vid -> use sequence (LRU)
        self._use_seq = 0
        # free deferral (recovery): >0 means maybe_free only records the vid;
        # without it, a replayed intermediate shared by several lost
        # consumers would be freed after the first one retires and replayed
        # again for each of the rest — exponential replay blowup
        self._defer_free = 0
        self._deferred: set = set()
        # clock-stall accumulators, drained by the chaos execute path:
        # spill write-backs overlap compute (net-out channel), fault-ins
        # block the waiting consumer (busy channel)
        self._net_stall_acc = 0.0
        self._busy_stall_acc = 0.0
        # cache of opened checkpoint archives: path -> {key: host array}
        self._ckpt_cache: Dict[str, Dict[str, np.ndarray]] = {}

    # -- configuration -------------------------------------------------------
    def configure(
        self,
        num_nodes: int,
        capacity: Optional[float] = None,
        gc: bool = False,
        high: float = 0.9,
        low: float = 0.75,
        cost_model=None,
        comm: Optional[bounds.CommModel] = None,
    ) -> None:
        """Install budget/GC policy.  ``capacity`` is elements per node."""
        if not 0.0 < low <= high <= 1.0:
            raise ValueError(f"watermarks must satisfy 0 < low <= high <= 1, "
                             f"got low={low} high={high}")
        self.enabled = bool(gc) or capacity is not None
        if capacity is not None:
            self.capacity = {n: float(capacity) for n in range(num_nodes)}
        self.high = high
        self.low = low
        if cost_model is not None:
            self.cost_model = cost_model
        if comm is not None:
            self.comm = comm

    @property
    def bytes_per_element(self) -> int:
        return 4 if self.executor.dtype == "float32" else 8

    # -- residency accounting ------------------------------------------------
    def _touch(self, vid: int) -> None:
        self._use_seq += 1
        self.last_use[vid] = self._use_seq

    def on_materialize(self, vid: int, node: int, elements: int) -> None:
        """A block value landed in the store at ``node`` (create/op/replay/
        fault-in) — always called, even when GC/budget are disabled."""
        self.node_of[vid] = node
        self.elems[vid] = elements
        if vid not in self.live_set:
            self.live_set.add(vid)
            self.live[node] = self.live.get(node, 0.0) + elements
            self.total_live += elements
        self._touch(vid)
        s = self.stats
        s.peak_live_elements = max(s.peak_live_elements, int(self.live[node]))
        s.peak_store_blocks = max(s.peak_store_blocks, len(self.live_set))
        s.peak_store_elements = max(s.peak_store_elements, int(self.total_live))

    def _forget(self, vid: int) -> None:
        if vid in self.live_set:
            self.live_set.discard(vid)
            node = self.node_of.get(vid)
            e = self.elems.get(vid, 0)
            if node is not None:
                self.live[node] = max(self.live.get(node, 0.0) - e, 0.0)
            self.total_live = max(self.total_live - e, 0.0)

    def on_lost(self, vid: int) -> None:
        """A node death dropped this block (``_drop_node_blocks``)."""
        self._forget(vid)

    # -- lifetime: pins + handles -------------------------------------------
    def pin(self, in_ids: Sequence[int], rec: bool = False) -> None:
        """``rec=True`` marks recovery-worklist pins: replays read the store
        directly (no fault-in on use), so those pins are eviction-hard."""
        if not self.enabled:
            return
        pins = self.rec_pins if rec else self.pins
        for i in in_ids:
            rv = self.executor.resolve(i)
            pins[rv] = pins.get(rv, 0) + 1
            self._touch(rv)

    def unpin(self, in_ids: Sequence[int], rec: bool = False) -> None:
        if not self.enabled:
            return
        pins = self.rec_pins if rec else self.pins
        for i in in_ids:
            rv = self.executor.resolve(i)
            n = pins.get(rv, 0) - 1
            if n <= 0:
                pins.pop(rv, None)
            else:
                pins[rv] = n
            self.maybe_free(rv)

    def note_handle(self, vertex) -> None:
        """Register a live ``Vertex`` leaf as a reachability root for its
        block.  The finalizer fires when the vertex is collected; handle and
        finalizer are symmetric, so double registration is harmless."""
        if not self.enabled:
            return
        rv = self.executor.resolve(vertex.vid)
        self.handles[rv] = self.handles.get(rv, 0) + 1
        weakref.finalize(vertex, self._handle_dropped, rv)

    def _handle_dropped(self, rv: int) -> None:
        n = self.handles.get(rv, 0) - 1
        if n <= 0:
            self.handles.pop(rv, None)
        else:
            self.handles[rv] = n
        self.maybe_free(rv)

    def maybe_free(self, vid: int) -> None:
        """Free the store entry once no handle and no pending consumer needs
        it.  Fires only from unpin/handle-drop events: a block between
        materialization and its first consumer's dispatch is never touched."""
        if not self.enabled:
            return
        if self._defer_free:
            self._deferred.add(vid)
            return
        if (self.pins.get(vid, 0) > 0 or self.rec_pins.get(vid, 0) > 0
                or self.handles.get(vid, 0) > 0):
            return
        if vid in self.spill_store:  # dead spill entry: nobody will fault it in
            e = self.elems.get(vid, 0)
            del self.spill_store[vid]
            self.stats.gc_freed_blocks += 1
            self.stats.gc_freed_elements += e
            return
        if vid not in self.live_set:
            return
        e = self.elems.get(vid, 0)
        node = self.node_of.get(vid, -1)
        self._forget(vid)
        self.executor.store[vid] = None
        self.stats.gc_freed_blocks += 1
        self.stats.gc_freed_elements += e
        tr = self.executor.tracer
        if tr is not None:
            # FlightRecorder.record, inlined in its compact gc_free layout
            ev = tr.events
            if len(ev) == tr.capacity:
                tr.dropped += 1
            ev.append(("gc_free", vid, e, node, perf_counter()))

    def flush_deferred(self) -> None:
        """Run the frees recorded while deferral was active (recovery end)."""
        deferred, self._deferred = self._deferred, set()
        for vid in deferred:
            self.maybe_free(vid)

    # -- budget enforcement --------------------------------------------------
    def admit(self, node: int, out_elements: int,
              protect: Tuple[int, ...] = ()) -> float:
        """Gate one materialization of ``out_elements`` on ``node``: over the
        high watermark, evict down to the low watermark and return the
        simulated stall charged for it (backpressure).  ``protect`` names the
        admitting op's own (resolved) operands — never evicted, or the op
        would thrash faulting them straight back in.  A dispatch that still
        exceeds capacity after eviction counts as a violation."""
        if self.capacity is None:
            return 0.0
        cap = self.capacity.get(node)
        if cap is None:
            return 0.0
        projected = self.live.get(node, 0.0) + out_elements
        if projected <= self.high * cap:
            return 0.0
        self.stats.backpressure_events += 1
        target = max(self.low * cap - out_elements, 0.0)
        stall = self._evict_node(node, target, protect=protect)
        if self.live.get(node, 0.0) + out_elements > cap:
            self.stats.violations += 1
        self.stats.backpressure_stall_s += stall
        return stall

    def _victims(self, node: int,
                 protect: Tuple[int, ...] = ()) -> List[Tuple[int, bool]]:
        """Evictable ``(vid, pinned)`` blocks on ``node``, unpinned first,
        least-recently-used first within each class.  Pinned blocks (operands
        of dispatched-but-unretired ops) are *spill-only* victims: the spill
        store keeps their bits and the consumer faults them back in — except
        during a recovery worklist, whose replays read the store directly.
        Deterministic (seq order)."""
        keep = set(protect)
        cand = [
            (vid, self.pins.get(vid, 0) > 0) for vid in self.live_set
            if self.node_of.get(vid) == node and vid not in keep
            and self.rec_pins.get(vid, 0) == 0  # replay reads store directly
        ]
        # unpinned: LRU (coldest first).  Pinned: *most* recently dispatched
        # first — pin() touches at dispatch and queues drain FIFO-ish, so a
        # recent touch means the consumer retires latest (Belady-flavored:
        # spill the block whose reuse is farthest, not the one needed next).
        cand.sort(key=lambda vp: (
            vp[1],
            -self.last_use.get(vp[0], 0) if vp[1]
            else self.last_use.get(vp[0], 0),
            vp[0]))
        return cand

    def _stall_seconds(self, elements: int) -> float:
        """Clock-track cost of moving one block over the spill channel —
        priced in the same units as ``WorkerClocks`` makespans (the α-β-γ
        ``CommModel`` keeps Ray-scale latencies for the *decision* pricing,
        which would dwarf µs-scale clock tracks if charged directly)."""
        if self.cost_model is not None:
            return self.cost_model.transfer_seconds(elements)
        return self.comm.R(elements)

    def _spill_cost(self, elements: int) -> float:
        # d2h now + h2d on fault-in, both through the shared-memory channel
        return 2.0 * self.comm.R(elements)

    def _recompute_cost(self, vid: int) -> Optional[float]:
        rec = self.executor.lineage.get(vid)
        if rec is None:
            return None
        if rec.op.startswith("create:"):
            return self.comm.gamma  # a seeded RNG / constant re-create
        for i in rec.in_ids:
            rv = self.executor.resolve(i)
            if rv not in self.live_set and rv not in self.spill_store:
                return None  # inputs gone: replay would cascade — spill
        work = self.elems.get(vid, 0) + sum(
            self.elems.get(self.executor.resolve(i), 0) for i in rec.in_ids)
        compute = (self.cost_model.compute_seconds(work)
                   if self.cost_model is not None else 0.0)
        return self.comm.gamma + compute

    def _evict_node(self, node: int, target: float,
                    protect: Tuple[int, ...] = ()) -> float:
        """Evict LRU victims on ``node`` until residency <= ``target`` (or no
        victim remains).  Each unpinned victim takes the cheaper of spill /
        recompute under the CommModel pricing; pinned victims are spill-only
        (their bits must survive for the waiting consumer).  Returns the
        simulated stall in clock-track seconds."""
        stall = 0.0
        ex = self.executor
        tr = ex.tracer
        for vid, pinned in self._victims(node, protect=protect):
            if self.live.get(node, 0.0) <= target:
                break
            e = self.elems.get(vid, 0)
            rc = None if pinned else self._recompute_cost(vid)
            sc = self._spill_cost(e)
            if ex.mode == "sim" or (rc is not None and rc <= sc):
                # drop: lineage replay rematerializes on next use
                self._forget(vid)
                ex.store[vid] = None
                self.stats.recompute_drops += 1
                if tr is not None:
                    tr.record("evict_drop", f"obj{vid}", node, -1,
                              args={"obj": vid, "elements": e})
            else:
                host = ex.backend.to_host(ex.store[vid])
                self.spill_store[vid] = host
                self._forget(vid)
                ex.store[vid] = None
                self.stats.spills += 1
                self.stats.spill_elements += e
                stall += self._stall_seconds(e)
                if tr is not None:
                    tr.record("evict_spill", f"obj{vid}", node, -1,
                              args={"obj": vid, "elements": e,
                                    "stall_s": self._stall_seconds(e)})
        self._net_stall_acc += stall
        return stall

    def oom(self, node: int, factor: float) -> float:
        """Chaos OOM injection: shrink ``node``'s budget to ``factor`` × its
        current capacity (or × current residency when unbudgeted) and evict
        down to the new low watermark.  Returns the simulated stall."""
        if self.capacity is None:
            self.capacity = {}
        cur = self.capacity.get(node)
        base = cur if cur is not None else max(self.live.get(node, 0.0), 1.0)
        new_cap = max(factor * base, 1.0)
        self.capacity[node] = new_cap
        self.stats.oom_events += 1
        stall = self._evict_node(node, self.low * new_cap)
        self.stats.backpressure_stall_s += stall
        return stall

    def drain_stalls(self) -> Tuple[float, float]:
        """Return and reset the accumulated ``(busy, net_out)`` clock stalls
        since the last drain.  The chaos execute path charges them to the
        engine's clock track; non-chaos paths discard (nominal clocks must
        never move, or budgeted scheduling would diverge from unbudgeted)."""
        busy, net = self._busy_stall_acc, self._net_stall_acc
        self._busy_stall_acc = 0.0
        self._net_stall_acc = 0.0
        return busy, net

    # -- transparent fault-in / revive --------------------------------------
    def is_spilled(self, vid: int) -> bool:
        return vid in self.spill_store

    def fault_in(self, vid: int):
        """Reload a spilled block through the backend's h2d path.  The spill
        store is host-side (driver memory): it survives node death, so a
        block whose home died faults in on the best survivor instead."""
        ex = self.executor
        host = self.spill_store.pop(vid)
        node = self.node_of.get(vid, 0)
        eng = ex.chaos
        if eng is not None and node in eng.dead:
            node = min(n for n in range(eng.clocks.k) if n not in eng.dead)
        e = self.elems.get(vid, int(host.size))
        stall = self.admit(node, e, protect=(vid,))
        stall += self._stall_seconds(e)
        self._busy_stall_acc += self._stall_seconds(e)
        self.stats.backpressure_stall_s += self._stall_seconds(e)
        self.stats.faultins += 1
        self.stats.faultin_elements += e
        if ex.tracer is not None:
            ex.tracer.record("fault_in", f"obj{vid}", node, -1,
                             args={"obj": vid, "elements": e,
                                   "stall_s": self._stall_seconds(e)})
        value = ex.backend.from_host(host, (node, 0))
        ex.store[vid] = value
        self.on_materialize(vid, node, e)
        return value, stall

    def revive(self, vid: int):
        """Produce the value of a freed/spilled block: fault spills back in,
        replay dropped blocks from lineage (both bitwise)."""
        if vid in self.spill_store:
            value, _ = self.fault_in(vid)
            return value
        if vid in self.executor.lineage:
            self.executor.recover([vid], _flush=False)
            return self.executor.store[vid]
        return None

    # -- reporting -----------------------------------------------------------
    def live_blocks(self) -> int:
        return len(self.live_set)

    def peak_bytes(self) -> int:
        return self.stats.peak_store_elements * self.bytes_per_element

    def snapshot(self) -> Dict[str, float]:
        s = self.stats
        cap = max(self.capacity.values()) if self.capacity else 0.0
        return {
            "mem_capacity": cap,
            "mem_high_watermark": self.high,
            "mem_low_watermark": self.low,
            "mem_live_blocks": len(self.live_set),
            "mem_live_elements": self.total_live,
            "mem_peak_live_elements": s.peak_live_elements,
            "mem_peak_store_blocks": s.peak_store_blocks,
            "mem_peak_store_bytes": self.peak_bytes(),
            "mem_gc_freed_blocks": s.gc_freed_blocks,
            "mem_gc_freed_elements": s.gc_freed_elements,
            "mem_spills": s.spills,
            "mem_spill_elements": s.spill_elements,
            "mem_faultins": s.faultins,
            "mem_recompute_drops": s.recompute_drops,
            "mem_backpressure_events": s.backpressure_events,
            "mem_backpressure_stall_s": s.backpressure_stall_s,
            "mem_violations": s.violations,
            "mem_oom_events": s.oom_events,
            "mem_checkpoints": s.checkpoints,
            "mem_checkpoint_blocks": s.checkpoint_blocks,
        }

    # -- checkpoint archive cache -------------------------------------------
    def ckpt_block(self, path: str, key: str) -> np.ndarray:
        """Host value of one checkpointed block (``create:restore`` roots)."""
        arch = self._ckpt_cache.get(path)
        if arch is None:
            from repro_torch.checkpoint.ckpt import load_npz

            arch = load_npz(path)
            self._ckpt_cache[path] = arch
        return arch[key]
