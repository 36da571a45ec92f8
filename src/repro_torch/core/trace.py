"""Flight recorder: a bounded in-memory event log for the block runtime.

Opt-in via ``ArrayContext(trace=True)`` (or ``--trace out.json`` on the
launch drivers).  When enabled, every runtime boundary appends one
``TraceEvent`` to a ring buffer:

==============  ==========================================================
kind            emitted at
==============  ==========================================================
``create``      ``Executor.create`` — block materialized from a creation op
``dispatch``    ``Executor.run_op`` — op handed to the executor (any mode)
``sched``       ``SchedulerBase._dispatch`` — placement decision made
``op``          ``WorkerClocks.place`` — simulated (start, finish) on one
                clock track (``args["track"]`` is ``sync`` / ``pipe`` /
                ``chaos``), with the start-time breakdown (worker-busy,
                operand-ready, transfer-arrival) the critical-path analyzer
                attributes stalls from
``retire``      ``Executor._execute`` — block value materialized (wall time)
``transfer``    ``ClusterState.transition`` — one operand move with element
                and byte counts (``intra`` marks worker->worker moves)
``backpressure``/``mem_stall``  memory-watermark stall charged to a lane
``evict_spill``/``evict_drop``  eviction victim spilled to host / dropped
``fault_in``    spilled block reloaded over h2d
``gc_free``     refcount GC freed a dead block
``oom``         injected OOM shrank a node budget (chaos)
``retry``       transient-fault retries + backoff charged before an op
``spec_win``/``spec_loss``      speculative duplicate won / was cancelled
``reroute``     op moved off a dead node
``node_death``  node killed mid-drain (``args["lost"]`` blocks dropped)
``replay``      lineage replay re-executed a lost block
``plan_hit``/``plan_miss``      plan-cache lookup outcome
==============  ==========================================================

Times ``t0``/``t1`` are *simulated* seconds on the event's clock track
(0 when the event has no simulated extent); ``wall`` is host
``perf_counter`` seconds relative to the recorder's epoch.  The buffer is a
``collections.deque(maxlen=capacity)``: when full, the oldest event is
dropped and ``dropped`` increments, so tracing never grows unbounded.
Disabled tracing costs one attribute load + ``is None`` test per boundary.

Overhead discipline: the buffer holds *raw tuples*; :class:`TraceEvent`
objects (and the hot ``op`` event's args dict, including the
binding-operand argmax) are materialized lazily at read time
(``iter_events``/``of``/export), so the recording path is one tuple build +
one deque append.  The traced/untraced wall ratio is held at ≤ 1.10x on the
card by ``chip_smoke.py``'s ``fault_obs`` phase.

On a GPU the runtime dispatches asynchronously: without
``Executor.profile_sync`` a ``retire`` event's ``wall_s`` covers the host's
dispatch of the op (its launch), not its device time; with it, the backend
waits for the op and ``wall_s`` is the op's end-to-end time.

Viewing a trace in Perfetto
---------------------------
Export with ``ctx.export_trace("out.json")`` (or pass ``--trace out.json``
to ``repro_torch.launch.blocks`` / ``repro_torch.launch.chaos``).  The file is Chrome
``trace_event`` JSON: open https://ui.perfetto.dev and use
"Open trace file" (or navigate to ``chrome://tracing`` in Chrome and click
"Load").  Each simulated node renders as a process row, each worker as a
thread lane; flow arrows connect a producer's retirement to its consumers'
starts; instant markers flag retries, evictions, GC frees, OOMs and node
deaths.  1 simulated second = 1e6 display units (``ts`` is microseconds).

Summarize from the shell with::

    python -m repro_torch.launch.trace_report out.json

which prints the critical path and the makespan decomposition
(compute / transfer / queue-stall / retry / eviction-stall per node).

Spans on the profiler's timeline
--------------------------------
Beside the recorder, and independent of it, the runtime opens ranges on
``torch.profiler``'s own timeline while a profiler session records (and
only then), so that a device trace's idle gaps name the layer the host was
in.  The layers read :func:`profiling` once on entry (``ArrayContext.compute``,
``Executor.flush``); the backend learns the answer through its ``spans``
flag, so an op pays one branch:

=====================================  =====================================
span                                   opened around
=====================================  =====================================
``repro_torch.sched.fingerprint``      the plan-cache fingerprint (``compute``)
``repro_torch.sched.replay``           a cached plan's replay
``repro_torch.sched.lshs``             a cold schedule (``scheduler.schedule``)
``repro_torch.exec.drain``             the outermost ``Executor.flush``
``repro_torch.backend.<op>``           one block op (``TorchBackend.execute``)
``repro_torch.pycollect.gen<N>``       one pass of Python's cyclic collector
``repro_torch.lm.mamba``               an LM layer's Mamba-1 mixer (``models``)
``repro_torch.lm.mamba2``              an LM layer's Mamba-2 (SSD) mixer
``repro_torch.lm.attention``           an LM layer's self-attention
``repro_torch.lm.moe``                 an LM layer's MoE channel
``repro_torch.lm.mlp``                 an LM layer's dense MLP
``repro_torch.lm.head``                the final norm and the logits
``repro_torch.serve.prefill``          an admission's (chunked) prefill
``repro_torch.serve.step``             a batched decode step
=====================================  =====================================

The LM path asks :func:`profiling` once per pass over the stack and opens
its spans through :func:`maybe_span`.  The collector's seconds are also
summed, always, into ``COLLECTOR.seconds`` (``pycollect_s`` in
``ArrayContext.loads()`` and ``ContinuousBatcher.loads()``).
"""
from __future__ import annotations

import gc
import math
import sys
from collections import deque
from contextlib import nullcontext
from time import perf_counter
from typing import Any, Dict, Iterable, List, Optional

DEFAULT_CAPACITY = 1 << 17  # 131072 events; smoke-scale runs use ~1e4


class TraceEvent:
    """One structured runtime event (see module docstring for kinds)."""

    __slots__ = ("kind", "name", "node", "worker", "t0", "t1", "wall", "args")

    def __init__(self, kind: str, name: str, node: int, worker: int,
                 t0: float, t1: float, wall: float, args: Dict[str, Any]):
        self.kind = kind
        self.name = name
        self.node = node
        self.worker = worker
        self.t0 = t0
        self.t1 = t1
        self.wall = wall
        self.args = args

    def as_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "name": self.name, "node": self.node,
            "worker": self.worker, "t0": self.t0, "t1": self.t1,
            "wall": self.wall, "args": self.args,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceEvent({self.kind}, {self.name!r}, n{self.node}w"
                f"{self.worker}, t0={self.t0:.3g}, t1={self.t1:.3g})")


class FlightRecorder:
    """Bounded ring buffer of :class:`TraceEvent`.

    Instrumented call sites hold a ``tracer``/``recorder`` attribute that is
    ``None`` when tracing is off; the recorder itself never mutates runtime
    state (clocks, RNG, stores), so tracing is bit- and clock-neutral by
    construction (``tests/test_torch_trace.py`` holds the port to it).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"trace capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self.events: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self._epoch = perf_counter()

    # -- hot path ---------------------------------------------------------
    # The buffer keeps the raw ``perf_counter()``; the epoch is subtracted
    # when an event is materialized.  The runtime's per-op sites (dispatch,
    # retire, the backend's cache hits, GC frees and the clock taps) inline
    # this body instead of calling it: a Python call per event is most of
    # the recorder's cost on a host-bound runtime.
    def record(self, kind: str, name: str = "", node: int = -1,
               worker: int = -1, t0: float = 0.0, t1: float = 0.0,
               args: Optional[Dict[str, Any]] = None) -> None:
        ev = self.events
        if len(ev) == self.capacity:
            self.dropped += 1
        ev.append((kind, name, node, worker, t0, t1, perf_counter(), args))

    # -- clock-track taps -------------------------------------------------
    def attach_clocks(self, clocks, track: str) -> None:
        """Install a per-``place`` tap on one ``WorkerClocks`` track: every
        simulated op placement becomes an ``op`` event tagged ``track``.

        The hottest record site (2-3 op events per dispatched op):
        ``WorkerClocks.place`` appends one raw tuple, nothing else.  The args
        dict — including the binding-operand argmax — is built lazily in
        _materialize.  ``in_objs``/``xlog`` are fresh lists per ``place``
        call and never mutated afterwards, so holding references is safe;
        ``clocks.ready`` entries are write-once per object (chaos replays
        may overwrite, in which case lazy materialization sees the final —
        still deterministic — value)."""
        clocks.recorder = (self, track)

    def _materialize(self, raw) -> TraceEvent:
        decode = _COMPACT.get((raw[0], len(raw)))
        if decode is not None:
            return decode(raw, self._epoch)
        kind, name, node, worker, t0, t1, wall, args = raw
        if type(args) is tuple:  # deferred payload (hot sites skip the dict)
            if kind == "op":
                (clocks, out_obj, work, in_objs, xlog,
                 w_busy, t_ready, t_xfer) = args
                # binding operand: the input whose availability set t_ready
                # (first max wins — deterministic)
                ready_obj, best = -1, -1.0
                ready = clocks.ready
                for obj, _e in in_objs:
                    t = ready.get(obj, 0.0)
                    if t > best:
                        best, ready_obj = t, obj
                args = {
                    "track": name, "out": out_obj,
                    "ins": [obj for obj, _e in in_objs],
                    "w_busy": w_busy, "t_ready": t_ready, "t_xfer": t_xfer,
                    "ready_obj": ready_obj, "work": work, "xfers": xlog,
                }
            elif kind == "sched":
                args = {"out": args[0], "options": args[1]}
        elif args is None:
            args = {}
        return TraceEvent(kind, name, node, worker, float(t0), float(t1),
                          wall - self._epoch, args)

    def on_transition(self, state, node: int, worker: int, out_obj: int,
                      out_elements: int, new_transfers,
                      eta_sync, eta_pipe) -> None:
        """``ClusterState.transition`` tap: record the operand moves this
        transition caused, with byte counts from the cost model."""
        bpe = state.cost_model.bytes_per_element
        for tr in new_transfers:
            self.record("transfer", f"obj{tr.obj}", tr.dst, worker, args={
                "obj": tr.obj, "src": tr.src, "dst": tr.dst,
                "elements": int(tr.elements),
                "bytes": int(tr.elements * bpe),
                "intra": bool(tr.intra_node),
            })

    # -- inspection -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for raw in self.events:
            out[raw[0]] = out.get(raw[0], 0) + 1
        return out

    def of(self, *kinds: str) -> List[TraceEvent]:
        want = set(kinds)
        return [self._materialize(raw) for raw in self.events
                if raw[0] in want]

    def iter_events(self) -> Iterable[TraceEvent]:
        return (self._materialize(raw) for raw in self.events)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0
        self._epoch = perf_counter()


# -- compact raw layouts of the per-op hot sites ------------------------------
# The runtime's per-op sites append shorter tuples than ``record`` does (the
# fewer values a hot site touches, the less a traced run costs); each layout
# is decoded here into the same event ``record`` would have given.

def _dispatch_event(raw, epoch: float) -> TraceEvent:
    # ("dispatch", OpRecord, queued, wall): the lineage record holds the rest
    _kind, rec, queued, wall = raw
    t0, t1 = rec.times if rec.times else (0.0, 0.0)
    return TraceEvent("dispatch", rec.op, rec.placement[0], rec.placement[1],
                      float(t0), float(t1), wall - epoch,
                      {"out": rec.out_id, "ins": rec.in_ids, "queued": queued})


def _retire_event(raw, epoch: float) -> TraceEvent:
    # ("retire", op, placement, wall, out_id, elements, in_ids, wall_s,
    # executor): ``work`` (output + every input, the clock model's
    # elements-touched measure) is summed here from the executor's shapes
    _kind, op, placement, wall, out_id, elements, in_ids, wall_s, ex = raw
    work = elements
    for i in in_ids:
        work += int(math.prod(ex.shapes[ex.resolve(i)]))
    return TraceEvent("retire", op, placement[0], placement[1], 0.0, 0.0,
                      wall - epoch, {"out": out_id, "elements": elements,
                                     "work": work, "wall_s": wall_s})


def _gc_free_event(raw, epoch: float) -> TraceEvent:
    # ("gc_free", vid, elements, node, wall)
    _kind, vid, elements, node, wall = raw
    return TraceEvent("gc_free", f"obj{vid}", node, -1, 0.0, 0.0, wall - epoch,
                      {"obj": vid, "elements": elements})


#: (kind, tuple length) -> decoder; ``record`` always appends 8 values
_COMPACT = {("dispatch", 4): _dispatch_event, ("retire", 9): _retire_event,
            ("gc_free", 5): _gc_free_event}


# -- spans on the profiler's timeline ------------------------------------------

SCHED_FINGERPRINT = "repro_torch.sched.fingerprint"
SCHED_REPLAY = "repro_torch.sched.replay"
SCHED_LSHS = "repro_torch.sched.lshs"
EXEC_DRAIN = "repro_torch.exec.drain"
LM_MAMBA = "repro_torch.lm.mamba"
LM_MAMBA2 = "repro_torch.lm.mamba2"
LM_ATTENTION = "repro_torch.lm.attention"
LM_MOE = "repro_torch.lm.moe"
LM_MLP = "repro_torch.lm.mlp"
LM_HEAD = "repro_torch.lm.head"
SERVE_PREFILL = "repro_torch.serve.prefill"
SERVE_STEP = "repro_torch.serve.step"


def profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording (none can be where
    torch was never imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


_RANGE = None


def _range_type():
    """The cheapest range the installed torch offers: ``_RecordFunctionFast``
    (about 0.5 us a range with no profiler, ``record_function`` about 15)."""
    global _RANGE
    if _RANGE is None:
        try:
            from torch._C._profiler import _RecordFunctionFast as rng
        except ImportError:  # an older torch
            from torch.profiler import record_function as rng
        _RANGE = rng
    return _RANGE


def span(name: str):
    """A context manager that records the range ``name`` on the profiler's
    timeline (a host event; nothing on the device's)."""
    return _range_type()(name)


#: what a layer enters in place of a span while no profiler records
NO_SPAN = nullcontext()


def maybe_span(on: bool, name: str):
    """The span ``name`` where ``on`` (a :func:`profiling` answer the caller
    read once), else :data:`NO_SPAN`."""
    return span(name) if on else NO_SPAN


class LayerSpan:
    """The span ``name``, during which ``backend`` (when given) opens a span
    per block op as well."""

    __slots__ = ("_range", "_backend", "_was")

    def __init__(self, name: str, backend=None):
        self._range = span(name)
        self._backend = backend
        self._was = False

    def __enter__(self):
        self._range.__enter__()
        be = self._backend
        if be is not None:
            self._was, be.spans = be.spans, True
        return None

    def __exit__(self, *exc):
        if self._backend is not None:
            self._backend.spans = self._was
        return self._range.__exit__(*exc)


class _SpanNames(dict):
    """``prefix + key``, built once per key (so no hot path builds a string)."""

    def __init__(self, prefix: str):
        super().__init__()
        self.prefix = prefix

    def __missing__(self, key) -> str:
        name = self[key] = f"{self.prefix}{key}"
        return name


BACKEND_SPANS = _SpanNames("repro_torch.backend.")
PYCOLLECT_SPANS = _SpanNames("repro_torch.pycollect.gen")


class CollectorClock:
    """A ``gc.callbacks`` hook: sums the seconds Python's cyclic collector
    runs, and opens a ``repro_torch.pycollect.gen<N>`` span over each pass
    while a profiler records.  One per process (:data:`COLLECTOR`), so a pass
    counts once however many contexts are alive."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = None
        self._range = None

    def __call__(self, phase: str, info) -> None:
        if phase == "start":
            if profiling():
                self._range = span(PYCOLLECT_SPANS[info["generation"]])
                self._range.__enter__()
            self._t0 = perf_counter()
            return
        if self._t0 is not None:
            self.seconds += perf_counter() - self._t0
            self._t0 = None
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(None, None, None)

    def install(self) -> None:
        """Add the hook to ``gc.callbacks`` unless it is there already."""
        if not any(cb is self for cb in gc.callbacks):
            gc.callbacks.append(self)


COLLECTOR = CollectorClock()
