"""ArrayContext: ties grids, layouts, cluster state, scheduler and executor
together — the user-facing entry point of the NumS reproduction (Fig. 1).

    ctx = ArrayContext(cluster=ClusterSpec(4, 4), node_grid=(2, 2))
    X = ctx.random((256, 256), grid=(4, 4))
    Y = ctx.random((256, 256), grid=(4, 4))
    Z = (X @ Y).compute()        # LSHS-scheduled
    Z.to_numpy()

Creation operations execute immediately and are placed by the hierarchical
data layout; numerical expressions are scheduled on ``compute()``.

The port's context runs its blocks on the card unless the caller asks for
the CPU: ``device=None`` means every visible CUDA device and raises where
there is none; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import os
import random
import zlib
from time import perf_counter
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from .cluster import ClusterState, CostModel
from .executor import Executor
from .graph_array import GraphArray, Vertex, einsum, leaf, matmul, tensordot
from .grid import ArrayGrid, auto_grid
from .layout import ClusterSpec, HierarchicalLayout, NodeGrid, default_node_grid
from .plan import (
    PlanCache,
    PlanRecorder,
    SchedStats,
    fingerprint,
    replay_plan,
    structure_counts,
)
from .schedulers import SchedulerBase, make_scheduler
from .trace import (
    COLLECTOR,
    NO_SPAN,
    SCHED_FINGERPRINT,
    SCHED_LSHS,
    SCHED_REPLAY,
    LayerSpan,
    profiling,
    span,
)

#: ``loads()`` keys of the port that the reference has not: host seconds
#: inside the backend's ``execute`` and inside Python's cyclic collector
PORT_LOADS = ("execute_s", "pycollect_s")


class ArrayContext:
    def __init__(
        self,
        cluster: ClusterSpec = ClusterSpec(1, 1),
        node_grid: Optional[Union[NodeGrid, Tuple[int, ...]]] = None,
        scheduler: Union[str, SchedulerBase] = "lshs",
        backend: Optional[str] = None,
        system: str = "ray",
        cost_model: Optional[CostModel] = None,
        seed: int = 0,
        fuse: bool = False,
        pipeline: bool = False,
        plan_cache: Union[bool, PlanCache] = False,
        auto_layout: bool = False,
        dtype: Optional[str] = None,
        mem_capacity: Optional[float] = None,
        gc: Optional[bool] = None,
        mem_watermarks: Tuple[float, float] = (0.9, 0.75),
        trace: Union[bool, int, object] = False,
        calibration: Optional[object] = None,
        device: Optional[str] = None,
    ):
        # backend: the block-kernel execution substrate (``repro_torch.backend``):
        # "cuda" (torch + the hand-written Hopper matmul kernel, the
        # default), "torch" (torch ops on device-resident tensors), "numpy"
        # (reference interpreter), or "sim" (metadata only).
        #
        # dtype: block element type.  ``None`` picks the backend's natural
        # dtype — float64 for numpy (the bit-exact oracle) and float32 for
        # torch/cuda (the accelerator-native type); parity tests request
        # float64.
        #
        # device: where torch/cuda blocks live — ``None`` or "cuda" is every
        # visible CUDA device (node i on device i % count), "cuda:<i>" one
        # card, "cpu" the host.  Ignored by numpy and sim.
        if backend is None:
            backend = "cuda"
        self.cluster = cluster
        if node_grid is None:
            node_grid = NodeGrid((cluster.num_nodes,))
        elif not isinstance(node_grid, NodeGrid):
            node_grid = NodeGrid(tuple(node_grid))
        if node_grid.num_nodes != cluster.num_nodes:
            raise ValueError("node_grid must factor the cluster's node count")
        self.node_grid = node_grid
        # measured-cost calibration (repro_torch.obs.calibrate): ``calibration``
        # is a CalibrationProfile, a dict, or a path to a profile JSON.  The
        # fitted per-op-kind compute coefficients and link alpha/beta replace
        # the CostModel's default constants before any clock state is built,
        # so schedulers, chaos clocks and the memory manager all see the
        # calibrated model.  The profile signature is folded into the plan
        # cache's config signature below: swapping profiles invalidates plans.
        if calibration is not None:
            from repro_torch.obs.calibrate import load_profile

            self.calibration = load_profile(calibration)
            cost_model = self.calibration.cost_model(cost_model)
        else:
            self.calibration = None
        self.state = ClusterState(cluster, cost_model=cost_model, system=system)
        self.pipeline = pipeline
        self.backend = backend
        self.device = device
        self.executor = Executor(mode=backend, seed=seed, pipeline=pipeline,
                                 dtype=dtype, devices=_devices(device))
        self.dtype = self.executor.dtype
        # memory-budgeted runtime (core.memory): ``mem_capacity`` is a
        # per-node budget in elements; ``gc`` enables refcount block freeing
        # (defaults on whenever a budget is set).  Residency is enforced at
        # the executor layer only — never folded into the scheduling state or
        # the plan-cache config signature — so budgeted runs produce
        # bit-identical outputs to unbudgeted ones.
        if gc is None:
            gc = mem_capacity is not None
        self.executor.memory.configure(
            cluster.num_nodes, capacity=mem_capacity, gc=gc,
            high=mem_watermarks[0], low=mem_watermarks[1],
            cost_model=self.state.cost_model,
        )
        self.state.set_mem_capacity(mem_capacity)
        self._ckpt_seq = 0
        self.scheduler = (
            scheduler
            if isinstance(scheduler, SchedulerBase)
            else make_scheduler(scheduler, cluster.num_nodes)
        )
        self._seed = seed
        self._create_counter = 0
        self.fuse_enabled = fuse
        # chaos runtime (core.chaos): ``enable_chaos`` attaches an engine
        self.chaos_engine = None
        # auto layout (§4 heuristic, per-array): creations and scheduled
        # outputs get a node grid factored to match their own block grid
        # (``default_node_grid``) instead of the context-wide ``node_grid``;
        # explicit per-array overrides (reshard targets) always win
        self.auto_layout = auto_layout
        # plan cache (structural-fingerprint -> placement plan); an existing
        # PlanCache may be shared across compatible contexts
        if isinstance(plan_cache, PlanCache):
            self.plan_cache: Optional[PlanCache] = plan_cache
        else:
            self.plan_cache = PlanCache() if plan_cache else None
        self.sched_stats = SchedStats()
        # configuration signature folded into every fingerprint: any change
        # to cluster/cost-model/scheduler/seed invalidates cached plans
        cm = self.state.cost_model
        self._config_sig = zlib.crc32(repr((
            cluster.num_nodes, cluster.workers_per_node,
            cluster.intra_node_coeff, system, cm.mode, cm.bytes_per_element,
            cm.hbm_bw, cm.link_bw, self.scheduler.name,
            getattr(self.scheduler, "dest_hint", False), seed, auto_layout,
            cm.calibration_sig,
        )).encode())
        # flight recorder (core.trace): ``trace`` is False (off), True
        # (default capacity), an int capacity, or a FlightRecorder to share.
        # The recorder observes — it never mutates clocks, RNG or stores —
        # so traced runs are bit- and clock-identical to untraced ones.
        self.tracer = None
        # note: not ``if trace:`` — an empty FlightRecorder is len()-falsy
        if trace is not None and trace is not False and trace != 0:
            from .trace import FlightRecorder

            if isinstance(trace, FlightRecorder):
                rec = trace
            elif isinstance(trace, bool):
                rec = FlightRecorder()
            else:
                rec = FlightRecorder(capacity=int(trace))
            self._install_tracer(rec)
        # unified metrics registry (repro_torch.obs.metrics): every stats source
        # registers as a named provider and ``loads()`` is one ``snapshot()``
        # — the key schema is golden-tested per feature set in test_obs
        from repro_torch.obs.metrics import MetricsRegistry

        self.metrics = MetricsRegistry()
        self._register_metrics()
        COLLECTOR.install()
        self._pycollect0 = COLLECTOR.seconds

    def _install_tracer(self, rec) -> None:
        self.tracer = rec
        self.executor.tracer = rec
        self.state.tracer = rec
        rec.attach_clocks(self.state.clocks_sync, "sync")
        rec.attach_clocks(self.state.clocks_pipe, "pipe")

    def _register_metrics(self) -> None:
        """Wire the runtime stats objects into the registry as providers, in
        the historical ``loads()`` assembly order (cluster summary, executor
        and scheduling counters, comm bounds, backend substrate, memory
        manager, chaos engine) so the merged key schema is stable."""
        reg = self.metrics

        def _cluster():
            return self.state.summary()

        def _runtime():
            st = self.sched_stats
            st.note_exec(self.executor.stats)
            return {
                "n_rfc": self.executor.stats.n_rfc,
                "transfers": self.state.network_elements(),
                "makespan": self.state.makespan(pipeline=self.pipeline),
                "pending_ops": self.executor.pending_count(),
                "plan_hits": st.plan_hits,
                "plan_misses": st.plan_misses,
                "sched_overhead_s": st.scheduling_overhead_s,
                "dispatch_s": st.dispatch_s,
                "drain_s": st.drain_s,
                "execute_s": self.executor.stats.execute_s,
                "pycollect_s": COLLECTOR.seconds - self._pycollect0,
                "reshards": st.reshards,
                "reshard_moved": st.reshard_moved_elements,
            }

        def _comm():
            # comm-bound accounting: per linalg op, measured network
            # elements / moved-element floor (``bounds``)
            st = self.sched_stats
            out = {}
            for op, ratio in st.comm_ratios.items():
                out[f"comm_moved_{op}"] = st.comm_moved[op]
                out[f"comm_lower_{op}"] = st.comm_lower[op]
                out[f"comm_ratio_{op}"] = ratio
            return out

        def _backend():
            be = self.executor.backend
            if be is None:
                return {}
            return be.stats.as_dict()

        def _memory():
            self.sched_stats.note_memory(self.executor.memory)
            return dict(self.sched_stats.mem)

        def _chaos():
            if self.chaos_engine is None:
                return {}
            return self.chaos_engine.summary()

        reg.register_provider("cluster", _cluster)
        reg.register_provider("runtime", _runtime)
        reg.register_provider("comm", _comm)
        reg.register_provider("backend", _backend)
        reg.register_provider("memory", _memory)
        reg.register_provider("chaos", _chaos)

    # -- creation (eager, §4) -------------------------------------------------
    def _layout(self, grid: ArrayGrid,
                node_grid: Optional[NodeGrid] = None) -> HierarchicalLayout:
        if node_grid is None:
            node_grid = (default_node_grid(grid, self.cluster)
                         if self.auto_layout else self.node_grid)
        return HierarchicalLayout(grid, node_grid, self.cluster)

    def _create(
        self,
        shape: Sequence[int],
        grid: Optional[Sequence[int]],
        kind: str,
        value: Optional[np.ndarray] = None,
    ) -> GraphArray:
        shape = tuple(int(s) for s in shape)
        if grid is None:
            agrid = auto_grid(shape, self.cluster.num_workers, dtype=self.dtype)
        else:
            agrid = ArrayGrid(shape, tuple(int(g) for g in grid), self.dtype)
        ng = default_node_grid(agrid, self.cluster) if self.auto_layout else None
        layout = self._layout(agrid, ng)
        blocks = np.empty(agrid.grid if agrid.grid else (), dtype=object)
        for idx in agrid.iter_indices():
            node, worker = layout.placement(idx)
            bshape = agrid.block_shape(idx)
            v = leaf(bshape, node, worker)
            self._create_counter += 1
            bval = value[agrid.block_slices(idx)] if value is not None else None
            self.executor.create(
                v.vid, bshape, (node, worker), kind=kind, value=bval,
                seed=self._seed * 1_000_003 + self._create_counter,
            )
            self.state.add_object(v.vid, node, worker, int(np.prod(bshape)))
            self.executor.note_handle(v)
            blocks[idx if agrid.grid else ()] = v
        return GraphArray(self, agrid, blocks, node_grid=ng)

    def zeros(self, shape, grid=None) -> GraphArray:
        return self._create(shape, grid, "zeros")

    def ones(self, shape, grid=None) -> GraphArray:
        return self._create(shape, grid, "ones")

    def random(self, shape, grid=None) -> GraphArray:
        return self._create(shape, grid, "random")

    def uniform(self, shape, grid=None) -> GraphArray:
        return self._create(shape, grid, "uniform")

    def from_numpy(self, arr: np.ndarray, grid=None) -> GraphArray:
        arr = np.asarray(arr, dtype=self.dtype)
        return self._create(arr.shape, grid, "value", value=arr)

    # -- algebra entry points ---------------------------------------------------
    matmul = staticmethod(matmul)
    tensordot = staticmethod(tensordot)
    einsum = staticmethod(einsum)

    # -- scheduling (LSHS, §5) -----------------------------------------------------
    def compute(self, ga: GraphArray) -> GraphArray:
        if ga.is_materialized():
            return ga
        if self.fuse_enabled:
            from .fusion import fuse_graph

            fuse_graph(ga)
        # per-array layout override (reshard target) beats auto/default layout
        out_layout = self._layout(ga.grid, getattr(ga, "node_grid", None))
        roots = []
        forced: Dict[int, Tuple[int, int]] = {}
        for idx in ga.grid.iter_indices():
            v = ga.block(idx)
            if v.is_leaf():
                continue
            roots.append(v)
            forced[v.vid] = out_layout.placement(idx)
        stats = self.sched_stats
        stats.computes += 1
        # frontier sampling seeded from an intern-free structural summary,
        # and the worker round-robin cursor reset (with a structure-derived
        # offset) per schedule: cold scheduling is deterministic given
        # (structure, load state), so on structurally repeating loops a cold
        # re-schedule repeats the recorded plan's decisions exactly (see
        # plan.py).  With the cache off, only the count-based summary is
        # needed — the full token stream is skipped.  While a profiler
        # records, each phase below is a span (core/trace.py).
        spans = profiling()
        t0 = perf_counter()
        with span(SCHED_FINGERPRINT) if spans else NO_SPAN:
            if self.plan_cache is not None:
                fp = fingerprint(roots, forced, self.state, self._config_sig)
                rng_key = fp.rng_key
            else:
                fp = None
                rng_key = structure_counts(roots)
        stats.fingerprint_s += perf_counter() - t0
        rng = random.Random(rng_key ^ (self._seed * 2654435761))
        self.state.begin_schedule((rng_key >> 7) % self.cluster.workers_per_node)
        if fp is not None:
            cached = self.plan_cache.get(fp.key)
            if cached is not None:
                t1 = perf_counter()
                with LayerSpan(SCHED_REPLAY, self.executor.backend) if spans else NO_SPAN:
                    replay_plan(cached, fp.verts, self.state, self.executor, stats=stats)
                stats.replay_s += perf_counter() - t1
                stats.plan_hits += 1
                if self.tracer is not None:
                    self.tracer.record(
                        "plan_hit", f"fp:{fp.rng_key & 0xFFFF:04x}",
                        args={"roots": len(roots)})
                return ga
            recorder = PlanRecorder(fp.cid_of)
        else:
            recorder = None
        for root in roots:
            self._annotate_dest(root, forced[root.vid][0])
        t1 = perf_counter()
        with LayerSpan(SCHED_LSHS, self.executor.backend) if spans else NO_SPAN:
            self.scheduler.schedule(roots, forced, self.state, self.executor, rng,
                                    recorder=recorder, stats=stats)
        stats.sched_cold_s += perf_counter() - t1
        if recorder is not None:
            self.plan_cache.put(fp.key, recorder.plan())
            stats.plan_misses += 1
            if self.tracer is not None:
                self.tracer.record(
                    "plan_miss", f"fp:{fp.rng_key & 0xFFFF:04x}",
                    args={"roots": len(roots)})
        return ga

    @staticmethod
    def _annotate_dest(root, node: int) -> None:
        """Tag the subtree with its output's layout node (used by LSHS+'s
        destination hint; plain LSHS ignores it)."""
        stack = [root]
        while stack:
            v = stack.pop()
            if v.kind == "leaf" or "dest" in v.meta:
                continue
            v.meta["dest"] = node
            stack.extend(v.children)

    # -- lineage checkpointing (bounded recovery) -------------------------------
    def checkpoint(self, arrays: Sequence[GraphArray], dir: str,
                   step: Optional[int] = None, keep: int = 3) -> str:
        """Snapshot the live blocks of ``arrays`` through the atomic
        ``repro_torch.checkpoint`` staging machinery and rewrite their lineage
        records to ``create:restore`` roots, truncating replay depth: a node
        kill after this point replays at most the ops since the last
        checkpoint, not the whole history back to ``create:`` roots.  Blocks
        are copied off their device into the archive as numpy arrays.
        Returns the published checkpoint directory."""
        from repro_torch.checkpoint import ckpt as _ckpt

        from .executor import OpRecord

        ex = self.executor
        if ex.mode == "sim":
            raise RuntimeError("sim executor holds no data to checkpoint")
        arrays = list(arrays)
        for ga in arrays:
            self.compute(ga)
        ex.flush()
        state: Dict[str, np.ndarray] = {}
        metas = []
        for ga in arrays:
            blocks = []
            for idx in ga.grid.iter_indices():
                v = ga.block(idx)
                rv = ex.resolve(v.vid)
                key = f"b{rv}"
                if key not in state:
                    state[key] = ex.backend.to_host(ex.get(rv))
                blocks.append({"index": list(idx), "key": key,
                               "placement": list(v.placement),
                               "shape": list(v.shape)})
            metas.append({"shape": list(ga.shape), "grid": list(ga.grid.grid),
                          "dtype": ga.grid.dtype, "blocks": blocks})
        if step is None:
            step = self._ckpt_seq
        self._ckpt_seq = step + 1
        meta = {
            "arrays": metas,
            "cluster": [self.cluster.num_nodes,
                        self.cluster.workers_per_node],
            "node_grid": list(self.node_grid.dims),
            "backend": self.backend,
            "device": None if self.device is None else str(self.device),
            "dtype": self.dtype,
            "seed": self._seed,
            "pipeline": self.pipeline,
            "scheduler": self.scheduler.name,
        }
        final = _ckpt.save(dir, step, state, meta=meta, keep=keep)
        npz = os.path.join(final, "state.npz")
        # lineage rewrite: checkpointed blocks become restore roots — replay
        # reloads their bits from the archive instead of recursing deeper
        for ga in arrays:
            for idx in ga.grid.iter_indices():
                v = ga.block(idx)
                rv = ex.resolve(v.vid)
                ex.lineage[rv] = OpRecord(
                    rv, "create:restore",
                    {"seed": None, "value": None,
                     "path": npz, "key": f"b{rv}"},
                    (), tuple(v.placement),
                )
        mm = ex.memory
        mm.stats.checkpoints += 1
        mm.stats.checkpoint_blocks += len(state)
        mm._ckpt_cache[npz] = dict(state)
        return final

    @classmethod
    def restore(cls, dir: str, step: Optional[int] = None,
                **overrides) -> Tuple["ArrayContext", list]:
        """Rebuild a context and its checkpointed arrays after simulated
        driver loss: a fresh ``ArrayContext`` (configuration from the
        checkpoint's meta, overridable) whose arrays materialize from
        ``create:restore`` roots — bitwise the blocks that were saved, put
        back on the context's device (the checkpointed context's unless
        ``device=`` overrides it).
        Returns ``(ctx, arrays)`` in the order given to ``checkpoint``."""
        from repro_torch.checkpoint import ckpt as _ckpt

        state, meta = _ckpt.restore(dir, step)
        npz = os.path.join(dir, f"step_{meta['step']:08d}", "state.npz")
        k, w = meta["cluster"]
        kwargs = {
            "cluster": ClusterSpec(k, w),
            "node_grid": tuple(meta["node_grid"]),
            "backend": meta["backend"],
            "device": meta.get("device"),
            "dtype": meta["dtype"],
            "seed": meta["seed"],
            "pipeline": meta["pipeline"],
            "scheduler": meta["scheduler"],
        }
        kwargs.update(overrides)
        ctx = cls(**kwargs)
        # prime the archive cache with the blocks restore() already read
        ctx.executor.memory._ckpt_cache[npz] = dict(state)
        arrays = []
        for am in meta["arrays"]:
            agrid = ArrayGrid(tuple(am["shape"]), tuple(am["grid"]),
                              am["dtype"])
            blocks = np.empty(agrid.grid if agrid.grid else (), dtype=object)
            for bm in am["blocks"]:
                idx = tuple(bm["index"])
                node, worker = bm["placement"]
                v = leaf(tuple(bm["shape"]), node, worker)
                ctx.executor.create(
                    v.vid, tuple(bm["shape"]), (node, worker),
                    kind="restore", ckpt=(npz, bm["key"]),
                )
                ctx.state.add_object(v.vid, node, worker,
                                     int(np.prod(bm["shape"])))
                ctx.executor.note_handle(v)
                blocks[idx if agrid.grid else ()] = v
            arrays.append(GraphArray(ctx, agrid, blocks, node_grid=None))
        return ctx, arrays

    # -- chaos runtime ----------------------------------------------------------
    def enable_chaos(self, plan, seed: int = 0, retry=None):
        """Attach a seeded fault-injection engine (``core.chaos``) to this
        context's executor: stragglers, link degradation, transient-fault
        retry/backoff, node death + lineage replay, and live speculative
        re-execution.  Scheduling is untouched, so outputs stay bit-identical
        to the fault-free run; same (seed, plan) ⇒ same chaos schedule.
        Returns the attached ``ChaosEngine``."""
        from .chaos import ChaosEngine

        return ChaosEngine(plan, seed=seed, retry=retry).attach(self)

    # -- pipelined dispatch -----------------------------------------------------
    def flush(self) -> int:
        """Drain any pending pipelined ops (no-op for the sync executor).
        Returns the number of ops executed."""
        return self.executor.flush()

    # -- reporting ------------------------------------------------------------------
    def export_trace(self, path: Optional[str] = None) -> Dict:
        """Export the flight recorder as Chrome/Perfetto ``trace_event`` JSON
        (write to ``path`` when given, return the document either way).
        Requires the context to have been built with ``trace=...``."""
        if self.tracer is None:
            raise RuntimeError(
                "tracing is off — construct ArrayContext(trace=True)")
        from repro_torch.obs.perfetto import export_chrome_trace, write_chrome_trace

        makespans = {
            "sync": self.state.makespan(pipeline=False),
            "pipe": self.state.makespan(pipeline=True),
        }
        if self.chaos_engine is not None:
            makespans["chaos"] = self.chaos_engine.clocks.makespan()
        meta = {
            "backend": self.backend,
            "nodes": self.cluster.num_nodes,
            "workers_per_node": self.cluster.workers_per_node,
            "bytes_per_element": self.state.cost_model.bytes_per_element,
        }
        if path is not None:
            return write_chrome_trace(path, self.tracer,
                                      makespans=makespans, meta=meta)
        return export_chrome_trace(self.tracer, makespans=makespans, meta=meta)

    def loads(self) -> Dict[str, float]:
        """One merged snapshot of every runtime stats source — cluster load
        summary, executor/scheduling counters, comm-bound ratios, backend
        substrate counters, memory-budget accounting, chaos summary — via the
        unified ``MetricsRegistry`` (see ``_register_metrics``).  The key
        schema per feature set is golden-tested in ``tests/test_obs.py``."""
        return self.metrics.snapshot()

    def reset_loads(self) -> None:
        """Zero the load counters and simulated clocks (keep residency maps)
        — used between benchmark phases to isolate per-expression loads."""
        self.state.S[:] = 0.0
        self.state.transfers.clear()
        self.state.reset_clocks()
        self.executor.stats.reset()
        if self.executor.backend is not None:
            self.executor.backend.stats.reset()
        self.executor.memory.stats.reset()
        self.sched_stats.reset()
        self._pycollect0 = COLLECTOR.seconds
        if self.tracer is not None:
            self.tracer.clear()


def _devices(device) -> Optional[list]:
    """The executor's device list for an ArrayContext ``device`` argument."""
    if device is None or str(device) == "cuda":
        return None  # every visible CUDA device; raises where there is none
    return [device]
