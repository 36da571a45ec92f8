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
        if trace is not None and trace is not False and trace != 0:
            raise NotImplementedError(
                "trace= waits for the core/trace.py port "
                "(ROADMAP Queue 1 item 5)")
        if calibration is not None:
            raise NotImplementedError(
                "calibration= waits for the obs/calibrate.py port "
                "(ROADMAP Queue 1 item 5)")
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
        self.tracer = None
        # unified metrics registry (repro_torch.obs.metrics): every stats source
        # registers as a named provider and ``loads()`` is one ``snapshot()``
        # — the key schema is golden-tested per feature set in test_obs
        from repro_torch.obs.metrics import MetricsRegistry

        self.metrics = MetricsRegistry()
        self._register_metrics()

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
            self.sched_stats.note_backend(be)
            return be.counters()

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
        # needed — the full token stream is skipped.
        t0 = perf_counter()
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

    # -- features of later slices ----------------------------------------------
    def checkpoint(self, arrays: Sequence[GraphArray], dir: str,
                   step: Optional[int] = None, keep: int = 3) -> str:
        raise NotImplementedError(
            "checkpoint waits for the checkpoint/ckpt.py port "
            "(ROADMAP Queue 1 item 2)")

    @classmethod
    def restore(cls, dir: str, step: Optional[int] = None, **overrides):
        raise NotImplementedError(
            "restore waits for the checkpoint/ckpt.py port "
            "(ROADMAP Queue 1 item 2)")

    def enable_chaos(self, plan, seed: int = 0, retry=None):
        raise NotImplementedError(
            "enable_chaos waits for the core/chaos.py port "
            "(ROADMAP Queue 1 item 5)")

    # -- pipelined dispatch -----------------------------------------------------
    def flush(self) -> int:
        """Drain any pending pipelined ops (no-op for the sync executor).
        Returns the number of ops executed."""
        return self.executor.flush()

    # -- reporting ------------------------------------------------------------------
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


def _devices(device) -> Optional[list]:
    """The executor's device list for an ArrayContext ``device`` argument."""
    if device is None or str(device) == "cuda":
        return None  # every visible CUDA device; raises where there is none
    return [device]
