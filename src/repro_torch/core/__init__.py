"""NumS core: GraphArray IR + LSHS scheduling (the paper's contribution).

The port's copy of ``repro.core``, with the same semantics: the same graph
and seed give the same LSHS placements, loads and simulated makespans in
both packages.

Public API:
    ArrayContext, ClusterSpec, NodeGrid, ArrayGrid, auto_grid,
    GraphArray, matmul, tensordot, einsum,
    LSHS / RoundRobinScheduler / DynamicScheduler, ClusterState, CostModel,
    bounds (α-β-γ communication model, Appendix A).
"""
from .chaos import ChaosEngine, ChaosPlan, ChaosStats, RetryPolicy
from .cluster import ClusterState, CostModel, WorkerClocks, MEM, NET_IN, NET_OUT
from .context import ArrayContext
from .executor import Executor
from .fusion import fuse_graph
from .graph_array import GraphArray, einsum, matmul, tensordot
from .grid import ArrayGrid, auto_grid
from .memory import MemoryManager, MemStats
from .layout import (
    ClusterSpec,
    HierarchicalLayout,
    LayoutChoice,
    NodeGrid,
    default_node_grid,
    node_grid_factorizations,
    tune_node_grid,
)
from .reshard import reshard, reshard_naive
from .trace import FlightRecorder, TraceEvent
from .plan import PlacementPlan, PlanCache, SchedStats, fingerprint as plan_fingerprint, replay_plan
from .schedulers import DynamicScheduler, LSHS, RoundRobinScheduler, make_scheduler
from . import bounds

__all__ = [
    "ArrayContext",
    "ArrayGrid",
    "ChaosEngine",
    "ChaosPlan",
    "ChaosStats",
    "ClusterSpec",
    "ClusterState",
    "CostModel",
    "DynamicScheduler",
    "Executor",
    "FlightRecorder",
    "GraphArray",
    "HierarchicalLayout",
    "LSHS",
    "MemStats",
    "MemoryManager",
    "NodeGrid",
    "PlacementPlan",
    "PlanCache",
    "RetryPolicy",
    "RoundRobinScheduler",
    "SchedStats",
    "TraceEvent",
    "WorkerClocks",
    "plan_fingerprint",
    "replay_plan",
    "reshard",
    "reshard_naive",
    "LayoutChoice",
    "auto_grid",
    "bounds",
    "default_node_grid",
    "einsum",
    "fuse_graph",
    "make_scheduler",
    "matmul",
    "node_grid_factorizations",
    "tensordot",
    "tune_node_grid",
    "MEM",
    "NET_IN",
    "NET_OUT",
]
