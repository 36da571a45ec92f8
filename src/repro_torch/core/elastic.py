"""Elastic scaling for GraphArrays.

When the node count changes (scale-up after provisioning, scale-down after a
failure), every materialized GraphArray is re-laid-out onto the new cluster's
hierarchical layout.  Blocks whose placement changed move through a real
reshard-style move graph: each is wrapped in a whole-block ``concat_blocks``
vertex whose single child is the surviving source block, and the roots are
LSHS-scheduled onto the new layout by ``ArrayContext.compute`` — so the move
flows through ``ClusterState.transition`` (net-out charged at the surviving
source, net-in + memory at the new home, both clock tracks advanced) and
through the executor's dispatch queues like any other subgraph.  LSHS then
continues on the new ClusterState.

Scale-downs are guarded: a block whose old home no longer exists in the new
cluster has no surviving source row to charge, so it is re-ingested at its
new home by reference (net-in only) instead of indexing stale placements.

A chaos engine attached to the old context (``core.chaos``) is re-bound to
the new one: clock rows and residency for surviving node ids carry over, and
nodes removed by the shrink leave its dead set.

The new context keeps the old one's block device and dtype, so arrays it
creates land beside the blocks it inherits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .cluster import NET_IN, NET_OUT
from .context import ArrayContext
from .graph_array import GraphArray, Vertex, leaf
from .layout import ClusterSpec, HierarchicalLayout
from .reshard import _scheduled_compute


def elastic_relayout(
    old_ctx: ArrayContext,
    arrays: list,
    new_cluster: ClusterSpec,
    new_node_grid: Optional[Tuple[int, ...]] = None,
    scheduler: str = "lshs",
) -> Tuple[ArrayContext, list, int]:
    """Re-home ``arrays`` (materialized GraphArrays) onto a new cluster.

    Returns ``(new_ctx, new_arrays, blocks_moved)``.  The new context shares
    the old executor's block storage; blocks that change nodes are copied
    through scheduled ``concat_blocks`` move vertices (see module docstring),
    so the transfer schedule is exactly the set of blocks whose hierarchical
    placement changed and the load accounting is the transition function's.
    """
    # quiesce pipelined dispatch: blocks must be materialized before re-homing
    old_ctx.executor.flush()
    new_ctx = ArrayContext(
        cluster=new_cluster,
        node_grid=new_node_grid,
        scheduler=scheduler,
        backend=old_ctx.executor.mode,
        dtype=old_ctx.dtype,
        device=old_ctx.device,
        system=old_ctx.state.system,
        seed=old_ctx._seed,
        pipeline=old_ctx.pipeline,
        # share the plan cache across the re-plan: the new cluster's config
        # signature keys its plans separately, so stale plans never hit, and
        # post-scale iterations keep amortizing once they re-record
        plan_cache=old_ctx.plan_cache or False,
        # a calibrated cost model survives the resize: the new ClusterState's
        # clocks keep predicting measured time
        calibration=old_ctx.calibration,
    )
    # share physical storage: the object store outlives the re-plan
    new_ctx.executor = old_ctx.executor
    # a chaos engine rides along: surviving nodes keep their chaos clocks,
    # removed nodes leave its dead set, and its executor hook follows
    if old_ctx.chaos_engine is not None:
        old_ctx.chaos_engine.rebind(new_ctx)
    k_new = new_cluster.num_nodes
    w_new = new_cluster.workers_per_node
    moved = 0
    new_arrays = []
    for ga in arrays:
        if not ga.is_materialized():
            raise ValueError("elastic_relayout requires materialized arrays")
        layout = HierarchicalLayout(ga.grid, new_ctx.node_grid, new_cluster)
        blocks = np.empty(ga.grid.grid if ga.grid.grid else (), dtype=object)
        n_ops = 0
        for idx in ga.grid.iter_indices():
            old_v = ga.block(idx)
            node, worker = layout.placement(idx)
            old_node, old_worker = old_v.placement
            elements = old_v.elements
            ndim = len(old_v.shape)
            if old_node >= k_new:
                # scale-down: the source node left the cluster, so there is
                # no surviving row to charge net-out on — the object-store
                # survivor is re-ingested at its new home by reference
                v = leaf(old_v.shape, node, worker)
                new_ctx.executor.alias(v.vid, old_v.vid)
                new_ctx.state.add_object(v.vid, node, worker, elements)
                new_ctx.state.S[node, NET_IN] += elements
                moved += 1
                blocks[idx if ga.grid.grid else ()] = v
                continue
            src_worker = min(old_worker, w_new - 1)
            if old_node == node or ndim == 0:
                # same node (intra-node re-homing is free under the ray
                # object-store model) — register the survivor where it lives
                v = leaf(old_v.shape, node, worker)
                new_ctx.executor.alias(v.vid, old_v.vid)
                new_ctx.state.add_object(v.vid, node, worker, elements)
                if old_node != node:  # 0-d block moving nodes: charge flat
                    new_ctx.state.S[old_node, NET_OUT] += elements
                    new_ctx.state.S[node, NET_IN] += elements
                    moved += 1
                blocks[idx if ga.grid.grid else ()] = v
                continue
            # real move: register the surviving source in the new state,
            # then wrap it in a whole-block concat_blocks vertex whose root
            # compute() forces onto the new layout — the transfer flows
            # through ClusterState.transition and the executor queues
            src = leaf(old_v.shape, old_node, src_worker)
            new_ctx.executor.alias(src.vid, old_v.vid)
            new_ctx.state.add_object(src.vid, old_node, src_worker, elements)
            mv = Vertex(
                "op", "concat_blocks", old_v.shape, [src],
                {"shape": tuple(old_v.shape), "offsets": ((0,) * ndim,)},
            )
            moved += 1
            n_ops += 1
            blocks[idx if ga.grid.grid else ()] = mv
        out = GraphArray(new_ctx, ga.grid, blocks)
        if n_ops:
            _scheduled_compute(new_ctx, out, n_ops)
        new_arrays.append(out)
    return new_ctx, new_arrays, moved
