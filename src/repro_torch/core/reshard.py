"""Reshard subsystem: scheduler-aware rechunk/redistribute (beyond-paper).

Arrays are created in one ``(blockshape, node_grid)`` layout and — until this
module — were frozen there: mismatched grids could not interoperate, and the
mode-2/3 updates of CP-ALS were inexpressible.  ``reshard`` transforms a
materialized :class:`GraphArray` into any target layout by emitting a
block-level *move graph* of ``slice`` / ``concat_blocks`` vertices that LSHS
places like any other subgraph:

* each destination block is assembled (``concat_blocks``) from the pieces of
  the source blocks it overlaps; proper sub-block pieces are extracted by
  ``slice`` vertices, which have a single placement option (the source
  block's node) — so slicing happens *where the data lives* and only the
  pieces travel;
* the ``concat_blocks`` roots are forced onto the target hierarchical
  layout by ``ArrayContext.compute``, exactly like any output subgraph;
* transfers therefore flow through ``ClusterState.transition`` (net/mem
  load accounting, dual clock tracks), are dispatched through the executor
  (pipelined queues overlap them with compute under ``pipeline=True``), and
  the whole move graph is fingerprintable by the plan cache — a reshard
  inside an iterative loop replays its placement plan from iteration 2 on.

A destination block whose span and placement already coincide with a source
block passes through untouched, so a reshard to the current layout is an
exact no-op: zero vertices, zero transfers, bit-identical blocks.

``reshard_naive`` is the all-to-all baseline the paper's Dask comparison
implies: gather every block into one giant block on a single node, then
slice each destination block out of it and scatter.  It uses the same
vertex ops, so the moved-bytes advantage of locality-aware resharding is
measured by the same load accounting.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .graph_array import GraphArray, Vertex, infer_shape
from .grid import ArrayGrid, Index
from .layout import HierarchicalLayout, NodeGrid, tune_node_grid


def _axis_starts(grid: ArrayGrid, axis: int) -> List[int]:
    starts = [0]
    for sz in grid.block_sizes(axis):
        starts.append(starts[-1] + sz)
    return starts


def _axis_overlaps(src: ArrayGrid, dst: ArrayGrid, axis: int
                   ) -> List[List[Tuple[int, int, int]]]:
    """For each destination block index along ``axis``: the overlapping
    source blocks as ``(src_index, lo, hi)`` in *global* coordinates."""
    s_starts = _axis_starts(src, axis)
    d_starts = _axis_starts(dst, axis)
    out: List[List[Tuple[int, int, int]]] = []
    for j in range(dst.grid[axis]):
        d_lo, d_hi = d_starts[j], d_starts[j + 1]
        row = []
        for i in range(src.grid[axis]):
            lo = max(d_lo, s_starts[i])
            hi = min(d_hi, s_starts[i + 1])
            if hi > lo:
                row.append((i, lo, hi))
        out.append(row)
    return out


def _piece_table(ga: GraphArray, dst_grid: ArrayGrid
                 ) -> Dict[Index, List[Tuple[Index, tuple, tuple, tuple]]]:
    """dest index -> ``[(src_index, local_starts, local_stops, dst_offset)]``
    over every overlapping source piece (coordinates block-local)."""
    src_grid = ga.grid
    per_axis = [_axis_overlaps(src_grid, dst_grid, a) for a in range(src_grid.ndim)]
    s_starts = [_axis_starts(src_grid, a) for a in range(src_grid.ndim)]
    d_starts = [_axis_starts(dst_grid, a) for a in range(src_grid.ndim)]
    table: Dict[Index, List[Tuple[Index, tuple, tuple, tuple]]] = {}
    for didx in dst_grid.iter_indices():
        pieces = []
        for combo in itertools.product(*(per_axis[a][didx[a]]
                                         for a in range(src_grid.ndim))):
            sidx = tuple(c[0] for c in combo)
            starts = tuple(c[1] - s_starts[a][c[0]] for a, c in enumerate(combo))
            stops = tuple(c[2] - s_starts[a][c[0]] for a, c in enumerate(combo))
            offset = tuple(c[1] - d_starts[a][didx[a]] for a, c in enumerate(combo))
            pieces.append((sidx, starts, stops, offset))
        table[didx] = pieces
    return table


def _resolve_target(
    ga: GraphArray,
    grid: Optional[Sequence[int]],
    node_grid: Optional[Union[NodeGrid, Tuple[int, ...]]],
    need_table: bool = True,
) -> Tuple[ArrayGrid, NodeGrid,
           Optional[Dict[Index, List[Tuple[Index, tuple, tuple, tuple]]]]]:
    ctx = ga.ctx
    dst_grid = (ga.grid if grid is None
                else ArrayGrid(ga.shape, tuple(int(g) for g in grid), ga.grid.dtype))
    # the piece table feeds the move-graph builder and the tuner's source
    # sets; skip it when neither needs it (explicit node grid, naive path)
    table = (_piece_table(ga, dst_grid)
             if need_table or node_grid is None else None)
    if node_grid is None:
        # layout tuner: min-max-load factorization, scored against the live
        # cluster state using the upcoming move's actual source blocks
        sources = {
            didx: [ga.block(sidx).vid for sidx, _a, _b, _o in pieces]
            for didx, pieces in table.items()
        }
        choice = tune_node_grid(dst_grid, ctx.cluster, state=ctx.state,
                                sources=sources)
        ng = choice.node_grid
    elif isinstance(node_grid, NodeGrid):
        ng = node_grid
    else:
        ng = NodeGrid(tuple(int(d) for d in node_grid))
    return dst_grid, ng, table


def reshard(
    ga: GraphArray,
    grid: Optional[Sequence[int]] = None,
    node_grid: Optional[Union[NodeGrid, Tuple[int, ...]]] = None,
) -> GraphArray:
    """Transform ``ga`` into the target ``(grid, node_grid)`` layout.

    The source is materialized first (a reshard is a data movement, not an
    expression); the move graph is then scheduled immediately, so transfers
    are placed by LSHS against current loads and — in pipelined mode — drain
    overlapped with any subsequently scheduled compute.
    """
    ctx = ga.ctx
    if ga.ndim == 0:
        return ga
    ctx.compute(ga)
    dst_grid, ng, table = _resolve_target(ga, grid, node_grid)
    layout = HierarchicalLayout(dst_grid, ng, ctx.cluster)
    blocks = np.empty(dst_grid.grid, dtype=object)
    n_ops = 0
    for didx, pieces in table.items():
        dshape = dst_grid.block_shape(didx)
        target = layout.placement(didx)
        if len(pieces) == 1:
            sidx, starts, stops, _off = pieces[0]
            src_v = ga.block(sidx)
            if (tuple(stops) == tuple(src_v.shape)
                    and all(s == 0 for s in starts)
                    and src_v.placement == target):
                blocks[didx] = src_v  # exact block, exact placement: no-op
                continue
        kids: List[Vertex] = []
        offsets: List[tuple] = []
        for sidx, starts, stops, offset in pieces:
            src_v = ga.block(sidx)
            if tuple(stops) == tuple(src_v.shape) and all(s == 0 for s in starts):
                piece_v = src_v  # whole source block: no slice op needed
            else:
                meta = {"starts": tuple(starts), "stops": tuple(stops)}
                piece_v = Vertex("op", "slice",
                                 infer_shape("slice", meta, [src_v.shape]),
                                 [src_v], meta)
                n_ops += 1
            kids.append(piece_v)
            offsets.append(tuple(offset))
        blocks[didx] = Vertex(
            "op", "concat_blocks", dshape, kids,
            {"shape": tuple(dshape), "offsets": tuple(offsets)})
        n_ops += 1
    out = GraphArray(ctx, dst_grid, blocks, node_grid=ng)
    _scheduled_compute(ctx, out, n_ops)
    return out


def reshard_naive(
    ga: GraphArray,
    grid: Optional[Sequence[int]] = None,
    node_grid: Optional[Union[NodeGrid, Tuple[int, ...]]] = None,
) -> GraphArray:
    """All-to-all baseline: gather the whole array into one giant block on a
    single node (LSHS picks the cheapest holder, matching a driver-side
    gather), then slice every destination block back out.  Same vertex ops,
    same load accounting — strictly more data movement whenever any source
    block already lives where a destination block lands."""
    ctx = ga.ctx
    if ga.ndim == 0:
        return ga
    ctx.compute(ga)
    dst_grid, ng, _table = _resolve_target(ga, grid, node_grid, need_table=False)
    layout = HierarchicalLayout(dst_grid, ng, ctx.cluster)
    src_grid = ga.grid
    kids, offsets = [], []
    for sidx in src_grid.iter_indices():
        kids.append(ga.block(sidx))
        offsets.append(tuple(sl.start for sl in src_grid.block_slices(sidx)))
    giant = Vertex("op", "concat_blocks", ga.shape, kids,
                   {"shape": tuple(ga.shape), "offsets": tuple(offsets)})
    blocks = np.empty(dst_grid.grid, dtype=object)
    n_ops = 1
    for didx in dst_grid.iter_indices():
        dslices = dst_grid.block_slices(didx)
        meta = {"starts": tuple(sl.start for sl in dslices),
                "stops": tuple(sl.stop for sl in dslices)}
        piece = Vertex("op", "slice",
                       infer_shape("slice", meta, [giant.shape]), [giant], meta)
        dshape = dst_grid.block_shape(didx)
        blocks[didx] = Vertex(
            "op", "concat_blocks", dshape, [piece],
            {"shape": tuple(dshape), "offsets": ((0,) * len(dshape),)})
        n_ops += 2
    out = GraphArray(ctx, dst_grid, blocks, node_grid=ng)
    _scheduled_compute(ctx, out, n_ops)
    return out


def _scheduled_compute(ctx, out: GraphArray, n_ops: int) -> None:
    """Schedule a move graph now, tracking its transfer volume in the
    context's scheduling stats (``SchedStats.reshards`` /
    ``reshard_moved_elements``)."""
    before = ctx.state.network_elements()
    ctx.compute(out)
    stats = ctx.sched_stats
    stats.reshards += 1
    stats.reshard_ops += n_ops
    stats.reshard_moved_elements += ctx.state.network_elements() - before
