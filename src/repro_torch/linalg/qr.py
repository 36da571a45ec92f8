"""Tall-skinny QR decompositions (paper §8.3).

``tsqr_direct``  — direct TSQR [Benson/Gleich/Demmel 2013]: per-block QR,
stack the R factors, re-factor, and recover Q = Q1_i @ Q2_i.  Requires a
single column partition (as Dask's implementation does).

``tsqr_indirect`` — indirect TSQR [Constantine/Gleich 2011]: R is computed by
a *tree reduction* with the associative combiner R_ab = qr_r([R_a; R_b]) —
scheduled by LSHS exactly like a sum reduction (locality-paired) — and
Q = X R^{-1} blockwise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import ArrayContext, GraphArray
from repro_torch.core import bounds
from repro_torch.core.grid import ArrayGrid
from repro_torch.core.graph_array import Vertex, infer_shape


def _wrap(ctx: ArrayContext, grid: ArrayGrid, blocks: np.ndarray) -> GraphArray:
    return GraphArray(ctx, grid, blocks)


def _op(op: str, children, meta=None) -> Vertex:
    shp = infer_shape(op, meta or {}, [c.shape for c in children])
    return Vertex("op", op, shp, list(children), meta or {})


def tsqr_direct(ctx: ArrayContext, X: GraphArray) -> Tuple[GraphArray, GraphArray]:
    n, d = X.shape
    q = X.grid.grid[0]
    if X.grid.grid[1] != 1:
        raise ValueError(
            f"direct TSQR requires a single column partition, got grid "
            f"{tuple(X.grid.grid)} for shape {X.shape}")
    rows = X.grid.block_sizes(0)
    for i in range(q):
        if rows[i] < d:
            raise ValueError(
                f"each row block must have at least d={d} rows; block "
                f"({i}, 0) has shape {(rows[i], d)}")
    before = ctx.state.network_elements()
    x_blocks = [X.block((i, 0)) for i in range(q)]
    q1 = [_op("qr_q", [b]) for b in x_blocks]
    r1 = [_op("qr_r", [b]) for b in x_blocks]
    stacked = _op("stack", r1) if q > 1 else r1[0]
    r2 = _op("qr_r", [stacked])
    q2 = _op("qr_q", [stacked])
    # Q = Q1_i @ Q2[i*d:(i+1)*d]
    q_blocks = np.empty((q, 1), dtype=object)
    for i in range(q):
        q2_i = (
            _op("slice_rows", [q2], {"start": i * d, "stop": (i + 1) * d})
            if q > 1
            else q2
        )
        q_blocks[i, 0] = _op("matmul", [q1[i], q2_i], {"ta": False, "tb": False})
    Qg = _wrap(ctx, ArrayGrid((n, d), (q, 1), X.grid.dtype), q_blocks)
    r_blocks = np.empty((1, 1), dtype=object)
    r_blocks[0, 0] = r2
    Rg = _wrap(ctx, ArrayGrid((d, d), (1, 1), X.grid.dtype), r_blocks)
    ctx.compute(Rg)
    ctx.compute(Qg)
    # direct TSQR is not communication-avoiding (all R's stack to one node);
    # recorded under its own key so the gate only binds the indirect variant
    ctx.sched_stats.note_comm(
        "tsqr_direct", ctx.state.network_elements() - before,
        bounds.tsqr_lower_elements(d, ctx.cluster.num_nodes, q))
    return Qg, Rg


def tsqr_indirect(ctx: ArrayContext, X: GraphArray) -> Tuple[GraphArray, GraphArray]:
    n, d = X.shape
    q = X.grid.grid[0]
    if X.grid.grid[1] != 1:
        raise ValueError(
            f"indirect TSQR requires a single column partition, got grid "
            f"{tuple(X.grid.grid)} for shape {X.shape}")
    before = ctx.state.network_elements()
    x_blocks = [X.block((i, 0)) for i in range(q)]
    r1 = [_op("qr_r", [b]) for b in x_blocks]
    if q > 1:
        root = Vertex("reduce", "qr_stackr", (d, d), r1)
    else:
        root = r1[0]
    r_blocks = np.empty((1, 1), dtype=object)
    r_blocks[0, 0] = root
    Rg = _wrap(ctx, ArrayGrid((d, d), (1, 1), X.grid.dtype), r_blocks)
    ctx.compute(Rg)
    # Q = X R^{-1}, blockwise against the single R block
    q_blocks = np.empty((q, 1), dtype=object)
    for i in range(q):
        q_blocks[i, 0] = _op("rsolve", [X.block((i, 0)), Rg.block((0, 0))])
    Qg = _wrap(ctx, ArrayGrid((n, d), (q, 1), X.grid.dtype), q_blocks)
    ctx.compute(Qg)
    ctx.sched_stats.note_comm(
        "tsqr", ctx.state.network_elements() - before,
        bounds.tsqr_lower_elements(d, ctx.cluster.num_nodes, q))
    return Qg, Rg
