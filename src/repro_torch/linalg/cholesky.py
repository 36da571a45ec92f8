"""Blocked right-looking Cholesky factorization and triangular solve (§8).

``cholesky``       — A = L L^T on a square block grid: per-diagonal-block
``potrf``, ``trsm`` panel updates L[i,t] = A[i,t] L[t,t]^{-T}, and
``syrk_update`` trailing updates A[i,j] -= L[i,t] L[j,t]^T, all as vertex
ops scheduled by LSHS (the whole factorization is one graph, so the plan
cache replays it and the trailing-update data flow is locality-placed).

``cholesky_solve`` — given L from ``cholesky``, solves A x = b by blocked
forward substitution (L y = b) then blocked backward substitution
(L^T x = y, via the ``tsolve`` vertex op), again as a single graph.

Both record measured network elements against the ``core.bounds``
moved-element floors via ``SchedStats.note_comm`` (the ``comm_ratio_*``
keys of ``ctx.loads()``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ArrayContext, GraphArray
from repro_torch.core import bounds
from repro_torch.core.graph_array import Vertex
from repro_torch.core.grid import ArrayGrid

from .qr import _op, _wrap


def _check_square(A: GraphArray) -> int:
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(
            f"cholesky requires a square 2-D array, got shape {A.shape}")
    q0, q1 = A.grid.grid
    if q0 != q1:
        raise ValueError(
            f"cholesky requires a square block grid, got grid {(q0, q1)}")
    return q0


def cholesky(ctx: ArrayContext, A: GraphArray) -> GraphArray:
    """Lower Cholesky factor of a symmetric positive-definite ``A``.

    Right-looking: at step t, factor the diagonal block, update the panel
    below it, then apply rank-b updates to the trailing lower triangle.
    Only the lower triangle of ``A`` is read; the strict upper triangle of
    the result is exact zero blocks.
    """
    q = _check_square(A)
    n = A.shape[0]
    before = ctx.state.network_elements()
    cur: dict = {(i, j): A.block((i, j)) for i in range(q) for j in range(i + 1)}
    for t in range(q):
        d = _op("potrf", [cur[(t, t)]])
        cur[(t, t)] = d
        for i in range(t + 1, q):
            cur[(i, t)] = _op("trsm", [cur[(i, t)], d])
        for j in range(t + 1, q):
            for i in range(j, q):
                cur[(i, j)] = _op(
                    "syrk_update", [cur[(i, j)], cur[(i, t)], cur[(j, t)]])
    zeros = ctx.zeros((n, n), grid=(q, q)) if q > 1 else None
    blocks = np.empty((q, q), dtype=object)
    for i in range(q):
        for j in range(q):
            blocks[i, j] = cur[(i, j)] if i >= j else zeros.block((i, j))
    Lg = _wrap(ctx, ArrayGrid((n, n), (q, q), A.grid.dtype), blocks)
    ctx.compute(Lg)
    moved = ctx.state.network_elements() - before
    ctx.sched_stats.note_comm(
        "cholesky", moved,
        bounds.cholesky_lower_elements(n, q, ctx.cluster.num_nodes))
    return Lg


def cholesky_solve(ctx: ArrayContext, L: GraphArray,
                   b: GraphArray) -> GraphArray:
    """Solve A x = b given the factor L from ``cholesky`` (A = L L^T).

    ``b`` may be 1-D on a ``(q,)`` grid or 2-D on a ``(q, 1)`` grid with
    the same row partition as ``L``.  Forward substitution produces
    y_i = L_ii^{-1} (b_i - Σ_{j<i} L_ij y_j); backward substitution
    x_i = L_ii^{-T} (y_i - Σ_{j>i} L_ji^T x_j).  One graph, one schedule.
    """
    q = L.grid.grid[0]
    if b.grid.grid[0] != q:
        raise ValueError(
            f"b row grid {b.grid.grid[0]} must match L's block grid {q}")
    if b.ndim == 2 and b.grid.grid[1] != 1:
        raise ValueError("cholesky_solve requires a single column partition of b")

    def bblock(i: int) -> Vertex:
        return b.block((i,) if b.ndim == 1 else (i, 0))

    y = []
    for i in range(q):
        acc = bblock(i)
        for j in range(i):
            acc = _op("sub", [acc, _op("matmul", [L.block((i, j)), y[j]])])
        y.append(_op("solve", [L.block((i, i)), acc]))
    x: list = [None] * q
    for i in range(q - 1, -1, -1):
        acc = y[i]
        for j in range(i + 1, q):
            acc = _op("sub", [acc, _op("matmul", [L.block((j, i)), x[j]],
                                       {"ta": True, "tb": False})])
        x[i] = _op("tsolve", [L.block((i, i)), acc])
    blocks = np.empty(b.grid.grid, dtype=object)
    for i in range(q):
        blocks[(i,) if b.ndim == 1 else (i, 0)] = x[i]
    Xg = _wrap(ctx, ArrayGrid(tuple(b.shape), b.grid.grid, b.grid.dtype), blocks)
    ctx.compute(Xg)
    return Xg
