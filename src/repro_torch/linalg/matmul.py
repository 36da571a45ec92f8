"""Distributed matrix multiplication (paper §8.2, Appendix A.5).

``recursive_matmul`` is NumS's algorithm (Alg. 3): block matmuls + Reduce,
scheduled by LSHS — identical to ``A @ B`` on GraphArrays.

``summa_matmul`` is the SUMMA baseline (Alg. 4) used by ScaLAPACK/SLATE:
a *statically scheduled* loop over the contraction dimension in which
A[i,h] / B[h,j] are broadcast to the output block's owner and accumulated
in place.  It is implemented on the same runtime with manual placement so
the benchmark compares communication volumes like-for-like.  Note SUMMA's
in-place accumulation needs only one output buffer per block (the paper
credits SLATE's memory efficiency to this); our load model reflects that by
accumulating into a single object per output block.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import ArrayContext, GraphArray
from repro_torch.core.grid import ArrayGrid
from repro_torch.core.graph_array import Vertex, infer_shape, matmul
from repro_torch.core.layout import HierarchicalLayout


def recursive_matmul(A: GraphArray, B: GraphArray) -> GraphArray:
    return matmul(A, B).compute()


def summa_matmul(ctx: ArrayContext, A: GraphArray, B: GraphArray) -> GraphArray:
    """SUMMA over the block runtime: output-stationary accumulation with
    operands broadcast to the output owner's node per h-step."""
    (ma, ka), (kb, nb) = A.grid.grid, B.grid.grid
    if ka != kb:
        raise ValueError("grid mismatch")
    out_grid = ArrayGrid((A.shape[0], B.shape[1]), (ma, nb), A.grid.dtype)
    layout = HierarchicalLayout(out_grid, ctx.node_grid, ctx.cluster)
    blocks = np.empty((ma, nb), dtype=object)
    state, ex = ctx.state, ctx.executor
    acc = {}
    for h in range(ka):
        for i in range(ma):
            for j in range(nb):
                node, worker = layout.placement((i, j))
                ca, cb = A.block((i, h)), B.block((h, j))
                meta = {"ta": False, "tb": False}
                mm = Vertex("op", "matmul", infer_shape("matmul", meta, [ca.shape, cb.shape]),
                            [ca, cb], meta)
                eta = state.transition(node, mm.vid, mm.elements, [ca.vid, cb.vid],
                                       worker=worker, kind="matmul")
                ex.run_op(mm.vid, "matmul", meta, [ca.vid, cb.vid], (node, worker),
                          eta=eta)
                mm.to_leaf(node, worker)
                if (i, j) not in acc:
                    acc[(i, j)] = mm
                else:
                    prev = acc[(i, j)]
                    add = Vertex("op", "add", mm.shape, [prev, mm])
                    # in-place accumulate: output reuses the buffer -> no new
                    # memory charge beyond the partial just produced
                    eta = state.transition(node, add.vid, 0, [prev.vid, mm.vid],
                                           worker=worker, kind="add")
                    ex.run_op(add.vid, "add", {}, [prev.vid, mm.vid], (node, worker),
                              eta=eta)
                    add.to_leaf(node, worker)
                    acc[(i, j)] = add
    for (i, j), v in acc.items():
        blocks[i, j] = v
    return GraphArray(ctx, out_grid, blocks)
