"""Sketch-based randomized SVD (paper §8.3; Halko/Martinsson/Tropp 2011).

Pipeline: Gaussian sketch Ω → tall-skinny sample Y = A Ω → orthonormal
range basis Q via the existing communication-avoiding ``tsqr_indirect`` →
small core B^T = A^T Q factored by a single-block SVD → rotate back
U = Q U_b.  Optional power iterations Y ← A (A^T Q) sharpen the spectrum
for slowly decaying singular values.

Everything distributed is built from the same vertex ops as TSQR (matmul
reduce trees, ``rsolve``) plus the small-core ``svd_u``/``svd_s``/``svd_vt``
block ops, so all three backends and the plan cache apply unchanged.
Measured network elements are recorded against ``bounds.rsvd_lower_elements``
via ``SchedStats.note_comm``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import ArrayContext, GraphArray
from repro_torch.core import bounds
from repro_torch.core.grid import ArrayGrid

from .qr import _op, _wrap, tsqr_indirect


def rsvd(ctx: ArrayContext, A: GraphArray, rank: int, oversample: int = 8,
         power_iters: int = 0, seed: int = 0,
         ) -> Tuple[GraphArray, GraphArray, GraphArray]:
    """Rank-``rank`` randomized SVD of a tall-skinny ``A``.

    Returns ``(U, S, V)`` with ``A ≈ U diag(S) V^T``: U is ``(m, l)`` on
    A's row grid, S is ``(l,)`` and V is ``(d, l)``, each a single block,
    where ``l = min(rank + oversample, d)``.  Like TSQR, requires a single
    column partition.

    Caveat inherited from ``tsqr_indirect``'s Q = Y R^{-1} recovery: the
    sample Y = A Ω must have full column rank, i.e. A must have numerical
    rank >= l.  For an *exactly* rank-r matrix, call with ``oversample=0``
    and ``rank=r`` (the sketch then spans the range exactly); oversampling
    is for full-numerical-rank inputs with decaying spectra.
    """
    m, d = A.shape
    qrows = A.grid.grid[0]
    if A.grid.grid[1] != 1:
        raise ValueError("rsvd requires a single column partition")
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    sketch = min(rank + oversample, d)
    before = ctx.state.network_elements()
    rng = np.random.default_rng(seed)
    omega = ctx.from_numpy(rng.standard_normal((d, sketch)), grid=(1, 1))
    Y = A @ omega
    for _ in range(power_iters):
        Q, _r = tsqr_indirect(ctx, Y)
        Y = A @ (A.T @ Q)
    Q, _r = tsqr_indirect(ctx, Y)
    # small core: B^T = A^T Q is (d, sketch), a single block after the
    # matmul reduce tree; B = U_b S V^T gives svd(B^T) = (V, S, U_b^T)
    Bt = (A.T @ Q).compute()
    bt = Bt.block((0, 0))
    v = _op("svd_u", [bt])
    s = _op("svd_s", [bt])
    ubt = _op("svd_vt", [bt])
    dt = A.grid.dtype
    Vg = _wrap(ctx, ArrayGrid((d, sketch), (1, 1), dt),
               np.array([[v]], dtype=object))
    s_blocks = np.empty((1,), dtype=object)
    s_blocks[0] = s
    Sg = _wrap(ctx, ArrayGrid((sketch,), (1,), dt), s_blocks)
    Ub = _wrap(ctx, ArrayGrid((sketch, sketch), (1, 1), dt),
               np.array([[ubt]], dtype=object))
    ctx.compute(Vg)
    ctx.compute(Sg)
    ctx.compute(Ub)
    Ug = (Q @ Ub.T).compute()
    moved = ctx.state.network_elements() - before
    ctx.sched_stats.note_comm(
        "rsvd", moved,
        bounds.rsvd_lower_elements(d, sketch, ctx.cluster.num_nodes, qrows,
                                   power_iters=power_iters))
    return Ug, Sg, Vg
