"""Full CP-ALS on GraphArrays via matricization + reshard (paper §8.4).

The paper's tensor-factorization result demonstrates a *single* mode-1 MTTKRP;
a full alternating-least-squares sweep needs the tensor matricized along
*every* mode, which requires layouts the input array was not created in.  The
reshard subsystem makes those layouts reachable:

* ``X`` (mode-0 row-partitioned ``(q, 1, 1)``) is resharded once per mode to
  a layout partitioned along that mode (the layout tuner picks the node-grid
  factorization, e.g. ``(1, k, 1)`` for mode 1), then unfolded block-locally
  by the ``matricize`` vertex op — every mode's MTTKRP becomes an
  embarrassingly row-parallel ``X_(n) @ KhatriRao(...)``.
* factor updates come out row-partitioned; a small in-loop reshard gathers
  them to a single block for the next mode's Khatri-Rao product — this
  reshard repeats structurally every iteration, so the plan cache replays
  its placement plan from iteration 2 on.
* the normal-equation solve ``M G^{-1}`` (``G = (AᵀA) ∘ (BᵀB)``, Hadamard of
  Grams) runs blockwise through the existing ``rsolve`` vertex op — no data
  leaves the cluster; the whole sweep works on the metadata-only ``sim``
  backend for load studies.

``cp_als_reference`` is the pure-numpy mirror (same update order, same
initialization) used by the accuracy tests (1e-8 agreement).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import GraphArray
from repro_torch.core.graph_array import Vertex, infer_shape
from repro_torch.core.grid import ArrayGrid
from repro_torch.core.reshard import reshard as _reshard, reshard_naive as _reshard_naive


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def khatri_rao(a: GraphArray, b: GraphArray) -> GraphArray:
    """Column-wise Kronecker product of two single-block factor matrices:
    ``out[j*K + k, f] = a[j, f] * b[k, f]``."""
    if a.grid.grid != (1, 1) or b.grid.grid != (1, 1):
        raise ValueError("khatri_rao needs single-block factors (reshard first)")
    va, vb = a.block((0, 0)), b.block((0, 0))
    shp = infer_shape("khatri_rao", {}, [va.shape, vb.shape])
    v = Vertex("op", "khatri_rao", shp, [va, vb])
    grid = ArrayGrid(shp, (1, 1), a.grid.dtype)
    blocks = np.empty((1, 1), dtype=object)
    blocks[0, 0] = v
    return GraphArray(a.ctx, grid, blocks)


def matricize(x: GraphArray, mode: int) -> GraphArray:
    """Mode-``mode`` unfolding ``X_(n)``: blocks become ``(dim_n, rest)``
    matrices.  Requires every *other* axis unpartitioned (grid 1) so the
    unfolding is block-local — reshard to such a layout first."""
    mode = mode % x.ndim
    for a, g in enumerate(x.grid.grid):
        if a != mode and g != 1:
            raise ValueError(
                f"matricize(mode={mode}) needs grid 1 on axis {a}, got "
                f"{x.grid.grid} — reshard first")
    rest = int(np.prod([s for a, s in enumerate(x.shape) if a != mode]))
    out_grid = ArrayGrid((x.shape[mode], rest), (x.grid.grid[mode], 1),
                         x.grid.dtype)
    blocks = np.empty(out_grid.grid, dtype=object)
    for i in range(x.grid.grid[mode]):
        sidx = tuple(i if a == mode else 0 for a in range(x.ndim))
        c = x.block(sidx)
        shp = infer_shape("matricize", {"mode": mode}, [c.shape])
        blocks[i, 0] = Vertex("op", "matricize", shp, [c], {"mode": mode})
    return GraphArray(x.ctx, out_grid, blocks)


def _blockwise_rsolve(M: GraphArray, G: GraphArray) -> GraphArray:
    """Row-blockwise ``M @ G^{-1}`` with a shared single-block Gram matrix
    (the ALS normal-equation solve, via the ``rsolve`` vertex op)."""
    vg = G.block((0, 0))
    blocks = np.empty(M.grid.grid, dtype=object)
    for idx in M.grid.iter_indices():
        vm = M.block(idx)
        shp = infer_shape("rsolve", {}, [vm.shape, vg.shape])
        blocks[idx] = Vertex("op", "rsolve", shp, [vm, vg])
    return GraphArray(M.ctx, M.grid, blocks)


def _gram(a: GraphArray) -> GraphArray:
    return a.T @ a


# ---------------------------------------------------------------------------
# CP-ALS driver
# ---------------------------------------------------------------------------

@dataclass
class CPALSResult:
    factors: List[GraphArray]          # [A (I,F), B (J,F), C (K,F)], single-block
    iterations: int
    moved_elements: float              # network elements moved by reshards
    reshards: int
    fit_history: List[float] = field(default_factory=list)  # numpy backend only


def _mode_grid(x: GraphArray, mode: int, q: int) -> Tuple[int, ...]:
    return tuple(q if a == mode else 1 for a in range(x.ndim))


def cp_als(
    X: GraphArray,
    rank: int,
    iters: int = 3,
    inits: Optional[Sequence[np.ndarray]] = None,
    method: str = "reshard",
    seed: int = 0,
    track_fit: bool = True,
) -> CPALSResult:
    """Alternating least squares for the rank-``rank`` CP decomposition of a
    3-way GraphArray ``X``, all three mode updates per sweep.

    ``method`` selects how the per-mode layouts are reached:
      * ``"reshard"`` — the locality-aware move graphs of ``core.reshard``
        (LSHS-placed slices/concats, tuner-chosen node grids);
      * ``"naive"``   — the all-to-all gather/scatter baseline
        (``reshard_naive``), for the moved-bytes comparison.

    Factor initializations default to standard-normal draws from ``seed``
    (pass the same ``inits`` to ``cp_als_reference`` to compare outputs).
    ``track_fit=False`` skips the per-sweep relative-fit evaluation (which
    gathers the full tensor) — use it when timing sweeps.
    """
    if X.ndim != 3:
        raise ValueError("cp_als expects a 3-way tensor")
    if method not in ("reshard", "naive"):
        raise ValueError(f"unknown method {method!r}")
    move = _reshard if method == "reshard" else _reshard_naive
    ctx = X.ctx
    dims = X.shape
    q = max(X.grid.grid)
    if inits is None:
        rng = np.random.default_rng(seed)
        inits = [rng.standard_normal((d, rank)) for d in dims]
    factors = [ctx.from_numpy(np.asarray(f0, dtype=np.float64), grid=(1, 1))
               for f0 in inits]

    stats = ctx.sched_stats
    moved0, reshards0 = stats.reshard_moved_elements, stats.reshards

    # one layout + unfolding per mode, built once and reused every sweep
    xmats = []
    for mode in range(3):
        tgrid = _mode_grid(X, mode, q)
        Xi = X if X.grid.grid == tgrid else move(X, grid=tgrid)
        xmats.append(matricize(Xi, mode).compute())

    others = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    result = CPALSResult(factors=factors, iterations=0,
                         moved_elements=0.0, reshards=0)
    for _sweep in range(iters):
        for mode in range(3):
            o1, o2 = (factors[m] for m in others[mode])
            kr = khatri_rao(o1, o2)
            M = xmats[mode] @ kr
            G = (_gram(o1) * _gram(o2)).compute()
            updated = _blockwise_rsolve(M, G).compute()
            # gather the row-partitioned update back to a single block for
            # the next mode's Khatri-Rao — the in-loop (plan-cached) reshard
            factors[mode] = move(updated, grid=(1, 1))
        result.iterations += 1
        if track_fit and ctx.executor.mode == "numpy":
            result.fit_history.append(cp_fit(X, factors))
    result.factors = factors
    result.moved_elements = stats.reshard_moved_elements - moved0
    result.reshards = stats.reshards - reshards0
    return result


def cp_fit(X: GraphArray, factors: Sequence[GraphArray]) -> float:
    """Relative fit ``1 - ||X - [[A,B,C]]|| / ||X||`` (numpy backend only)."""
    Xn = X.to_numpy()
    A, B, C = (f.to_numpy() for f in factors)
    approx = np.einsum("if,jf,kf->ijk", A, B, C)
    nrm = np.linalg.norm(Xn)
    return float(1.0 - np.linalg.norm(Xn - approx) / max(nrm, 1e-300))


# ---------------------------------------------------------------------------
# pure-numpy mirror (accuracy oracle)
# ---------------------------------------------------------------------------

def _khatri_rao_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.einsum("jf,kf->jkf", a, b).reshape(a.shape[0] * b.shape[0],
                                                 a.shape[1])


def _unfold_np(X: np.ndarray, mode: int) -> np.ndarray:
    return np.moveaxis(X, mode, 0).reshape(X.shape[mode], -1)


def cp_als_reference(
    X: np.ndarray,
    rank: int,
    iters: int = 3,
    inits: Optional[Sequence[np.ndarray]] = None,
    seed: int = 0,
) -> List[np.ndarray]:
    """Reference ALS with the exact update order of :func:`cp_als`."""
    X = np.asarray(X, dtype=np.float64)
    if inits is None:
        rng = np.random.default_rng(seed)
        inits = [rng.standard_normal((d, rank)) for d in X.shape]
    factors = [np.asarray(f0, dtype=np.float64) for f0 in inits]
    others = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    for _sweep in range(iters):
        for mode in range(3):
            o1, o2 = (factors[m] for m in others[mode])
            M = _unfold_np(X, mode) @ _khatri_rao_np(o1, o2)
            G = (o1.T @ o1) * (o2.T @ o2)
            factors[mode] = np.linalg.solve(G.T, M.T).T
    return factors
