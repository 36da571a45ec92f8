"""Newton's method for GLMs on GraphArray (paper Algorithm 2, §6 schedule).

Per iteration:
    mu   = m(X, beta)                      elementwise after X@beta: local
    g    = X^T (mu - y) + reg*beta         blockwise inner product -> tree
    H    = X^T ((w x X)) + reg*I           blockwise inner product -> tree
    beta = beta - H^{-1} g                 single-block solve on node N_0,0
The convergence test ||g||_2 <= eps is computed on the single-block gradient.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core import ArrayContext, GraphArray
from repro_torch.core.grid import ArrayGrid
from repro_torch.core.graph_array import Vertex


def _single_block_binary(ctx: ArrayContext, op: str, A: GraphArray, B: GraphArray) -> GraphArray:
    """Apply a binary block op to two single-block arrays (e.g. solve)."""
    va, vb = A.block(tuple(0 for _ in A.grid.grid)), B.block(tuple(0 for _ in B.grid.grid))
    from repro_torch.core.graph_array import infer_shape

    shp = infer_shape(op, {}, [va.shape, vb.shape])
    v = Vertex("op", op, shp, [va, vb])
    grid = ArrayGrid(shp, tuple(1 for _ in shp), A.grid.dtype)
    blocks = np.empty(grid.grid if grid.grid else (), dtype=object)
    blocks[tuple(0 for _ in grid.grid) if grid.grid else ()] = v
    return GraphArray(ctx, grid, blocks)


@dataclass
class FitResult:
    beta: GraphArray
    iterations: int
    grad_norms: List[float] = field(default_factory=list)
    objectives: List[float] = field(default_factory=list)
    converged: bool = False


class NewtonSolver:
    def __init__(self, max_iter: int = 10, tol: float = 1e-8, reg: float = 0.0):
        self.max_iter = max_iter
        self.tol = tol
        self.reg = reg

    def fit(self, ctx: ArrayContext, model, X: GraphArray, y: GraphArray) -> FitResult:
        n, d = X.shape
        beta = ctx.zeros((d, 1), grid=(1, 1))
        eye = None
        if self.reg > 0:
            eye = ctx.from_numpy(self.reg * np.eye(d), grid=(1, 1))
        res = FitResult(beta=beta, iterations=0)
        for it in range(self.max_iter):
            mu = model.mean(X, beta).compute()
            g = (X.T @ (mu - y)).compute()
            if self.reg > 0:
                g = (g + self.reg * beta).compute()
            w = model.hessian_weights(mu).compute()
            C = (w * X).compute()
            H = (X.T @ C).compute()
            if eye is not None:
                H = (H + eye).compute()
            gnorm = float(np.sqrt((g * g).sum().to_numpy()))
            res.grad_norms.append(gnorm)
            res.iterations = it + 1
            if gnorm <= self.tol:
                res.converged = True
                break
            delta = _single_block_binary(ctx, "solve", H, g).compute()
            beta = (beta - delta).compute()
            res.beta = beta
        return res
