"""Plain PyTorch Newton's method for L2-regularised logistic regression.

The reference the port's fits are judged against.  It imports nothing of
the port and works every quantity out from the raw inputs: each iteration
sums the gradient ``X^T (mu - y) + reg beta`` and the Hessian
``X^T (w * X) + reg I`` over row blocks, reads the gradient's norm, stops
once it is at most ``tol``, and otherwise takes the step
``beta - H^{-1} g``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def newton_logreg(X: torch.Tensor, y: torch.Tensor, *, max_iter: int, tol: float,
                  reg: float, block_rows: int) -> Tuple[torch.Tensor, List[float]]:
    """Fit ``y ~ Bernoulli(sigmoid(X beta))`` from ``beta = 0``.  Returns the
    final ``beta`` (d, 1) and the gradient norm read at each iteration."""
    n, d = X.shape
    beta = torch.zeros((d, 1), dtype=X.dtype, device=X.device)
    ridge = reg * torch.eye(d, dtype=X.dtype, device=X.device)
    norms: List[float] = []
    for _ in range(max_iter):
        g = reg * beta
        H = ridge.clone()
        for r0 in range(0, n, block_rows):
            Xb, yb = X[r0:r0 + block_rows], y[r0:r0 + block_rows]
            mu = torch.sigmoid(Xb @ beta)
            g += Xb.T @ (mu - yb)
            H += Xb.T @ ((mu * (1.0 - mu)) * Xb)
        gnorm = float(torch.sqrt((g * g).sum()))
        norms.append(gnorm)
        if gnorm <= tol:
            break
        beta = beta - torch.linalg.solve(H, g)
    return beta, norms
