"""User-facing GLM estimators (paper §6/§8.5-8.6)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import ArrayContext, GraphArray

from .lbfgs import LBFGSSolver
from .models import MODELS
from .newton import FitResult, NewtonSolver


class GLM:
    def __init__(
        self,
        ctx: ArrayContext,
        model: str = "logistic",
        solver: str = "newton",
        max_iter: int = 10,
        tol: float = 1e-8,
        reg: float = 0.0,
        history: int = 10,
    ):
        self.ctx = ctx
        self.model = MODELS[model]
        if solver == "newton":
            self.solver = NewtonSolver(max_iter=max_iter, tol=tol, reg=reg)
        elif solver == "lbfgs":
            self.solver = LBFGSSolver(max_iter=max_iter, tol=tol, reg=reg, history=history)
        else:
            raise ValueError(f"unknown solver {solver!r}")
        self.result: Optional[FitResult] = None

    def fit(self, X: GraphArray, y: GraphArray) -> "GLM":
        self.result = self.solver.fit(self.ctx, self.model, X, y)
        return self

    def fit_numpy(self, X: np.ndarray, y: np.ndarray, row_blocks: Optional[int] = None) -> "GLM":
        q = row_blocks or self.ctx.cluster.num_workers
        q = min(q, X.shape[0])
        Xg = self.ctx.from_numpy(X, grid=(q, 1))
        yg = self.ctx.from_numpy(y.reshape(-1, 1), grid=(q, 1))
        return self.fit(Xg, yg)

    @property
    def beta(self) -> np.ndarray:
        return self.result.beta.to_numpy()

    def predict_proba(self, X: GraphArray) -> np.ndarray:
        mu = self.model.mean(X, self.result.beta).compute()
        return mu.to_numpy()

    def predict_proba_numpy(self, X: np.ndarray) -> np.ndarray:
        q = min(self.ctx.cluster.num_workers, X.shape[0])
        Xg = self.ctx.from_numpy(X, grid=(q, 1))
        return self.predict_proba(Xg)

    def score_numpy(self, X: np.ndarray, y: np.ndarray) -> float:
        p = self.predict_proba_numpy(X).ravel()
        if self.model.name == "logistic":
            return float(((p > 0.5) == (y.ravel() > 0.5)).mean())
        return -float(np.mean((p - y.ravel()) ** 2))


class LogisticRegression(GLM):
    def __init__(self, ctx: ArrayContext, **kw):
        super().__init__(ctx, model="logistic", **kw)
