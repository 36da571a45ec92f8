"""L-BFGS for GLMs on GraphArray (paper §8.5 Spark comparison).

Matches the Spark/Breeze structure the paper benchmarks against: the
gradient is computed *distributed* (blockwise inner product with tree
reduction, exactly the §6 schedule); the two-loop recursion and line search
direction-finding operate on the gathered d-dimensional vectors (single
blocks on node N_0,0 — the d x 1 home block is the "driver" copy)."""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List

import numpy as np

from repro_torch.core import ArrayContext, GraphArray

from .newton import FitResult


class LBFGSSolver:
    def __init__(
        self,
        max_iter: int = 10,
        tol: float = 1e-8,
        reg: float = 0.0,
        history: int = 10,
        ls_max: int = 20,
        c1: float = 1e-4,
    ):
        self.max_iter = max_iter
        self.tol = tol
        self.reg = reg
        self.history = history
        self.ls_max = ls_max
        self.c1 = c1

    def _grad(self, ctx, model, X, y, beta) -> np.ndarray:
        mu = model.mean(X, beta).compute()
        g = (X.T @ (mu - y)).compute()
        gnp = g.to_numpy()
        if self.reg > 0:
            gnp = gnp + self.reg * beta.to_numpy()
        return gnp

    def _obj(self, ctx, model, X, y, beta) -> float:
        val = model.objective(X, y, beta)
        if self.reg > 0:
            b = beta.to_numpy()
            val += 0.5 * self.reg * float((b * b).sum())
        return val

    def fit(self, ctx: ArrayContext, model, X: GraphArray, y: GraphArray) -> FitResult:
        n, d = X.shape
        beta = ctx.zeros((d, 1), grid=(1, 1))
        res = FitResult(beta=beta, iterations=0)
        s_hist: deque = deque(maxlen=self.history)
        y_hist: deque = deque(maxlen=self.history)
        g = self._grad(ctx, model, X, y, beta)
        f = self._obj(ctx, model, X, y, beta)
        for it in range(self.max_iter):
            res.iterations = it + 1
            gnorm = float(np.linalg.norm(g))
            res.grad_norms.append(gnorm)
            res.objectives.append(f)
            if gnorm <= self.tol:
                res.converged = True
                break
            # two-loop recursion (Nocedal & Wright Alg. 7.4)
            q = g.copy()
            alphas = []
            for s, yv in reversed(list(zip(s_hist, y_hist))):
                rho = 1.0 / float((yv * s).sum())
                a = rho * float((s * q).sum())
                alphas.append((a, rho, s, yv))
                q -= a * yv
            if y_hist:
                s_l, y_l = s_hist[-1], y_hist[-1]
                gamma = float((s_l * y_l).sum()) / float((y_l * y_l).sum())
                q *= gamma
            for a, rho, s, yv in reversed(alphas):
                b = rho * float((yv * q).sum())
                q += (a - b) * s
            direction = -q
            # backtracking Armijo line search (identical for both libraries,
            # per §8.5) evaluating the distributed objective
            t = 1.0
            gTd = float((g * direction).sum())
            beta_np = beta.to_numpy()
            accepted = False
            for _ in range(self.ls_max):
                cand = ctx.from_numpy(beta_np + t * direction, grid=(1, 1))
                f_new = self._obj(ctx, model, X, y, cand)
                if f_new <= f + self.c1 * t * gTd:
                    accepted = True
                    break
                t *= 0.5
            if not accepted:
                break
            new_beta = ctx.from_numpy(beta_np + t * direction, grid=(1, 1))
            g_new = self._grad(ctx, model, X, y, new_beta)
            s_hist.append(t * direction)
            y_hist.append(g_new - g)
            beta, g, f = new_beta, g_new, f_new
            res.beta = beta
        return res
