"""GLM link functions and per-model Newton quantities (paper §6).

Each model supplies, in GraphArray expressions:
  mean(X, beta)            the model m(X, beta)
  gradient(X, y, mu)       ∇f = X^T (mu - y)          (canonical links)
  hessian_weights(mu)      w with  ∇²f = X^T (w × X)
  objective(X, y, beta)    the convex objective f
All expressions follow the §6 schedule: elementwise ops stay local; the
X^T(...) contractions are block-wise inner products reduced over a tree.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import GraphArray


class _ModelBase:
    name = "base"

    def mean(self, X: GraphArray, beta: GraphArray) -> GraphArray:
        raise NotImplementedError

    def gradient(self, X, y, mu) -> GraphArray:
        # canonical link: X^T (mu - y); transpose fused into matmul (§6)
        return X.T @ (mu - y)

    def hessian_weights(self, mu) -> GraphArray:
        raise NotImplementedError

    def objective(self, X, y, beta) -> float:
        raise NotImplementedError


class LogisticModel(_ModelBase):
    name = "logistic"

    def mean(self, X, beta):
        return (X @ beta).sigmoid()

    def hessian_weights(self, mu):
        return mu * (1.0 - mu)

    def objective(self, X, y, beta) -> float:
        # f = sum softplus(z) - y z   (stable logistic NLL)
        z = (X @ beta).compute()
        val = (z.softplus() - y * z).sum()
        return float(val.to_numpy())


class LinearModel(_ModelBase):
    name = "linear"

    def mean(self, X, beta):
        return X @ beta

    def hessian_weights(self, mu):
        return 1.0 + 0.0 * mu  # identity weights, same layout as mu

    def objective(self, X, y, beta) -> float:
        r = ((X @ beta).compute() - y).compute()
        return 0.5 * float((r * r).sum().to_numpy())


class PoissonModel(_ModelBase):
    name = "poisson"

    def mean(self, X, beta):
        return (X @ beta).exp()

    def hessian_weights(self, mu):
        return mu

    def objective(self, X, y, beta) -> float:
        z = (X @ beta).compute()
        val = (z.exp() - y * z).sum()
        return float(val.to_numpy())


MODELS = {m.name: m for m in (LogisticModel(), LinearModel(), PoissonModel())}
