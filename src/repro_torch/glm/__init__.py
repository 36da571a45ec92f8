"""Generalized linear models on GraphArray (paper §6, §8.5): the Newton
solver and the model link functions.  L-BFGS, the estimator front end and
the data generators are not ported yet (ROADMAP Queue 1 item 3)."""
from .models import LinearModel, LogisticModel, PoissonModel
from .newton import NewtonSolver

__all__ = ["LinearModel", "LogisticModel", "NewtonSolver", "PoissonModel"]
