"""Generalized linear models on GraphArray (paper §6, §8.5)."""
from .data import overlapping_gaussians, paper_bimodal
from .models import LinearModel, LogisticModel, PoissonModel
from .newton import NewtonSolver
from .lbfgs import LBFGSSolver
from .glm import GLM, LogisticRegression

__all__ = [
    "GLM",
    "LBFGSSolver",
    "LinearModel",
    "LogisticModel",
    "LogisticRegression",
    "NewtonSolver",
    "PoissonModel",
    "overlapping_gaussians",
    "paper_bimodal",
]
