"""The paper's own workload: terabyte-scale logistic regression via
Newton's method (NumS §6/§8.5) — n x 256 tall-skinny design matrix."""
from dataclasses import dataclass


@dataclass(frozen=True)
class GLMConfig:
    name: str = "glm-logreg"
    n_features: int = 256
    dtype: str = "float64"
    solver: str = "newton"
    max_iter: int = 10
    reg: float = 1e-6


CONFIG = GLMConfig()
