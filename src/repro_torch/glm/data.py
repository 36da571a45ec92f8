"""Synthetic classification data (paper §8.5).

``paper_bimodal``: 75% negatives ~ N(10, sqrt 2), 25% positives ~ N(30, 2),
256-dimensional by default — the distribution "recommended by our industry
collaborators".  ``overlapping_gaussians`` is a harder variant (means ±1)
used by correctness tests so the optimum is finite (the paper's data is
linearly separable).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def paper_bimodal(
    n: int, d: int = 256, seed: int = 0, standardize: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n_neg = int(0.75 * n)
    n_pos = n - n_neg
    Xn = rng.normal(10.0, np.sqrt(2.0), size=(n_neg, d))
    Xp = rng.normal(30.0, 2.0, size=(n_pos, d))
    X = np.concatenate([Xn, Xp], axis=0)
    y = np.concatenate([np.zeros(n_neg), np.ones(n_pos)])[:, None]
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]
    if standardize:
        X = (X - X.mean(0)) / (X.std(0) + 1e-12)
    return X, y


def overlapping_gaussians(
    n: int, d: int = 16, seed: int = 0, sep: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n_neg = n // 2
    n_pos = n - n_neg
    Xn = rng.normal(-sep / 2, 1.0, size=(n_neg, d))
    Xp = rng.normal(+sep / 2, 1.0, size=(n_pos, d))
    X = np.concatenate([Xn, Xp], axis=0)
    y = np.concatenate([np.zeros(n_neg), np.ones(n_pos)])[:, None]
    perm = rng.permutation(n)
    return X[perm], y[perm]
