"""Cells of logistic regression by Newton's method (configuration kind
``glm_newton``).

The system under test is the user's entry,
``repro_torch.glm.LogisticRegression(ctx, solver="newton", ...).fit(X, y)``,
fit after fit on data that stay resident in the port's blocks.  A step is
one Newton iteration: the window runs whole fits, and the step boundaries
are the solver's calls of its model's ``mean`` (the first thing each
iteration does), so the iterations tile the window and each one holds the
solver's own gradient-norm read-back.  Each fit's answer is its ``beta`` read
to the host, as a user reads it, and its gradient norms.

Traffic parameters: ``row_blocks`` (q, the row blocks of X and y) and
``warmup_fits``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from time import perf_counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.runtime import (Phases, Window, host_copy, layer_ranges, lower_precision,
                               make_context, release, reset_peak, sync)

#: the sizes at which the CPU tests run this kind in seconds
SMALL = {"n_rows": 1 << 13, "reference_block_rows": 1 << 11}


def control(config: Dict) -> Dict:
    """The port's own path one precision below the configuration's."""
    return lower_precision(config)


def make_inputs(config: Dict, seed: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """X ~ N(0, 1) (n, d); y ~ Bernoulli(sigmoid(X beta*)) (n, 1) for a planted
    beta* ~ N(0, 1/d); drawn on ``device`` from ``seed`` in a few large calls."""
    n, d = config["n_rows"], config["n_features"]
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X = torch.randn((n, d), generator=gen, dtype=dtype, device=device)
    beta_star = torch.randn((d, 1), generator=gen, dtype=dtype, device=device) / math.sqrt(d)
    u = torch.rand((n, 1), generator=gen, dtype=dtype, device=device)
    y = (u < torch.sigmoid(X @ beta_star)).to(dtype)
    return X, y


def block_rows(config: Dict, traffic: Dict) -> int:
    n, q = config["n_rows"], traffic["row_blocks"]
    if n % q:
        raise ValueError(f"n_rows {n} is not a multiple of row_blocks {q}")
    return n // q


def step_products(config: Dict, traffic: Dict) -> List[Tuple[int, int, int, int]]:
    """(m, k, n, count) of the block products one iteration needs: X_i beta,
    X_i^T (mu_i - y_i) and X_i^T (w_i * X_i) for each row block i."""
    r, d, q = block_rows(config, traffic), config["n_features"], traffic["row_blocks"]
    return [(r, d, 1, q), (d, r, 1, q), (d, r, d, q)]


def step_flops(config: Dict, traffic: Dict) -> float:
    """Model operations of one iteration: 2nd^2 (Hessian) + 2nd (X beta) +
    2nd (gradient) + nd (w * X)."""
    n, d = config["n_rows"], config["n_features"]
    return 2.0 * n * d * d + 5.0 * n * d


class _IterationClock:
    """Stands in for the estimator's model and notes the time of each call of
    ``mean``, the first thing a Newton iteration does; every other attribute
    is the model's own."""

    def __init__(self, model):
        self._model = model
        self.marks: List[float] = []

    def mean(self, X, beta):
        self.marks.append(perf_counter())
        return self._model.mean(X, beta)

    def __getattr__(self, name):
        return getattr(self._model, name)


@dataclass
class Fit:
    beta: np.ndarray
    grad_norms: List[float]


class Job:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str, context: Dict):
        from repro_torch.glm import LogisticRegression

        self.device = device
        self.phases = Phases(device)
        self.ctx = make_context(context, device)
        self.phases.mark("context")
        X, y = make_inputs(config, seed, device)
        self.phases.mark("inputs")
        Xh, yh = host_copy(X), host_copy(y)
        del X, y
        release(device)
        reset_peak(device)
        self.phases.mark("to_host")
        q = traffic["row_blocks"]
        block_rows(config, traffic)
        self.X = self.ctx.from_numpy(Xh, grid=(q, 1))
        self.y = self.ctx.from_numpy(yh, grid=(q, 1))
        del Xh, yh
        self.phases.mark("from_numpy")
        self.est = LogisticRegression(self.ctx, solver=config["solver"],
                                      max_iter=config["max_iter"], tol=config["tol"],
                                      reg=config["reg"])
        self.clock = _IterationClock(self.est.model)
        self.est.model = self.clock
        self.fits: List[Fit] = []
        for _ in range(traffic["warmup_fits"]):
            self._fit()
        self.fits.clear()
        self.phases.mark("warmup")

    def _fit(self) -> None:
        self.est.fit(self.X, self.y)
        beta = self.est.beta
        self.fits.append(Fit(beta, list(self.est.result.grad_norms)))

    def window(self, seconds: float) -> Window:
        sync(self.device)
        self.clock.marks.clear()
        t0 = perf_counter()
        self._fit()
        while perf_counter() - t0 < seconds:
            self._fit()
        sync(self.device)
        t1 = perf_counter()
        bounds = [t0, *self.clock.marks[1:], t1]
        times = [b - a for a, b in zip(bounds, bounds[1:])]
        return Window(steps=len(times), window_s=t1 - t0, step_times=times)

    def loads(self) -> Dict:
        return self.ctx.loads()

    def trace_ranges(self) -> None:
        layer_ranges(self.ctx)

    def answers(self) -> List[Fit]:
        return list(self.fits)

    def close(self) -> None:
        del self.est, self.clock, self.X, self.y, self.ctx
        release(self.device)


def compare(config: Dict, fits: List[Fit], beta_ref: np.ndarray,
            norms_ref: List[float]) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """The numbers compared, over all fits and for each fit.

    ``beta_err``: max |beta - beta_ref| over max |beta_ref|.  ``gnorm_err``:
    the relative gap of the gradient norm at each iteration whose reference
    norm is at least ``gnorm_compare_share`` of the first (below that the
    norm is rounding; the fit's iterations there are held by ``beta_err``).
    A fit that stops before such an iteration, or a value that is not a
    number, reads infinity."""
    scale = float(np.abs(beta_ref).max())
    share = config["gnorm_compare_share"]
    compared = [k for k, g in enumerate(norms_ref) if g >= share * norms_ref[0]]
    per_fit = []
    for fit in fits:
        beta_err = float(np.abs(fit.beta - beta_ref).max()) / scale
        gaps = [abs(fit.grad_norms[k] - norms_ref[k]) / norms_ref[k]
                if k < len(fit.grad_norms) else math.inf for k in compared]
        per_fit.append({"beta_err": _finite_or_inf(beta_err),
                        "gnorm_err": _finite_or_inf(max(gaps))})
    worst = {name: max((f[name] for f in per_fit), default=math.inf)
             for name in ("beta_err", "gnorm_err")}
    return worst, per_fit


def _finite_or_inf(value: float) -> float:
    return value if math.isfinite(value) else math.inf


def check(config: Dict, traffic: Dict, seed: int, device: str, fits: List[Fit],
          reference) -> Tuple[Dict[str, float], int, List[str]]:
    """Run the reference on the same inputs (drawn again from the seed) and
    compare every fit of the window.  Returns the worst of each number, the
    iterations of the fits that fail a limit, and notes for the log."""
    X, y = make_inputs(config, seed, device)
    beta_ref, norms_ref = reference.newton_logreg(
        X, y, max_iter=config["max_iter"], tol=config["tol"], reg=config["reg"],
        block_rows=config["reference_block_rows"])
    beta_ref = host_copy(beta_ref)
    del X, y
    release(device)
    worst, per_fit = compare(config, fits, beta_ref, norms_ref)
    limits = config["limits"]
    failed = sum(len(fit.grad_norms) for fit, nums in zip(fits, per_fit)
                 if any(not nums[k] <= limits[k] for k in limits))
    return worst, failed, [f"reference gradient norms {norms_ref!r}",
                           f"fits {len(fits)}, iterations {[len(f.grad_norms) for f in fits]}"]
