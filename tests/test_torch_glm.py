"""The port's GLM front end (``GLM``, ``LogisticRegression``), its L-BFGS
solver and its data generators against the reference.

The same data (the generators give the reference's bits from the same
seed) through the reference's numpy backend and the port's ``numpy``,
``torch`` and ``cuda`` backends (``cuda`` on CPU tensors) at f64: each
estimator meets the reference's own checks (``tests/test_glm.py``,
``TestPoissonGLM`` of ``tests/test_examples_and_glm_extra.py``), and the
port's fit agrees with the reference package's, iteration by iteration.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as R
import repro.glm as ref_glm
import repro_torch.core as P
import repro_torch.glm as port_glm

BACKENDS = ["numpy", "torch", "cuda"]


def _ctx(pkg, backend="numpy", k=4, r=2, seed=0):
    kw = {"dtype": "float64", "backend": backend}
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.ArrayContext(cluster=pkg.ClusterSpec(k, r), node_grid=(k, 1), seed=seed,
                            **kw)


def _fit_both(backend, X, y, cls="LogisticRegression", row_blocks=8, k=4, r=2, **kw):
    """The same estimator fitted in the reference (numpy) and in the port."""
    fits = []
    for pkg, glm in ((R, ref_glm), (P, port_glm)):
        m = getattr(glm, cls)(_ctx(pkg, "numpy" if pkg is R else backend, k=k, r=r), **kw)
        fits.append(m.fit_numpy(X, y, row_blocks=row_blocks))
    return fits


def numpy_newton_logistic(X, y, iters=10, reg=0.0):
    beta = np.zeros((X.shape[1], 1))
    for _ in range(iters):
        mu = 1.0 / (1.0 + np.exp(-X @ beta))
        g = X.T @ (mu - y) + reg * beta
        H = X.T @ (mu * (1.0 - mu) * X) + reg * np.eye(X.shape[1])
        beta = beta - np.linalg.solve(H, g)
    return beta


@pytest.mark.parametrize("gen,kw", [
    ("paper_bimodal", dict(n=1000, d=16, seed=4)),
    ("paper_bimodal", dict(n=999, d=8, seed=1, standardize=False)),
    ("overlapping_gaussians", dict(n=513, d=8, seed=2, sep=2.0)),
])
def test_data_generators_give_the_reference_bits(gen, kw):
    X, y = getattr(port_glm, gen)(**kw)
    Xr, yr = getattr(ref_glm, gen)(**kw)
    assert X.tobytes() == Xr.tobytes() and y.tobytes() == yr.tobytes()
    assert X.shape == (kw["n"], kw["d"]) and y.shape == (kw["n"], 1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_newton_front_end_matches_oracle_and_reference(backend):
    X, y = port_glm.overlapping_gaussians(512, d=8, seed=1, sep=2.0)
    ref, port = _fit_both(backend, X, y, solver="newton", max_iter=5, reg=1e-3)
    assert np.allclose(port.beta, numpy_newton_logistic(X, y, iters=5, reg=1e-3), atol=1e-8)
    np.testing.assert_allclose(port.beta, ref.beta, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(port.result.grad_norms, ref.result.grad_norms,
                               rtol=1e-8, atol=1e-10)
    assert port.score_numpy(X, y) == ref.score_numpy(X, y) > 0.8
    np.testing.assert_allclose(port.predict_proba_numpy(X), ref.predict_proba_numpy(X),
                               rtol=1e-10)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lbfgs_matches_reference_and_reaches_newton(backend):
    X, y = port_glm.overlapping_gaussians(512, d=8, seed=5, sep=1.0)
    ref, port = _fit_both(backend, X, y, solver="lbfgs", max_iter=100, reg=1e-3)
    newton = port_glm.LogisticRegression(_ctx(P, backend), solver="newton", max_iter=12,
                                         reg=1e-3).fit_numpy(X, y, row_blocks=8)
    assert np.allclose(port.beta, newton.beta, atol=1e-4)
    np.testing.assert_allclose(port.beta, ref.beta, rtol=1e-8, atol=1e-10)
    _same_path(port, ref)


def _same_path(port, ref):
    """The two fits' objectives agree iteration by iteration.  Near the
    optimum the last steps are decided at rounding level, so the two may
    stop an iteration apart: compare the iterations both ran."""
    n = min(len(port.result.objectives), len(ref.result.objectives))
    assert abs(port.result.iterations - ref.result.iterations) <= 1
    np.testing.assert_allclose(port.result.objectives[:n], ref.result.objectives[:n],
                               rtol=1e-8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lbfgs_objective_monotone_like_reference(backend):
    X, y = port_glm.overlapping_gaussians(512, d=8, seed=7, sep=2.0)
    ref, port = _fit_both(backend, X, y, solver="lbfgs", max_iter=15, reg=1e-3)
    obj = port.result.objectives
    assert all(b <= a + 1e-9 for a, b in zip(obj, obj[1:]))
    _same_path(port, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lbfgs_on_paper_bimodal_decreases_loss(backend):
    """``chip_smoke.py``'s configuration at small size: L-BFGS on the paper's
    separable data with the ridge of the reference's paper-data test, 10
    iterations (without a ridge the first step takes the loss to 0)."""
    X, y = port_glm.paper_bimodal(2048, d=32, seed=4)
    ref, port = _fit_both(backend, X, y, solver="lbfgs", max_iter=10, reg=1e-2)
    obj = port.result.objectives
    assert port.result.iterations == 10
    assert all(b < a for a, b in zip(obj, obj[1:]))
    _same_path(port, ref)
    np.testing.assert_allclose(port.beta, ref.beta, rtol=1e-8)
    assert port.score_numpy(X, y) > 0.99


@pytest.mark.parametrize("backend", BACKENDS)
def test_linear_model_closed_form(backend):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((256, 6))
    beta_true = rng.standard_normal((6, 1))
    ref, port = _fit_both(backend, X, X @ beta_true, cls="GLM", model="linear",
                          solver="newton", max_iter=2)
    assert np.allclose(port.beta, beta_true, atol=1e-8)
    assert port.score_numpy(X, X @ beta_true) == pytest.approx(
        ref.score_numpy(X, X @ beta_true), abs=1e-20)


@pytest.mark.parametrize("backend", BACKENDS)
def test_poisson_recovers_rate(backend):
    rng = np.random.default_rng(0)
    X = rng.normal(0, 0.3, size=(2048, 4))
    beta_true = np.array([[0.5], [-0.3], [0.2], [0.1]])
    y = rng.poisson(np.exp(X @ beta_true)).astype(np.float64)
    ref, port = _fit_both(backend, X, y, cls="GLM", model="poisson", solver="newton",
                          max_iter=8, reg=1e-8)
    assert np.allclose(port.beta, beta_true, atol=0.1)
    np.testing.assert_allclose(port.beta, ref.beta, rtol=1e-10)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("solver", ["newton", "lbfgs"])
def test_poisson_matches_numpy_newton(backend, solver):
    rng = np.random.default_rng(1)
    X = rng.normal(0, 0.3, size=(512, 3))
    y = rng.poisson(np.exp(X @ np.array([[0.4], [0.1], [-0.2]]))).astype(float)
    ref, port = _fit_both(backend, X, y, cls="GLM", model="poisson", solver=solver,
                          max_iter=5 if solver == "newton" else 60, reg=0.0,
                          row_blocks=4, k=2, r=2)
    beta = np.zeros((3, 1))
    for _ in range(5):
        mu = np.exp(X @ beta)
        beta -= np.linalg.solve(X.T @ (mu * X), X.T @ (mu - y))
    assert np.allclose(port.beta, beta, atol=1e-8 if solver == "newton" else 1e-5)
    np.testing.assert_allclose(port.beta, ref.beta, rtol=1e-8, atol=1e-12)


def test_unknown_solver_raises_and_beta_stays_home():
    ctx = _ctx(P, "cuda")
    with pytest.raises(ValueError, match="unknown solver"):
        port_glm.GLM(ctx, solver="sgd")
    X, y = port_glm.overlapping_gaussians(1024, d=8, seed=9)
    m = port_glm.LogisticRegression(ctx, solver="lbfgs", max_iter=3).fit_numpy(X, y)
    assert m.result.beta.block((0, 0)).placement[0] == 0
