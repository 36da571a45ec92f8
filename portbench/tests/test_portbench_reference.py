"""The plain references against the port on the host at small size, and
against textbook facts."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import harness


def _module(kind, part):
    return harness.load_module(ROOT / "portbench" / part / f"{kind}.py")


def test_newton_reference_matches_the_port():
    from repro_torch.glm import LogisticRegression
    from portbench.runtime import make_context

    kind, ref = _module("glm_newton", "kinds"), _module("glm_newton", "reference")
    config = harness.load_json(ROOT / "portbench" / "configs" / "logreg-newton.json")
    config.update(n_rows=1 << 12, n_features=32)
    X, y = kind.make_inputs(config, 123, "cpu")
    beta_ref, norms_ref = ref.newton_logreg(X, y, max_iter=10, tol=config["tol"],
                                            reg=config["reg"], block_rows=1000)
    ctx = make_context(config["context"], "cpu")
    est = LogisticRegression(ctx, solver="newton", max_iter=10, tol=config["tol"],
                             reg=config["reg"])
    est.fit(ctx.from_numpy(X.numpy(), grid=(8, 1)), ctx.from_numpy(y.numpy(), grid=(8, 1)))
    np.testing.assert_allclose(est.beta, beta_ref.numpy(), rtol=1e-10, atol=1e-12)
    assert len(est.result.grad_norms) == len(norms_ref)
    np.testing.assert_allclose(est.result.grad_norms[:3], norms_ref[:3], rtol=1e-10)


def test_newton_reference_reaches_the_optimum():
    """At the reference's answer the regularised gradient vanishes, from a
    planted model it recovers beta* to sampling error."""
    ref = _module("glm_newton", "reference")
    gen = torch.Generator().manual_seed(7)
    n, d, reg = 1 << 15, 8, 1e-6
    X = torch.randn((n, d), generator=gen, dtype=torch.float64)
    beta_star = torch.randn((d, 1), generator=gen, dtype=torch.float64)
    y = (torch.rand((n, 1), generator=gen, dtype=torch.float64)
         < torch.sigmoid(X @ beta_star)).double()
    beta, norms = ref.newton_logreg(X, y, max_iter=20, tol=1e-8, reg=reg, block_rows=4096)
    grad = X.T @ (torch.sigmoid(X @ beta) - y) + reg * beta
    assert norms[-1] <= 1e-8 and float(grad.norm()) <= 1e-6
    assert float((beta - beta_star).abs().max()) < 0.1


def test_product_rows_is_the_product():
    ref = _module("block_matmul", "reference")
    gen = torch.Generator().manual_seed(3)
    A = torch.randn((96, 96), generator=gen, dtype=torch.float64)
    B = torch.randn((96, 96), generator=gen, dtype=torch.float64)
    rows = torch.cat([r for _i, r in ref.product_rows(A, B, 4)])
    torch.testing.assert_close(rows, A @ B, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["glm_newton", "block_matmul"])
def test_inputs_repeat_from_the_seed(kind):
    mod = _module(kind, "kinds")
    config = harness.load_json(ROOT / "portbench" / "configs" / (
        "logreg-newton.json" if kind == "glm_newton" else "dgemm-f64.json"))
    config.update(n_rows=512, dim=64)
    first, again = mod.make_inputs(config, 2 ** 31 + 3, "cpu"), mod.make_inputs(
        config, 2 ** 31 + 3, "cpu")
    other = mod.make_inputs(config, 2 ** 31 + 4, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], other[0])
