"""Canonical demo workload graphs.

One definition of the logreg Newton-iteration graph (the Fig. 15 workload)
and the dense square matmul, shared by the launch driver
(``repro_torch.launch.blocks``), ``chip_smoke.py`` and the port's tests — so
all of them exercise the *same* expression graph as the reference's
``repro.launch.workloads``.  (``cpals_loop`` waits for the CP-ALS port,
ROADMAP Queue 1 item 4.)
"""
from __future__ import annotations

from repro_torch.core import ArrayContext


def logreg_newton_graph(ctx: ArrayContext, n: int, d: int, q: int,
                        reset_loads: bool = True):
    """One Newton iteration of logistic regression on an (n, d) design matrix
    split into q row blocks.  Returns the (gradient, Hessian) GraphArrays.

    ``reset_loads`` zeroes the load counters and simulated clocks after the
    operands are created, so reported loads cover the iteration only.
    """
    X = ctx.random((n, d), grid=(q, 1))
    y = ctx.random((n, 1), grid=(q, 1))
    beta = ctx.zeros((d, 1), grid=(1, 1))
    if reset_loads:
        ctx.reset_loads()
    mu = (X @ beta).sigmoid().compute()
    g = (X.T @ (mu - y)).compute()
    w = (mu * (1.0 - mu)).compute()
    H = (X.T @ (w * X).compute()).compute()
    return g, H


def dgemm_graph(ctx: ArrayContext, dim: int, g: int, reset_loads: bool = True):
    """Dense square (dim, dim) matmul on a (g, g) block grid."""
    A = ctx.random((dim, dim), grid=(g, g))
    B = ctx.random((dim, dim), grid=(g, g))
    if reset_loads:
        ctx.reset_loads()
    return (A @ B).compute()


def logreg_newton_loop(ctx: ArrayContext, n: int, d: int, q: int,
                       iters: int = 10, reset_loads: bool = True):
    """``iters`` full Newton iterations of ridge-regularized logistic
    regression — the paper's flagship *iterative* workload (§6/§8.5), and
    the plan-cache benchmark: every iteration re-builds a structurally
    identical block graph, so iterations 2..n replay iteration 1's plans.

    Returns the final ``(g, H, beta)`` GraphArrays (bit-comparable across
    plan-cache on/off runs).  Works on any backend; ``sim`` measures pure
    scheduling cost.
    """
    import numpy as np

    from repro_torch.glm.newton import _single_block_binary

    X = ctx.random((n, d), grid=(q, 1))
    y = ctx.uniform((n, 1), grid=(q, 1))
    beta = ctx.zeros((d, 1), grid=(1, 1))
    eye = ctx.from_numpy(1e-3 * np.eye(d), grid=(1, 1))
    if reset_loads:
        ctx.reset_loads()
    g = H = None
    for _ in range(iters):
        mu = (X @ beta).sigmoid().compute()
        g = (X.T @ (mu - y)).compute()
        w = (mu * (1.0 - mu)).compute()
        H = ((X.T @ (w * X).compute()) + eye).compute()
        delta = _single_block_binary(ctx, "solve", H, g).compute()
        beta = (beta - delta).compute()
    return g, H, beta


def dgemm_loop(ctx: ArrayContext, dim: int, g: int, iters: int = 10,
               reset_loads: bool = True):
    """Repeated C = A @ B on fixed operands.  Each iteration spreads a few
    more block copies, so residency (part of the structural fingerprint)
    keeps shifting within one run and plans mostly re-record; an identical
    second run evolves residency the same way and replays every plan from a
    shared cache — the cross-run (e.g. re-submitted job) caching regime."""
    A = ctx.random((dim, dim), grid=(g, g))
    B = ctx.random((dim, dim), grid=(g, g))
    if reset_loads:
        ctx.reset_loads()
    C = None
    for _ in range(iters):
        C = (A @ B).compute()
    return C
