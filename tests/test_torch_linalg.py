"""The port's communication-avoiding linear algebra against the reference.

TSQR (direct and indirect), blocked Cholesky and its solve, the randomized
SVD, SUMMA and the recursive matmul, on the port's ``numpy``, ``torch`` and
``cuda`` backends (``cuda`` on CPU tensors: block products through the
matmul wrapper's plain version) at f64: values within the reference's own
tolerances (``tests/test_linalg_ca.py``, ``tests/test_linalg_tensor.py``)
and against the reference package run on the same graph and seed; every
``comm_ratio_*``, placement and simulated makespan equal to the
reference's, and equal between the data backends and ``sim``.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as R
import repro.linalg as ref_linalg
import repro_torch.core as P
import repro_torch.linalg as port_linalg

BACKENDS = ["numpy", "torch", "cuda"]
RTOL = 1e-9  # the reference's f64 ceiling (tests/test_linalg_ca.py)


def _ctx(pkg, backend, k=4, r=2, ng=None, **kw):
    if backend != "sim":
        kw.setdefault("dtype", "float64")
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.ArrayContext(cluster=pkg.ClusterSpec(k, r), node_grid=ng or (k, 1),
                            backend=backend, seed=0, **kw)


def _pair(backend, **kw):
    """(reference numpy context, port context on ``backend``) — or two sim
    contexts for ``sim``."""
    return (_ctx(R, "sim" if backend == "sim" else "numpy", **kw),
            _ctx(P, backend, **kw))


def _facts(ctx, *outs):
    loads = ctx.loads()
    return {"comm": {k: v for k, v in loads.items() if k.startswith("comm_")},
            "S": ctx.state.S.tolist(),
            "placements": [list(o.placements().values()) for o in outs],
            "makespans": (ctx.state.makespan(pipeline=False),
                          ctx.state.makespan(pipeline=True))}


def rel(err, ref):
    return np.abs(err).max() / max(np.abs(ref).max(), 1.0)


def spd(n, seed=0):
    m = np.random.default_rng(seed).standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


def low_rank(m, d, svals, seed=0):
    rng = np.random.default_rng(seed)
    r = len(svals)
    u = np.linalg.qr(rng.standard_normal((m, r)))[0]
    v = np.linalg.qr(rng.standard_normal((d, r)))[0]
    return u @ np.diag(np.asarray(svals, dtype=float)) @ v.T


# ---------------------------------------------------------------------------
# TSQR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fn", ["tsqr_direct", "tsqr_indirect"])
@pytest.mark.parametrize("shape,q", [((256, 12), 8), ((128, 8), 4)])
def test_tsqr_matches_reference(backend, fn, shape, q):
    ref, port = _pair(backend)
    outs = []
    for pkg, linalg, ctx in ((R, ref_linalg, ref), (P, port_linalg, port)):
        X = ctx.random(shape, grid=(q, 1))
        Q, Rm = getattr(linalg, fn)(ctx, X)
        outs.append((X.to_numpy(), Q.to_numpy(), Rm.to_numpy(), _facts(ctx, Q, Rm)))
    (Xr, Qr, Rr, fr), (X, Qn, Rn, f) = outs
    assert X.tobytes() == Xr.tobytes()
    assert np.allclose(Qn @ Rn, X, atol=1e-8)
    assert np.allclose(Qn.T @ Qn, np.eye(shape[1]), atol=1e-8)
    assert np.allclose(Rn, np.triu(Rn), atol=1e-12)
    # R is unique up to the signs of its rows; both packages use LAPACK's
    assert rel(Rn - Rr, Rr) <= RTOL and rel(Qn - Qr, 1) <= RTOL
    assert f == fr


def test_tsqr_degenerate_and_validation():
    ctx = _ctx(P, "cuda", k=1, r=1, ng=(1, 1))
    X = ctx.random((64, 8), grid=(1, 1))
    Q, Rm = port_linalg.tsqr_indirect(ctx, X)
    assert np.allclose(Q.to_numpy() @ Rm.to_numpy(), X.to_numpy(), atol=1e-9)
    sim = _ctx(P, "sim")
    bad = sim.random((64, 8), grid=(4, 2))
    for fn in (port_linalg.tsqr_direct, port_linalg.tsqr_indirect):
        with pytest.raises(ValueError, match=r"got grid \(4, 2\)"):
            fn(sim, bad)
    with pytest.raises(ValueError, match=r"block \(0, 0\) has shape \(4, 8\)"):
        port_linalg.tsqr_direct(sim, sim.random((24, 8), grid=(6, 1)))


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,q,cols", [(50, 3, 2), (64, 4, 1), (40, 1, 1)])
def test_cholesky_and_solve_match_reference(backend, n, q, cols):
    a_np = spd(n)
    b_np = np.random.default_rng(1).standard_normal((n, cols))
    ref, port = _pair(backend)
    outs = []
    for linalg, ctx in ((ref_linalg, ref), (port_linalg, port)):
        L = linalg.cholesky(ctx, ctx.from_numpy(a_np, grid=(q, q)))
        x = linalg.cholesky_solve(ctx, L, ctx.from_numpy(b_np, grid=(q, 1)))
        outs.append((L.to_numpy(), x.to_numpy(), _facts(ctx, L, x)))
    (Lr, xr, fr), (L, x, f) = outs
    assert np.array_equal(L, np.tril(L)), "strict upper must be zero"
    assert rel(L @ L.T - a_np, a_np) <= RTOL
    assert rel(L - np.linalg.cholesky(a_np), L) <= 1e-9
    assert rel(x - np.linalg.solve(a_np, b_np), 1) <= RTOL
    assert rel(L - Lr, Lr) <= 1e-12 and rel(x - xr, xr) <= 1e-12
    assert f == fr


def test_cholesky_solve_1d_and_validation():
    n, q = 48, 3
    a_np, b_np = spd(n), np.random.default_rng(2).standard_normal(n)
    ctx = _ctx(P, "cuda")
    L = port_linalg.cholesky(ctx, ctx.from_numpy(a_np, grid=(q, q)))
    x = port_linalg.cholesky_solve(ctx, L, ctx.from_numpy(b_np, grid=(q,)))
    assert np.allclose(x.to_numpy(), np.linalg.solve(a_np, b_np))
    sim = _ctx(P, "sim")
    with pytest.raises(ValueError, match=r"square 2-D"):
        port_linalg.cholesky(sim, sim.random((32, 16), grid=(2, 1)))
    with pytest.raises(ValueError, match=r"square block grid.*\(2, 4\)"):
        port_linalg.cholesky(sim, sim.random((32, 32), grid=(2, 4)))
    L = port_linalg.cholesky(sim, sim.random((32, 32), grid=(2, 2)))
    with pytest.raises(ValueError, match=r"row grid"):
        port_linalg.cholesky_solve(sim, L, sim.random((32, 1), grid=(4, 1)))


def test_cholesky_plan_cache_bitwise():
    """An iterative Cholesky solve replays its plans; cache on and off give
    the same bits, on the cuda backend as in the reference's numpy test."""
    n, q = 64, 4
    a_np, b_np = spd(n), np.random.default_rng(6).standard_normal((n, 2))

    def loop(plan_cache):
        ctx = _ctx(P, "cuda", plan_cache=plan_cache)
        xs = []
        for _ in range(3):
            L = port_linalg.cholesky(ctx, ctx.from_numpy(a_np, grid=(q, q)))
            xs.append(port_linalg.cholesky_solve(
                ctx, L, ctx.from_numpy(b_np, grid=(q, 1))).to_numpy().tobytes())
        return ctx, xs

    _, cold = loop(False)
    ctx, cached = loop(True)
    assert ctx.sched_stats.plan_hits > 0
    assert cold == cached and len(set(cached)) == 1


# ---------------------------------------------------------------------------
# randomized SVD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,q", [(200, 3), (256, 4), (96, 1)])
def test_rsvd_exact_rank_matches_reference(backend, m, q):
    svals = [10.0, 5.0, 2.0, 1.0, 0.5]
    x_np = low_rank(m, 24, svals)
    ref, port = _pair(backend)
    outs = []
    for linalg, ctx in ((ref_linalg, ref), (port_linalg, port)):
        U, S, V = linalg.rsvd(ctx, ctx.from_numpy(x_np, grid=(q, 1)),
                              rank=len(svals), oversample=0, seed=1)
        outs.append((U.to_numpy(), S.to_numpy(), V.to_numpy(), _facts(ctx, U, S, V)))
    (Ur, Sr, Vr, fr), (Un, Sn, Vn, f) = outs
    r = len(svals)
    assert rel(Un @ np.diag(Sn) @ Vn.T - x_np, x_np) <= RTOL
    assert np.all(np.diff(Sn) <= 1e-6), "singular values must descend"
    assert rel(Un.T @ Un - np.eye(r), 1) <= RTOL
    assert rel(Vn.T @ Vn - np.eye(r), 1) <= RTOL
    assert np.abs(Sn - np.asarray(svals)).max() <= 10 * RTOL
    assert rel(Sn - Sr, Sr) <= 1e-12
    assert f == fr


@pytest.mark.parametrize("backend", BACKENDS)
def test_rsvd_oversampled_power_iterations_match_reference(backend):
    d, r = 30, 4
    rng = np.random.default_rng(4)
    svals = np.concatenate([[8.0, 4.0, 2.0, 1.0], 1e-3 * rng.random(d - r)])
    u = np.linalg.qr(rng.standard_normal((200, d)))[0]
    v = np.linalg.qr(rng.standard_normal((d, d)))[0]
    x_np = u @ np.diag(svals) @ v.T
    ref, port = _pair(backend)
    outs = []
    for linalg, ctx in ((ref_linalg, ref), (port_linalg, port)):
        _, S, _ = linalg.rsvd(ctx, ctx.from_numpy(x_np, grid=(4, 1)),
                              rank=r, oversample=4, power_iters=2, seed=5)
        outs.append((S.to_numpy(), _facts(ctx, S)))
    (Sr, fr), (S, f) = outs
    assert np.abs(S[:r] - svals[:r]).max() <= 1e-8
    assert rel(S - Sr, Sr) <= 1e-10
    assert f == fr


def test_rsvd_validation():
    sim = _ctx(P, "sim")
    with pytest.raises(ValueError, match="single column partition"):
        port_linalg.rsvd(sim, sim.random((64, 16), grid=(2, 2)), rank=4)
    with pytest.raises(ValueError, match="rank"):
        port_linalg.rsvd(sim, sim.random((64, 16), grid=(4, 1)), rank=0)


# ---------------------------------------------------------------------------
# communication: the comm ratios are facts of the schedule
# ---------------------------------------------------------------------------

def _tsqr(linalg, ctx):
    linalg.tsqr_indirect(ctx, ctx.random((4096, 64), grid=(16, 1)))


def _cholesky(linalg, ctx):
    linalg.cholesky(ctx, ctx.from_numpy(spd(256), grid=(4, 4)))


def _rsvd(linalg, ctx):
    linalg.rsvd(ctx, ctx.random((2048, 32), grid=(8, 1)), rank=8, oversample=8,
                power_iters=1)


@pytest.mark.parametrize("backend", ["sim", "cuda"])
@pytest.mark.parametrize("name,run,gate", [("tsqr", _tsqr, 1.5),
                                           ("cholesky", _cholesky, 2.0),
                                           ("rsvd", _rsvd, 2.5)])
def test_comm_ratio_matches_reference_and_sim(backend, name, run, gate):
    """The ratio of moved elements to the ``bounds`` floor equals the
    reference's (sim) on the port's sim and data backends, inside the
    reference's gate."""
    ref = _ctx(R, "sim")
    run(ref_linalg, ref)
    port = _ctx(P, backend)
    run(port_linalg, port)
    want = ref.loads()
    got = port.loads()
    for key in (f"comm_ratio_{name}", f"comm_moved_{name}", f"comm_lower_{name}"):
        assert got[key] == want[key], key
    assert 0 < got[f"comm_lower_{name}"] and got[f"comm_ratio_{name}"] <= gate


def test_comm_ratio_single_node_is_one():
    ctx = _ctx(P, "sim", k=1, r=2, ng=(1, 1))
    port_linalg.tsqr_indirect(ctx, ctx.random((512, 16), grid=(4, 1)))
    assert ctx.loads()["comm_ratio_tsqr"] == 1.0


# ---------------------------------------------------------------------------
# SUMMA and the recursive matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_summa_and_recursive_matmul_match_reference(backend):
    ref, port = _pair(backend, ng=(2, 2))
    outs = []
    for linalg, ctx in ((ref_linalg, ref), (port_linalg, port)):
        A = ctx.random((64, 64), grid=(4, 4))
        B = ctx.random((64, 64), grid=(4, 4))
        ctx.reset_loads()
        Z = linalg.summa_matmul(ctx, A, B)
        summa_net = ctx.state.network_elements()
        W = linalg.recursive_matmul(A, B)
        outs.append((A.to_numpy() @ B.to_numpy(), Z.to_numpy(), W.to_numpy(), summa_net,
                     _facts(ctx, Z, W)))
    (_, Zr, Wr, nr, fr), (AB, Z, W, n, f) = outs
    assert np.allclose(Z, AB) and np.allclose(W, AB)
    assert rel(Z - Zr, Zr) <= 1e-12 and rel(W - Wr, Wr) <= 1e-12
    assert n == nr > 0
    assert f == fr
