"""The port's CP-ALS and tensor algebra against the reference.

Full CP-ALS (three mode updates a sweep, matricization through reshard) on
the port's ``numpy``, ``torch`` and ``cuda`` backends (``cuda`` on CPU
tensors: every 2-D block product through the matmul wrapper's plain
version) agrees with the pure-numpy mirror ``cp_als_reference`` to 1e-8 and
with the reference package's ``cp_als`` to 1e-10, and schedules as the
reference does: the same placements, reshards, moved elements, plan-cache
hits and simulated makespans, sim included.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as R
import repro.factor as ref_factor
import repro.launch.blocks as ref_blocks
import repro.launch.workloads as ref_workloads
import repro.tensor as ref_tensor
import repro_torch.core as P
import repro_torch.factor as port_factor
import repro_torch.launch.blocks as port_blocks
import repro_torch.launch.workloads as port_workloads
import repro_torch.tensor as port_tensor
from repro_torch.kernels import launches, reset_launches

BACKENDS = ["numpy", "torch", "cuda"]


def _ctx(pkg, backend, k=4, r=2, **kw):
    if backend != "sim":
        kw.setdefault("dtype", "float64")
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.ArrayContext(cluster=pkg.ClusterSpec(k, r), node_grid=(k, 1, 1),
                            backend=backend, seed=0, **kw)


def _schedule(ctx, factors):
    st = ctx.sched_stats
    return {"S": ctx.state.S.tolist(),
            "transfers": [(t.src, t.dst, t.elements) for t in ctx.state.transfers],
            "placements": [list(f.placements().values()) for f in factors],
            "makespans": (ctx.state.makespan(pipeline=False),
                          ctx.state.makespan(pipeline=True)),
            "reshards": (st.reshards, st.reshard_ops, st.reshard_moved_elements),
            "plans": (st.plan_hits, st.plan_misses)}


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_khatri_rao_and_matricize_match_reference(backend):
    rng = np.random.default_rng(3)
    Bn, Cn = rng.standard_normal((6, 4)), rng.standard_normal((5, 4))
    got = {}
    for pkg, factor in ((R, ref_factor), (P, port_factor)):
        ctx = _ctx(pkg, "numpy" if pkg is R else backend)
        kr = factor.khatri_rao(ctx.from_numpy(Bn, grid=(1, 1)),
                               ctx.from_numpy(Cn, grid=(1, 1))).to_numpy()
        X = ctx.random((16, 12, 8), grid=(4, 1, 1))
        mats = [factor.matricize(X if m == 0 else X.reshard(
            grid=tuple(4 if a == m else 1 for a in range(3))), m).to_numpy()
            for m in range(3)]
        got[pkg] = (kr, mats, X.to_numpy())
        with pytest.raises(ValueError):
            factor.khatri_rao(ctx.random((8, 4), grid=(4, 1)),
                              ctx.random((6, 4), grid=(1, 1)))
        with pytest.raises(ValueError, match="reshard first"):
            factor.matricize(X, 1)
    (kr_r, mats_r, _), (kr, mats, X) = got[R], got[P]
    assert kr.tobytes() == kr_r.tobytes()
    assert np.array_equal(kr, np.einsum("jf,kf->jkf", Bn, Cn).reshape(30, 4))
    for m, (a, b) in enumerate(zip(mats, mats_r)):
        assert a.tobytes() == b.tobytes()
        assert np.array_equal(a, np.moveaxis(X, m, 0).reshape(X.shape[m], -1))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mttkrp_mode_matches_reference(backend, mode):
    """The reduce-based any-mode MTTKRP agrees with the reference's and with
    the matricization + Khatri-Rao formulation."""
    f_np = [np.random.default_rng(9).standard_normal((d, 3)) for d in (16, 12, 8)]
    out = {}
    for pkg, tensor in ((R, ref_tensor), (P, port_tensor)):
        ctx = _ctx(pkg, "numpy" if pkg is R else backend)
        X = ctx.random((16, 12, 8), grid=(4, 1, 1))
        factors = [ctx.from_numpy(f, grid=(1, 1)) for f in f_np]
        out[pkg] = (tensor.mttkrp_mode(X, factors, mode).to_numpy(), X.to_numpy(),
                    ctx.state.network_elements())
    (got, X, net), (want, _, net_r) = out[P], out[R]
    rest = [m for m in range(3) if m != mode]
    kr = np.einsum("jf,kf->jkf", f_np[rest[0]], f_np[rest[1]]).reshape(-1, 3)
    assert np.allclose(got, np.moveaxis(X, mode, 0).reshape(X.shape[mode], -1) @ kr,
                       atol=1e-10)
    assert _rel(got, want) < 1e-12
    assert net == net_r


@pytest.mark.parametrize("backend", BACKENDS)
def test_mttkrp_and_double_contraction_match_reference(backend):
    out = {}
    for pkg, tensor in ((R, ref_tensor), (P, port_tensor)):
        ctx = _ctx(pkg, "numpy" if pkg is R else backend)
        X = ctx.random((32, 24, 16), grid=(4, 2, 1))
        B, C = ctx.random((24, 5), grid=(2, 1)), ctx.random((16, 5), grid=(1, 1))
        m = tensor.mttkrp(X, B, C)
        ctx2 = pkg.ArrayContext(cluster=pkg.ClusterSpec(4, 2), node_grid=(1, 4, 1),
                                seed=0, **({"backend": backend, "dtype": "float64",
                                            "device": "cpu"} if pkg is P else {}))
        Y = ctx2.random((12, 16, 10), grid=(1, 4, 1))
        Z = ctx2.random((16, 10, 7), grid=(4, 1, 1))
        dc = tensor.double_contraction(Y, Z)
        out[pkg] = (m.to_numpy(), dc.to_numpy(), list(m.placements().values()),
                    list(dc.placements().values()),
                    np.einsum("ijk,jf,kf->if", X.to_numpy(), B.to_numpy(), C.to_numpy()),
                    np.tensordot(Y.to_numpy(), Z.to_numpy(), axes=2))
    (m, dc, pm, pdc, m_np, dc_np), (m_r, dc_r, pm_r, pdc_r, _, _) = out[P], out[R]
    assert np.allclose(m, m_np) and np.allclose(dc, dc_np)
    assert _rel(m, m_r) < 1e-12 and _rel(dc, dc_r) < 1e-12
    assert (pm, pdc) == (pm_r, pdc_r)


# ---------------------------------------------------------------------------
# CP-ALS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method,pipeline", [("reshard", True), ("naive", False)])
def test_cp_als_matches_both_references(backend, method, pipeline):
    """Three sweeps of full CP-ALS on a (4, 1, 1)-partitioned tensor: port
    against ``cp_als_reference`` to 1e-8 and against the reference package
    to 1e-10, with the reference's schedule."""
    Xn = np.random.default_rng(7).standard_normal((16, 12, 8))
    runs = {}
    for pkg, factor in ((R, ref_factor), (P, port_factor)):
        ctx = _ctx(pkg, "numpy" if pkg is R else backend, plan_cache=True,
                   pipeline=pipeline)
        X = ctx.from_numpy(Xn, grid=(4, 1, 1))
        res = factor.cp_als(X, rank=3, iters=3, method=method, seed=1)
        runs[pkg] = (ctx, res, [f.to_numpy() for f in res.factors])
    mirror = port_factor.cp_als_reference(Xn, rank=3, iters=3, seed=1)
    for a, b in zip(mirror, ref_factor.cp_als_reference(Xn, rank=3, iters=3, seed=1)):
        assert a.tobytes() == b.tobytes()
    (ctx, res, fs), (ctx_r, res_r, fs_r) = runs[P], runs[R]
    assert res.iterations == 3 and res.reshards == res_r.reshards
    assert res.moved_elements == res_r.moved_elements > 0
    for f, f_r, m in zip(fs, fs_r, mirror):
        assert np.allclose(f, m, atol=1e-8, rtol=1e-8)
        assert _rel(f, f_r) < 1e-10
    assert _schedule(ctx, res.factors) == _schedule(ctx_r, res_r.factors)
    if backend == "numpy":
        np.testing.assert_allclose(res.fit_history, res_r.fit_history, rtol=1e-10)
    else:
        assert res.fit_history == []  # cp_fit gathers the tensor: numpy only


def test_cp_als_fit_improves():
    """On a genuinely low-rank tensor, ALS sweeps increase the fit."""
    rng = np.random.default_rng(2)
    A0, B0, C0 = (rng.standard_normal((d, 2)) for d in (16, 12, 8))
    ctx = _ctx(P, "numpy")
    res = port_factor.cp_als(
        ctx.from_numpy(np.einsum("if,jf,kf->ijk", A0, B0, C0), grid=(4, 1, 1)),
        rank=2, iters=8, seed=0)
    assert res.fit_history[-1] > 0.99
    assert res.fit_history[-1] >= res.fit_history[0]
    with pytest.raises(ValueError, match="3-way"):
        port_factor.cp_als(ctx.random((8, 8), grid=(4, 1)), rank=2)
    with pytest.raises(ValueError, match="method"):
        port_factor.cp_als(ctx.random((8, 8, 8), grid=(4, 1, 1)), rank=2, method="x")


@pytest.mark.parametrize("method", ["reshard", "naive"])
def test_cpals_loop_on_sim_schedules_like_reference(method):
    """The driver's workload (``cpals_loop``) on the metadata-only backend:
    moved elements, plan-cache hit rate and makespans equal the reference's,
    and the locality-aware reshard moves fewer elements than the naive one."""
    out = {}
    for pkg, workloads in ((R, ref_workloads), (P, port_workloads)):
        ctx = _ctx(pkg, "sim", plan_cache=True)
        A = workloads.cpals_loop(ctx, 24, rank=4, q=4, iters=3, method=method)
        out[pkg] = (_schedule(ctx, [A]), ctx.sched_stats.hit_rate(), A.shape)
    assert out[P] == out[R]
    assert out[P][1] >= 0.5
    moved = {m: _cpals_moved(m) for m in ("reshard", "naive")}
    assert 0 < moved["reshard"] < moved["naive"]


def _cpals_moved(method):
    ctx = _ctx(P, "sim")
    port_workloads.cpals_loop(ctx, 24, rank=4, q=4, iters=2, method=method)
    return ctx.sched_stats.reshard_moved_elements


def test_cpals_workload_launches_no_kernel_on_cpu():
    reset_launches()
    ctx = _ctx(P, "cuda")
    A = port_blocks.build_workload(ctx, "cpals", scale=0, iters=2)
    ref = ref_blocks.build_workload(_ctx(R, "numpy"), "cpals", scale=0, iters=2)
    assert A.shape == ref.shape == (16, 8)
    assert _rel(A.to_numpy(), ref.to_numpy()) < 1e-10
    assert launches["matmul"] == 0
