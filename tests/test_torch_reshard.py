"""The port's reshard, elastic and straggler modules against the reference.

The same graph and seed in both packages: a reshard (locality-aware or
naive), an elastic re-layout and a CP-ALS-style in-loop gather schedule
identically (placements, transfers, moved elements, both simulated
makespans), and the blocks they move are bitwise the reference's, on the
port's ``numpy``, ``torch`` and ``cuda`` backends (``cuda`` on CPU tensors,
where its matmul runs its plain version).  The straggler simulation reads
the same task profile off either package's lineage and gives the same
makespans.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as R
import repro.core.elastic as ref_elastic
import repro.core.straggler as ref_straggler
import repro_torch.core as P
import repro_torch.core.elastic as port_elastic
import repro_torch.core.straggler as port_straggler

BACKENDS = ["numpy", "torch", "cuda"]


def _ref_ctx(backend="numpy", k=4, r=2, ng=(4, 1), **kw):
    if backend != "sim":
        kw.setdefault("dtype", "float64")
    return R.ArrayContext(cluster=R.ClusterSpec(k, r), node_grid=ng,
                          backend=backend, seed=0, **kw)


def _port_ctx(backend="numpy", k=4, r=2, ng=(4, 1), **kw):
    if backend != "sim":
        kw.setdefault("dtype", "float64")
    return P.ArrayContext(cluster=P.ClusterSpec(k, r), node_grid=ng,
                          backend=backend, seed=0, device="cpu", **kw)


def _signature(ctx, out):
    return {
        "S": ctx.state.S.tolist(),
        "transfers": [(t.src, t.dst, t.elements) for t in ctx.state.transfers],
        "placements": list(out.placements().values()),
        "n_rfc": ctx.executor.stats.n_rfc,
        "makespans": (ctx.state.makespan(pipeline=False),
                      ctx.state.makespan(pipeline=True)),
        "reshard": (ctx.sched_stats.reshards, ctx.sched_stats.reshard_ops,
                    ctx.sched_stats.reshard_moved_elements),
    }


def _both(backend, fn, **kw):
    """``fn(pkg, ctx)`` in the reference (numpy, or sim for sim) and in the
    port on ``backend``: ((ref_ctx, ref_out), (port_ctx, port_out))."""
    ref = _ref_ctx("sim" if backend == "sim" else "numpy", **kw)
    port = _port_ctx(backend, **kw)
    return (ref, fn(R, ref)), (port, fn(P, port))


# ---------------------------------------------------------------------------
# reshard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape,src,dst", [
    ((64, 48), (4, 1), (2, 2)),
    ((64, 48), (2, 3), (4, 1)),
    ((60,), (4,), (3,)),           # uneven 1-D split
    ((33, 17), (4, 2), (2, 3)),    # uneven blocks on both axes
    ((32, 24, 16), (4, 1, 1), (1, 4, 1)),
    ((32, 24, 16), (4, 1, 1), (2, 2, 2)),
])
def test_reshard_roundtrip_matches_reference(backend, shape, src, dst):
    ng = (4,) + (1,) * (len(shape) - 1)

    def run(pkg, ctx):
        X = ctx.random(shape, grid=src)
        ctx.reset_loads()
        Y = X.reshard(grid=dst)
        return X, Y, Y.reshard(grid=src)

    (ref, (Xr, Yr, Zr)), (port, (X, Y, Z)) = _both(backend, run, ng=ng)
    assert Y.grid.grid == dst
    assert Y.to_numpy().tobytes() == Yr.to_numpy().tobytes()
    assert Z.to_numpy().tobytes() == X.to_numpy().tobytes() == Xr.to_numpy().tobytes()
    assert _signature(port, Z) == _signature(ref, Zr)
    assert port.sched_stats.reshard_moved_elements == port.state.summary()["total_net"]


@pytest.mark.parametrize("backend", ["sim"] + BACKENDS)
@pytest.mark.parametrize("method", ["reshard", "naive"])
def test_reshard_methods_schedule_like_reference(backend, method):
    """Locality-aware and naive reshards move the reference's element counts
    on every backend, sim included (scheduling never reads values)."""
    def run(pkg, ctx):
        X = ctx.random((32, 24, 16), grid=(4, 1, 1))
        ctx.reset_loads()
        move = X.reshard if method == "reshard" else (
            lambda **kw: pkg.reshard_naive(X, **kw))
        return move(grid=(1, 4, 1))

    (ref, Yr), (port, Y) = _both(backend, run, ng=(4, 1, 1))
    assert _signature(port, Y) == _signature(ref, Yr)
    if backend != "sim":
        assert Y.to_numpy().tobytes() == Yr.to_numpy().tobytes()


def test_reshard_moves_less_than_naive():
    moved = {}
    for method in ("reshard", "naive"):
        port = _port_ctx("cuda", ng=(4, 1, 1))
        X = port.random((32, 24, 16), grid=(4, 1, 1))
        port.reset_loads()
        (X.reshard if method == "reshard" else
         lambda **kw: P.reshard_naive(X, **kw))(grid=(1, 4, 1)).to_numpy()
        moved[method] = port.sched_stats.reshard_moved_elements
    assert 0 < moved["reshard"] < moved["naive"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_noop_and_node_grid_only_reshard(backend):
    port = _port_ctx(backend)
    X = port.random((64, 8), grid=(4, 1))
    port.reset_loads()
    rfc0 = port.executor.stats.n_rfc
    Y = X.reshard()  # the tuner keeps the status-quo layout: nothing moves
    assert port.executor.stats.n_rfc == rfc0
    assert all(Y.block(i) is X.block(i) for i in X.grid.iter_indices())
    Z = port.random((64, 64), grid=(2, 2)).reshard(node_grid=(2, 2))
    assert {Z.block(i).placement[0] for i in Z.grid.iter_indices()} == {0, 1, 2, 3}


@pytest.mark.parametrize("pipeline", [False, True])
def test_reshard_loop_plan_cache_like_reference(pipeline):
    """A structurally repeating reshard loop replays its plans as the
    reference's does, and plan cache on and off give the same bits."""
    def run(pkg, ctx):
        X = ctx.random((48, 32), grid=(4, 1))
        acc = None
        for _ in range(3):
            Y = X.reshard(grid=(2, 2)).reshard(grid=(4, 1))
            acc = Y if acc is None else (acc + Y).compute()
        return acc

    (ref, ar), (port, a) = _both("torch", run, plan_cache=True, pipeline=pipeline)
    off = run(P, _port_ctx("torch", pipeline=pipeline))
    assert port.sched_stats.plan_hits == ref.sched_stats.plan_hits > 0
    assert a.to_numpy().tobytes() == off.to_numpy().tobytes() == ar.to_numpy().tobytes()


# ---------------------------------------------------------------------------
# elastic re-layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k_old,k_new", [(2, 4), (4, 2)])
def test_elastic_relayout_matches_reference(backend, k_old, k_new):
    outs = []
    for pkg, elastic, ctx in ((R, ref_elastic, _ref_ctx("numpy", k=k_old, ng=(k_old, 1))),
                              (P, port_elastic, _port_ctx(backend, k=k_old, ng=(k_old, 1)))):
        X = ctx.random((64, 16), grid=(8, 1))
        w = (X.T @ X).compute()
        new_ctx, (X2, w2), moved = elastic.elastic_relayout(
            ctx, [X, w], pkg.ClusterSpec(k_new, 2))
        v = (X2.T @ X2).compute()  # the new context keeps computing
        outs.append((new_ctx, X2, moved, v))
    (ref, Xr, mr, vr), (port, X, m, v) = outs
    assert m == mr > 0
    assert X.placements() == Xr.placements()
    assert X.to_numpy().tobytes() == Xr.to_numpy().tobytes()
    assert _signature(port, v) == _signature(ref, vr)
    np.testing.assert_allclose(v.to_numpy(), vr.to_numpy(), rtol=1e-12)
    if backend != "numpy":
        assert port.device == "cpu" and port.dtype == "float64"


# ---------------------------------------------------------------------------
# straggler simulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_sim_times", [False, True])
@pytest.mark.parametrize("mode", ["duplicate", "migrate"])
def test_straggler_makespans_match_reference(use_sim_times, mode):
    def run(pkg, ctx):
        X = ctx.random((256, 16), grid=(16, 1))
        return (X.T @ X).compute()

    (ref, _), (port, _) = _both("cuda", run, pipeline=True)
    prof_r = ref_straggler.context_task_profile(ref, use_sim_times=use_sim_times)
    prof = port_straggler.context_task_profile(port, use_sim_times=use_sim_times)
    assert prof == prof_r
    for spec in (False, True):
        kw = dict(k=4, slow_nodes={3: 10.0}, speculative=spec, mode=mode)
        got = port_straggler.simulate_makespan(*prof, **kw)
        want = ref_straggler.simulate_makespan(*prof_r, **kw)
        assert (got.makespan, got.duplicated) == (want.makespan, want.duplicated)
        assert got.per_node_busy.tolist() == want.per_node_busy.tolist()
    slow = port_straggler.simulate_makespan(*prof, k=4, slow_nodes={3: 10.0})
    hedged = port_straggler.simulate_makespan(*prof, k=4, slow_nodes={3: 10.0},
                                              speculative=True, mode=mode)
    assert hedged.makespan < slow.makespan and hedged.duplicated > 0
    with pytest.raises(ValueError, match="speculation mode"):
        port_straggler.simulate_makespan(*prof, k=4, speculative=True, mode="x")
