"""The port's chaos runtime (``repro_torch.core.chaos``) against the
reference's.

``tests/test_chaos.py`` is the spec: seeded live fault injection never
changes output bits, is deterministic given (seed, ChaosPlan), and
exercises retry/backoff, speculation, node death + lineage replay and
elastic rebinding.  The port keeps the reference's numpy generator for the
fault draws, so each case also runs the reference (numpy) on the same
graph, seed and plan and holds the port's trajectory to it on the numpy,
torch and cuda backends (``device="cpu"``, f64): the same retry counts,
speculation decisions, replays, dead nodes and chaos makespan; values
bitwise on numpy, within the reference's f64 tolerance elsewhere.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core.elastic import elastic_relayout as r_relayout
from repro.launch.chaos import run_chaos_scenario as r_scenario
from repro_torch.core.elastic import elastic_relayout as p_relayout
from repro_torch.launch.chaos import run_chaos_scenario as p_scenario

BACKENDS = ["numpy", "torch", "cuda"]


def make_ctx(pkg, backend="numpy", k=4, r=2, seed=0, **kw):
    kw.setdefault("pipeline", True)
    kw.setdefault("dtype", "float64")
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.ArrayContext(cluster=pkg.ClusterSpec(k, r), node_grid=(k, 1),
                            backend=backend, seed=seed, **kw)


def newton_like(ctx, n=128, d=16, q=8):
    X = ctx.random((n, d), grid=(q, 1))
    y = ctx.uniform((n, 1), grid=(q, 1))
    beta = ctx.zeros((d, 1), grid=(1, 1))
    mu = (X @ beta).sigmoid().compute()
    g = (X.T @ (mu - y)).compute()
    H = (X.T @ (mu * (1.0 - mu) * X).compute()).compute()
    return g.to_numpy(), H.to_numpy()


def close(port, ref, backend):
    if backend == "numpy":
        return port.tobytes() == ref.tobytes()
    return np.abs(port - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1e-300)


def chaos_run(pkg, backend, plan, seed=0, retry=None, **ctx_kw):
    ctx = make_ctx(pkg, backend, **ctx_kw)
    eng = ctx.enable_chaos(pkg.ChaosPlan(**plan), seed=seed,
                           retry=None if retry is None else pkg.RetryPolicy(**retry))
    g, H = newton_like(ctx)
    return g, H, eng


PLANS = {
    "stragglers+faults": (dict(stragglers={1: 4.0, 2: 8.0}, transient_fault_prob=0.2,
                               link_degradation=2.0), 7, None),
    "node death at t=0": (dict(node_failures={1: 0.0}), 0, None),
    "death+straggler+faults": (dict(node_failures={3: 1e-8}, stragglers={1: 4.0},
                                    transient_fault_prob=0.15), 3, None),
    "escalation": (dict(transient_fault_prob=0.9), 0, dict(max_retries=2)),
    "speculation": (dict(stragglers={1: 16.0}, speculation=True), 0, None),
    "no speculation": (dict(stragglers={0: 8.0, 1: 8.0}, speculation=False), 0, None),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(PLANS))
def test_trajectory_equals_reference(backend, name):
    """Same graph, seed and plan: the port's chaos stats (fault draws,
    retries, escalations, speculation, deaths, losses, replays, re-routes),
    dead set and chaos makespan equal the reference's, and its values
    equal the fault-free run's bits and the reference's values."""
    plan, seed, retry = PLANS[name]
    g_r, H_r, e_r = chaos_run(R, "numpy", plan, seed, retry)
    g, H, eng = chaos_run(P, backend, plan, seed, retry)
    assert eng.stats.as_dict() == e_r.stats.as_dict()
    assert eng.dead == e_r.dead
    assert eng.makespan() == e_r.makespan()
    assert close(g, g_r, backend) and close(H, H_r, backend)
    g0, H0 = newton_like(make_ctx(P, backend))
    assert g.tobytes() == g0.tobytes() and H.tobytes() == H0.tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
def test_node_death_mid_drain_replays_bit_identical(backend):
    g0, H0 = newton_like(make_ctx(P, backend))
    g, H, eng = chaos_run(P, backend, dict(node_failures={1: 0.0}))
    assert g.tobytes() == g0.tobytes() and H.tobytes() == H0.tobytes()
    assert eng.dead == {1}
    assert eng.stats.nodes_failed == 1
    assert eng.stats.blocks_replayed > 0
    assert eng.stats.rerouted_ops > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_nominal_schedule_untouched_by_chaos(backend):
    ref = make_ctx(P, backend)
    newton_like(ref)
    ctx = make_ctx(P, backend)
    ctx.enable_chaos(P.ChaosPlan(stragglers={0: 16.0}, transient_fault_prob=0.3))
    newton_like(ctx)
    assert ctx.state.makespan(pipeline=True) == ref.state.makespan(pipeline=True)
    assert np.array_equal(ctx.state.S, ref.state.S)


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_seed_same_plan_same_everything(backend):
    plan = dict(node_failures={3: 1e-8}, stragglers={1: 4.0}, transient_fault_prob=0.15)
    runs = [chaos_run(P, backend, plan, seed=3) for _ in range(2)]
    (g1, H1, e1), (g2, H2, e2) = runs
    assert g1.tobytes() + H1.tobytes() == g2.tobytes() + H2.tobytes()
    assert e1.stats == e2.stats
    assert e1.makespan() == e2.makespan()


def test_different_seed_different_fault_draws():
    plan = dict(transient_fault_prob=0.3)
    _g, _H, e1 = chaos_run(P, "cuda", plan, seed=1)
    _g, _H, e2 = chaos_run(P, "cuda", plan, seed=2)
    assert e1.stats.transient_faults != e2.stats.transient_faults


@pytest.mark.parametrize("backend", BACKENDS)
def test_sync_dispatch_transient_faults_equal_reference(backend):
    plan = dict(transient_fault_prob=0.3, stragglers={0: 2.0})
    g_r, H_r, e_r = chaos_run(R, "numpy", plan, pipeline=False)
    g, H, eng = chaos_run(P, backend, plan, pipeline=False)
    g0, H0 = newton_like(make_ctx(P, backend, pipeline=False))
    assert g.tobytes() == g0.tobytes() and H.tobytes() == H0.tobytes()
    assert eng.stats.transient_faults > 0
    assert eng.stats.as_dict() == e_r.stats.as_dict()
    assert close(H, H_r, backend)


def test_retry_backoff_schedule_and_plan_normalization():
    rp = P.RetryPolicy(max_retries=3, backoff_base=2.0, backoff_factor=3.0)
    assert rp.backoff(2) == 18.0
    assert rp.total_backoff(10) == rp.total_backoff(3) == 2.0 + 6.0 + 18.0
    p = P.ChaosPlan(node_failures={3: 1.0, 1: 0.5}, stragglers={2: 4.0},
                    correlated_failures=((0.25, (2, 0)),))
    r = R.ChaosPlan(node_failures={3: 1.0, 1: 0.5}, stragglers={2: 4.0},
                    correlated_failures=((0.25, (2, 0)),))
    assert (p.node_failures, p.stragglers, p.correlated_failures) == (
        r.node_failures, r.stragglers, r.correlated_failures)
    hash(p)
    for bad in (dict(stragglers={0: 0.5}), dict(link_degradation=0.9),
                dict(oom_events=((0, 1.0, 1.5),))):
        with pytest.raises(ValueError):
            P.ChaosPlan(**bad)


def test_attach_validations_name_the_port_backends():
    sim = P.ArrayContext(cluster=P.ClusterSpec(2, 2), node_grid=(2, 1), backend="sim")
    with pytest.raises(ValueError, match=r"data-holding backend \(numpy/torch/cuda\)"):
        sim.enable_chaos(P.ChaosPlan())
    with pytest.raises(ValueError, match="pipeline"):
        make_ctx(P, "cuda", k=2, pipeline=False).enable_chaos(
            P.ChaosPlan(node_failures={0: 1.0}))
    with pytest.raises(ValueError, match="outside"):
        make_ctx(P, "cuda", k=2).enable_chaos(P.ChaosPlan(stragglers={5: 2.0}))
    with pytest.raises(ValueError, match="MemoryManager"):
        make_ctx(P, "cuda", k=2).enable_chaos(P.ChaosPlan(oom_events=((0, 1.0, 0.5),)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_engine_rebinds_across_relayout(backend):
    """``elastic_relayout`` carries the engine to the new context, as the
    reference's does: clock history kept, the executor hook follows, and
    the chaos clocks after the resize equal the reference's."""
    out = {}
    for pkg, be, relayout in ((R, "numpy", r_relayout), (P, backend, p_relayout)):
        ctx = make_ctx(pkg, be, k=4)
        eng = ctx.enable_chaos(pkg.ChaosPlan(stragglers={1: 4.0},
                                             transient_fault_prob=0.2), seed=5)
        X = ctx.random((256, 16), grid=(8, 1))
        X.compute()
        ctx.flush()
        busy_before = eng.clocks.busy[:3].copy()
        new_ctx, (X2,), moved = relayout(ctx, [X], pkg.ClusterSpec(3, 2), (3, 1))
        assert new_ctx.chaos_engine is eng and new_ctx.executor.chaos is eng
        assert eng.clocks.k == 3
        assert np.all(eng.clocks.busy >= busy_before)
        Y = (X2 + X2).compute().to_numpy()
        out[pkg] = (moved, eng.makespan(), eng.stats.as_dict(), Y)
    (m_p, mk_p, st_p, y_p), (m_r, mk_r, st_r, y_r) = out[P], out[R]
    assert (m_p, mk_p, st_p) == (m_r, mk_r, st_r)
    assert close(y_p, y_r, backend)


SCENARIOS = {
    "resize+traffic": dict(nodes=4, workers=2, iters=2, d=16, fail_nodes=1, stragglers=1,
                           slowdown=4.0, fault_prob=0.05, resize_to=3, traffic=1),
    "correlated kill+oom": dict(nodes=4, workers=2, iters=2, d=16, fail_nodes=2,
                                correlated_kill=True, mem_budget=0.6, oom_at=0.5),
    "controller": dict(nodes=8, workers=2, iters=3, d=32, fail_nodes=1, stragglers=2,
                       slowdown=4.0, fault_prob=0.02, controller=True),
}
#: report entries that are host wall or configuration, not trajectory
_NOT_TRAJECTORY = {"backend", "device"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_driver_equals_reference(backend, name):
    """``run_chaos_scenario``: fault-free leg, chaos leg and determinism
    re-run.  Its report (makespans and ratio, every chaos and memory
    counter, dead nodes, controller actions, relayout moves, served
    requests) equals the reference's on the same arguments; values are
    identical to the fault-free leg and deterministic."""
    kw = SCENARIOS[name]
    ref = r_scenario(backend="numpy", **kw)
    got = p_scenario(backend=backend, device="cpu", **kw)
    assert got["identical"] and got["deterministic"]
    assert ref["identical"] and ref["deterministic"]
    for key, want in ref.items():
        if key in _NOT_TRAJECTORY or key == "checksum":
            continue
        assert got[key] == want, key
    assert got["device"] == "cpu"
    if name == "controller":
        assert got["controller_n_actions"] >= 1
    else:
        assert got["chaos_blocks_replayed"] > 0


def test_scenario_gate_cli(capsys, monkeypatch):
    """The CLI's ``--assert-gate`` (its default scenario: 8 nodes, 1 dead,
    2 stragglers at 4x, fault probability 0.02) holds bit identity,
    determinism and the 1.5x makespan limit on the card's backend."""
    from repro_torch.launch import chaos

    monkeypatch.setattr("sys.argv", ["chaos", "--device", "cpu", "--assert-gate"])
    chaos.main()
    out = capsys.readouterr().out
    assert '"identical": true' in out and '"deterministic": true' in out
