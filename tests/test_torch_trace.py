"""The port's flight recorder (``repro_torch.core.trace``) against the
reference's.

``tests/test_obs.py`` is the spec: a traced run records one event per
runtime boundary, and the recorder observes without mutating, so traced
runs give the same bits and exactly the same simulated clocks as untraced
ones.  Here each case also runs the reference (numpy) on the same graph
and seed and holds the port's event sequence (kind, op, node, worker,
simulated start and end; wall fields excluded) equal to it on the numpy,
torch and cuda backends (``device="cpu"``, f64).
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.launch.workloads import logreg_newton_loop as r_newton_loop
from repro_torch.launch.workloads import logreg_newton_loop as p_newton_loop

BACKENDS = ["numpy", "torch", "cuda"]


def make_ctx(pkg, backend="numpy", k=4, r=2, seed=0, **kw):
    kw.setdefault("pipeline", True)
    kw.setdefault("dtype", "float64")
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.ArrayContext(cluster=pkg.ClusterSpec(k, r), node_grid=(k, 1),
                            backend=backend, seed=seed, **kw)


def small_workload(ctx, n=128, d=16, q=8):
    loop = p_newton_loop if isinstance(ctx, P.ArrayContext) else r_newton_loop
    _g, _H, beta = loop(ctx, n, d, q, iters=2, reset_loads=False)
    ctx.flush()
    return beta.to_numpy()


def events(recorder):
    """The comparable event sequence: kind, name, node, worker and the
    simulated interval, plus an op event's start-time breakdown.  Vertex
    ids come from a process-global counter, so names like ``obj<vid>`` are
    renumbered by first occurrence."""
    ids = {}
    out = []
    for e in recorder.iter_events():
        row = (e.kind, ids.setdefault(e.name, len(ids)), e.node, e.worker, e.t0, e.t1)
        if e.kind == "op":
            a = e.args
            row += (a["track"], a["w_busy"], a["t_ready"], a["t_xfer"], a["work"],
                    len(a["ins"]), len(a["xfers"]))
        out.append(row)
    return out


def assert_values_match(port, ref, backend):
    """Bitwise on numpy; torch sums in another order (the reference's own
    f64 tolerance, relative to the largest value)."""
    if backend == "numpy":
        assert port.tobytes() == ref.tobytes()
    else:
        assert np.abs(port - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("kw", [{}, {"gc": True, "mem_capacity": 5e4}],
                         ids=["plain", "gc+budget"])
def test_event_sequence_equals_reference(backend, pipeline, kw):
    ref = make_ctx(R, pipeline=pipeline, trace=True, **kw)
    b_ref = small_workload(ref)
    ctx = make_ctx(P, backend, pipeline=pipeline, trace=True, **kw)
    b = small_workload(ctx)
    got, want = events(ctx.tracer), events(ref.tracer)
    assert len(got) == len(want)
    assert got == want
    for e, r in zip(ctx.tracer.of("gc_free", "retire"), ref.tracer.of("gc_free", "retire")):
        assert (e.kind, e.args.keys()) == (r.kind, r.args.keys())
    assert_values_match(b, b_ref, backend)
    assert dict(ctx.tracer.counts()) == dict(ref.tracer.counts())


@pytest.mark.parametrize("backend", BACKENDS)
def test_event_counts_match_dispatch_counters(backend):
    ctx = make_ctx(P, backend, trace=True)
    small_workload(ctx)
    c = dict(ctx.tracer.counts())
    s = ctx.executor.stats
    assert c["create"] == s.n_creates
    assert c["dispatch"] == s.n_rfc - s.n_creates
    assert c["retire"] == c["dispatch"]
    assert c["sched"] == c["dispatch"]
    # every dispatched op is placed on both simulated clock tracks
    assert c["op"] == 2 * c["dispatch"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_lane_timestamps_monotonic(backend):
    ctx = make_ctx(P, backend, trace=True)
    small_workload(ctx)
    lanes = {}
    for ev in ctx.tracer.of("op"):
        key = (ev.args["track"], ev.node, ev.worker)
        assert ev.t1 >= ev.t0
        assert ev.t0 >= lanes.get(key, 0.0) - 1e-12
        lanes[key] = ev.t0
    assert lanes


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kw", [{}, {"gc": True, "mem_capacity": 5e4},
                                {"plan_cache": True}],
                         ids=["plain", "gc+budget", "plan-cache"])
def test_tracing_changes_no_bits_and_no_clocks(backend, kw):
    ref = make_ctx(P, backend, **kw)
    b_ref = small_workload(ref)
    l_ref = ref.loads()
    ctx = make_ctx(P, backend, trace=True, **kw)
    b = small_workload(ctx)
    loads = ctx.loads()
    assert b.tobytes() == b_ref.tobytes()
    assert loads["makespan_sync"] == l_ref["makespan_sync"]
    assert loads["makespan_pipelined"] == l_ref["makespan_pipelined"]
    assert list(loads.keys()) == list(l_ref.keys())
    assert np.array_equal(ctx.state.S, ref.state.S)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_trace_equals_reference_and_is_deterministic(backend):
    plan = dict(stragglers={1: 3.0}, transient_fault_prob=0.1, link_degradation=1.5)

    def traced_run(pkg, be):
        ctx = make_ctx(pkg, be, k=4)
        ctx._install_tracer(pkg.FlightRecorder())
        ctx.enable_chaos(pkg.ChaosPlan(**plan), seed=11)
        small_workload(ctx)
        return events(ctx.tracer), ctx.chaos_engine.stats.as_dict()

    first = traced_run(P, backend)
    assert first == traced_run(P, backend)
    assert first == traced_run(R, "numpy")


def test_ring_buffer_bounds_and_drop_count():
    rec = P.FlightRecorder(capacity=16)
    for i in range(100):
        rec.record("op", f"e{i}")
    assert len(rec) == 16
    assert rec.dropped == 84
    assert next(iter(rec.iter_events())).name == "e84"
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0
    with pytest.raises(ValueError):
        P.FlightRecorder(capacity=0)


def test_reset_loads_clears_trace():
    ctx = make_ctx(P, "torch", trace=True)
    small_workload(ctx)
    assert len(ctx.tracer) > 0
    ctx.reset_loads()
    assert len(ctx.tracer) == 0


def test_export_requires_tracing():
    with pytest.raises(RuntimeError, match="tracing is off"):
        make_ctx(P, "cuda").export_trace()


@pytest.mark.parametrize("backend", BACKENDS)
def test_disabled_recorder_costs_nothing_structurally(backend):
    ctx = make_ctx(P, backend)
    assert ctx.tracer is None
    assert ctx.executor.tracer is None
    assert ctx.state.tracer is None
    assert ctx.state.clocks_sync.recorder is None
    assert ctx.state.clocks_pipe.recorder is None


def test_recorder_instance_and_capacity():
    rec = P.FlightRecorder(capacity=1 << 12)
    ctx = make_ctx(P, "cuda", trace=rec)
    assert ctx.tracer is rec and ctx.executor.tracer is rec and ctx.state.tracer is rec
    small_workload(ctx)
    assert len(rec) > 0
    assert make_ctx(P, "torch", trace=256).tracer.capacity == 256


@pytest.mark.parametrize("backend", BACKENDS)
def test_retire_events_carry_host_wall(backend):
    """Every executed op's ``retire`` event carries its host wall seconds
    and the clock model's work measure, which the calibration fit reads;
    ``profile_sync`` makes the backend wait for each op inside the window."""
    ctx = make_ctx(P, backend, trace=True)
    ctx.executor.profile_sync = True
    small_workload(ctx)
    retired = ctx.tracer.of("retire")
    assert retired
    assert all(e.args["wall_s"] > 0.0 and e.args["work"] > 0 for e in retired)


def test_numpy_seed_unaffected_by_tracing():
    np.random.seed(1234)
    small_workload(make_ctx(P, "torch"))
    state_ref = np.random.get_state()[1].sum()
    np.random.seed(1234)
    small_workload(make_ctx(P, "torch", trace=True))
    assert np.random.get_state()[1].sum() == state_ref
