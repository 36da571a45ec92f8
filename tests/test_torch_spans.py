"""The port's spans on the profiler's timeline and its two always-on counters
(``core/trace.py``): which spans a pipelined Newton fit and a block matmul
open under ``torch.profiler``, how they nest, that none opens without a
profiler, that the profiler changes no bits, and ``execute_s`` /
``pycollect_s`` in ``loads()``."""
from __future__ import annotations

import gc
from time import perf_counter

import numpy as np
import pytest
import torch

import repro_torch.core.trace as T
from repro_torch.core import ArrayContext, ClusterSpec
from repro_torch.glm import LogisticRegression

PREFIX = "repro_torch."


def make_ctx(seed=0):
    return ArrayContext(cluster=ClusterSpec(4, 2), node_grid=(4, 1), backend="torch",
                        dtype="float64", pipeline=True, plan_cache=True, gc=True,
                        seed=seed, device="cpu")


def workload(ctx, fits=2, product=True):
    """Newton fits on 8 row blocks, then a block matmul; their answers."""
    rng = np.random.default_rng(3)
    X = ctx.from_numpy(rng.standard_normal((256, 8)), grid=(8, 1))
    y = ctx.from_numpy((rng.random((256, 1)) < 0.5).astype(float), grid=(8, 1))
    est = LogisticRegression(ctx, solver="newton", max_iter=5)
    betas = []
    for _ in range(fits):
        est.fit(X, y)
        betas.append(np.array(est.beta))
    if not product:
        return betas, None
    A = ctx.random((48, 48), grid=(2, 2))
    C = (A @ A.T).compute().to_numpy()
    return betas, C


def profiled(fn):
    """``fn()`` under a CPU profiler: its result and the program's spans as
    (name, start ns, end ns), in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith(PREFIX)), key=lambda sp: (sp[1], -sp[2]))
    return out, spans


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def traced():
    """One profiled run: context, answers, spans and the loads' change."""
    ctx = make_ctx()
    # plans recorded, so the profiled fits replay (and the product is cold)
    workload(ctx, fits=1, product=False)
    before = ctx.loads()

    def run():
        out = workload(ctx)
        gc.collect()
        return out

    out, spans = profiled(run)
    after = ctx.loads()
    return ctx, out, spans, {k: after[k] - before[k] for k in after
                            if isinstance(after[k], (int, float))}


def test_every_span_appears(traced):
    _ctx, _out, spans, _delta = traced
    names = {name for name, _s, _e in spans}
    for name in (T.SCHED_FINGERPRINT, T.SCHED_REPLAY, T.SCHED_LSHS, T.EXEC_DRAIN,
                 "repro_torch.backend.matmul", "repro_torch.backend.mul",
                 "repro_torch.backend.solve", "repro_torch.pycollect.gen2"):
        assert name in names, name


def test_spans_nest(traced):
    _ctx, _out, spans, _delta = traced
    drains = [sp for sp in spans if sp[0] == T.EXEC_DRAIN]
    ops = [sp for sp in spans if sp[0].startswith("repro_torch.backend.")]
    assert ops and all(any(_inside(op, d) for d in drains) for op in ops)
    sched = [sp for sp in spans if sp[0].startswith("repro_torch.sched.")]
    for i, a in enumerate(sched):
        assert not any(_inside(a, b) for j, b in enumerate(sched) if j != i), a
    # one span per op: no backend span opens inside another
    for i, a in enumerate(ops):
        assert not any(_inside(a, b) for j, b in enumerate(ops) if j != i), a


def test_one_backend_span_per_dispatch(traced):
    _ctx, _out, spans, delta = traced
    op_spans = [n for n, _s, _e in spans if n.startswith("repro_torch.backend.")]
    assert len(op_spans) == delta["backend_dispatches"] > 0


def test_no_span_without_profiler_and_same_bits(traced, monkeypatch):
    _ctx, (betas_on, c_on), _spans, _delta = traced
    opened = []
    real = T._range_type()

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(T, "_range_type", lambda: counting)  # every span's maker
    ctx = make_ctx()
    workload(ctx, fits=1, product=False)
    betas_off, c_off = workload(ctx)
    gc.collect()
    assert opened == []
    assert not ctx.executor.backend.spans
    assert all(a.tobytes() == b.tobytes() for a, b in zip(betas_on, betas_off))
    assert c_on.tobytes() == c_off.tobytes()


def test_execute_within_drain(traced):
    ctx, _out, _spans, delta = traced
    loads = ctx.loads()
    assert 0.0 < loads["execute_s"] <= loads["drain_s"]
    assert 0.0 < delta["execute_s"] <= delta["drain_s"]


def test_collector_counted_once():
    a, b = make_ctx(), make_ctx(seed=1)
    assert sum(cb is T.COLLECTOR for cb in gc.callbacks) == 1
    own = []

    def clock(phase, _info):
        own.append(perf_counter())

    gc.disable()  # only the two collections below
    gc.callbacks.insert(0, clock)
    try:
        a0, b0 = a.loads()["pycollect_s"], b.loads()["pycollect_s"]
        gc.collect()
        gc.collect()
        da, db = a.loads()["pycollect_s"] - a0, b.loads()["pycollect_s"] - b0
    finally:
        gc.callbacks.remove(clock)
        gc.enable()
    assert len(own) == 4
    seen = sum(t1 - t0 for t0, t1 in zip(own[::2], own[1::2]))
    assert da == db > 0.0
    assert 0.5 * seen < da < 1.5 * seen


def test_reset_loads_restarts_counters():
    ctx = make_ctx()
    workload(ctx, fits=1)
    gc.collect()
    loads = ctx.loads()
    assert loads["pycollect_s"] > 0.0 and loads["execute_s"] > 0.0
    gc.disable()
    try:
        ctx.reset_loads()
        loads = ctx.loads()
    finally:
        gc.enable()
    assert loads["pycollect_s"] == 0.0 and loads["execute_s"] == 0.0
