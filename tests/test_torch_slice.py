"""The port's main path against the reference, end to end, on the CPU.

The same seed and the same graph in both packages: the Newton loop and the
block DGEMM schedule identically (placements, loads, both simulated
makespans), the port's ``cuda`` backend matches the reference's ``pallas``
backend at f64 (1e-6 relative, the reference's own backend-parity
tolerance) with identical schedules, and the runtime's bitwise contracts
(pipelined == sync, plan-cache on == off, GC'd == un-GC'd) hold on the
port's backends.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro.glm as ref_glm
import repro.launch.workloads as ref_workloads
import repro_torch.core as P
import repro_torch.glm as port_glm
import repro_torch.launch.workloads as port_workloads
from repro_torch.core.context import PORT_LOADS
from repro_torch.interop import carry_arrays
from repro_torch.kernels import launches, reset_launches

RTOL = 1e-6
#: wall-clock keys of ``ctx.loads()``: the only ones allowed to differ (the
#: port's own ``PORT_LOADS`` are wall-clock seconds the reference has not)
WALL_KEYS = {"sched_overhead_s", "dispatch_s", "drain_s", *PORT_LOADS}


def _ref_ctx(backend="numpy", k=4, r=2, ng=(2, 2), **kw):
    kw.setdefault("dtype", None if backend == "sim" else "float64")
    return R.ArrayContext(cluster=R.ClusterSpec(k, r), node_grid=ng,
                          backend=backend, seed=0, **kw)


def _port_ctx(backend="cuda", k=4, r=2, ng=(2, 2), **kw):
    kw.setdefault("dtype", None if backend == "sim" else "float64")
    return P.ArrayContext(cluster=P.ClusterSpec(k, r), node_grid=ng,
                          backend=backend, seed=0, device="cpu", **kw)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _signature(ctx, out):
    return {
        "S": ctx.state.S.tolist(),
        # vertex ids are process-global, so compare transfer *structure*
        "transfers": [(t.src, t.dst, t.elements) for t in ctx.state.transfers],
        "placements": list(out.placements().values()),
        "n_rfc": ctx.executor.stats.n_rfc,
        "makespans": (ctx.state.makespan(pipeline=False),
                      ctx.state.makespan(pipeline=True)),
    }


def _loads(ctx):
    return {k: v for k, v in ctx.loads().items() if k not in WALL_KEYS}


@pytest.fixture
def jax_x64():
    """The reference's f64 pallas backend turns on jax's process-global x64
    mode; restore it so later tests in this process see the default."""
    import jax

    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


# ---------------------------------------------------------------------------
# schedule identity (sim mode: scheduling only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline,plan_cache", [(True, True), (False, False)])
def test_sim_logreg_schedules_identically(pipeline, plan_cache):
    kw = dict(pipeline=pipeline, plan_cache=plan_cache)
    ref, port = _ref_ctx("sim", **kw), _port_ctx("sim", **kw)
    outs = [w.logreg_newton_loop(c, 1 << 12, 16, 16, iters=3)
            for w, c in ((ref_workloads, ref), (port_workloads, port))]
    for a, b in zip(*outs):
        assert _signature(ref, a) == _signature(port, b)
    assert _loads(ref) == _loads(port)


def test_sim_dgemm_schedules_identically():
    ref, port = _ref_ctx("sim", k=4, r=4), _port_ctx("sim", k=4, r=4)
    a = ref_workloads.dgemm_graph(ref, 1024, 4)
    b = port_workloads.dgemm_graph(port, 1024, 4)
    assert _signature(ref, a) == _signature(port, b)
    assert _loads(ref) == _loads(port)


# ---------------------------------------------------------------------------
# values: the port's cuda backend (plain matmul on the CPU) vs pallas
# ---------------------------------------------------------------------------

def test_logreg_newton_matches_pallas_backend(jax_x64):
    ref = _ref_ctx("pallas")
    g_r, H_r, b_r = ref_workloads.logreg_newton_loop(ref, 128, 8, 4, iters=3)
    port = _port_ctx("cuda")
    g, H, b = port_workloads.logreg_newton_loop(port, 128, 8, 4, iters=3)
    for got, want in ((b, b_r), (g, g_r), (H, H_r)):
        assert _rel(got.to_numpy(), want.to_numpy()) < RTOL
    assert _signature(ref, H_r) == _signature(port, H)


def test_dgemm_matches_pallas_backend(jax_x64):
    ref = _ref_ctx("pallas")
    C_r = ref_workloads.dgemm_graph(ref, 64, 4)
    port = _port_ctx("cuda")
    C = port_workloads.dgemm_graph(port, 64, 4)
    assert _rel(C.to_numpy(), C_r.to_numpy()) < RTOL
    assert _signature(ref, C_r) == _signature(port, C)


def test_cpu_path_launches_no_kernel():
    reset_launches()
    port = _port_ctx("cuda")
    port_workloads.logreg_newton_loop(port, 128, 8, 4, iters=1)[2].to_numpy()
    assert launches["matmul"] == 0


# ---------------------------------------------------------------------------
# the runtime's bitwise contracts on the port's backends
# ---------------------------------------------------------------------------

def _beta_bits(backend, **kw):
    ctx = _port_ctx(backend, **kw)
    _g, _H, beta = port_workloads.logreg_newton_loop(ctx, 256, 8, 8, iters=3,
                                                     reset_loads=False)
    return beta.to_numpy().tobytes(), ctx


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_pipelined_equals_sync_bitwise(backend):
    sync, _ = _beta_bits(backend, pipeline=False)
    piped, ctx = _beta_bits(backend, pipeline=True)
    assert piped == sync
    assert ctx.executor.stats.n_queued > 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_plan_cache_on_equals_off_bitwise(backend):
    off, _ = _beta_bits(backend, pipeline=True)
    on, ctx = _beta_bits(backend, pipeline=True, plan_cache=True)
    assert on == off
    assert ctx.sched_stats.plan_hits > 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_gc_equals_no_gc_bitwise(backend):
    plain, ref_ctx = _beta_bits(backend, pipeline=True)
    gcd, ctx = _beta_bits(backend, pipeline=True, gc=True)
    assert gcd == plain
    mm = ctx.executor.memory.stats
    assert mm.gc_freed_blocks > 0
    assert mm.peak_store_blocks < ref_ctx.executor.memory.stats.peak_store_blocks


# ---------------------------------------------------------------------------
# the GLM solver, resuming a reference run, the launch driver
# ---------------------------------------------------------------------------

def test_newton_solver_fit_matches_reference():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((256, 6))
    y = (rng.random((256, 1)) < 1 / (1 + np.exp(-X @ rng.standard_normal((6, 1))))
         ).astype(np.float64)
    fits = []
    for glm, ctx in ((ref_glm, _ref_ctx("numpy", ng=(4, 1))),
                     (port_glm, _port_ctx("cuda", ng=(4, 1)))):
        Xg, yg = ctx.from_numpy(X, grid=(8, 1)), ctx.from_numpy(y, grid=(8, 1))
        res = glm.NewtonSolver(max_iter=6, reg=1e-3).fit(
            ctx, glm.LogisticModel(), Xg, yg)
        fits.append((res.beta.to_numpy(), res.grad_norms, res.iterations))
    (b_r, gn_r, it_r), (b, gn, it) = fits
    assert it == it_r
    assert _rel(b, b_r) < 1e-10
    np.testing.assert_allclose(gn, gn_r, rtol=1e-8, atol=1e-12)


def _newton_step(ctx, X, y, beta, eye, single_block_binary):
    mu = (X @ beta).sigmoid().compute()
    g = (X.T @ (mu - y)).compute()
    w = (mu * (1.0 - mu)).compute()
    H = ((X.T @ (w * X).compute()) + eye).compute()
    delta = single_block_binary(ctx, "solve", H, g).compute()
    return g, H, (beta - delta).compute()


def test_carry_arrays_resumes_a_reference_run():
    """Two Newton iterations in the reference, the third in the port: the
    port continues from the carried blocks and agrees with the reference's
    own third iteration."""
    from repro.glm.newton import _single_block_binary as ref_sbb
    from repro_torch.glm.newton import _single_block_binary as port_sbb

    n, d, q = 256, 8, 8
    ref = _ref_ctx("numpy")
    X = ref.random((n, d), grid=(q, 1))
    y = ref.uniform((n, 1), grid=(q, 1))
    beta = ref.zeros((d, 1), grid=(1, 1))
    eye = ref.from_numpy(1e-3 * np.eye(d), grid=(1, 1))
    for _ in range(2):
        _g, _H, beta = _newton_step(ref, X, y, beta, eye, ref_sbb)
    state = {name: (ga.to_numpy(), ga.grid.grid, ga.placements())
             for name, ga in (("X", X), ("y", y), ("beta", beta), ("eye", eye))}
    g_r, H_r, beta_r = _newton_step(ref, X, y, beta, eye, ref_sbb)

    port = _port_ctx("cuda")
    a = carry_arrays(port, state)
    for name, (values, _grid, _pl) in state.items():
        assert a[name].to_numpy().tobytes() == values.tobytes()
    g, H, beta3 = _newton_step(port, a["X"], a["y"], a["beta"], a["eye"], port_sbb)
    # the port starts from a fresh load state, so its reduce trees may pair
    # blocks in another order: float reassociation, visible relative to a
    # gradient that is already near zero
    for got, want in ((g, g_r), (H, H_r), (beta3, beta_r)):
        assert _rel(got.to_numpy(), want.to_numpy()) < RTOL


def test_carry_arrays_rejects_moved_placements():
    port = _port_ctx("cuda")
    vals = np.ones((8, 2))
    bad = {(0, 0): (1, 0), (1, 0): (0, 0)}
    with pytest.raises(AssertionError, match="placements"):
        carry_arrays(port, {"X": (vals, (2, 1), bad)})


def test_launch_driver_runs_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.blocks", "--device", "cpu",
         "--scale", "0", "--iters", "2", "--plan-cache"],
        capture_output=True, text=True, env=env, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["backend"] == "cuda" and report["device"] == "cpu"
    assert report["plan_hits"] > 0 and report["backend_dispatches"] > 0
    assert "jax" not in proc.stderr
