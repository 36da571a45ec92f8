"""The port's measured-cost calibration (``repro_torch.obs.calibrate``), its
observed-load controller (``repro_torch.obs.controller``) and its device
inventory (``repro_torch.launch.mesh``) against the reference's.

``tests/test_calibration.py`` is the spec: the fit is a pure function of
the recorded event set, profiles are versioned JSON, calibration changes
clocks and not values, and the controller decides from simulated and
counter signals only.  Here the port's fit of the same synthetic events is
the reference's bit for bit, a profile written by either package loads in
the other, a calibrated port context has the reference's cost model and
clocks, and the controller takes the reference's actions.  Like the
reference, the port records the device class a profile was fitted on and
does not refuse a profile fitted elsewhere.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as R
import repro.obs as RO
import repro_torch.core as P
import repro_torch.obs as PO
from repro.launch.workloads import logreg_newton_loop as r_newton_loop
from repro_torch.launch.workloads import logreg_newton_loop as p_newton_loop

BACKENDS = ["numpy", "torch", "cuda"]
KINDS = {"matmul": (2e-5, 3e-9), "add": (1e-6, 4e-10)}
XFERS = {"h2d": (5e-6, 1e-10), "d2h": (7e-6, 2e-10)}


def synthetic_recorder(pkg, order=1, noise=0.0):
    """Events on known alpha/beta/gamma lines (``noise`` perturbs them by a
    seeded relative amount); ``order`` flips the emission order."""
    rng = np.random.default_rng(0)
    rec = pkg.FlightRecorder()
    events = []
    for kind, (a, b) in KINDS.items():
        for work in (256.0, 4096.0, 65536.0, 1048576.0):
            wall = (a + b * work) * (1.0 + noise * rng.standard_normal())
            events.append(("retire", kind, {"wall_s": wall, "work": work}))
    for cls, (a, b) in XFERS.items():
        for nbytes in (2048.0, 32768.0, 524288.0):
            wall = (a + b * nbytes) * (1.0 + noise * rng.standard_normal())
            events.append(("xfer_probe", cls, {"cls": cls, "bytes": nbytes, "wall_s": wall}))
    events.append(("gamma_probe", "gamma", {"dispatch_s": 0.012, "n_rfc": 300}))
    for kind, name, args in events[::order]:
        rec.record(kind, name, args=args)
    return rec


@pytest.mark.parametrize("noise", [0.0, 0.05], ids=["exact", "noisy"])
@pytest.mark.parametrize("order", [1, -1], ids=["forward", "reversed"])
def test_fit_profile_equals_reference_bit_for_bit(noise, order):
    p = PO.fit_profile(synthetic_recorder(P, order, noise), backend="cuda")
    r = RO.fit_profile(synthetic_recorder(R, order, noise), backend="cuda")
    assert p.dumps() == r.dumps()
    assert p.signature() == r.signature()
    if noise == 0.0:
        for kind, (a, b) in KINDS.items():
            assert p.compute_coeffs[kind] == pytest.approx((a, b), rel=1e-6)
        for cls, (a, b) in XFERS.items():
            assert p.transfer_coeffs[cls] == pytest.approx((a, b), rel=1e-6)
        assert p.gamma_s == pytest.approx(0.012 / 300, rel=1e-12)
        assert "link" in p.transfer_coeffs


def test_fit_profile_is_order_independent():
    a = PO.fit_profile(synthetic_recorder(P, 1, 0.05), backend="cuda")
    b = PO.fit_profile(synthetic_recorder(P, -1, 0.05), backend="cuda")
    assert a.dumps() == b.dumps()


@pytest.mark.parametrize("points", [
    [(x, 3e-5 + 2e-9 * x) for x in (1e3, 1e4, 1e5, 1e6)],
    [(1.0, 5.0), (2.0, 4.0), (3.0, 3.0)],
    [(1.0, 0.5), (2.0, 2.5), (3.0, 4.5)],
    [(100.0, 2.0)],
], ids=["line", "negative slope", "negative intercept", "one point"])
def test_fit_affine_equals_reference(points):
    assert PO.fit_affine(points) == RO.fit_affine(points)


def test_fit_errors():
    with pytest.raises(PO.CalibrationError):
        PO.fit_affine([])
    with pytest.raises(PO.CalibrationError, match="profile_sync"):
        PO.fit_profile(P.FlightRecorder(), backend="cuda")


def test_profiles_cross_load_between_packages(tmp_path):
    p = PO.fit_profile(synthetic_recorder(P), backend="cuda",
                       metadata={"device": "cuda:cuda (NVIDIA H100 80GB HBM3) x1"})
    path = tmp_path / "p.json"
    p.save(str(path))
    r = RO.load_profile(str(path))
    assert r.dumps() == p.dumps()
    back = tmp_path / "r.json"
    r.save(str(back))
    q = PO.load_profile(str(back))
    assert q.to_json() == p.to_json()
    assert PO.load_profile(p) is p
    assert PO.load_profile(p.to_json()).dumps() == p.dumps()


def test_profile_schema_and_malformed_files(tmp_path):
    doc = PO.fit_profile(synthetic_recorder(P), backend="cuda").to_json()
    doc["schema_version"] = 99
    with pytest.raises(PO.CalibrationError, match="schema_version"):
        PO.CalibrationProfile.from_json(doc)
    bad = tmp_path / "bad.json"
    bad.write_text("not json {")
    with pytest.raises(PO.CalibrationError, match="not valid JSON"):
        PO.CalibrationProfile.load(str(bad))


def make_ctx(pkg, backend="numpy", k=4, r=2, **kw):
    kw.setdefault("pipeline", True)
    kw.setdefault("dtype", "float64")
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.ArrayContext(cluster=pkg.ClusterSpec(k, r), node_grid=(k, 1),
                            backend=backend, seed=0, **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_calibrated_context_equals_reference(backend, tmp_path):
    """The same profile gives the port the reference's calibrated cost model
    and plan-cache signature, and the same Newton loop the same calibrated
    clocks; values stay within the reference's tolerance of the
    uncalibrated run (bitwise on numpy).  A profile fitted on another
    device class is applied, as the reference applies it: the class is
    recorded, not enforced."""
    p = PO.fit_profile(synthetic_recorder(P), backend="numpy",
                       metadata={"device": "numpy:cpu (elsewhere) x1"})
    path = tmp_path / "p.json"
    p.save(str(path))
    runs = {}
    for pkg, be, loop in ((R, "numpy", r_newton_loop), (P, backend, p_newton_loop)):
        for cal in (None, str(path)):
            ctx = make_ctx(pkg, be, calibration=cal)
            _g, _h, beta = loop(ctx, 256, 16, 8, iters=2, reset_loads=False)
            ctx.flush()
            runs[pkg, cal] = (ctx, beta.to_numpy())
    ctx, beta = runs[P, str(path)]
    rctx, rbeta = runs[R, str(path)]
    cm = ctx.state.cost_model
    assert cm.calibrated and cm.calibration_sig == p.signature()
    assert repr(cm) == repr(rctx.state.cost_model)
    assert ctx._config_sig == rctx._config_sig != runs[P, None][0]._config_sig
    for pipeline in (False, True):
        assert ctx.state.makespan(pipeline=pipeline) == rctx.state.makespan(pipeline=pipeline)
    assert ctx.state.makespan(pipeline=True) != runs[P, None][0].state.makespan(pipeline=True)
    np.testing.assert_allclose(beta, runs[P, None][1], rtol=1e-9, atol=1e-12)
    if backend == "numpy":
        assert beta.tobytes() == rbeta.tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_calibration_on_the_port_backends(backend):
    """The live harness (``device="cpu"``): a compute line per op kind the
    Newton loop and the sweep run, h2d/d2h probes and the derived link, a
    positive gamma, and the device class in the metadata; a ``(rows, cols)``
    sweep entry profiles tall blocks."""
    prof = PO.run_calibration(backend=backend, device="cpu", dtype="float64", nodes=2,
                              workers=1, n=128, d=8, iters=1, sweep=(16, (64, 8)))
    assert {"matmul", "add", "mul", "sigmoid"} <= set(prof.compute_coeffs)
    assert {"h2d", "d2h", "link"} <= set(prof.transfer_coeffs)
    assert prof.gamma_s > 0.0
    assert prof.backend == backend and prof.dtype == "float64"
    assert prof.bytes_per_element == 8
    assert prof.metadata["device"].startswith(f"{backend}:cpu (")
    assert prof.metadata["sweep"] == [16, [64, 8]]
    assert PO.load_profile(prof.to_json()).dumps() == prof.dumps()
    with pytest.raises(PO.CalibrationError):
        PO.run_calibration(backend="sim")


def test_device_class_names_the_host_or_raises_without_a_card(monkeypatch):
    from repro_torch.launch.mesh import device_class, device_inventory

    assert device_class("numpy").startswith("numpy:cpu (")
    assert device_class("cuda", "cpu").endswith(") x1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: device_class("cuda"), lambda: device_class("torch", "cuda:0"),
                 device_inventory, lambda: PO.run_calibration()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- the observed-load controller ---------------------------------------------

def controller_on(pkg, ctx, **policy_kw):
    policy_kw.setdefault("warmup_iters", 0)
    return pkg.ObservedLoadController(pkg.ControllerPolicy(**policy_kw)).attach(ctx)


def forced_signals(ctl, **overrides):
    sig = ctl.signals()
    sig.update({k: float(v) for k, v in overrides.items()})
    ctl.signals = lambda: sig
    return ctl


CONTROLLER_CASES = {
    "dead node grows once": (dict(cooldown_iters=0), [dict(dead_nodes=1, utilization=0.6)] * 3),
    "warm-up and cooldown": (dict(warmup_iters=2, cooldown_iters=1),
                             [dict(dead_nodes=1)] * 3 + [dict(dead_nodes=2)] * 2),
    "shrink": (dict(cooldown_iters=0), [dict(utilization=0.1, dead_nodes=0,
                                             mem_pressure=0)] * 2),
    "rebalance": (dict(cooldown_iters=0), [dict(utilization=0.6, mem_imbalance=5.0,
                                                dead_nodes=0, mem_pressure=0)] * 2),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(CONTROLLER_CASES))
def test_controller_actions_equal_reference(backend, name):
    policy, signals = CONTROLLER_CASES[name]
    reports = []
    for pkg, opkg, be in ((R, RO, "numpy"), (P, PO, backend)):
        ctl = controller_on(opkg, make_ctx(pkg, be), **policy)
        for it, sig in enumerate(signals):
            forced_signals(ctl, **sig)
            ctl.decide(it)
        reports.append(ctl.report())
    assert reports[0] == reports[1]
    assert reports[1]["n_actions"] >= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_controller_signals_equal_reference(backend):
    """The controller's own signals after a chaos run with a dead node:
    utilization, imbalance, pressure and dead nodes are the reference's."""
    sigs = []
    for pkg, opkg, be, loop in ((R, RO, "numpy", r_newton_loop),
                                (P, PO, backend, p_newton_loop)):
        ctx = make_ctx(pkg, be)
        ctx.enable_chaos(pkg.ChaosPlan(node_failures={3: 1e-8}, stragglers={1: 4.0}),
                         seed=2)
        ctl = controller_on(opkg, ctx, cooldown_iters=0)
        loop(ctx, 128, 16, 8, iters=2, reset_loads=False)
        ctx.flush()
        sigs.append((ctl.signals(), ctl.decide(0)))
    (s_r, a_r), (s_p, a_p) = sigs
    assert s_p == s_r
    assert (a_p is None) == (a_r is None)
    if a_p is not None:
        assert (a_p.kind, a_p.from_nodes, a_p.to_nodes) == (a_r.kind, a_r.from_nodes,
                                                            a_r.to_nodes)


def test_fastest_retires_keeps_each_ops_least_wall():
    """Calibration's best-of-repeats: one retirement per op, the fastest;
    passes that executed different ops are refused."""
    from repro_torch.obs.calibrate import fastest_retires

    walls = [[3.0, 1.0, 2.0], [1.5, 4.0, 2.5]]
    recs = []
    for run in walls:
        rec = P.FlightRecorder()
        for i, w in enumerate(run):
            rec.record("retire", "matmul", 0, i, args={"out": i, "elements": 1,
                                                       "work": 10 * (i + 1), "wall_s": w})
        recs.append(rec)
    best = fastest_retires(recs)
    assert [e.args["wall_s"] for e in best.of("retire")] == [1.5, 1.0, 2.0]
    assert [e.args["work"] for e in best.of("retire")] == [10, 20, 30]
    recs[1].record("retire", "add", 0, 0, args={"out": 9, "elements": 1, "work": 1,
                                                 "wall_s": 1.0})
    with pytest.raises(PO.CalibrationError, match="different ops"):
        fastest_retires(recs)
    prof = PO.run_calibration(backend="torch", device="cpu", dtype="float64", nodes=2,
                              workers=1, n=128, d=8, iters=1, sweep=(16,), repeats=2)
    assert prof.metadata["repeats"] == 2 and "matmul" in prof.compute_coeffs
