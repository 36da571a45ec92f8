"""The port's observability stack (``repro_torch.obs``: Perfetto export,
critical-path attribution, the trace report, the metrics schema) against
the reference's.

``tests/test_obs.py`` is the spec.  Each case runs the reference (numpy)
and the port (numpy, torch and cuda with ``device="cpu"``, f64) on the same
graph and seed: the exported op slices on the simulated tracks, the
critical-path decomposition and the ``loads()`` key schema are equal; the
decomposition closes to 100 ± 1% of the makespan.
"""
from __future__ import annotations

import json

import pytest

import repro.core as R
import repro.obs as RO
import repro_torch.core as P
import repro_torch.obs as PO
from repro.launch.workloads import logreg_newton_loop as r_newton_loop
from repro_torch.core.context import PORT_LOADS
from repro_torch.launch.workloads import logreg_newton_loop as p_newton_loop

BACKENDS = ["numpy", "torch", "cuda"]
#: ``loads()`` keys of the reference that the port has not: calls of the
#: reference backends' memoized callables (the port's ops are eager)
REF_ONLY_LOADS = ("backend_jit_calls",)
#: slice args the port adds (host wall) or that carry process-global ids
_PORT_ONLY = {"wall_s"}
_IDS = {"out", "ins", "ready_obj", "xfers"}


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


def traced(pkg, backend, chaos=None, **kw):
    ctx = make_ctx(pkg, backend, trace=True, **kw)
    if chaos is not None:
        ctx.enable_chaos(pkg.ChaosPlan(**chaos), seed=3)
    small_workload(ctx)
    return ctx, ctx.export_trace()


def slices(doc):
    """The op, stall and transfer slices of an exported trace, without the
    process-global vertex ids and the port's host wall."""
    out = []
    for e in doc["traceEvents"]:
        if e["ph"] != "X":
            continue
        args = {k: v for k, v in e["args"].items() if k not in _PORT_ONLY | _IDS}
        if e["cat"] == "transfer":
            args.pop("obj", None)
            args.pop("consumer", None)
        out.append((e["cat"], e["pid"], e["tid"], e["ts"], e["dur"],
                    e["name"] if e["cat"] != "transfer" else "xfer",
                    json.dumps(args, sort_keys=True, default=float)))
    return out


CHAOS = {None: None,
         "death+straggler+faults": dict(node_failures={3: 1e-7}, stragglers={1: 4.0},
                                        transient_fault_prob=0.05)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("chaos", list(CHAOS), ids=["fault-free", "chaos"])
def test_export_equals_reference(backend, chaos):
    _c, ref = traced(R, "numpy", CHAOS[chaos])
    _c, doc = traced(P, backend, CHAOS[chaos])
    assert slices(doc) == slices(ref)
    for key in ("primary_track", "tracks", "makespans", "nodes", "workers_per_node"):
        assert doc["otherData"][key] == ref["otherData"][key], key
    assert doc["otherData"]["backend"] == backend
    assert doc["otherData"]["event_counts"] == ref["otherData"]["event_counts"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("chaos", list(CHAOS), ids=["fault-free", "chaos"])
def test_critical_path_equals_reference(backend, chaos):
    """The decomposition on the simulated track: bucket seconds, per-node
    shares, the path's length and its dominant stall all equal the
    reference's, and the buckets close to the makespan."""
    _c, ref = traced(R, "numpy", CHAOS[chaos])
    _c, doc = traced(P, backend, CHAOS[chaos])
    a, b = PO.analyze(doc), RO.analyze(ref)
    for key in ("track", "makespan", "breakdown", "breakdown_pct", "per_node_pct",
                "critical_path_len", "top_stall", "decomposition_total_pct"):
        assert a[key] == b[key], key
    assert a["track"] == ("pipe" if chaos is None else "chaos")
    assert abs(a["decomposition_total_pct"] - 100.0) <= 1.0
    assert sum(a["breakdown"].values()) == pytest.approx(a["makespan"], rel=1e-9)
    assert PO.top_segments(a) == RO.top_segments(b)
    assert PO.summary_line(a) == RO.summary_line(b)


@pytest.mark.parametrize("backend", BACKENDS)
def test_document_structure_and_flows(backend):
    _c, doc = traced(P, backend)
    doc = json.loads(json.dumps(doc, default=float))
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert {"X", "M"} <= {e["ph"] for e in evs}
    ops = [e for e in evs if e["ph"] == "X" and e.get("cat") == "op"]
    assert ops
    for e in ops:
        assert {"w_busy", "t_ready", "t_xfer", "out"} <= set(e["args"])
        # every executed op carries its host wall from its retire event
        assert e["args"]["wall_s"] > 0.0 or e["name"].startswith("create")
        assert e["dur"] >= 0 and e["ts"] >= 0
    starts = [e for e in evs if e["ph"] == "s"]
    ends = [e for e in evs if e["ph"] == "f"]
    assert starts and {e["id"] for e in starts} == {e["id"] for e in ends}


def test_write_chrome_trace_and_makespans(tmp_path):
    ctx, _doc = traced(P, "cuda")
    path = tmp_path / "t.json"
    ctx.export_trace(str(path))
    doc = json.loads(path.read_text())
    assert doc["traceEvents"]
    assert doc["otherData"]["primary_track"] == "pipe"
    doc = PO.export_chrome_trace(ctx.tracer, makespans={"pipe": 1.0})
    assert doc["otherData"]["makespans"] == {"pipe": 1.0}


@pytest.mark.parametrize("backend", BACKENDS)
def test_trace_report_cli(backend, tmp_path, capsys):
    """The report prints the reference's sections and, per op kind, the host
    wall of the executed ops; ``--json`` gives both distributions."""
    from repro_torch.launch.trace_report import main, wall_histograms

    ctx, doc = traced(P, backend)
    path = tmp_path / "t.json"
    ctx.export_trace(str(path))
    main([str(path)])
    out = capsys.readouterr().out
    for part in ("# trace:", "decomposition", "compute", "op durations",
                 "host wall per executed op"):
        assert part in out, part
    main([str(path), "--json"])
    analysis = json.loads(capsys.readouterr().out)
    hists = wall_histograms(doc)
    assert set(analysis["host_wall"]) == set(hists) >= {"matmul", "sigmoid"}
    executed = ctx.executor.stats.n_rfc - ctx.executor.stats.n_creates
    assert sum(h.count for h in hists.values()) == executed
    for kind, st in analysis["host_wall"].items():
        assert st["n"] == hists[kind].count
        assert 0.0 < st["p50"] <= st["p95"] <= st["p99"] <= st["max"]
    assert set(analysis["op_durations"]) >= set(hists)


def test_sim_trace_has_no_host_wall():
    from repro_torch.launch.trace_report import wall_histograms

    ctx = make_ctx(P, "sim", trace=True)
    p_newton_loop(ctx, 128, 16, 8, iters=2, reset_loads=False)
    doc = ctx.export_trace()
    assert wall_histograms(doc) == {}
    assert PO.analyze(doc)["critical_path_len"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_drift_report_pairs_every_timed_op(backend):
    """Predicted (simulated) against measured (profiled host wall) per op
    kind: every executed op is paired, and the op kinds are the
    reference's."""
    ctx = make_ctx(P, backend, trace=True)
    ctx.executor.profile_sync = True
    small_workload(ctx)
    rep = PO.drift_report(ctx.tracer)
    ref = make_ctx(R, "numpy", trace=True)
    ref.executor.profile_sync = True
    small_workload(ref)
    want = RO.drift_report(ref.tracer)
    assert rep["track"] == want["track"] == "pipe"
    assert rep["n_ops"] == want["n_ops"] > 0
    assert sorted(rep["per_kind"]) == sorted(want["per_kind"])
    assert rep["predicted_s"] == want["predicted_s"]
    assert rep["drift"] >= 0.0
    assert len(PO.drift_lines(rep)) == len(rep["per_kind"]) + 2


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("feature", ["base", "budget", "chaos"])
def test_loads_schema_equals_reference(backend, feature):
    """``ctx.loads()``'s key sequence per feature set is the reference's
    (the golden lists in ``tests/test_obs.py``), chaos keys included, plus
    the port's own ``PORT_LOADS`` (execute and collector seconds, present)
    and less ``REF_ONLY_LOADS``, on every backend."""
    def run(pkg, be):
        kw = {"mem_capacity": 1e5} if feature == "budget" else {}
        ctx = make_ctx(pkg, be, **kw)
        if feature == "chaos":
            ctx.enable_chaos(pkg.ChaosPlan(stragglers={1: 2.0}), seed=1)
        X = ctx.random((64, 16), grid=(4, 1))
        (X.T @ X).compute()
        ctx.flush()
        return ctx

    ctx, ref = run(P, backend), run(R, "numpy")
    keys = list(ctx.loads())
    assert set(PORT_LOADS) <= set(keys)
    want = list(ref.loads())
    assert set(REF_ONLY_LOADS) <= set(want)
    assert ([k for k in keys if k not in PORT_LOADS]
            == [k for k in want if k not in REF_ONLY_LOADS])
    assert ctx.metrics.provider_names() == ref.metrics.provider_names()
    if feature == "chaos":
        got, want = ctx.loads(), ref.loads()
        for key in [k for k in want if k.startswith("chaos_")]:
            assert got[key] == want[key], key


def test_obs_exports_match_reference():
    assert sorted(PO.__all__) == sorted(RO.__all__)
