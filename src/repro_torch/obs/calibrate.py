"""Measured-cost calibration: fit the simulated clock model to the live
backend (the closed-loop half of the observability stack).

The α-β-γ constants in ``CostModel``/``bounds.CommModel`` are hand-picked,
so every simulated-clock claim is a sim claim until something ties them to
measured time.  This module closes the loop:

1. ``run_calibration`` replays representative block kernels (the
   logreg-Newton iteration body plus a matmul/elementwise size sweep) on the
   live backend under a :class:`~repro_torch.core.trace.FlightRecorder` with
   ``Executor.profile_sync`` on, so every ``retire`` event carries a true
   per-op wall time (the backend waits for the device before the clock
   stops); it also probes host<->backend transfers over a size
   sweep and records them as ``xfer_probe`` events, and snapshots the
   per-RFC dispatch overhead as a ``gamma_probe`` event.
2. ``fit_profile`` is a *pure function of the recorded event stream*:
   per-op-kind affine compute coefficients ``wall = α + β·work`` (closed-form
   least squares, sorted inputs — same events in, bit-identical profile
   out), per-link-class transfer coefficients, and γ from the dispatch
   counters.
3. :class:`CalibrationProfile` persists the fit as versioned JSON and
   constructs calibrated ``CostModel`` / ``CommModel`` instances;
   ``ArrayContext(calibration=profile_or_path)`` swaps the fitted constants
   into ``ClusterState`` so LSHS loads and all three clock tracks predict
   measured time.

Drift is measured as ``|ln(predicted / measured)|`` over total op seconds —
robust when the defaults are orders of magnitude off — via
``repro_torch.obs.critical_path.drift_report``.
"""
from __future__ import annotations

import gc
import json
import zlib
from dataclasses import dataclass, field, replace
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

# transfer probe sizes (elements, float64): spans the block sizes the smoke
# workloads move so the affine fit sees both the latency- and the
# bandwidth-dominated regime
PROBE_SIZES = (1 << 8, 1 << 12, 1 << 16, 1 << 18)
PROBE_REPEATS = 3


class CalibrationError(ValueError):
    """Raised on unusable profiles (schema mismatch, empty sample sets)."""


# -- fitting (pure, deterministic) -------------------------------------------

def fit_affine(points: List[Tuple[float, float]]) -> Tuple[float, float]:
    """Closed-form least-squares fit of ``y = alpha + beta * x`` with both
    coefficients clamped non-negative (negative latency or inverse bandwidth
    is measurement noise, not physics).  Points are sorted first so the fit
    is a function of the point *set*, not its order."""
    pts = sorted((float(x), float(y)) for x, y in points)
    if not pts:
        raise CalibrationError("fit_affine: no sample points")
    n = len(pts)
    if n == 1:
        x, y = pts[0]
        return (0.0, y / x) if x > 0 else (max(y, 0.0), 0.0)
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    sxx = sum((x - mx) * (x - mx) for x, _ in pts)
    sxy = sum((x - mx) * (y - my) for x, y in pts)
    beta = sxy / sxx if sxx > 0.0 else 0.0
    alpha = my - beta * mx
    if beta < 0.0:
        # slope noise on near-constant data: a flat latency-only model
        return (max(my, 0.0), 0.0)
    if alpha < 0.0:
        # force through the origin: pure-bandwidth model
        sx2 = sum(x * x for x, _ in pts)
        b0 = sum(x * y for x, y in pts) / sx2 if sx2 > 0.0 else 0.0
        return (0.0, max(b0, 0.0))
    return (alpha, beta)


def samples_from_recorder(recorder) -> Dict[str, Any]:
    """Harvest calibration samples from a flight-recorder stream.

    Returns ``{"compute": {kind: [(work, wall_s), ...]}, "transfer":
    {cls: [(bytes, wall_s), ...]}, "gamma": [(dispatch_s, n_rfc), ...]}``.
    ``retire`` events feed compute (only those carrying a positive
    ``wall_s`` — untimed events from non-profiling runs are skipped);
    ``xfer_probe``/``gamma_probe`` events are emitted by the harness."""
    compute: Dict[str, List[Tuple[float, float]]] = {}
    transfer: Dict[str, List[Tuple[float, float]]] = {}
    gamma: List[Tuple[float, float]] = []
    for ev in recorder.iter_events():
        if ev.kind == "retire":
            wall = ev.args.get("wall_s", 0.0)
            work = ev.args.get("work")
            if wall > 0.0 and work:
                compute.setdefault(ev.name, []).append(
                    (float(work), float(wall)))
        elif ev.kind == "xfer_probe":
            transfer.setdefault(ev.args["cls"], []).append(
                (float(ev.args["bytes"]), float(ev.args["wall_s"])))
        elif ev.kind == "gamma_probe":
            gamma.append((float(ev.args["dispatch_s"]),
                          float(ev.args["n_rfc"])))
    return {"compute": compute, "transfer": transfer, "gamma": gamma}


def fit_profile(recorder, *, backend: str, dtype: str = "float64",
                bytes_per_element: int = 8,
                metadata: Optional[Dict[str, Any]] = None
                ) -> "CalibrationProfile":
    """Fit a :class:`CalibrationProfile` from a recorded event stream — a
    pure, deterministic function of the events (the synthetic-recovery and
    bit-identity tests in ``tests/test_calibration.py`` depend on this)."""
    s = samples_from_recorder(recorder)
    if not s["compute"]:
        raise CalibrationError(
            "no timed retire events: run the harness with profile_sync and "
            "tracing enabled (or feed a synthetic stream)")
    compute_coeffs = {kind: fit_affine(pts)
                      for kind, pts in sorted(s["compute"].items())}
    all_pts = [p for _k, pts in sorted(s["compute"].items()) for p in pts]
    compute_default = fit_affine(all_pts)
    transfer_coeffs = {cls: fit_affine(pts)
                       for cls, pts in sorted(s["transfer"].items())}
    if transfer_coeffs and "link" not in transfer_coeffs:
        # no real inter-node wire exists in-process: the h2d/d2h round trip
        # is the measured stand-in for one hop on the link class
        ln = [transfer_coeffs[c] for c in sorted(transfer_coeffs)]
        transfer_coeffs["link"] = (
            sum(a for a, _b in ln) / len(ln),
            sum(b for _a, b in ln) / len(ln),
        )
    gamma_s = 0.0
    if s["gamma"]:
        tot_s = sum(d for d, _n in s["gamma"])
        tot_n = sum(n for _d, n in s["gamma"])
        gamma_s = tot_s / tot_n if tot_n > 0 else 0.0
    meta = dict(metadata or {})
    meta.setdefault("samples", {
        "compute": {k: len(v) for k, v in sorted(s["compute"].items())},
        "transfer": {k: len(v) for k, v in sorted(s["transfer"].items())},
        "gamma": len(s["gamma"]),
    })
    return CalibrationProfile(
        schema_version=SCHEMA_VERSION, backend=backend, dtype=dtype,
        bytes_per_element=bytes_per_element,
        compute_coeffs=compute_coeffs, compute_default=compute_default,
        transfer_coeffs=transfer_coeffs, gamma_s=gamma_s, metadata=meta)


# -- the persisted artifact ---------------------------------------------------

@dataclass
class CalibrationProfile:
    """A versioned, JSON-persistable set of fitted cost coefficients.

    ``compute_coeffs[kind] = (alpha_s, s_per_element)``;
    ``transfer_coeffs[cls] = (alpha_s, s_per_byte)`` with classes ``h2d`` /
    ``d2h`` / ``link`` (the derived inter-node proxy the clock model uses);
    ``gamma_s`` is the measured per-RFC dispatch overhead."""

    schema_version: int
    backend: str
    dtype: str
    bytes_per_element: int
    compute_coeffs: Dict[str, Tuple[float, float]]
    compute_default: Tuple[float, float]
    transfer_coeffs: Dict[str, Tuple[float, float]]
    gamma_s: float
    metadata: Dict[str, Any] = field(default_factory=dict)

    # -- persistence ------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "backend": self.backend,
            "dtype": self.dtype,
            "bytes_per_element": self.bytes_per_element,
            "compute_coeffs": {k: list(v) for k, v in
                               sorted(self.compute_coeffs.items())},
            "compute_default": list(self.compute_default),
            "transfer_coeffs": {k: list(v) for k, v in
                                sorted(self.transfer_coeffs.items())},
            "gamma_s": self.gamma_s,
            "metadata": self.metadata,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())
            f.write("\n")

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "CalibrationProfile":
        ver = doc.get("schema_version")
        if ver != SCHEMA_VERSION:
            raise CalibrationError(
                f"calibration profile schema_version {ver!r} is not "
                f"supported (this build reads version {SCHEMA_VERSION}); "
                "re-fit the profile with --calibrate")
        return cls(
            schema_version=SCHEMA_VERSION,
            backend=doc["backend"],
            dtype=doc.get("dtype", "float64"),
            bytes_per_element=int(doc.get("bytes_per_element", 8)),
            compute_coeffs={k: (float(v[0]), float(v[1]))
                            for k, v in doc["compute_coeffs"].items()},
            compute_default=(float(doc["compute_default"][0]),
                             float(doc["compute_default"][1])),
            transfer_coeffs={k: (float(v[0]), float(v[1]))
                             for k, v in doc["transfer_coeffs"].items()},
            gamma_s=float(doc.get("gamma_s", 0.0)),
            metadata=dict(doc.get("metadata", {})),
        )

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise CalibrationError(
                    f"calibration profile {path!r} is not valid JSON: {e}"
                ) from e
        if not isinstance(doc, dict):
            raise CalibrationError(
                f"calibration profile {path!r} is not a JSON object")
        return cls.from_json(doc)

    def signature(self) -> int:
        """Stable fingerprint of the fitted coefficients — folded into
        ``ArrayContext._config_sig`` so calibrated contexts never share
        cached plans with uncalibrated (or differently calibrated) ones."""
        return zlib.crc32(json.dumps(
            self.to_json(), sort_keys=True).encode())

    # -- model constructors -----------------------------------------------
    def link_coeffs(self) -> Tuple[float, float]:
        tc = self.transfer_coeffs
        if "link" in tc:
            return tc["link"]
        if tc:
            first = tc[sorted(tc)[0]]
            return first
        return (0.0, 1.0 / 50e9)

    def cost_model(self, base=None):
        """A calibrated :class:`~repro_torch.core.cluster.CostModel`: fitted
        per-kind compute coefficients and link-class transfer coefficients
        replace the channel formulas, and the bandwidth fields are rebased
        to the fit's effective bandwidths so the ``time``-mode objective
        stays commensurable with the clocks."""
        from repro_torch.core.cluster import CostModel

        base = base or CostModel()
        la, lb = self.link_coeffs()
        link_bw = 1.0 / lb if lb > 0.0 else base.link_bw
        _da, db = self.compute_default
        hbm_bw = self.bytes_per_element / db if db > 0.0 else base.hbm_bw
        return CostModel(
            mode=base.mode,
            bytes_per_element=self.bytes_per_element,
            hbm_bw=hbm_bw,
            link_bw=link_bw,
            compute_coeffs=dict(self.compute_coeffs),
            compute_default=tuple(self.compute_default),
            transfer_coeffs=(la, lb),
            calibration_sig=self.signature(),
        )

    def comm_model(self, base=None):
        """A calibrated :class:`~repro_torch.core.bounds.CommModel`: the fitted
        link coefficients replace the inter-node channel, γ is the measured
        per-RFC dispatch overhead, and the intra-node channels are scaled by
        the fitted-over-default bandwidth ratio (no in-process probe can see
        them directly)."""
        from repro_torch.core.bounds import CommModel

        base = base or CommModel()
        la, lb = self.link_coeffs()
        beta_ratio = lb / base.beta if base.beta > 0.0 else 1.0
        alpha_ratio = la / base.alpha if base.alpha > 0.0 else 1.0
        return replace(
            base,
            alpha=la, beta=lb,
            alpha_d=base.alpha_d * alpha_ratio,
            beta_d=base.beta_d * beta_ratio,
            alpha_r=base.alpha_r * alpha_ratio,
            beta_r=base.beta_r * beta_ratio,
            gamma=self.gamma_s,
            bytes_per_element=self.bytes_per_element,
        )


def load_profile(profile) -> CalibrationProfile:
    """Accept a profile object or a path to one (the ``calibration=``
    context kwarg and the ``--profile`` CLI flags route through here)."""
    if isinstance(profile, CalibrationProfile):
        return profile
    if isinstance(profile, dict):
        return CalibrationProfile.from_json(profile)
    return CalibrationProfile.load(str(profile))


# -- the live micro-profiling harness -----------------------------------------

def _probe_transfers(backend, recorder, sizes=PROBE_SIZES,
                     repeats=PROBE_REPEATS) -> None:
    """Time host->backend and backend->host block moves over a size sweep
    and record each best-of-``repeats`` measurement as an ``xfer_probe``
    event (so the fit stays a pure function of the event stream)."""
    import numpy as np

    for elements in sizes:
        arr = np.ones(int(elements), dtype=np.float64)
        best_h2d = best_d2h = None
        for _ in range(max(repeats, 1)):
            t0 = perf_counter()
            dev = backend.from_host(arr, (0, 0))
            backend.wait(dev)
            h2d = perf_counter() - t0
            t0 = perf_counter()
            backend.to_host(dev)
            d2h = perf_counter() - t0
            best_h2d = h2d if best_h2d is None else min(best_h2d, h2d)
            best_d2h = d2h if best_d2h is None else min(best_d2h, d2h)
        nbytes = int(arr.nbytes)
        recorder.record("xfer_probe", "h2d", args={
            "cls": "h2d", "bytes": nbytes, "elements": int(elements),
            "wall_s": best_h2d})
        recorder.record("xfer_probe", "d2h", args={
            "cls": "d2h", "bytes": nbytes, "elements": int(elements),
            "wall_s": best_d2h})


def fastest_retires(recorders) -> "FlightRecorder":
    """One recorder holding, for every op of several measured passes of one
    graph (the same schedule in each, so their ``retire`` events align),
    the retirement with the least wall: a host stall only ever adds time."""
    from repro_torch.core import FlightRecorder

    runs = [rec.of("retire") for rec in recorders]
    keys = [[(e.name, e.args["work"]) for e in run] for run in runs]
    if any(k != keys[0] for k in keys[1:]):
        raise CalibrationError("the measured passes executed different ops")
    out = FlightRecorder()
    for evs in zip(*runs):
        best = min(evs, key=lambda e: e.args["wall_s"])
        out.record("retire", best.name, best.node, best.worker, args=dict(best.args))
    return out


def run_calibration(*, backend: str = "cuda", device=None,
                    dtype: Optional[str] = None, nodes: int = 4, workers: int = 2,
                    n: int = 1 << 10, d: int = 32, q: Optional[int] = None,
                    iters: int = 2, seed: int = 0, sweep=(32, 64, 128),
                    repeats: int = 1) -> CalibrationProfile:
    """Micro-profile the live backend and fit a calibration profile.

    Runs one warmup pass (callable caches, kernel builds, allocator warm
    paths), then a measured pass of the logreg-Newton iteration body plus a
    matmul / elementwise block-size sweep under ``profile_sync`` tracing,
    with Python's collector paused, probes h2d/d2h transfers, and fits.
    ``repeats`` > 1 measures the pass that many times, each in a fresh
    context, and fits each op's fastest retirement (``fastest_retires``).
    ``backend`` defaults to the card (``"cuda"``: every 2-D block product
    through the hand-written matmul kernel) and ``device`` is the
    ``ArrayContext``'s (None: the card; raises where there is none).  A ``sweep`` entry ``m`` profiles (m, m) blocks, a
    pair ``(rows, cols)`` blocks of that shape (``X.T @ X`` then has the
    Newton loop's ``Xᵀ(w∘X)`` form).  Blocks are ``dtype`` (default: the
    backend's natural dtype, as ``ArrayContext`` picks it).  The ``sim``
    backend holds no data and has nothing to measure."""
    if backend == "sim":
        raise CalibrationError("the sim backend has no measurable kernels")
    import numpy as np

    from repro_torch.core import ArrayContext, ClusterSpec, FlightRecorder
    from repro_torch.launch.mesh import device_class
    from repro_torch.launch.workloads import logreg_newton_loop

    device_name = device_class(backend, device)
    q = q or 2 * nodes

    def drive(ctx):
        logreg_newton_loop(ctx, n, d, q, iters=iters, reset_loads=False)
        for m in sweep:
            rows, cols = (m, m) if isinstance(m, int) else m
            X = ctx.random((rows * nodes, cols), grid=(nodes, 1))
            (X.T @ X).compute()
            (X + X).compute()
            (X * X).compute()
            X.sum().compute()
        ctx.flush()

    def make_ctx(**kw):
        return ArrayContext(cluster=ClusterSpec(nodes, workers),
                            node_grid=(nodes, 1), backend=backend,
                            dtype=dtype, pipeline=True, seed=seed,
                            device=device, **kw)

    # warmup: callable caches fill, first-touch allocations happen here.
    # A context holds reference cycles: collect it, so that its blocks leave
    # the card before the measured pass allocates its own
    drive(make_ctx())
    gc.collect()

    recs = []
    for i in range(max(repeats, 1)):
        if i:
            del ctx
            gc.collect()
        recs.append(FlightRecorder())
        ctx = make_ctx(trace=recs[-1])
        # the measured pass: each op's wall covers its device work
        # (profile_sync), and the collector, paused, adds no pause to any op
        gc_was_enabled = gc.isenabled()
        gc.disable()
        ctx.executor.profile_sync = True
        try:
            drive(ctx)
        finally:
            ctx.executor.profile_sync = False
            if gc_was_enabled:
                gc.enable()
    rec = recs[0] if len(recs) == 1 else fastest_retires(recs)
    _probe_transfers(ctx.executor.backend, rec)
    st = ctx.executor.stats
    rec.record("gamma_probe", "gamma", args={
        "dispatch_s": st.dispatch_s, "n_rfc": st.n_rfc})
    return fit_profile(
        rec, backend=backend, dtype=ctx.executor.dtype,
        bytes_per_element=int(np.dtype(ctx.executor.dtype).itemsize),
        metadata={"device": device_name, "nodes": nodes, "workers": workers,
                  "n": n, "d": d, "q": q, "iters": iters, "seed": seed,
                  "repeats": repeats,
                  "sweep": [m if isinstance(m, int) else list(m)
                            for m in sweep]})
