"""Critical-path extraction and makespan decomposition over an exported
Chrome/Perfetto trace (``repro_torch.obs.perfetto``).

The walk starts at the op with the latest simulated finish and repeatedly
steps to the *binding* predecessor — the event that set the current op's
start time.  ``WorkerClocks.place`` computes
``start = max(worker_busy, operand_ready, transfer_arrival)`` and the
exporter keeps all three in the slice args, so the binder is exact, not
heuristic:

* worker-busy bound  -> previous op on the same (node, worker) lane;
* operand-ready bound -> the producer of the binding operand;
* transfer bound     -> the producer of the transferred operand, with the
  wire time itself attributed as ``transfer``.

Each step covers the half-open window ``(pred.t1, cur.t1]`` exactly once
(telescoping), and the head/tail windows cover ``[0, first.t0]`` and
``(last.t1, makespan]``, so the five buckets — ``compute``, ``transfer``,
``queue_stall``, ``retry``, ``eviction_stall`` — sum to the makespan to
floating-point accuracy; the tests and ``chip_smoke.py`` check 100% ± 1%.
Gap time inside a window is charged in priority order: lane stall slices (eviction/fault-in
backpressure) first, then the op's recorded retry backoff, then wire time,
then residual ``queue_stall`` (dependency or channel wait).
"""
from __future__ import annotations

import bisect
import math
from typing import Any, Dict, List, Optional, Tuple

_US = 1e6

BUCKETS = ("compute", "transfer", "queue_stall", "retry", "eviction_stall")


class _Op:
    __slots__ = ("name", "node", "worker", "t0", "t1", "args", "index")

    def __init__(self, ev: Dict[str, Any], index: int):
        self.name = ev.get("name", "")
        self.node = ev["pid"]
        self.worker = ev["tid"]
        self.t0 = ev["ts"] / _US
        self.t1 = (ev["ts"] + ev.get("dur", 0.0)) / _US
        self.args = ev.get("args", {})
        self.index = index

    @property
    def out(self):
        return self.args.get("out")


def _overlap(lo: float, hi: float,
             windows: List[Tuple[float, float]]) -> float:
    total = 0.0
    for w0, w1 in windows:
        total += max(0.0, min(hi, w1) - max(lo, w0))
    return total


def analyze(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Decompose a trace's makespan along its critical path.

    ``trace`` is the dict produced by ``export_chrome_trace`` (or loaded
    from a ``--trace`` JSON file).  Returns bucket seconds/percentages,
    per-node percentages, the path itself, and the dominant stall cause.
    """
    raw = trace.get("traceEvents", [])
    other = trace.get("otherData", {})
    ops = [_Op(e, i) for i, e in enumerate(raw)
           if e.get("ph") == "X" and e.get("cat") == "op"]
    stall_evs = [e for e in raw
                 if e.get("ph") == "X" and e.get("cat") == "stall"]
    n_events = sum(1 for e in raw if e.get("ph") != "M")
    track = other.get("primary_track")
    makespans = other.get("makespans", {})

    result: Dict[str, Any] = {
        "track": track, "events": n_events,
        "dropped": other.get("dropped", 0), "n_ops": len(ops),
    }
    if not ops:
        result.update({
            "makespan": 0.0, "critical_path_len": 0,
            "breakdown": {b: 0.0 for b in BUCKETS},
            "breakdown_pct": {b: 0.0 for b in BUCKETS},
            "per_node_pct": {}, "decomposition_total_pct": 0.0,
            "top_stall": "none", "segments": [], "path": [],
        })
        return result

    makespan = float(makespans.get(track) or max(op.t1 for op in ops))
    # lane structures
    lanes: Dict[Tuple[int, int], List[_Op]] = {}
    for op in ops:
        lanes.setdefault((op.node, op.worker), []).append(op)
    lane_t0s: Dict[Tuple[int, int], List[float]] = {}
    for key, lst in lanes.items():
        lst.sort(key=lambda o: (o.t0, o.index))
        lane_t0s[key] = [o.t0 for o in lst]
    # stall windows, per-lane and per-kind ("retry" vs memory/eviction)
    lane_stalls: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    all_stalls: List[Tuple[float, float]] = []
    for e in stall_evs:
        kind = e.get("args", {}).get("kind", e.get("name"))
        if kind == "retry":
            continue  # retries attribute via per-op backoff args
        w = (e["ts"] / _US, (e["ts"] + e.get("dur", 0.0)) / _US)
        lane_stalls.setdefault((e["pid"], e["tid"]), []).append(w)
        all_stalls.append(w)
    # producers by output id, ordered by finish time
    producers: Dict[Any, List[_Op]] = {}
    for op in ops:
        producers.setdefault(op.out, []).append(op)
    for lst in producers.values():
        lst.sort(key=lambda o: (o.t1, o.index))

    def producer_before(obj, t: float) -> Optional[_Op]:
        tol = 1e-12 + 1e-9 * abs(t)
        best = None
        for p in producers.get(obj, ()):
            if p.t1 <= t + tol:
                best = p
            else:
                break
        return best

    def lane_pred(op: _Op) -> Optional[_Op]:
        lst = lanes[(op.node, op.worker)]
        i = bisect.bisect_left(lane_t0s[(op.node, op.worker)], op.t0)
        while i < len(lst) and lst[i] is not op:
            i += 1
        if i == 0 or i >= len(lst):
            return None
        pred = lst[i - 1]
        tol = 1e-12 + 1e-9 * abs(op.t0)
        return pred if pred.t1 <= op.t0 + tol else None

    # -- the walk ---------------------------------------------------------
    top = max(ops, key=lambda o: (o.t1, o.index))
    buckets = {b: 0.0 for b in BUCKETS}
    per_node = {}
    segments: List[Dict[str, Any]] = []
    path: List[Any] = []
    seen = set()

    def charge(bucket: str, node: int, lo: float, hi: float,
               op: Optional[_Op], label: str) -> None:
        dur = hi - lo
        if dur <= 0:
            return
        buckets[bucket] += dur
        per_node.setdefault(node, {b: 0.0 for b in BUCKETS})[bucket] += dur
        segments.append({
            "kind": bucket, "name": label, "node": node,
            "worker": op.worker if op is not None else -1,
            "out": op.out if op is not None else None,
            "t0": lo, "t1": hi, "dur_s": dur,
        })

    cur: Optional[_Op] = top
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        path.append(cur.out)
        charge("compute", cur.node, cur.t0, cur.t1, cur, cur.name)
        a = cur.args
        w_busy = a.get("w_busy", 0.0)
        t_ready = a.get("t_ready", 0.0)
        t_xfer = a.get("t_xfer", 0.0)
        # binder priority on ties: lane, then ready, then transfer —
        # start == max(w_busy, t_ready, t_xfer) on overlap tracks
        if w_busy >= t_ready and w_busy >= t_xfer:
            binder = "lane"
        elif t_ready >= t_xfer:
            binder = "ready"
        else:
            binder = "xfer"
        xfer_win = None
        if binder == "lane":
            pred = lane_pred(cur)
        elif binder == "ready":
            pred = producer_before(a.get("ready_obj"), cur.t0)
        else:
            xs = a.get("xfers", [])
            # binding transfer: the one whose arrival set t_xfer
            bx = max(xs, key=lambda x: x[4]) if xs else None
            pred = producer_before(bx[1], cur.t0) if bx is not None else None
            xfer_win = (bx[3], bx[4]) if bx is not None else None
        lo = pred.t1 if pred is not None else 0.0
        hi = cur.t0
        if hi > lo:
            # priority: eviction/backpressure stalls, retry backoff,
            # wire time, residual queue wait
            evict = _overlap(lo, hi, lane_stalls.get(
                (cur.node, cur.worker), ())) if binder == "lane" else 0.0
            evict = min(evict, hi - lo)
            rest = hi - lo - evict
            retry = min(a.get("backoff", 0.0), rest) if binder == "lane" else 0.0
            rest -= retry
            xfer_s = 0.0
            if xfer_win is not None:
                xfer_s = min(max(0.0, xfer_win[1] - max(xfer_win[0], lo)), rest)
            rest -= xfer_s
            # report in time order: queue wait happens before the rest of
            # the gap resolves, but second-order ordering inside one gap is
            # presentational only — totals are what the gate checks
            charge("eviction_stall", cur.node, lo, lo + evict, cur, "eviction")
            charge("retry", cur.node, lo + evict, lo + evict + retry, cur,
                   "backoff")
            charge("transfer", cur.node, lo + evict + retry,
                   lo + evict + retry + xfer_s, cur, "transfer")
            charge("queue_stall", cur.node, lo + evict + retry + xfer_s, hi,
                   cur, f"wait:{binder}")
        cur = pred

    # tail: clock time past the last op on the path's track (end-of-drain
    # OOM/backpressure charges) — classified from the recorded stalls
    if makespan > top.t1:
        tail_evict = min(_overlap(top.t1, makespan, all_stalls),
                         makespan - top.t1)
        charge("eviction_stall", top.node, top.t1, top.t1 + tail_evict,
               None, "tail eviction")
        charge("queue_stall", top.node, top.t1 + tail_evict, makespan,
               None, "tail")

    total = sum(buckets.values())
    pct = {b: 100.0 * v / makespan if makespan > 0 else 0.0
           for b, v in buckets.items()}
    stall_pcts = {b: p for b, p in pct.items() if b != "compute"}
    top_stall = max(stall_pcts, key=stall_pcts.get) if any(
        v > 0 for v in stall_pcts.values()) else "none"
    result.update({
        "makespan": makespan,
        "critical_path_len": len(path),
        "breakdown": buckets,
        "breakdown_pct": pct,
        "per_node_pct": {
            n: {b: 100.0 * v / makespan if makespan > 0 else 0.0
                for b, v in row.items()}
            for n, row in sorted(per_node.items())
        },
        "decomposition_total_pct": 100.0 * total / makespan
        if makespan > 0 else 0.0,
        "top_stall": top_stall,
        "segments": segments,
        "path": list(reversed(path)),
    })
    return result


def top_segments(analysis: Dict[str, Any], n: int = 3) -> List[str]:
    """The ``n`` longest critical-path segments, formatted for a job log."""
    segs = sorted(analysis.get("segments", ()),
                  key=lambda s: s["dur_s"], reverse=True)[:n]
    mk = analysis.get("makespan") or 1.0
    return [
        f"{s['kind']:<14} {s['name']:<20} node {s['node']} "
        f"[{s['t0']:.3e}s, {s['t1']:.3e}s] {100.0 * s['dur_s'] / mk:5.1f}%"
        for s in segs
    ]


_DRIFT_TRACKS = ("chaos", "pipe", "sync")


def drift_report(recorder, track: Optional[str] = None) -> Dict[str, Any]:
    """Predicted-vs-measured drift per op kind over a flight-recorder run.

    Pairs each op's *simulated* duration on one clock track (``op`` events,
    default: the primary track — ``chaos`` if present, else ``pipe``) with
    its *measured* backend wall time (``retire`` events carrying ``wall_s``,
    recorded when ``Executor.profile_sync`` timed the kernel).  Drift is
    ``|ln(predicted_s / measured_s)|`` — symmetric and robust when the
    hand-picked constants are orders of magnitude off; 0 means the clocks
    predict measured time exactly.  Ops without a timed retirement are
    ignored, so the report is meaningful only for profiled runs."""
    measured: Dict[Any, float] = {}
    kinds: Dict[Any, str] = {}
    sim_by_track: Dict[str, Dict[Any, float]] = {}
    for ev in recorder.iter_events():
        if ev.kind == "retire":
            wall = ev.args.get("wall_s", 0.0)
            if wall > 0.0:
                measured[ev.args["out"]] = wall
                kinds[ev.args["out"]] = ev.name
        elif ev.kind == "op":
            sim_by_track.setdefault(ev.args["track"], {})[
                ev.args["out"]] = max(ev.t1 - ev.t0, 0.0)
    if track is None:
        track = next((t for t in _DRIFT_TRACKS if t in sim_by_track),
                     "pipe")
    sim = sim_by_track.get(track, {})
    per_kind: Dict[str, Dict[str, float]] = {}
    tot_pred = tot_meas = 0.0
    for out, wall in measured.items():
        pred = sim.get(out)
        if pred is None:
            continue
        row = per_kind.setdefault(kinds[out], {
            "n": 0, "predicted_s": 0.0, "measured_s": 0.0})
        row["n"] += 1
        row["predicted_s"] += pred
        row["measured_s"] += wall
        tot_pred += pred
        tot_meas += wall

    def _drift(pred: float, meas: float) -> float:
        if pred <= 0.0 or meas <= 0.0:
            return float("inf") if pred != meas else 0.0
        return abs(math.log(pred / meas))

    for row in per_kind.values():
        row["drift"] = _drift(row["predicted_s"], row["measured_s"])
    return {
        "track": track,
        "n_ops": sum(r["n"] for r in per_kind.values()),
        "predicted_s": tot_pred,
        "measured_s": tot_meas,
        "drift": _drift(tot_pred, tot_meas),
        "per_kind": {k: per_kind[k] for k in sorted(per_kind)},
    }


def drift_lines(report: Dict[str, Any]) -> List[str]:
    """Human-readable drift table (one line per op kind plus a total)."""
    out = [f"{'op kind':<16} {'n':>5} {'predicted_s':>12} "
           f"{'measured_s':>12} {'drift':>8}"]
    rows = list(report.get("per_kind", {}).items())
    rows.append(("TOTAL", {"n": report.get("n_ops", 0),
                           "predicted_s": report.get("predicted_s", 0.0),
                           "measured_s": report.get("measured_s", 0.0),
                           "drift": report.get("drift", 0.0)}))
    for kind, r in rows:
        out.append(f"{kind:<16} {r['n']:>5} {r['predicted_s']:>12.3e} "
                   f"{r['measured_s']:>12.3e} {r['drift']:>8.3f}")
    return out


def summary_line(analysis: Dict[str, Any],
                 path: Optional[str] = None) -> str:
    """One-line trace summary for driver reports."""
    stall = analysis.get("top_stall", "none")
    pct = analysis.get("breakdown_pct", {}).get(stall, 0.0)
    where = f" -> {path}" if path else ""
    return (f"# trace: {analysis.get('events', 0)} events, critical path "
            f"{analysis.get('critical_path_len', 0)} ops, top stall "
            f"{stall} ({pct:.1f}%){where}")
