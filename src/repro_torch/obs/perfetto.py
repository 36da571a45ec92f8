"""Chrome/Perfetto ``trace_event`` JSON export for flight-recorder traces.

Produces the classic ``{"traceEvents": [...]}`` format that both
https://ui.perfetto.dev ("Open trace file") and ``chrome://tracing`` load
directly (see the ``repro_torch.core.trace`` docstring for the import path).

Mapping:

* process (``pid``)  = simulated node, thread (``tid``) = worker lane; per
  node an extra ``net`` lane (``tid = 1000``) carries operand transfers.
* ``ph: "X"`` complete slices = simulated op executions on the *primary*
  clock track (``chaos`` when a chaos engine ran, else ``pipe``), with
  ``ts``/``dur`` in microseconds of simulated time (1 sim second = 1e6).
  Slice ``args`` keep the start-time breakdown (``w_busy``/``t_ready``/
  ``t_xfer``), operand ids, per-op backoff, the other tracks' intervals and,
  for an op a data-holding backend executed, its host wall (``wall_s``) —
  everything the critical-path analyzer needs, so the exported file is the
  single artifact for both humans and ``repro_torch.launch.trace_report``.
* ``ph: "s"``/``"f"`` flow arrows connect a producer's retirement to each
  consumer's start (one flow id per edge).
* ``cat: "stall"`` slices mark lane time lost to retries/backoff and
  memory stalls; ``ph: "i"`` instants flag evictions, GC frees, fault-ins,
  OOMs, speculation outcomes, replays, node deaths and cache hits.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

_US = 1e6  # simulated seconds -> trace_event microseconds
NET_TID = 1000  # per-node transfer lane

# event kinds rendered as lane stall slices (they carry [t0, t1] windows on
# a worker lane and are what the analyzer charges eviction/retry gaps to)
_STALL_KINDS = ("retry", "mem_stall")
# event kinds rendered as instant markers
_INSTANT_KINDS = (
    "evict_spill", "evict_drop", "fault_in", "gc_free", "oom",
    "backpressure", "spec_win", "spec_loss", "reroute", "node_death",
    "replay", "plan_hit", "plan_miss",
)

_TRACK_ORDER = ("chaos", "pipe", "sync")


def _op_names(events) -> Dict[int, str]:
    """out_id -> op name, from dispatch/create events."""
    names: Dict[int, str] = {}
    for ev in events:
        if ev.kind in ("dispatch", "create"):
            out = ev.args.get("out")
            if out is not None:
                names[out] = ev.name
    return names


def export_chrome_trace(
    recorder,
    makespans: Optional[Dict[str, float]] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Render a :class:`repro_torch.core.trace.FlightRecorder` to a trace_event
    document (a plain JSON-serializable dict)."""
    events = list(recorder.iter_events())
    names = _op_names(events)
    ops_by_track: Dict[str, List] = {}
    for ev in events:
        if ev.kind == "op":
            ops_by_track.setdefault(ev.args["track"], []).append(ev)
    primary = next((t for t in _TRACK_ORDER if t in ops_by_track), None)

    # per-op backoff (chaos retries charged immediately before the op)
    backoff: Dict[int, float] = {}
    for ev in events:
        if ev.kind == "retry":
            out = ev.args.get("out")
            if out is not None:
                backoff[out] = backoff.get(out, 0.0) + ev.args.get(
                    "backoff_s", 0.0)
    # other-track intervals per out id, attached to the primary slice args
    other_tracks: Dict[str, Dict[int, List[float]]] = {}
    for track, ops in ops_by_track.items():
        if track == primary:
            continue
        other_tracks[track] = {ev.args["out"]: [ev.t0, ev.t1] for ev in ops}
    # host wall seconds of each op's execution (``retire`` events): the
    # backend's dispatch of the op, or with ``profile_sync`` its whole time
    wall: Dict[int, float] = {}
    for ev in events:
        if ev.kind == "retire":
            out = ev.args.get("out")
            if out is not None:
                wall[out] = ev.args.get("wall_s", 0.0)
    # transfer byte counts per object (from ClusterState.transition events)
    xfer_bytes: Dict[int, int] = {}
    for ev in events:
        if ev.kind == "transfer":
            xfer_bytes[ev.args["obj"]] = ev.args["bytes"]

    out_events: List[Dict[str, Any]] = []
    pids: Dict[int, None] = {}
    tids: Dict[tuple, None] = {}

    def lane(pid: int, tid: int) -> None:
        pids.setdefault(pid, None)
        tids.setdefault((pid, tid), None)

    producers: Dict[int, List] = {}
    for ev in ops_by_track.get(primary, ()):
        producers.setdefault(ev.args["out"], []).append(ev)

    flow_id = 0
    for ev in ops_by_track.get(primary, ()):
        a = ev.args
        out = a["out"]
        lane(ev.node, ev.worker)
        args = {
            "out": out, "ins": list(a["ins"]), "track": primary,
            "w_busy": a["w_busy"], "t_ready": a["t_ready"],
            "t_xfer": a["t_xfer"], "ready_obj": a["ready_obj"],
            "work": a["work"], "backoff": backoff.get(out, 0.0),
            "xfers": [list(x) for x in a["xfers"]],
        }
        for track, spans in other_tracks.items():
            if out in spans:
                args[track] = spans[out]
        if out in wall:
            args["wall_s"] = wall[out]
        out_events.append({
            "name": names.get(out, f"op{out}"), "cat": "op", "ph": "X",
            "pid": ev.node, "tid": ev.worker, "ts": ev.t0 * _US,
            "dur": max(ev.t1 - ev.t0, 0.0) * _US, "args": args,
        })
        # transfer slices on the node's net lane
        for src, obj, elements, x0, x1 in a["xfers"]:
            lane(ev.node, NET_TID)
            out_events.append({
                "name": f"xfer obj{obj}", "cat": "transfer", "ph": "X",
                "pid": ev.node, "tid": NET_TID, "ts": x0 * _US,
                "dur": max(x1 - x0, 0.0) * _US,
                "args": {"src": src, "obj": obj, "elements": elements,
                         "bytes": xfer_bytes.get(obj), "consumer": out},
            })
        # flow arrows: producer retire -> this op's start
        tol = 1e-12 + 1e-9 * ev.t0
        for obj in a["ins"]:
            cands = [p for p in producers.get(obj, ())
                     if p is not ev and p.t1 <= ev.t0 + tol]
            if not cands:
                continue
            prod = cands[-1]
            flow_id += 1
            out_events.append({
                "name": "dep", "cat": "flow", "ph": "s", "id": flow_id,
                "pid": prod.node, "tid": prod.worker, "ts": prod.t1 * _US,
            })
            out_events.append({
                "name": "dep", "cat": "flow", "ph": "f", "bp": "e",
                "id": flow_id, "pid": ev.node, "tid": ev.worker,
                "ts": ev.t0 * _US,
            })

    for ev in events:
        if ev.kind in _STALL_KINDS and ev.t1 > ev.t0:
            lane(ev.node, ev.worker)
            out_events.append({
                "name": ev.kind, "cat": "stall", "ph": "X",
                "pid": ev.node, "tid": ev.worker, "ts": ev.t0 * _US,
                "dur": (ev.t1 - ev.t0) * _US,
                "args": {"kind": ev.kind, **ev.args},
            })
        elif ev.kind in _INSTANT_KINDS:
            pid = max(ev.node, 0)
            tid = max(ev.worker, 0)
            lane(pid, tid)
            out_events.append({
                "name": ev.kind, "cat": "marker", "ph": "i", "s": "t",
                "pid": pid, "tid": tid, "ts": max(ev.t0, 0.0) * _US,
                "args": dict(ev.args),
            })

    meta_events: List[Dict[str, Any]] = []
    for pid in sorted(pids):
        meta_events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "args": {"name": f"node {pid}"}})
        meta_events.append({"name": "process_sort_index", "ph": "M",
                            "pid": pid, "args": {"sort_index": pid}})
    for pid, tid in sorted(tids):
        label = "net" if tid == NET_TID else f"worker {tid}"
        meta_events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": label}})

    return {
        "traceEvents": meta_events + out_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "primary_track": primary,
            "tracks": sorted(ops_by_track),
            "makespans": dict(makespans or {}),
            "event_counts": recorder.counts(),
            "dropped": recorder.dropped,
            **(meta or {}),
        },
    }


def write_chrome_trace(path: str, recorder,
                       makespans: Optional[Dict[str, float]] = None,
                       meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    doc = export_chrome_trace(recorder, makespans=makespans, meta=meta)
    with open(path, "w") as f:
        json.dump(doc, f, default=float)
    return doc
