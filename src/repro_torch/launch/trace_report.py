"""Critical-path report over a ``--trace`` JSON artifact.

    python -m repro_torch.launch.trace_report out.json [--top N] [--json]

Prints event counts, per-track makespans, the makespan decomposition
(compute / transfer / queue-stall / retry / eviction-stall, total and per
node), a per-op-kind duration distribution (n / p50 / p95 / p99 / max over
the primary track's op slices, via ``repro_torch.obs.metrics.Histogram``),
the same per op kind of the *host* wall each executed op took (n / total /
p50 / p95 / p99 / max of its ``retire`` time: the backend's dispatch of the
op on an asynchronous device, its whole time under ``profile_sync``) and the
longest critical-path segments.  ``--json`` dumps the raw analysis dict
instead (for scripting).  The input is the Chrome/Perfetto trace written by
``ArrayContext.export_trace`` or the launch drivers' ``--trace PATH`` — the
same file Perfetto renders (see ``repro_torch.core.trace`` for the import path).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.critical_path import BUCKETS, analyze, summary_line, top_segments
from repro_torch.obs.metrics import Histogram

_US = 1e6
#: host-wall buckets: 20 per decade from 0.1 µs to 100 s (12% apart)
WALL_BOUNDS = tuple(10.0 ** (k / 20) for k in range(-140, 41))


def op_histograms(trace: dict) -> dict:
    """Per-op-kind duration histograms over the primary track's op slices.
    Returns ``{kind: Histogram}`` with durations in seconds."""
    hists: dict = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X" or ev.get("cat") != "op":
            continue
        kind = ev.get("name", "?")
        h = hists.get(kind)
        if h is None:
            h = hists[kind] = Histogram(kind)
        h.observe(ev.get("dur", 0.0) / _US)
    return hists


def wall_histograms(trace: dict) -> dict:
    """Per-op-kind histograms of the host wall seconds of every executed op
    (the ``wall_s`` the exporter copies from its ``retire`` event).  Empty
    for a sim-backend trace, which executes nothing."""
    hists: dict = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X" or ev.get("cat") != "op":
            continue
        wall = ev.get("args", {}).get("wall_s")
        if wall is None:
            continue
        kind = ev.get("name", "?")
        h = hists.get(kind)
        if h is None:
            h = hists[kind] = Histogram(kind, bounds=WALL_BOUNDS)
        h.observe(wall)
    return hists


def wall_lines(hists: dict) -> list:
    """The host-wall table: exact n, total and max; quantiles bucketed (the
    upper bound of a 12%-wide bucket, capped at the max)."""
    if not hists:
        return []
    lines = ["# host wall per executed op (s; quantiles bucketed 12%):",
             f"#   {'op kind':<16} {'n':>6} {'total':>10} {'p50':>10} "
             f"{'p95':>10} {'p99':>10} {'max':>10}"]
    for kind, st in histogram_stats(hists, clamp=True).items():
        lines.append(
            f"#   {kind:<16} {st['n']:>6} {st['sum_s']:>10.3e} "
            f"{st['p50']:>10.3e} {st['p95']:>10.3e} {st['p99']:>10.3e} "
            f"{st['max']:>10.3e}")
    return lines


def _q(h, q: float, clamp: bool) -> float:
    return min(h.quantile(q), h.max) if clamp else h.quantile(q)


def histogram_stats(hists: dict, clamp: bool = False) -> dict:
    """``{kind: {n, sum_s, p50, p95, p99, max}}`` of a histogram dict;
    ``clamp`` caps each bucketed quantile at the observed max."""
    return {kind: {"n": h.count, "sum_s": h.sum, "p50": _q(h, 0.5, clamp),
                   "p95": _q(h, 0.95, clamp), "p99": _q(h, 0.99, clamp),
                   "max": h.max}
            for kind, h in sorted(hists.items())}


def histogram_lines(hists: dict) -> list:
    """The op-duration distribution table (bucketed quantiles: each value is
    the histogram bucket's upper bound, like the metrics snapshots)."""
    if not hists:
        return []
    lines = [f"# op durations (s, bucketed quantiles):",
             f"#   {'op kind':<16} {'n':>6} {'p50':>10} {'p95':>10} "
             f"{'p99':>10} {'max':>10}"]
    for kind in sorted(hists):
        h = hists[kind]
        lines.append(
            f"#   {kind:<16} {h.count:>6} {h.quantile(0.5):>10.3e} "
            f"{h.quantile(0.95):>10.3e} {h.quantile(0.99):>10.3e} "
            f"{h.max:>10.3e}")
    return lines


def render(analysis: dict, trace: dict, top: int = 3) -> str:
    lines = []
    other = trace.get("otherData", {})
    lines.append(summary_line(analysis))
    counts = other.get("event_counts", {})
    if counts:
        lines.append("# events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counts.items())))
    if analysis.get("dropped"):
        lines.append(f"# ring buffer dropped {analysis['dropped']} events "
                     "(oldest first) — raise the trace capacity for full "
                     "attribution")
    makespans = other.get("makespans", {})
    if makespans:
        lines.append("# makespans: " + ", ".join(
            f"{t}={v:.6e}s" for t, v in sorted(makespans.items())))
    lines.append(f"# decomposition of {analysis['track']} makespan "
                 f"{analysis['makespan']:.6e}s "
                 f"(sums to {analysis['decomposition_total_pct']:.2f}%):")
    for b in BUCKETS:
        lines.append(f"#   {b:<15} {analysis['breakdown'][b]:.6e}s "
                     f"{analysis['breakdown_pct'][b]:6.2f}%")
    per_node = analysis.get("per_node_pct", {})
    if per_node:
        lines.append("# per-node share of makespan (%):")
        header = "  ".join(f"{b[:9]:>9}" for b in BUCKETS)
        lines.append(f"#   {'node':<6}{header}")
        for node, row in per_node.items():
            vals = "  ".join(f"{row[b]:9.2f}" for b in BUCKETS)
            lines.append(f"#   {node:<6}{vals}")
    lines.extend(histogram_lines(op_histograms(trace)))
    lines.extend(wall_lines(wall_histograms(trace)))
    segs = top_segments(analysis, n=top)
    if segs:
        lines.append(f"# top {len(segs)} critical-path segments:")
        lines.extend(f"#   {s}" for s in segs)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="critical-path report over a --trace JSON artifact")
    ap.add_argument("trace", help="trace_event JSON written by --trace")
    ap.add_argument("--top", type=int, default=3,
                    help="longest segments to print (default 3)")
    ap.add_argument("--json", action="store_true",
                    help="dump the analysis dict as JSON")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    analysis = analyze(trace)
    if args.json:
        analysis.pop("segments", None)
        analysis["op_durations"] = histogram_stats(op_histograms(trace))
        analysis["host_wall"] = histogram_stats(wall_histograms(trace),
                                                clamp=True)
        print(json.dumps(analysis, indent=2, default=float))
    else:
        print(render(analysis, trace, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
