"""Block-runtime launch driver: run a GraphArray workload on a simulated
cluster with any scheduler, in sync or pipelined dispatch mode, and print the
per-node loads plus both simulated makespans (the overlap ablation).

    PYTHONPATH=src python -m repro_torch.launch.blocks --workload logreg \\
        --nodes 16 --workers 32 --scheduler lshs --pipeline
    PYTHONPATH=src python -m repro_torch.launch.blocks --workload dgemm --sync
    PYTHONPATH=src python -m repro_torch.launch.blocks --workload logreg \\
        --iters 10 --plan-cache
    PYTHONPATH=src python -m repro_torch.launch.blocks --device cpu \\
        --iters 10 --backend torch --gc --mem-capacity 2e5
    PYTHONPATH=src python -m repro_torch.launch.blocks --workload cpals \\
        --iters 3 --plan-cache --reshard-method naive

Blocks live on the card (``--device cuda``, the default) unless
``--device cpu`` is given; ``--backend cuda`` (the default) sends every 2-D
block product through the hand-written Hopper matmul kernel.

``--iters N`` runs the workload as an N-iteration loop (the Newton loop for
logreg, repeated C = A @ B for dgemm, N CP-ALS sweeps for cpals, whose
layout changes ``--reshard-method`` picks) — the iterative regime where
``--plan-cache`` amortizes scheduling: iteration 1 cold-schedules and records
placement plans, later iterations replay them.  The report includes the
plan-cache hit/miss counts and the scheduler-overhead vs dispatch-time split.

The ``--fail-node`` flag injects a node failure while pipelined ops are
still queued, then recovers from lineage — the fault-tolerance path of the
async executor.

``--chaos`` delegates to the full chaos scenario driver (``launch.chaos``):
stragglers + live node death + transient faults composed on the logreg-Newton
loop, with a fault-free reference run and bit-identity / determinism checks.
``--trace PATH`` writes the run's flight-recorder trace as Perfetto JSON
(``python -m repro_torch.launch.trace_report PATH`` summarizes it);
``--calibrate`` fits a cost profile on the live backend first (written to
``--profile PATH`` when given) and ``--profile PATH`` alone applies one.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core import ArrayContext, ClusterSpec
from repro_torch.launch.workloads import (
    cpals_loop,
    dgemm_graph,
    dgemm_loop,
    logreg_newton_graph,
    logreg_newton_loop,
)


def build_workload(ctx: ArrayContext, workload: str, scale: int, iters: int = 1,
                   reshard_method: str = "reshard"):
    if workload == "logreg":
        n, d, q = 1 << (10 + scale), 64, 8 * ctx.cluster.num_nodes
        if iters > 1:
            _g, H, _beta = logreg_newton_loop(ctx, n, d, q, iters=iters)
            return H
        _g, H = logreg_newton_graph(ctx, n, d, q)
        return H
    if workload == "dgemm":
        dim, g = 256 << scale, 2 * int(np.sqrt(ctx.cluster.num_nodes))
        if iters > 1:
            return dgemm_loop(ctx, dim, g, iters=iters)
        return dgemm_graph(ctx, dim, g)
    if workload == "cpals":
        dim = 16 << scale
        return cpals_loop(ctx, dim, rank=8, q=ctx.cluster.num_nodes,
                          iters=max(iters, 1), method=reshard_method)
    raise ValueError(f"unknown workload {workload!r}")



def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", default="logreg",
                    choices=("logreg", "dgemm", "cpals"))
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--scheduler", default="lshs",
                    choices=("lshs", "lshs+", "roundrobin", "dynamic"))
    ap.add_argument("--backend", default="cuda",
                    choices=("sim", "numpy", "torch", "cuda"),
                    help="block-kernel execution backend (repro_torch.backend): "
                         "sim = metadata only, numpy = reference interpreter, "
                         "torch = torch ops on device tensors, cuda = torch + "
                         "the hand-written Hopper matmul kernel")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where torch/cuda blocks live (cpu runs the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "float64"),
                    help="block dtype (default: the backend's natural dtype "
                         "— float64 for numpy, float32 for torch/cuda)")
    ap.add_argument("--scale", type=int, default=2, help="log2 size multiplier")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=1,
                    help="iterations of the workload loop (>1 makes the "
                         "graphs structurally repeat, the plan-cache regime)")
    ap.add_argument("--reshard-method", default="reshard",
                    choices=("reshard", "naive"),
                    help="cpals layout changes: locality-aware move graphs "
                         "vs the all-to-all gather/scatter baseline")
    ap.add_argument("--plan-cache", dest="plan_cache", action="store_true",
                    help="cache placement plans by structural fingerprint "
                         "and replay them on repeat graphs")
    ap.add_argument("--auto-layout", dest="auto_layout", action="store_true",
                    help="per-array node grids from default_node_grid "
                         "instead of the context-wide node grid")
    ap.add_argument("--gc", action="store_true",
                    help="refcount GC of dead intermediates: frees store "
                         "entries when the last consumer retires (freed "
                         "blocks replay from lineage if read late)")
    ap.add_argument("--mem-capacity", dest="mem_capacity", type=float,
                    default=None,
                    help="per-node memory budget in elements: dispatches "
                         "over the high watermark backpressure and evict "
                         "(spill-vs-recompute) down to the low watermark")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--pipeline", dest="pipeline", action="store_true",
                       help="queue ops and drain via the async event loop")
    group.add_argument("--sync", dest="pipeline", action="store_false",
                       help="dispatch every op eagerly (seed behavior)")
    ap.set_defaults(pipeline=True)
    ap.add_argument("--fail-node", type=int, default=None,
                    help="inject a node failure mid-run, then recover from "
                         "lineage (any data-holding backend: numpy/torch/cuda)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a flight-recorder trace and write "
                         "Chrome/Perfetto trace_event JSON to PATH (inspect "
                         "with python -m repro_torch.launch.trace_report PATH)")
    ap.add_argument("--chaos", action="store_true",
                    help="run the composed chaos scenario instead "
                         "(launch.chaos: stragglers + node death + transient "
                         "faults on logreg-Newton, fault-free comparison)")
    ap.add_argument("--calibrate", action="store_true",
                    help="micro-profile the live backend (repro_torch.obs."
                         "calibrate) and run with the fitted cost profile; "
                         "writes the profile JSON to --profile PATH if given")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="calibration profile JSON to apply to the cost "
                         "model (written instead when --calibrate is set)")
    args = ap.parse_args()

    calibration = None
    if args.calibrate:
        from repro_torch.obs.calibrate import run_calibration
        backend = "numpy" if args.backend == "sim" else args.backend
        calibration = run_calibration(backend=backend, device=args.device,
                                      dtype=args.dtype,
                                      nodes=min(args.nodes, 4),
                                      workers=min(args.workers, 2),
                                      seed=args.seed)
        if args.profile:
            calibration.save(args.profile)
            print(f"# calibration profile -> {args.profile}")
    elif args.profile:
        calibration = args.profile

    if args.chaos:
        from .chaos import run_chaos_scenario
        backend = "numpy" if args.backend == "sim" else args.backend
        report = run_chaos_scenario(
            nodes=args.nodes, workers=args.workers, backend=backend,
            device=args.device,
            iters=max(args.iters, 3), seed=args.seed,
            scheduler=args.scheduler, plan_cache=args.plan_cache,
            trace_path=args.trace, calibration=calibration,
        )
        print(json.dumps(report, indent=2, default=float))
        tr = report.get("trace")
        if tr is not None:
            print(f"# trace: {tr['events']} events -> {tr['path']}, "
                  f"critical path {tr['critical_path_len']} ops, top stall "
                  f"{tr['top_stall']}")
        return

    ctx = ArrayContext(
        cluster=ClusterSpec(args.nodes, args.workers),
        node_grid=(args.nodes, 1),
        scheduler=args.scheduler,
        backend=args.backend,
        dtype=args.dtype,
        seed=args.seed,
        pipeline=args.pipeline,
        plan_cache=args.plan_cache,
        auto_layout=args.auto_layout,
        mem_capacity=args.mem_capacity,
        gc=True if args.gc else None,
        trace=args.trace is not None,
        calibration=calibration,
        device=args.device,
    )
    out = build_workload(ctx, args.workload, args.scale, iters=args.iters,
                         reshard_method=args.reshard_method)

    if args.fail_node is not None:
        if args.backend == "sim":
            raise SystemExit("--fail-node needs a data-holding backend "
                             "(numpy/torch/cuda: there must be data to lose)")
        pending = ctx.executor.pending_count()
        lost = ctx.executor.fail_node(args.fail_node)
        replayed = ctx.executor.recover(
            [out.block(i).vid for i in out.grid.iter_indices()])
        print(f"# failed node {args.fail_node}: {len(lost)} blocks lost "
              f"({pending} ops were queued), {replayed} tasks replayed")

    ctx.flush()
    report = ctx.loads()
    if args.gc or args.mem_capacity is not None:
        print(f"# peak store: {report['mem_peak_store_blocks']:.0f} blocks / "
              f"{report['mem_peak_store_bytes']:.0f} bytes | gc freed "
              f"{report['mem_gc_freed_blocks']:.0f} blocks | "
              f"{report['mem_spills']:.0f} spills, "
              f"{report['mem_recompute_drops']:.0f} drops, "
              f"{report['mem_violations']:.0f} budget violations")
    report.update(
        workload=args.workload, scheduler=args.scheduler,
        pipeline=args.pipeline, nodes=args.nodes, workers=args.workers,
        n_queued=ctx.executor.stats.n_queued, iters=args.iters,
        plan_cache=args.plan_cache, backend=args.backend, dtype=ctx.dtype,
        device=args.device,
    )
    report.update(ctx.sched_stats.as_dict())
    print(json.dumps(report, indent=2, default=float))
    if args.trace is not None:
        from repro_torch.obs import analyze, summary_line

        doc = ctx.export_trace(args.trace)
        print(summary_line(analyze(doc), path=args.trace))


if __name__ == "__main__":
    main()
