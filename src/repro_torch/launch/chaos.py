"""Chaos scenario driver: the logreg-Newton workload under live fault
injection, with optional mid-workload elastic resize and synthetic serving
traffic — the composed "production story" behind every fault-tolerance claim.

    PYTHONPATH=src python -m repro_torch.launch.chaos --nodes 8 --iters 3 \
        --fail-nodes 1 --stragglers 2 --slowdown 4 --fault-prob 0.02
    PYTHONPATH=src python -m repro_torch.launch.chaos --resize-to 6 --traffic 2
    PYTHONPATH=src python -m repro_torch.launch.chaos --fail-nodes 2 \
        --correlated-kill --mem-budget 0.6 --oom-at 0.5 --assert-gate
    PYTHONPATH=src python -m repro_torch.launch.chaos --device cpu --assert-gate
    PYTHONPATH=src python -m repro_torch.launch.blocks --chaos   # same scenario

Blocks live on the card (``--backend cuda --device cuda``, the defaults:
every 2-D block product, replays and speculative copies included, goes
through the hand-written Hopper matmul kernel) unless ``--device cpu`` or
``--backend numpy`` is given; blocks are float64.

Every scenario runs **twice with identical host-side decisions** — once
fault-free (an empty ChaosPlan on the same chaos clock, so makespans are
apples-to-apples) and once under the injected plan — and asserts the model
coefficients and served-traffic checksum are **bit-identical**: scheduling is
chaos-independent (see ``core.chaos``), so retries, speculation, node death +
lineage replay, and re-routing may move work but can never change values.  A
third run re-executes the chaos leg to check the determinism contract:
same seed + same ChaosPlan ⇒ same chaos makespan, same retry counts, same
speculation decisions.

The fault-free vs degraded chaos-makespan ratio is the gate
(``--assert-gate``): 1 dead node + 2 stragglers (4x) must degrade the
pipelined makespan by ≤ 50%.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np

from repro_torch.core import ArrayContext, ChaosPlan, ClusterSpec, RetryPolicy
from repro_torch.core.elastic import elastic_relayout
from repro_torch.glm.newton import _single_block_binary


def _newton_iteration(ctx, X, y, beta, eye):
    """One ridge-regularized Newton step (the Fig. 15 iteration body)."""
    mu = (X @ beta).sigmoid().compute()
    g = (X.T @ (mu - y)).compute()
    w = (mu * (1.0 - mu)).compute()
    H = ((X.T @ (w * X).compute()) + eye).compute()
    delta = _single_block_binary(ctx, "solve", H, g).compute()
    return (beta - delta).compute()


def run_scenario(
    plan: ChaosPlan,
    *,
    nodes: int = 8,
    workers: int = 2,
    backend: str = "cuda",
    device: Optional[str] = None,
    n: Optional[int] = None,
    d: int = 32,
    iters: int = 3,
    seed: int = 0,
    chaos_seed: int = 0,
    scheduler: str = "lshs",
    plan_cache: bool = False,
    retry: Optional[RetryPolicy] = None,
    resize_to: Optional[int] = None,
    resize_at: Optional[int] = None,
    traffic: int = 0,
    mem_capacity: Optional[float] = None,
    gc: bool = False,
    trace: bool = False,
    controller=None,
    calibration=None,
) -> Dict:
    """One full scenario run under ``plan``: ``iters`` Newton iterations on
    an (n, d) design matrix split over ``2 * nodes`` row blocks, with an
    optional elastic resize to ``resize_to`` nodes after iteration
    ``resize_at`` (default: the middle one) and ``traffic`` synthetic
    serving requests (seeded ragged decode-shaped matmuls) interleaved per
    iteration.  Host-side decisions (sizes, seeds, traffic trace) are pure
    functions of the arguments — never of the plan — so two runs that differ
    only in ``plan`` are output-bit-comparable.

    ``controller`` closes the elastic loop: pass an
    ``repro_torch.obs.controller.ObservedLoadController`` and the driver consults
    it at every iteration boundary instead of taking a resize point — the
    controller's grow/shrink/rebalance decisions trigger ``elastic_relayout``
    autonomously (its decision signals are all deterministic simulated
    quantities, so controller-driven runs keep the determinism contract).
    ``calibration`` is forwarded to ``ArrayContext`` (a profile object or
    path) so every clock track predicts measured time.  ``backend`` and
    ``device`` are the context's (default: the card); blocks are float64 on
    every backend, as the reference's numpy blocks are.
    """
    n = n or 64 * nodes
    q = 2 * nodes
    ctx = ArrayContext(
        cluster=ClusterSpec(nodes, workers), node_grid=(nodes, 1),
        scheduler=scheduler, backend=backend, pipeline=True, seed=seed,
        dtype="float64", device=device,
        plan_cache=plan_cache, mem_capacity=mem_capacity,
        gc=True if gc else None, trace=trace, calibration=calibration,
    )
    engine = ctx.enable_chaos(plan, seed=chaos_seed, retry=retry)
    if controller is not None:
        controller.attach(ctx)
    X = ctx.random((n, d), grid=(q, 1))
    y = ctx.uniform((n, 1), grid=(q, 1))
    beta = ctx.zeros((d, 1), grid=(1, 1))
    eye = ctx.from_numpy(1e-3 * np.eye(d), grid=(1, 1))
    W = ctx.random((d, d), grid=(1, 1)) if traffic else None
    # serving-batcher synthetic traffic: a seeded trace of ragged
    # micro-batch row counts, drawn up-front so the request schedule is a
    # function of (seed, iters, traffic) alone
    traffic_rng = np.random.default_rng(seed * 7919 + 17)
    trace = [[int(traffic_rng.integers(1, 9)) for _ in range(traffic)]
             for _ in range(iters)]
    served = 0
    checksum = 0.0
    relayout_moved = 0
    resize_at = iters // 2 if resize_at is None else resize_at
    for it in range(iters):
        beta = _newton_iteration(ctx, X, y, beta, eye)
        for rows in trace[it]:
            Xq = ctx.from_numpy(
                traffic_rng.standard_normal((rows, d)), grid=(1, 1))
            out = (Xq @ W).sigmoid().compute().to_numpy()
            served += 1
            checksum += float(out.sum())
        if resize_to and it == resize_at and resize_to != ctx.cluster.num_nodes:
            persist = [X, y, beta, eye] + ([W] if W is not None else [])
            ctx, arrs, relayout_moved = elastic_relayout(
                ctx, persist, ClusterSpec(resize_to, workers),
                new_node_grid=(resize_to, 1), scheduler=scheduler)
            X, y, beta, eye = arrs[:4]
            if W is not None:
                W = arrs[4]
        if controller is not None:
            # observed-load autoscaling: the controller decides, the driver
            # relays out (array handles stay owned by this loop); a
            # rebalance keeps the node count but re-homes drifted blocks
            # onto a fresh hierarchical layout.  The iteration boundary is
            # the sync point — drain first so drain-side signals (dead
            # nodes, memory pressure) are fresh, not end-of-run stale.
            ctx.flush()
            action = controller.decide(it)
            if action is not None:
                persist = [X, y, beta, eye] + ([W] if W is not None else [])
                ctx, arrs, mv = elastic_relayout(
                    ctx, persist, ClusterSpec(action.to_nodes, workers),
                    new_node_grid=(action.to_nodes, 1), scheduler=scheduler)
                relayout_moved += mv
                X, y, beta, eye = arrs[:4]
                if W is not None:
                    W = arrs[4]
                controller.attach(ctx)
    ctx.flush()
    out_beta = beta.to_numpy()
    return {
        "beta": out_beta,
        "served": served,
        "checksum": checksum,
        "relayout_moved": relayout_moved,
        "engine": engine,
        "ctx": ctx,
        "chaos_makespan": engine.makespan(),
        "nominal_makespan": ctx.state.makespan(pipeline=True),
        "memory": ctx.executor.memory.snapshot(),
        "controller": controller.report() if controller is not None else None,
    }


def run_chaos_scenario(
    *,
    nodes: int = 8,
    workers: int = 2,
    backend: str = "cuda",
    device: Optional[str] = None,
    n: Optional[int] = None,
    d: int = 32,
    iters: int = 3,
    seed: int = 0,
    chaos_seed: int = 0,
    fail_nodes: int = 1,
    stragglers: int = 2,
    slowdown: float = 4.0,
    fault_prob: float = 0.02,
    link_degradation: float = 1.0,
    fail_at_frac: float = 0.4,
    speculation: bool = True,
    spec_threshold: float = 1.5,
    resize_to: Optional[int] = None,
    resize_at: Optional[int] = None,
    traffic: int = 0,
    scheduler: str = "lshs",
    plan_cache: bool = False,
    check_determinism: bool = True,
    mem_budget: Optional[float] = None,
    oom_at: Optional[float] = None,
    oom_factor: float = 0.5,
    correlated_kill: bool = False,
    trace_path: Optional[str] = None,
    controller: bool = False,
    controller_policy=None,
    calibration=None,
) -> Dict:
    """Fault-free vs chaos comparison on one scenario (module docstring).

    Builds a ChaosPlan with ``fail_nodes`` node deaths (highest node ids,
    timed at ``fail_at_frac`` × the fault-free chaos makespan), ``stragglers``
    slowed nodes (ids 1..stragglers at ``slowdown``×), per-dispatch transient
    faults and link degradation; runs the fault-free reference, the chaos
    leg, and (optionally) a determinism re-run.  Returns a flat JSON-able
    report — ``identical``, ``deterministic``, ``makespan_ratio`` and the
    chaos counters are the gate's inputs.

    Memory-bounded variants: ``mem_budget`` caps each node at that fraction
    of the fault-free *unbudgeted, un-GC'd* leg's peak residency — the
    budgeted leg turns refcount GC on, so freeing dead intermediates does
    most of the work and spill/backpressure handles the tail (enforcement
    never overshoots); ``oom_at`` shrinks node 0's budget to ``oom_factor``
    × capacity at that fraction of the fault-free makespan;
    ``correlated_kill`` merges the ``fail_nodes`` deaths into one correlated
    blast-radius group killed — and recovered — together.

    ``controller=True`` attaches an ``ObservedLoadController`` to the chaos
    leg (and the determinism re-run — a fresh instance with the same policy)
    so elastic resizes are decided from observed load instead of a resize
    parameter; the two legs' action streams must match for ``deterministic``
    to hold.  The fault-free reference leg stays controller-free.
    ``calibration`` (profile object or path) calibrates every leg's clocks.
    """
    use_mem = mem_budget is not None or oom_at is not None
    kw = dict(nodes=nodes, workers=workers, backend=backend, device=device,
              n=n, d=d,
              iters=iters, seed=seed, chaos_seed=chaos_seed,
              scheduler=scheduler, plan_cache=plan_cache,
              resize_to=resize_to, resize_at=resize_at, traffic=traffic,
              calibration=calibration)

    def _controller():
        if not controller:
            return None
        from repro_torch.obs.controller import ObservedLoadController

        return ObservedLoadController(policy=controller_policy)

    base = run_scenario(ChaosPlan(speculation=speculation,
                                  spec_threshold=spec_threshold), **kw)
    base_mk = base["chaos_makespan"]
    # retry backoff scaled to the workload: first backoff ~ one average op
    retry = RetryPolicy(backoff_base=base_mk / max(
        base["ctx"].executor.stats.n_queued, 1))
    capacity = None
    if mem_budget is not None:
        capacity = max(mem_budget * base["memory"]["mem_peak_live_elements"],
                       1.0)
    ooms = ()
    if oom_at is not None:
        # node 0 is never in the kill set (deaths take the highest ids)
        ooms = ((0, oom_at * base_mk, oom_factor),)
    failures = {nodes - 1 - i: fail_at_frac * base_mk for i in range(fail_nodes)}
    slow = {1 + i: slowdown for i in range(stragglers)}
    plan = ChaosPlan(
        node_failures=() if correlated_kill else tuple(failures.items()),
        correlated_failures=(((fail_at_frac * base_mk,
                               tuple(sorted(failures))),)
                             if correlated_kill and failures else ()),
        stragglers=tuple(slow.items()),
        transient_fault_prob=fault_prob,
        link_degradation=link_degradation,
        speculation=speculation,
        spec_threshold=spec_threshold,
        oom_events=ooms,
    )
    # only the chaos leg is traced; the fault-free leg and the determinism
    # re-run stay untraced, so ``identical`` / ``deterministic`` double as
    # live assertions that the recorder changed no bits and no clocks
    chaos = run_scenario(plan, retry=retry, mem_capacity=capacity,
                         gc=use_mem, trace=trace_path is not None,
                         controller=_controller(), **kw)
    # bit-identity needs matching elastic trajectories: a controller-driven
    # resize the fault-free leg never takes changes block summation order at
    # float-noise level (~1e-17 abs), so when the controller actually fired
    # the value gate drops to a tight allclose — while the determinism
    # re-run below (same trajectory) stays bitwise
    traj_diverged = controller and chaos["controller"]["n_actions"] > 0
    beta_match = (
        np.allclose(base["beta"], chaos["beta"], rtol=1e-9, atol=1e-12)
        if traj_diverged
        else base["beta"].tobytes() == chaos["beta"].tobytes()
    )
    identical = (
        beta_match
        and base["served"] == chaos["served"]
        and base["checksum"] == chaos["checksum"]
    )
    deterministic = True
    if check_determinism:
        rerun = run_scenario(plan, retry=retry, mem_capacity=capacity,
                             gc=use_mem, controller=_controller(), **kw)
        deterministic = (
            rerun["chaos_makespan"] == chaos["chaos_makespan"]
            and rerun["engine"].stats == chaos["engine"].stats
            and rerun["beta"].tobytes() == chaos["beta"].tobytes()
            and rerun["memory"] == chaos["memory"]
            and rerun["controller"] == chaos["controller"]
        )
    stats = chaos["engine"].stats
    report = {
        "nodes": nodes, "workers": workers, "backend": backend,
        "device": device,
        "n": n or 64 * nodes, "d": d, "iters": iters,
        "fail_nodes": fail_nodes, "stragglers": stragglers,
        "slowdown": slowdown, "fault_prob": fault_prob,
        "link_degradation": link_degradation,
        "resize_to": resize_to, "traffic": traffic,
        "served": chaos["served"],
        "relayout_moved": chaos["relayout_moved"],
        "makespan_faultfree": base_mk,
        "makespan_chaos": chaos["chaos_makespan"],
        "makespan_ratio": chaos["chaos_makespan"] / max(base_mk, 1e-300),
        "makespan_nominal_pipelined": chaos["nominal_makespan"],
        "identical": identical,
        "deterministic": deterministic,
        "mem_budget": mem_budget,
        "mem_budget_capacity": capacity,
        "oom_at": oom_at,
        "oom_factor": oom_factor if oom_at is not None else None,
        "correlated_kill": bool(correlated_kill),
    }
    report.update(stats.as_dict())
    report.update(chaos["memory"])
    report["chaos_dead_nodes"] = sorted(chaos["engine"].dead)
    if controller:
        cr = chaos["controller"]
        report["controller_actions"] = cr["actions"]
        report["controller_n_actions"] = cr["n_actions"]
        report["controller_n_samples"] = cr["n_samples"]
        report["controller_final_nodes"] = chaos["ctx"].cluster.num_nodes
    if trace_path is not None:
        from repro_torch.obs import analyze, top_segments

        doc = chaos["ctx"].export_trace(trace_path)
        a = analyze(doc)
        report["trace"] = {
            "path": trace_path,
            "events": a["events"],
            "dropped": a["dropped"],
            "critical_path_len": a["critical_path_len"],
            "top_stall": a["top_stall"],
            "breakdown_pct": a["breakdown_pct"],
            "decomposition_total_pct": a["decomposition_total_pct"],
            "segments": top_segments(a),
        }
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--backend", default="cuda",
                    choices=("numpy", "torch", "cuda"),
                    help="block-kernel execution backend: numpy, torch = "
                         "torch ops on device tensors, cuda = torch + the "
                         "hand-written Hopper matmul kernel")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where torch/cuda blocks live (cpu runs the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--n", type=int, default=None,
                    help="design-matrix rows (default 64 * nodes)")
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--fail-nodes", type=int, default=1,
                    help="nodes killed mid-run (highest ids)")
    ap.add_argument("--stragglers", type=int, default=2)
    ap.add_argument("--slowdown", type=float, default=4.0)
    ap.add_argument("--fault-prob", type=float, default=0.02)
    ap.add_argument("--link-degradation", type=float, default=1.0)
    ap.add_argument("--fail-at-frac", type=float, default=0.4)
    ap.add_argument("--no-speculation", dest="speculation",
                    action="store_false")
    ap.add_argument("--spec-threshold", type=float, default=1.5)
    ap.add_argument("--resize-to", type=int, default=None,
                    help="elastic resize to this node count mid-run")
    ap.add_argument("--resize-at", type=int, default=None)
    ap.add_argument("--traffic", type=int, default=0,
                    help="synthetic serving requests per iteration")
    ap.add_argument("--scheduler", default="lshs",
                    choices=("lshs", "lshs+", "roundrobin", "dynamic"))
    ap.add_argument("--plan-cache", dest="plan_cache", action="store_true")
    ap.add_argument("--mem-budget", dest="mem_budget", type=float,
                    default=None,
                    help="per-node budget as a fraction of the fault-free "
                         "leg's peak residency (e.g. 0.6); enforcement "
                         "backpressures instead of overshooting")
    ap.add_argument("--oom-at", dest="oom_at", type=float, default=None,
                    help="inject an OOM on node 0 at this fraction of the "
                         "fault-free makespan (budget shrinks to "
                         "--oom-factor x capacity)")
    ap.add_argument("--oom-factor", dest="oom_factor", type=float,
                    default=0.5)
    ap.add_argument("--correlated-kill", dest="correlated_kill",
                    action="store_true",
                    help="kill the --fail-nodes set as one correlated group "
                         "(rack loss) instead of independent deaths")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a flight-recorder trace of the chaos leg "
                         "and write Chrome/Perfetto trace_event JSON to PATH "
                         "(inspect with python -m repro_torch.launch.trace_report)")
    ap.add_argument("--controller", action="store_true",
                    help="observed-load autoscaling: an "
                         "ObservedLoadController decides grow/shrink/"
                         "rebalance from sampled metrics instead of "
                         "--resize-to/--resize-at")
    ap.add_argument("--calibrate", action="store_true",
                    help="micro-profile the live backend first and run all "
                         "legs with the fitted cost profile (writes it to "
                         "--profile PATH when given)")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="calibration profile JSON: loaded (or, with "
                         "--calibrate, written) and applied to every leg's "
                         "cost model")
    ap.add_argument("--assert-gate", action="store_true",
                    help="exit nonzero unless identical + deterministic and "
                         "makespan_ratio <= 1.5 (<= 2.0 with --mem-budget/"
                         "--oom-at/--controller: backpressure stalls and "
                         "elastic-relayout transfer are expected), with "
                         "zero budget violations and, with --controller, "
                         ">= 1 autonomous action")
    args = ap.parse_args()
    calibration = None
    if args.calibrate:
        from repro_torch.obs.calibrate import run_calibration

        calibration = run_calibration(backend=args.backend,
                                      device=args.device,
                                      nodes=min(args.nodes, 4),
                                      workers=args.workers, seed=args.seed)
        if args.profile:
            calibration.save(args.profile)
    elif args.profile:
        calibration = args.profile
    report = run_chaos_scenario(
        nodes=args.nodes, workers=args.workers, backend=args.backend,
        device=args.device, n=args.n, d=args.d, iters=args.iters, seed=args.seed,
        chaos_seed=args.chaos_seed, fail_nodes=args.fail_nodes,
        stragglers=args.stragglers, slowdown=args.slowdown,
        fault_prob=args.fault_prob, link_degradation=args.link_degradation,
        fail_at_frac=args.fail_at_frac, speculation=args.speculation,
        spec_threshold=args.spec_threshold, resize_to=args.resize_to,
        resize_at=args.resize_at, traffic=args.traffic,
        scheduler=args.scheduler, plan_cache=args.plan_cache,
        mem_budget=args.mem_budget, oom_at=args.oom_at,
        oom_factor=args.oom_factor, correlated_kill=args.correlated_kill,
        trace_path=args.trace, controller=args.controller,
        calibration=calibration,
    )
    print(json.dumps(report, indent=2, default=float))
    tr = report.get("trace")
    if tr is not None:
        print(f"# trace: {tr['events']} events -> {tr['path']}, critical "
              f"path {tr['critical_path_len']} ops, top stall "
              f"{tr['top_stall']} "
              f"({tr['breakdown_pct'].get(tr['top_stall'], 0.0):.1f}%)")
    if args.assert_gate:
        budgeted = args.mem_budget is not None or args.oom_at is not None
        # budgeted runs stall on backpressure, controller runs pay real
        # elastic-relayout transfer: both get the relaxed limit
        limit = 2.0 if budgeted or args.controller else 1.5
        ok = (report["identical"] and report["deterministic"]
              and report["makespan_ratio"] <= limit
              and (not budgeted or report["mem_violations"] == 0)
              and (not args.controller
                   or report["controller_n_actions"] >= 1))
        if not ok:
            if tr is not None:
                # where did the time go? the top critical-path segments
                # are the first thing to look at when the gate trips
                print("# gate failure: top critical-path segments:")
                for seg in tr["segments"]:
                    print(f"#   {seg}")
            raise SystemExit("chaos gate FAILED: "
                             f"identical={report['identical']} "
                             f"deterministic={report['deterministic']} "
                             f"ratio={report['makespan_ratio']:.3f} "
                             f"(limit {limit}) "
                             f"violations={report['mem_violations']}")


if __name__ == "__main__":
    main()
