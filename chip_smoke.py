"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the hand-written Hopper kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes and times
both (CUDA events), then drives the main path at full width — the paper's
logistic-regression Newton loop (n = 2**22 rows x 256 features, float64, 32
row blocks on a 4-node x 8-worker simulated cluster) and a 16384^2 block
DGEMM — on backend ``cuda`` (kernels) and on backend ``torch`` (plain torch
ops), and checks that both agree and schedule identically, that every 2-D
block product went through the matmul kernel, and that the runtime's bitwise
contracts hold on the card.  Each phase prints one JSON line; the kernel
line, the card's name and power limit, and a final ``{"ok": true, ...}``
line close the output.  Any failure raises and exits non-zero.

Needs one CUDA device; exits non-zero without printing a result where there
is none, or where ``src/repro_torch`` is not beside this script.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.glm_logreg import CONFIG  # noqa: E402
from repro_torch.core import ArrayContext, ClusterSpec  # noqa: E402
from repro_torch.kernels import build, launches, ops, reset_launches  # noqa: E402
from repro_torch.kernels.glm_fused import glm_fused_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul_ref  # noqa: E402
from repro_torch.launch.workloads import dgemm_graph, logreg_newton_loop  # noqa: E402

#: published peaks of one H100 SXM (dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 67e12, torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_NAME = {torch.float64: "FP64 tensor 67 TFLOP/s", torch.float32: "FP32 67 TFLOP/s",
             torch.bfloat16: "BF16 tensor 989 TFLOP/s"}
#: max |kernel - plain| / max(|plain|, 1): f64 sums in another order; f32
#: and bf16 are the reference's own test tolerances (tests/test_kernels.py)
MATMUL_TOL = {torch.float64: 1e-10, torch.float32: 1e-4, torch.bfloat16: 2e-2}
GLM_TOL = 1e-6   # absolute: mu, c, w are f32 values in [-1, 1]
RTOL = 1e-6      # backend parity at f64 (the reference's own)
DGEMM_RTOL = 1e-4  # f32 summation order over K = 16384

NEWTON = dict(n=1 << 22, d=CONFIG.n_features, q=32, iters=3)
DGEMM = dict(dim=16384, g=4)
CONTRACT_N = 1 << 16
MATMUL_SRC = ("src/repro_torch/csrc/matmul.cu", "src/repro/kernels/matmul.py:35")
GLM_SRC = ("src/repro_torch/csrc/glm_fused.cu", "src/repro/kernels/glm_fused.py:26")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def check(ok, what) -> None:
    """Fail the run (a plain ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, target_ms: float = 200.0, max_reps: int = 200) -> float:
    """Mean device time of ``fn`` over many launches (CUDA events, warmed
    up, the repetition count sized from one timed launch)."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(max_reps, max(3, target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops_count: float, bytes_count: float, dtype) -> tuple:
    t_ops = ops_count / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = bytes_count / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def matmul_case(name, a, b):
    dtype = a.dtype
    got = ops.matmul(a, b)
    again = ops.matmul(a, b)
    ref = matmul_ref(a, b)
    sync()
    check(torch.equal(got, again), f"matmul {name}: two launches differ")
    err = (got.double() - ref.double()).abs().max().item()
    rel = err / max(ref.double().abs().max().item(), 1.0)
    M, K = a.shape
    N = b.shape[1]
    bound_ms, bound_by = bound(2.0 * M * N * K,
                               (M * K + K * N + M * N) * a.element_size(), dtype)
    case = dict(case=name, dtype=str(dtype).replace("torch.", ""), shape=[M, K, N],
                max_abs_err=err, rel_err=rel, tol=MATMUL_TOL[dtype],
                ms=time_ms(lambda: ops.matmul(a, b)),
                plain_ms=time_ms(lambda: matmul_ref(a, b)),
                library_ms=time_ms(lambda: torch.matmul(a, b)),
                bound_ms=bound_ms, bound_by=bound_by, peak=PEAK_NAME[dtype])
    emit("kernel_case", kernel="matmul", **case)
    check(rel <= MATMUL_TOL[dtype], f"matmul {name}: rel err {rel} > {MATMUL_TOL[dtype]}")
    return case


def glm_case(name, z, y):
    got = ops.glm_fused(z, y)
    ref = glm_fused_ref(z, y)
    sync()
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    n = z.numel()
    bound_ms, bound_by = bound(7.0 * n, n * (2 * z.element_size() + 3 * 4), torch.float32)
    case = dict(case=name, dtype=str(z.dtype).replace("torch.", ""), shape=list(z.shape),
                max_abs_err=err, tol=GLM_TOL,
                ms=time_ms(lambda: ops.glm_fused(z, y)),
                plain_ms=time_ms(lambda: glm_fused_ref(z, y)),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                peak=PEAK_NAME[torch.float32])
    emit("kernel_case", kernel="glm_fused", **case)
    check(err <= GLM_TOL, f"glm_fused {name}: abs err {err} > {GLM_TOL}")
    return case


def kernel_phase(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    n_blk, d = NEWTON["n"] // NEWTON["q"], NEWTON["d"]
    matmul_cases = []
    for dtype in (torch.float64, torch.float32):
        X = torch.randn(n_blk, d, device=dev, dtype=dtype, generator=g)
        wX = torch.rand(n_blk, 1, device=dev, dtype=dtype, generator=g) * X
        beta = torch.randn(d, 1, device=dev, dtype=dtype, generator=g) * 0.01
        resid = torch.rand(n_blk, 1, device=dev, dtype=dtype, generator=g) - 0.5
        tag = str(dtype).replace("torch.float", "f")
        matmul_cases += [matmul_case(f"X^T(w*X) {tag}", X.mT, wX),
                         matmul_case(f"X@beta {tag}", X, beta),
                         matmul_case(f"X^T(mu-y) {tag}", X.mT, resid)]
        del X, wX, beta, resid
    sq = [torch.randn(4096, 4096, device=dev, generator=g) for _ in range(2)]
    matmul_cases.append(matmul_case("square bf16", sq[0].bfloat16(), sq[1].bfloat16()))
    matmul_cases.append(matmul_case("DGEMM tile f32", sq[0], sq[1]))
    del sq
    glm_cases = []
    for n in (1 << 22, n_blk):
        z = torch.randn(n, 1, device=dev, dtype=torch.float64, generator=g) * 4
        y = (torch.rand(n, 1, device=dev, generator=g) > 0.5).double()
        glm_cases.append(glm_case(f"({n}, 1) f64", z, y))
    return matmul_cases, glm_cases


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def _schedule(ctx, out):
    return {"S": ctx.state.S.tolist(),
            "transfers": [(t.src, t.dst, t.elements) for t in ctx.state.transfers],
            "placements": list(out.placements().values()),
            "n_rfc": ctx.executor.stats.n_rfc}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _timed_workload(ctx, run):
    """Run a workload; the loop clock starts when the workload resets the
    load counters, i.e. after its operands are created."""
    marks = {}
    reset = ctx.reset_loads

    def mark():
        sync()
        marks["start"] = time.perf_counter()
        reset()

    ctx.reset_loads = mark
    out = run(ctx)
    ctx.flush()
    sync()
    return out, time.perf_counter() - marks["start"]


def _matmul_dispatches(ctx) -> int:
    ex = ctx.executor
    return sum(1 for rec in ex.lineage.values() if rec.op == "matmul"
               and all(len(ex.shapes[ex.resolve(i)]) == 2 for i in rec.in_ids))


def _blocks(ex, op):
    """Values of the executor's blocks made by ``op``, in dispatch order."""
    return [ex.get(v) for v, rec in ex.lineage.items() if rec.op == op]


def newton_run(backend, dev):
    ctx = ArrayContext(cluster=ClusterSpec(4, 8), node_grid=(4, 1), backend=backend,
                       dtype=CONFIG.dtype, pipeline=True, plan_cache=True, seed=0,
                       device=str(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    (g, H, beta), loop_s = _timed_workload(
        ctx, lambda c: logreg_newton_loop(c, NEWTON["n"], NEWTON["d"], NEWTON["q"],
                                          iters=NEWTON["iters"]))
    counts = dict(launches)
    ex, q = ctx.executor, NEWTON["q"]
    # after three iterations the gradient has cancelled to rounding level, so
    # its error is taken against the magnitude of its summed terms,
    # sum_i |X_i|^T |mu_i - y_i| over the last iteration's blocks
    g_scale = sum(X.abs().mT @ (mu - y).abs() for X, y, mu in zip(
        _blocks(ex, "create:random"), _blocks(ex, "create:uniform"),
        _blocks(ex, "sigmoid")[-q:]))
    result = dict(beta=beta.to_numpy(), g=g.to_numpy(), H=H.to_numpy(),
                  g_scale=g_scale.max().item(), schedule=_schedule(ctx, H),
                  launches=counts, matmul_launches=counts["matmul"],
                  matmul_dispatches=_matmul_dispatches(ctx))
    emit(f"newton_{backend}", n=NEWTON["n"], d=NEWTON["d"], q=NEWTON["q"],
         iters=NEWTON["iters"], dtype=ctx.dtype, s_per_iter=loop_s / NEWTON["iters"],
         loop_s=loop_s, max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         launches=counts, matmul_dispatches=result["matmul_dispatches"],
         plan_hits=ctx.sched_stats.plan_hits, finite=bool(np.isfinite(result["H"]).all()))
    del ctx, ex, g, H, beta
    gc.collect()
    torch.cuda.empty_cache()
    return result


def dgemm_run(backend, dev):
    ctx = ArrayContext(cluster=ClusterSpec(4, 8), node_grid=(2, 2), backend=backend,
                       dtype="float32", pipeline=True, seed=0, device=str(dev))
    reset_launches()
    C, wall_s = _timed_workload(ctx, lambda c: dgemm_graph(c, DGEMM["dim"], DGEMM["g"]))
    counts = dict(launches)
    out = dict(C=C.to_numpy(), schedule=_schedule(ctx, C), launches=counts,
               matmul_dispatches=_matmul_dispatches(ctx))
    emit(f"dgemm_{backend}", dim=DGEMM["dim"], g=DGEMM["g"], dtype="float32",
         compute_s=wall_s, launches=counts, matmul_dispatches=out["matmul_dispatches"])
    del ctx, C
    gc.collect()
    torch.cuda.empty_cache()
    return out


def contracts(dev):
    def beta_bits(backend="cuda", device=str(dev), **kw):
        ctx = ArrayContext(cluster=ClusterSpec(4, 8), node_grid=(4, 1), backend=backend,
                           dtype="float64", seed=0, device=device, **kw)
        _g, _H, beta = logreg_newton_loop(ctx, CONTRACT_N, NEWTON["d"], NEWTON["q"],
                                          iters=NEWTON["iters"])
        return beta.to_numpy()

    sync_bits = beta_bits(pipeline=False)
    piped = beta_bits(pipeline=True)
    cached = beta_bits(pipeline=True, plan_cache=True)
    ref = beta_bits(backend="numpy", device=None, pipeline=True)
    res = dict(n=CONTRACT_N, pipelined_eq_sync=piped.tobytes() == sync_bits.tobytes(),
               plan_cache_on_eq_off=cached.tobytes() == piped.tobytes(),
               rel_err_vs_numpy=_rel(piped, ref))
    emit("contracts", **res)
    check(res["pipelined_eq_sync"] and res["plan_cache_on_eq_off"], f"contracts {res}")
    check(res["rel_err_vs_numpy"] <= RTOL, f"contracts {res}")


def kernel_entry(name, source, cases, headline, main_launches):
    head = next(c for c in cases if c["case"] == headline)
    return dict(name=name, route="cuda", source=source[0], replaces=source[1],
                launches=main_launches, max_abs_err=head["max_abs_err"], ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                headline=headline, cases=cases)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    reports = build.build(["matmul", "glm_fused"])
    build_s = time.perf_counter() - t0
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}", file=sys.stderr)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
         built=sorted(reports), allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    matmul_cases, glm_cases = kernel_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()

    # the runtime's bitwise contracts at n = 2**16 first: they also warm the
    # libraries (cuBLAS, cuSOLVER) and the callable cache both backends share
    contracts(dev)
    # main path: the Newton loop and the DGEMM, each on the kernels and on
    # plain torch
    cuda = newton_run("cuda", dev)
    plain = newton_run("torch", dev)
    per_iter = cuda["matmul_dispatches"] // NEWTON["iters"]
    check(cuda["matmul_launches"] == cuda["matmul_dispatches"] == 96 * NEWTON["iters"],
          f"matmul launches {cuda['matmul_launches']} vs 2-D matmul dispatches "
          f"{cuda['matmul_dispatches']}")
    check(plain["matmul_launches"] == 0, "backend torch launched the matmul kernel")
    newton_err = {k: _rel(cuda[k], plain[k]) for k in ("beta", "H")}
    newton_err["g"] = float(np.abs(cuda["g"] - plain["g"]).max() / plain["g_scale"])
    emit("newton_parity", rel_err=newton_err, rtol=RTOL,
         g_rel_to_max_g=_rel(cuda["g"], plain["g"]), g_scale=plain["g_scale"],
         same_schedule=cuda["schedule"] == plain["schedule"],
         matmul_launches_per_iter=per_iter)
    check(max(newton_err.values()) <= RTOL, f"Newton parity {newton_err}")
    check(cuda["schedule"] == plain["schedule"], "Newton schedules differ")

    dg_cuda = dgemm_run("cuda", dev)
    dg_plain = dgemm_run("torch", dev)
    dg_err = _rel(dg_cuda["C"], dg_plain["C"])
    emit("dgemm_parity", rel_err=dg_err, rtol=DGEMM_RTOL,
         same_schedule=dg_cuda["schedule"] == dg_plain["schedule"])
    check(dg_err <= DGEMM_RTOL and np.isfinite(dg_cuda["C"]).all(),
          f"DGEMM rel err {dg_err}")
    check(dg_cuda["schedule"] == dg_plain["schedule"], "DGEMM schedules differ")
    check(dg_cuda["launches"]["matmul"] == dg_cuda["matmul_dispatches"] > 0,
          f"DGEMM launches {dg_cuda['launches']} vs {dg_cuda['matmul_dispatches']}")

    # launches of the main path's own runs on backend cuda; like the
    # reference's backend, it never routes to glm_fused (held against its
    # plain version above, at the main path's shapes)
    main_launches = {k: cuda["launches"][k] + dg_cuda["launches"][k]
                     for k in cuda["launches"]}
    check(main_launches["matmul"] > 0, f"main-path launches {main_launches}")
    print(json.dumps({"kernels": [
        kernel_entry("matmul", MATMUL_SRC, matmul_cases, "X^T(w*X) f64",
                     main_launches["matmul"]),
        kernel_entry("glm_fused", GLM_SRC, glm_cases, f"({1 << 22}, 1) f64",
                     main_launches["glm_fused"]),
    ]}, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
