"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the four hand-written Hopper kernels from ``src/repro_torch/csrc``
(``matmul``, ``glm_fused``, ``flash_attention``, ``mamba_scan``; one
``nvcc`` each, all at once), holds each against its plain PyTorch version at
its main path's shapes and times both (CUDA events), then drives the two
main paths at full width:

- the block runtime: the paper's logistic-regression Newton loop (n = 2**22
  rows x 256 features, float64, 32 row blocks on a 4-node x 8-worker
  simulated cluster) and a 16384^2 block DGEMM, on backend ``cuda`` (every
  2-D block product through the matmul kernel) and on backend ``torch``
  (plain torch ops): both agree and schedule identically, and the runtime's
  bitwise contracts hold on the card;
- LM serving: hymba-1.5b at its published configuration (32 layers,
  d 1600, bf16, random weights from a seeded generator on the card) serves
  8 prompts of 2048 tokens and generates 32 tokens each through
  ``serve_demo``, with every layer's attention on the flash-attention
  kernel and every layer's prefill scan on the selective-scan kernel; the
  same weights served through the plain versions (teacher-forced with the
  kernel run's tokens) give the same logits to a bf16 tolerance, which a
  planted fault (the local layers' window removed) is shown to exceed; an
  f32 run at full width and 8 layers agrees to 1e-4 with the same tokens.

Each phase prints one JSON line; the kernel line, the card's name and power
limit, and a final ``{"ok": true, ...}`` line close the output.  Any
failure raises and exits non-zero.

Needs one CUDA device; exits non-zero without printing a result where there
is none, or where ``src/repro_torch`` is not beside this script.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, launches, ops, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref, visible  # noqa: E402
from repro_torch.kernels.glm_fused import glm_fused_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul_ref  # noqa: E402
from repro_torch.launch.serve import serve_demo  # noqa: E402
from repro_torch.launch.workloads import dgemm_graph, logreg_newton_loop  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

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

#: flash attention: the reference's kernel-test tolerances, relative to
#: max|plain|; the selective scan: 1e-4 relative to max (y and the carry)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SCAN_TOL = 1e-4
#: serve path, kernel route against plain route on the same weights, relative
#: to max|logit|.  bf16: the plain route is the reference's model attention,
#: which rounds scores and probabilities to bf16 where the kernel keeps f32;
#: at SERVE that difference alone moved the logits by 4.7-4.9% at prefill
#: and 5.3-5.5% at worst over decode (this script on an NVIDIA H100 80GB
#: HBM3 at 700 W), so the bound is 0.1, about 2x that.  serve_phase shows a planted fault (the local
#: layers' window removed) exceeding it.  f32: 1e-4, as the CPU tests hold
#: the port to the reference.
SERVE_TOL = {"bfloat16": 0.1, "float32": 1e-4}

NEWTON = dict(n=1 << 22, d=CONFIG.n_features, q=32, iters=3)
DGEMM = dict(dim=16384, g=4)
CONTRACT_N = 1 << 16
#: the serve path: hymba-1.5b at its published width and depth
SERVE = dict(arch="hymba-1.5b", batch=8, prompt_len=2048, gen=32)
#: the f32 check: full width, 8 layers (layer 7 is the first global one)
SERVE_F32_LAYERS = 8
#: depth of the warm-up runs before each timed pair of serve runs
SERVE_WARM_LAYERS = 2
MATMUL_SRC = ("src/repro_torch/csrc/matmul.cu", "src/repro/kernels/matmul.py:35")
GLM_SRC = ("src/repro_torch/csrc/glm_fused.cu", "src/repro/kernels/glm_fused.py:26")
FLASH_SRC = ("src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:92")
SCAN_SRC = ("src/repro_torch/csrc/mamba_scan.cu", "src/repro/kernels/mamba_scan.py:43")


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


def serve_shapes():
    """The serve path's attention and scan shapes: hymba-1.5b's heads, state
    and window, at SERVE's batch and prompt, over a cache of max_len."""
    cfg = get_config(SERVE["arch"])
    B, S = SERVE["batch"], SERVE["prompt_len"]
    max_len = S + SERVE["gen"] + 1
    return dict(B=B, S=S, max_len=max_len, H=cfg.n_heads, KV=cfg.n_kv_heads,
                hd=cfg.resolved_head_dim, window=cfg.window,
                DI=cfg.ssm.d_inner(cfg.d_model), N=cfg.ssm.d_state)


def flash_case(name, q, k, v, window, q_offset):
    dtype = q.dtype
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, True, window, q_offset)
    sync()
    check(torch.equal(got, again), f"flash_attention {name}: two launches differ")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    mask = visible(Sq, Skv, True, window, q_offset, q.device)
    pairs = int(mask.sum().item())            # (query, key) pairs this run needs
    keys = int(mask.any(dim=0).sum().item())  # keys any query sees
    # QK^T and PV: 2 flops each per (pair, head, dim)
    bound_ms, bound_by = bound(4.0 * B * H * pairs * hd,
                               (2 * B * H * Sq * hd + 2 * B * KV * keys * hd)
                               * q.element_size(), dtype)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=True)
    case = dict(case=name, dtype=str(dtype).replace("torch.", ""),
                q=list(q.shape), kv=list(k.shape), window=window, q_offset=q_offset,
                max_abs_err=err, rel_err=rel, tol=FLASH_TOL[dtype],
                ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, True, window,
                                                             q_offset)),
                library_ms=time_ms(library), library="scaled_dot_product_attention",
                bound_ms=bound_ms, bound_by=bound_by, peak=PEAK_NAME[dtype])
    emit("kernel_case", kernel="flash_attention", **case)
    check(rel <= FLASH_TOL[dtype], f"flash_attention {name}: rel err {rel}")
    return case


def scan_case(name, dA, dBx, C):
    y, h = ops.mamba_scan(dA, dBx, C)
    y2, h2 = ops.mamba_scan(dA, dBx, C)
    y_ref, h_ref = mamba_scan_ref(dA, dBx, C)
    sync()
    check(torch.equal(y, y2) and torch.equal(h, h2), f"mamba_scan {name}: two launches differ")
    err = max((y - y_ref).abs().max().item(), (h - h_ref).abs().max().item())
    rel = max((y - y_ref).abs().max().item() / y_ref.abs().max().item(),
              (h - h_ref).abs().max().item() / h_ref.abs().max().item())
    B, S, DI, N = dA.shape
    # per element and step: one FMA for h, one multiply-add toward y
    bound_ms, bound_by = bound(4.0 * B * S * DI * N,
                               4 * (2 * B * S * DI * N + B * S * N + B * S * DI + B * DI * N),
                               torch.float32)
    case = dict(case=name, dtype="float32", shape=[B, S, DI, N], max_abs_err=err,
                rel_err=rel, tol=SCAN_TOL, ms=time_ms(lambda: ops.mamba_scan(dA, dBx, C)),
                plain_ms=time_ms(lambda: mamba_scan_ref(dA, dBx, C), max_reps=5),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                peak=PEAK_NAME[torch.float32])
    emit("kernel_case", kernel="mamba_scan", **case)
    check(rel <= SCAN_TOL, f"mamba_scan {name}: rel err {rel}")
    return case


def serve_kernel_phase(dev):
    """Both new kernels at the serve path's shapes: prefill of the global and
    the local layers, a decode step at the last prompt position, and the
    prefill scan."""
    g = torch.Generator(device=dev).manual_seed(1)
    sh = serve_shapes()
    B, S, H, KV, hd = sh["B"], sh["S"], sh["H"], sh["KV"], sh["hd"]

    def u(*shape, dtype):
        return (torch.rand(shape, device=dev, generator=g) * 2 - 1).to(dtype)

    flash = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        q = u(B, H, S, hd, dtype=dtype)
        k, v = u(B, KV, sh["max_len"], hd, dtype=dtype), u(B, KV, sh["max_len"], hd, dtype=dtype)
        flash.append(flash_case(f"prefill-global {tag}", q, k, v, None, 0))
        if dtype == torch.bfloat16:
            flash.append(flash_case("prefill-local bf16", q, k, v, sh["window"], 0))
            flash.append(flash_case("decode bf16", q[:, :, :1].contiguous(), k, v, None, S))
        del q, k, v
        gc.collect()
        torch.cuda.empty_cache()
    N, DI = sh["N"], sh["DI"]
    dA = torch.rand(B, S, DI, N, device=dev, generator=g) * 0.49 + 0.5
    dBx = torch.rand(B, S, DI, N, device=dev, generator=g) * 2 - 1
    C = torch.rand(B, S, N, device=dev, generator=g) * 2 - 1
    scan = [scan_case(f"prefill {list(dA.shape)} f32", dA, dBx, C)]
    del dA, dBx, C
    gc.collect()
    torch.cuda.empty_cache()
    return flash, scan


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


def serve_run(dev, cfg, params, impl, forced=None, gen=None):
    """One serve_demo run of model ``cfg`` at SERVE's batch and prompt on the
    card, with its launches and peak memory; the launch counts are set to 0
    just before it."""
    record = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    tokens = serve_demo(cfg, SERVE["batch"], SERVE["prompt_len"], gen or SERVE["gen"],
                        device=dev,
                        params=params, impl=impl, forced=forced, record=record,
                        log_fn=lambda line: print(f"# {line}", file=sys.stderr))
    record.update(tokens=tokens, launches=dict(launches),
                  max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    return record


def serve_compare(label, kern, plain, tol):
    """Kernel route against plain route, step by step (step 0 is prefill's
    last position), relative to max|logit| of the plain route."""
    lk, lp = kern["logits"], plain["logits"]
    scale = float(np.abs(lp).max())
    per_step = (np.abs(lk - lp).max(axis=(1, 2)) / scale).tolist()
    finite = bool(np.isfinite(lk).all() and np.isfinite(lp).all())
    res = dict(rel_err_prefill=per_step[0], rel_err_decode_max=max(per_step[1:]),
               rel_err_per_step=per_step, tol=tol, max_abs_logit=scale, finite=finite,
               greedy_agree=float((kern["tokens"] == plain["tokens"]).mean()))
    for name, rec in (("kernel", kern), ("plain", plain)):
        res[name] = dict(prefill_s=rec["prefill_s"],
                         decode_s_per_token=rec["decode_s_per_token"],
                         tokens_per_s=rec["tokens_per_s"],
                         max_memory_allocated=rec["max_memory_allocated"],
                         launches=rec["launches"])
    emit(f"serve_{label}", arch=SERVE["arch"], batch=SERVE["batch"],
         prompt_len=SERVE["prompt_len"], gen=SERVE["gen"], max_len=kern["max_len"], **res)
    check(finite and max(per_step) <= tol, f"serve {label}: rel err {per_step} > {tol}")


def serve_warm_up(dev, cfg):
    """Both routes at SERVE_WARM_LAYERS layers and the same shapes, so that
    the timed runs after it find the libraries' kernels for these shapes
    chosen and the allocator's pool grown, whichever route runs first."""
    cfg = dataclasses.replace(cfg, n_layers=SERVE_WARM_LAYERS)
    for impl in ("kernel", "plain"):
        serve_run(dev, cfg, None, impl)


def planted_faults(dev, cfg, params, plain):
    """Prefill's last-position logits of the kernel route with a fault
    planted, against the plain route's correct ones (``plain``), relative
    to max|logit| as in serve_compare: the local layers' window removed
    (every layer global), and the last layer dropped.  The bf16 limit must
    catch the first; the second is read only."""
    scale = float(np.abs(plain["logits"]).max())
    layers = {name: {k: v[:-1] for k, v in group.items()}
              for name, group in params["layers"].items()}
    faults = {"no_window": (dataclasses.replace(cfg, window=None), params),
              "last_layer_dropped": (dataclasses.replace(cfg, n_layers=cfg.n_layers - 1),
                                     dict(params, layers=layers))}
    res = {}
    for name, (fcfg, fparams) in faults.items():
        rec = serve_run(dev, fcfg, fparams, "kernel", gen=1)
        res[name] = float(np.abs(rec["logits"][0] - plain["logits"][0]).max() / scale)
    emit("serve_bf16_planted_faults", rel_err_prefill=res, tol=SERVE_TOL["bfloat16"])
    check(res["no_window"] > SERVE_TOL["bfloat16"],
          f"the bf16 limit misses a planted fault: {res}")


def serve_phase(dev):
    """hymba-1.5b served through the kernels and through the plain versions
    on the same weights: bf16 at the published depth, then f32 at 8 layers.
    Returns the kernel route's launches in the bf16 run (the main path)."""
    cfg = get_config(SERVE["arch"])
    L = cfg.n_layers
    serve_warm_up(dev, cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    kern = serve_run(dev, cfg, params, "kernel")
    plain = serve_run(dev, cfg, params, "plain", forced=kern["tokens"])
    serve_compare("bf16", kern, plain, SERVE_TOL["bfloat16"])
    want = {"flash_attention": L * SERVE["gen"], "mamba_scan": L}
    got = {k: kern["launches"][k] for k in want}
    check(got == want, f"serve bf16 kernel launches {got} != {want}")
    check(plain["launches"]["flash_attention"] == plain["launches"]["mamba_scan"] == 0,
          f"serve bf16 plain route launched kernels: {plain['launches']}")
    main_launches = kern["launches"]
    planted_faults(dev, cfg, params, plain)
    del params, kern, plain

    cfg32 = dataclasses.replace(cfg, n_layers=SERVE_F32_LAYERS, dtype="float32")
    serve_warm_up(dev, cfg32)
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(0))
    kern = serve_run(dev, cfg32, params, "kernel")
    plain = serve_run(dev, cfg32, params, "plain", forced=kern["tokens"])
    serve_compare("f32", kern, plain, SERVE_TOL["float32"])
    check(np.array_equal(kern["tokens"], plain["tokens"]),
          "serve f32: greedy tokens differ between the routes")
    want = {"flash_attention": cfg32.n_layers * SERVE["gen"], "mamba_scan": cfg32.n_layers}
    check({k: kern["launches"][k] for k in want} == want,
          f"serve f32 kernel launches {kern['launches']} != {want}")
    del params, kern, plain
    gc.collect()
    torch.cuda.empty_cache()
    return main_launches


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
    reports = build.build(["matmul", "glm_fused", "flash_attention", "mamba_scan"])
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
    flash_cases, scan_cases = serve_kernel_phase(dev)

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

    # main path 2: LM serving, through the attention and scan kernels
    serve_launches = serve_phase(dev)

    # launches of the main paths' own runs: the block runtime on backend
    # cuda (like the reference's backend, it never routes to glm_fused, held
    # against its plain version above at the main path's shapes) and the
    # bf16 serve run through the kernels
    main_launches = {k: cuda["launches"][k] + dg_cuda["launches"][k]
                     for k in ("matmul", "glm_fused")}
    main_launches.update({k: serve_launches[k] for k in ("flash_attention", "mamba_scan")})
    check(main_launches["matmul"] > 0, f"main-path launches {main_launches}")
    print(json.dumps({"kernels": [
        kernel_entry("matmul", MATMUL_SRC, matmul_cases, "X^T(w*X) f64",
                     main_launches["matmul"]),
        kernel_entry("glm_fused", GLM_SRC, glm_cases, f"({1 << 22}, 1) f64",
                     main_launches["glm_fused"]),
        kernel_entry("flash_attention", FLASH_SRC, flash_cases, "prefill-global bf16",
                     main_launches["flash_attention"]),
        kernel_entry("mamba_scan", SCAN_SRC, scan_cases, scan_cases[0]["case"],
                     main_launches["mamba_scan"]),
    ]}, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
