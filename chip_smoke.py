"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the six hand-written Hopper kernels from ``src/repro_torch/csrc``
(``matmul``, ``glm_fused``, ``flash_attention``, ``flash_attention_bwd``,
``mamba_scan``, ``mamba_scan_bwd``; one ``nvcc`` each, all at once), holds
each against its plain PyTorch version at its main path's shapes and times
both (CUDA events), then drives the three main paths at full width:

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
  f32 run at full width and 8 layers agrees to 1e-4 with the same tokens;
- LM training: hymba-1.5b at its published configuration (1.66 B
  parameters, f32 master weights and AdamW state, bf16 compute, full remat)
  trains on batches of 4 x 2048 tokens through ``train_loop`` (1 warm-up
  step, 3 timed), with every layer's attention and scan on their kernels
  forward (twice: forward and recompute) and backward, launches counted per
  step; one step's loss and every gradient leaf agree with the plain route
  on the same weights and batch to a bf16 tolerance that a planted fault
  (the window dropped in the backward kernel only) exceeds, and in f32 at
  8 layers to 1e-4; two backward runs give the same bits.

Each phase prints one JSON line (a matmul case also names the loader it
took, vector or scalar; an attention-backward case the device time of each
of its kernels); the kernel line, the card's name and power limit, and a
final ``{"ok": true, ...}`` line close the output.  The compiler's register
report of every kernel goes to standard error; a register spill in the
libraries redesigned for Hopper (``REDESIGNED``) fails the run, as does a
Newton or DGEMM product on the scalar loader.  The attention forward is timed
at prefill and at decode, where it splits the keys (two device kernels per
call, whose device times a decode case also reports); the scan forward with
its checkpoints written, and the scan backward on both its routes (from the
forward's checkpoints, the one training takes, and without them), which must
give the same bits.  Any failure raises and exits non-zero.

Needs one CUDA device; exits non-zero without printing a result where there
is none, or where ``src/repro_torch`` is not beside this script.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
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
from repro_torch.kernels.flash_attention import (flash_attention_ref, kv_splits,  # noqa: E402
                                                 query_tiles, visible)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.glm_fused import glm_fused_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan_bwd_ref, mamba_scan_ref  # noqa: E402
from repro_torch.kernels.matmul import loaders, matmul_ref  # noqa: E402
from repro_torch.launch.serve import serve_demo  # noqa: E402
from repro_torch.launch.train import batch_to, train_loop  # noqa: E402
from repro_torch.launch.workloads import dgemm_graph, logreg_newton_loop  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.sharding.plans import SINGLE_CARD  # noqa: E402
from repro_torch.train import DataConfig, TokenPipeline, make_grad_fn  # noqa: E402
from repro_torch.models.transformer import _leaves  # noqa: E402

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
#: the train path: hymba-1.5b at its published width and depth, f32 master
#: weights and AdamW state, bf16 compute, full remat; 1 warm-up step, then
#: TRAIN["steps"] timed ones, then one step under torch.profiler
TRAIN = dict(arch="hymba-1.5b", batch=4, seq=2048, warm=1, steps=3, lr=1e-2)
#: device kernels of a train step by what they do, matched on their names
KERNEL_GROUPS = (
    ("attention forward", ("flash_fwd_kernel", "flash_fwd_mma_kernel",
                           "flash_split_combine_kernel")),
    ("attention backward", ("dkv_kernel", "dq_kernel", "dkv_mma_kernel", "dq_mma_kernel",
                            "delta_kernel")),
    ("scan forward", ("mamba_scan_kernel",)),
    ("scan backward", ("scan_bwd_kernel", "dc_sum_kernel")),
    ("matrix products (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
)
#: depth of the plain route's gradient step held against the kernel route
TRAIN_PLAIN_LAYERS = 32
#: the f32 gradient check: full width, 8 layers (layer 7 global), batch 1
TRAIN_F32 = dict(layers=8, batch=1)
#: train path, kernel route against plain route on the same weights and
#: batch: loss and every gradient leaf, relative to the leaf's max|g|.  bf16:
#: the plain route is the reference's model attention, which rounds scores
#: and probabilities to bf16 where the kernels keep f32; at TRAIN that moved
#: the embedding's gradient by 8.0% of its max and every other leaf by at
#: most 0.85% (this script on an NVIDIA H100 80GB HBM3 at 700 W), so the
#: bound is 0.16, about 2x the worst.  train_phase shows a planted fault
#: (the window dropped in the backward kernel only) exceeding it.  f32:
#: 1e-4, as the CPU tests hold the port to the reference.
TRAIN_TOL = {"bfloat16": 0.16, "float32": 1e-4}
MATMUL_SRC = ("src/repro_torch/csrc/matmul.cu", "src/repro/kernels/matmul.py:35")
GLM_SRC = ("src/repro_torch/csrc/glm_fused.cu", "src/repro/kernels/glm_fused.py:26")
FLASH_SRC = ("src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:92")
SCAN_SRC = ("src/repro_torch/csrc/mamba_scan.cu", "src/repro/kernels/mamba_scan.py:43")
FLASH_BWD_SRC = ("src/repro_torch/csrc/flash_attention_bwd.cu",
                 "src/repro/kernels/flash_attention_bwd.py:52")
#: no Pallas counterpart: the gradient of row 5, which the reference takes
#: by jax autodiff of its associative scan
SCAN_BWD_SRC = ("src/repro_torch/csrc/mamba_scan_bwd.cu",
                "src/repro/kernels/mamba_scan.py:43 (its gradient; no Pallas kernel)")
#: the libraries whose kernels were redesigned for Hopper (tensor cores,
#: asynchronous copies, split-KV, the scan's checkpoints); their ptxas report
#: must show no register spills
REDESIGNED = ("matmul", "flash_attention", "flash_attention_bwd", "mamba_scan",
              "mamba_scan_bwd")
#: every kernel library, built at once
KERNELS = ["matmul", "glm_fused", "flash_attention", "flash_attention_bwd", "mamba_scan",
           "mamba_scan_bwd"]


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


def device_ms_by_kernel(fn, parts: dict, reps: int = 5) -> dict:
    """Device time per call of ``fn`` (torch.profiler, ``reps`` calls after a
    warm-up) of the kernels whose names contain each value of ``parts``,
    keyed as ``parts`` is."""
    fn()
    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    out = {label: 0.0 for label in parts}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            for label, part in parts.items():
                if part in ev.key:
                    out[label] += ev.self_device_time_total / 1e3 / reps
    return out


def bound(ops_count: float, bytes_count: float, dtype) -> tuple:
    t_ops = ops_count / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = bytes_count / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def matmul_case(name, a, b):
    dtype = a.dtype
    reset_launches()
    got = ops.matmul(a, b)
    loader = next((k for k, n in loaders.items() if n), "none")  # the launch's loader
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
                loader=loader, max_abs_err=err, rel_err=rel, tol=MATMUL_TOL[dtype],
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
    scalar = [c["case"] for c in matmul_cases if c["dtype"] != "bfloat16"
              and c["loader"] != "vector"]
    check(not scalar, f"matmul cases on the scalar loader: {scalar}")
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
    splits = kv_splits(dtype, B, KV, H // KV, Sq, Skv, hd, True, window, q_offset)
    case = dict(case=name, dtype=str(dtype).replace("torch.", ""),
                q=list(q.shape), kv=list(k.shape), window=window, q_offset=q_offset,
                splits=splits, blocks=B * KV * query_tiles(dtype, H // KV, Sq) * splits,
                max_abs_err=err, rel_err=rel, tol=FLASH_TOL[dtype],
                ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, True, window,
                                                             q_offset)),
                library_ms=time_ms(library), library="scaled_dot_product_attention",
                bound_ms=bound_ms, bound_by=bound_by, peak=PEAK_NAME[dtype])
    if splits > 1:  # the call's two device kernels
        case["kernel_ms"] = device_ms_by_kernel(
            lambda: ops.flash_attention(q, k, v, **kw),
            {"partials": "flash_fwd", "combine": "flash_split_combine"})
    emit("kernel_case", kernel="flash_attention", **case)
    check(rel <= FLASH_TOL[dtype], f"flash_attention {name}: rel err {rel}")
    return case


def scan_case(name, dA, dBx, C):
    """The forward with its checkpoints written (what training runs) and
    without (serving): the same y and carry, bitwise."""
    y, h, _ = ops.mamba_scan(dA, dBx, C, checkpoints=True)
    y2, h2 = ops.mamba_scan(dA, dBx, C)
    y_ref, h_ref = mamba_scan_ref(dA, dBx, C)
    sync()
    check(torch.equal(y, y2) and torch.equal(h, h2),
          f"mamba_scan {name}: two launches (with and without checkpoints) differ")
    err = max((y - y_ref).abs().max().item(), (h - h_ref).abs().max().item())
    rel = max((y - y_ref).abs().max().item() / y_ref.abs().max().item(),
              (h - h_ref).abs().max().item() / h_ref.abs().max().item())
    B, S, DI, N = dA.shape
    # per element and step: one FMA for h, one multiply-add toward y
    bound_ms, bound_by = bound(4.0 * B * S * DI * N,
                               4 * (2 * B * S * DI * N + B * S * N + B * S * DI + B * DI * N),
                               torch.float32)
    case = dict(case=name, dtype="float32", shape=[B, S, DI, N], max_abs_err=err,
                rel_err=rel, tol=SCAN_TOL,
                ms=time_ms(lambda: ops.mamba_scan(dA, dBx, C, checkpoints=True)),
                ms_without_checkpoints=time_ms(lambda: ops.mamba_scan(dA, dBx, C)),
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
            flash.append(flash_case("decode-local bf16", q[:, :, :1].contiguous(), k, v,
                                    sh["window"], S))
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


def train_shapes():
    """The train path's attention and scan shapes: hymba-1.5b's heads, state
    and window at TRAIN's batch and sequence."""
    cfg = get_config(TRAIN["arch"])
    return dict(B=TRAIN["batch"], S=TRAIN["seq"], H=cfg.n_heads, KV=cfg.n_kv_heads,
                hd=cfg.resolved_head_dim, window=cfg.window,
                DI=cfg.ssm.d_inner(cfg.d_model), N=cfg.ssm.d_state)


def flash_bwd_case(name, q, k, v, window):
    """The backward kernels (dK/dV and dQ) on the forward kernel's own output
    and lse, against the plain backward on the same inputs."""
    dtype = q.dtype
    kw = dict(causal=True, window=window, q_offset=0)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    do = (torch.rand(out.shape, device=q.device, generator=torch.Generator(
        device=q.device).manual_seed(7)) * 2 - 1).to(dtype)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, True, window, 0)
    sync()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {name}: two launches differ")
    errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
    rels = [e / r.float().abs().max().item() for e, r in zip(errs, ref)]
    del got, again, ref
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    mask = visible(Sq, Skv, True, window, 0, q.device)
    pairs = int(mask.sum().item())
    # the five products S, dP, dV, dK, dQ: 2 flops each per (pair, head, dim);
    # q, o, do, dq and k, v, dk, dv once each, lse in f32
    bound_ms, bound_by = bound(10.0 * B * H * pairs * hd,
                               (4 * B * H * Sq * hd + 4 * B * KV * Skv * hd)
                               * q.element_size() + 4 * B * H * Sq, dtype)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                                             enable_gqa=True)
    library = lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do,  # noqa: E731
                                          retain_graph=True)
    case = dict(case=name, dtype=str(dtype).replace("torch.", ""), q=list(q.shape),
                kv=list(k.shape), window=window, max_abs_err=max(errs),
                rel_err={"dq": rels[0], "dk": rels[1], "dv": rels[2]},
                tol=FLASH_TOL[dtype],
                ms=time_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)),
                plain_ms=time_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                                 True, window, 0),
                                 max_reps=10),
                library_ms=time_ms(library),
                library="scaled_dot_product_attention backward",
                bound_ms=bound_ms, bound_by=bound_by, peak=PEAK_NAME[dtype],
                kernel_ms=device_ms_by_kernel(
                    lambda: ops.flash_attention_bwd(q, k, v, out, lse, do, **kw),
                    {"delta": "delta_kernel", "dkv": "dkv_", "dq": "dq_"}))
    del o_lib, qr, kr, vr
    emit("kernel_case", kernel="flash_attention_bwd", **case)
    check(max(rels) <= FLASH_TOL[dtype], f"flash_attention_bwd {name}: rel err {rels}")
    return case


def scan_bwd_case(name, dA, dBx, C, dy):
    """The backward from the checkpoints of one forward (the route training
    takes) and without them (it runs the recurrence forward first): the
    same bits, against the plain backward."""
    _, _, ckpt = ops.mamba_scan(dA, dBx, C, checkpoints=True)
    got = ops.mamba_scan_bwd(dA, dBx, C, dy, checkpoints=ckpt)
    again = ops.mamba_scan_bwd(dA, dBx, C, dy)
    ref = mamba_scan_bwd_ref(dA, dBx, C, dy)
    sync()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"mamba_scan_bwd {name}: the two routes differ")
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    rels = [e / r.abs().max().item() for e, r in zip(errs, ref)]
    del got, again, ref
    B, S, DI, N = dA.shape
    # per element and step: h (1 FMA), g (1 FMA + 1 product), d(dA) (1
    # product), dC's term (1 FMA); dA, dBx, d(dA), d(dBx) once each, and the
    # (B, S, DI) dy and the (B, S, N) C and dC
    bound_ms, bound_by = bound(8.0 * B * S * DI * N,
                               4 * (4 * B * S * DI * N + B * S * DI + 2 * B * S * N),
                               torch.float32)
    case = dict(case=name, dtype="float32", shape=[B, S, DI, N], max_abs_err=max(errs),
                rel_err={"d_dA": rels[0], "d_dBx": rels[1], "dC": rels[2]}, tol=SCAN_TOL,
                ms=time_ms(lambda: ops.mamba_scan_bwd(dA, dBx, C, dy, checkpoints=ckpt)),
                ms_without_checkpoints=time_ms(lambda: ops.mamba_scan_bwd(dA, dBx, C, dy)),
                plain_ms=time_ms(lambda: mamba_scan_bwd_ref(dA, dBx, C, dy), max_reps=3),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                peak=PEAK_NAME[torch.float32])
    emit("kernel_case", kernel="mamba_scan_bwd", **case)
    check(max(rels) <= SCAN_TOL, f"mamba_scan_bwd {name}: rel err {rels}")
    return case


def train_kernel_phase(dev):
    """Both backward kernels at the train path's shapes: attention of the
    global and the local layers (bf16) and of a global layer in f32, and
    the scan's backward."""
    g = torch.Generator(device=dev).manual_seed(2)
    sh = train_shapes()
    B, S, H, KV, hd = sh["B"], sh["S"], sh["H"], sh["KV"], sh["hd"]

    def u(*shape, dtype):
        return (torch.rand(shape, device=dev, generator=g) * 2 - 1).to(dtype)

    flash = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        q, k, v = u(B, H, S, hd, dtype=dtype), u(B, KV, S, hd, dtype=dtype), u(
            B, KV, S, hd, dtype=dtype)
        flash.append(flash_bwd_case(f"train-global {tag}", q, k, v, None))
        if dtype == torch.bfloat16:
            flash.append(flash_bwd_case("train-local bf16", q, k, v, sh["window"]))
        del q, k, v
        gc.collect()
        torch.cuda.empty_cache()
    N, DI = sh["N"], sh["DI"]
    dA = torch.rand(B, S, DI, N, device=dev, generator=g) * 0.49 + 0.5
    dBx = torch.rand(B, S, DI, N, device=dev, generator=g) * 2 - 1
    C = torch.rand(B, S, N, device=dev, generator=g) * 2 - 1
    dy = torch.rand(B, S, DI, device=dev, generator=g) * 2 - 1
    scan = [scan_bwd_case(f"train {list(dA.shape)} f32", dA, dBx, C, dy)]
    del dA, dBx, C, dy
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
    by_loader = dict(loaders)
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
                  matmul_loaders=by_loader, matmul_dispatches=_matmul_dispatches(ctx))
    emit(f"newton_{backend}", n=NEWTON["n"], d=NEWTON["d"], q=NEWTON["q"],
         iters=NEWTON["iters"], dtype=ctx.dtype, s_per_iter=loop_s / NEWTON["iters"],
         loop_s=loop_s, max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         launches=counts, matmul_loaders=by_loader,
         matmul_dispatches=result["matmul_dispatches"], plan_hits=ctx.sched_stats.plan_hits,
         finite=bool(np.isfinite(result["H"]).all()))
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
    by_loader = dict(loaders)
    out = dict(C=C.to_numpy(), schedule=_schedule(ctx, C), launches=counts,
               matmul_loaders=by_loader, matmul_dispatches=_matmul_dispatches(ctx))
    emit(f"dgemm_{backend}", dim=DGEMM["dim"], g=DGEMM["g"], dtype="float32",
         compute_s=wall_s, launches=counts, matmul_loaders=by_loader,
         matmul_dispatches=out["matmul_dispatches"])
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


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd")


def train_run(dev):
    """hymba-1.5b trained through ``train_loop`` on the kernel route: one
    warm-up step, TRAIN["steps"] timed ones, then one under torch.profiler.
    The launch counts are set to 0 just before the run and read (and set to
    0 again) after every step.  Returns the launches of the whole run."""
    cfg = get_config(TRAIN["arch"])
    L = cfg.n_layers
    steps = []

    def on_step(step, metrics):
        steps.append(dict(metrics, step=step, launches={k: launches[k] for k in TRAIN_KERNELS},
                          max_memory_allocated=torch.cuda.max_memory_allocated(dev)))
        reset_launches()

    profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
    last_timed = TRAIN["warm"] + TRAIN["steps"] - 1

    def on_step_profiled(step, metrics):
        on_step(step, metrics)
        if step == last_timed:
            profiler.start()  # the next step runs under the profiler
        elif step == last_timed + 1:
            profiler.stop()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    state, history = train_loop(TRAIN["arch"], steps=last_timed + 2,
                                batch=TRAIN["batch"], seq=TRAIN["seq"], reduced=False,
                                lr=TRAIN["lr"], log_every=1, device=dev,
                                on_step=on_step_profiled,
                                log_fn=lambda line: print(f"# {line}", file=sys.stderr))
    n_params = sum(t.numel() for _, t in _leaves(state["params"]))
    n_leaves = len(list(_leaves(state["params"])))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    timed = steps[TRAIN["warm"]:last_timed + 1]
    s_per_step = sum(st["s"] for st in timed) / len(timed)
    profile = train_profile(profiler, steps[-1]["s"])
    want = {"flash_attention": 2 * L, "flash_attention_bwd": L, "mamba_scan": 2 * L,
            "mamba_scan_bwd": L}
    emit("train_kernel", arch=TRAIN["arch"], n_layers=L, d_model=cfg.d_model,
         params=n_params, leaves=n_leaves, batch=TRAIN["batch"], seq=TRAIN["seq"],
         dtype=cfg.dtype, master="float32", remat=SINGLE_CARD.remat,
         s_per_step=s_per_step, tokens_per_s=TRAIN["batch"] * TRAIN["seq"] / s_per_step,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         steps=[{k: st[k] for k in ("step", "s", "loss", "grad_norm", "lr", "launches",
                                    "max_memory_allocated")} for st in steps],
         launches_per_step_expected=want)
    emit("train_profile", **profile)
    check(all(np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"]) for st in steps),
          f"train: non-finite loss or grad norm {history}")
    check(n_leaves == 21, f"train: {n_leaves} parameter leaves, not 21")
    for st in steps:
        check(st["launches"] == want, f"train step {st['step']} launches "
                                      f"{st['launches']} != {want}")
    return {k: sum(st["launches"][k] for st in steps) for k in TRAIN_KERNELS}


def train_profile(profiler, step_s):
    """Device time of the profiled train step by kernel group (the traced
    device kernels' time), the top kernels, and the device's idle share of
    the step's wall time (which the profiler's own cost lengthens)."""
    per_kernel = {}  # device kernels only: operator rows would count them twice
    for ev in profiler.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            key = ev.key[:120]
            per_kernel[key] = per_kernel.get(key, 0.0) + ev.self_device_time_total / 1e3  # ms
    busy_ms = sum(per_kernel.values())
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (elementwise, reductions, copies, optimizer)"] = 0.0
    for key, ms in per_kernel.items():
        name = next((g for g, pats in KERNEL_GROUPS if any(p in key for p in pats)),
                    "other (elementwise, reductions, copies, optimizer)")
        groups[name] += ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    check(busy_ms > 0, "train profile: no device time traced")
    return dict(step_s=step_s, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / 1e3 / step_s),
                groups_ms=groups, top_kernels_ms=dict(top))


def _grads(cfg, params, batch, impl, compute_dtype):
    """(loss, [(path, grad)]) of one gradient step of ``cfg`` (full remat),
    and the seconds it took."""
    sync()
    t0 = time.perf_counter()
    loss, _aux, grads = make_grad_fn(cfg, SINGLE_CARD, compute_dtype=compute_dtype,
                                     impl=impl)(params, batch)
    sync()
    return loss, list(_leaves(grads)), time.perf_counter() - t0


def _cut(params, layers):
    return dict(params, layers={g: {k: v[:layers] for k, v in leaves.items()}
                                for g, leaves in params["layers"].items()})


def _leaf_errs(got, want):
    """max|got - want| / max|want| per gradient leaf, keyed by path."""
    return {"/".join(path): ((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30)).item()
            for (path, a), (_, b) in zip(got, want)}


def train_compare(label, kern, plain, tol):
    """Loss and every gradient leaf of the kernel route against the plain
    route, each relative to the plain leaf's max|g|."""
    (lk, gk, sk), (lp, gp, sp) = kern, plain
    per_leaf = _leaf_errs(gk, gp)
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    finite = all(torch.isfinite(a).all().item() for _, a in gk)
    worst = max(per_leaf, key=per_leaf.get)
    emit(f"train_{label}", loss_kernel=lk.item(), loss_plain=lp.item(), loss_rel_err=loss_rel,
         grad_rel_err=per_leaf, worst_leaf=worst, worst_rel_err=per_leaf[worst], tol=tol,
         kernel_s=sk, plain_s=sp, finite=finite)
    check(finite and loss_rel <= tol and per_leaf[worst] <= tol,
          f"train {label}: loss {loss_rel}, worst leaf {worst} {per_leaf[worst]} > {tol}")
    return per_leaf


def train_phase(dev):
    """Training hymba-1.5b through the kernels (``train_run``), then the
    gradients of one step on the same weights and first batch: two kernel
    runs bitwise equal, the kernel route against the plain route (bf16, at
    TRAIN_PLAIN_LAYERS), a planted fault caught, and f32 at 8 layers.
    Returns the launches of the train run (the main path's)."""
    main_launches = train_run(dev)
    cfg = get_config(TRAIN["arch"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype="float32")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                    global_batch=TRAIN["batch"]))
    batch = batch_to(next(pipe), dev)  # train_loop's first batch, on its weights

    # determinism: the same backward twice at the published depth
    first = _grads(cfg, params, batch, "kernel", "bfloat16")
    second = _grads(cfg, params, batch, "kernel", "bfloat16")
    same = (torch.equal(first[0], second[0])
            and all(torch.equal(a, b) for (_, a), (_, b) in zip(first[1], second[1])))
    emit("train_determinism", n_layers=cfg.n_layers, bitwise_equal=same,
         kernel_s=[first[2], second[2]])
    check(same, "train: two backward runs on the card differ")
    del second

    cut = dataclasses.replace(cfg, n_layers=TRAIN_PLAIN_LAYERS)
    cparams = _cut(params, TRAIN_PLAIN_LAYERS)
    kern = first if TRAIN_PLAIN_LAYERS == cfg.n_layers else _grads(cut, cparams, batch,
                                                                   "kernel", "bfloat16")
    del first
    reset_launches()
    plain = _grads(cut, cparams, batch, "plain", "bfloat16")
    check(all(launches[k] == 0 for k in TRAIN_KERNELS),
          f"train plain route launched kernels: {dict(launches)}")
    train_compare("bf16", kern, plain, TRAIN_TOL["bfloat16"])
    del kern

    # planted fault: the local layers' window dropped in the backward kernel only
    real_bwd = ops.flash_attention_bwd
    ops.flash_attention_bwd = lambda *a, **kw: real_bwd(*a, **dict(kw, window=None))
    try:
        fault = _grads(cut, cparams, batch, "kernel", "bfloat16")
    finally:
        ops.flash_attention_bwd = real_bwd
    per_leaf = _leaf_errs(fault[1], plain[1])
    worst = max(per_leaf, key=per_leaf.get)
    emit("train_bf16_planted_fault", fault="window dropped in the backward kernel",
         worst_leaf=worst, worst_rel_err=per_leaf[worst], tol=TRAIN_TOL["bfloat16"])
    check(per_leaf[worst] > TRAIN_TOL["bfloat16"],
          f"the bf16 train limit misses a planted fault: {worst} {per_leaf[worst]}")
    del fault, plain, cparams, params
    gc.collect()
    torch.cuda.empty_cache()

    # f32: full width, 8 layers, batch 1
    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_F32["layers"], dtype="float32")
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(0))
    batch = {k: v[:TRAIN_F32["batch"]] for k, v in batch.items()}
    reset_launches()
    kern = _grads(cfg32, params, batch, "kernel", "float32")
    want = {"flash_attention": 2 * cfg32.n_layers, "flash_attention_bwd": cfg32.n_layers,
            "mamba_scan": 2 * cfg32.n_layers, "mamba_scan_bwd": cfg32.n_layers}
    got = {k: launches[k] for k in TRAIN_KERNELS}
    check(got == want, f"train f32 kernel launches {got} != {want}")
    plain = _grads(cfg32, params, batch, "plain", "float32")
    train_compare("f32", kern, plain, TRAIN_TOL["float32"])
    del kern, plain, params
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
    reports = build.build(KERNELS)
    build_s = time.perf_counter() - t0
    spills = []
    for name, report in reports.items():
        kernel = ""
        for line in report.splitlines():
            entry = re.search(r"entry function '_Z\w*?_cu_[0-9a-f]{8}(\d+)(\w+)'", line)
            if entry:  # the mangled name's identifier, then its template arguments
                n = int(entry.group(1))
                kernel = entry.group(2)[:n] + entry.group(2)[n:].split("EEv")[0][:32]
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name} {kernel}: {line.strip()}", file=sys.stderr)
            if re.search(r"[1-9]\d* bytes spill", line) and name in REDESIGNED:
                spills.append(f"{name} {kernel}: {line.strip()}")
    check(not spills, f"register spills in the redesigned kernels: {spills}")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
         built=sorted(reports), allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    matmul_cases, glm_cases = kernel_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    flash_cases, scan_cases = serve_kernel_phase(dev)
    flash_bwd_cases, scan_bwd_cases = train_kernel_phase(dev)

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
    check(cuda["matmul_loaders"]["scalar"] == 0,
          f"Newton products on the scalar loader: {cuda['matmul_loaders']}")
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
    check(dg_cuda["matmul_loaders"]["scalar"] == 0,
          f"DGEMM products on the scalar loader: {dg_cuda['matmul_loaders']}")

    # main path 2: LM serving, through the attention and scan kernels
    serve_launches = serve_phase(dev)
    # main path 3: LM training, through the attention and scan kernels and
    # their backward kernels
    train_launches = train_phase(dev)

    # launches of the main paths' own runs: the block runtime on backend
    # cuda (like the reference's backend, it never routes to glm_fused, held
    # against its plain version above at the main path's shapes), the bf16
    # serve run through the kernels, and the train run
    main_launches = {k: cuda["launches"][k] + dg_cuda["launches"][k]
                     for k in ("matmul", "glm_fused")}
    main_launches.update({k: serve_launches[k] + train_launches[k]
                          for k in ("flash_attention", "mamba_scan")})
    main_launches.update({k: train_launches[k]
                          for k in ("flash_attention_bwd", "mamba_scan_bwd")})
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
        kernel_entry("flash_attention_bwd", FLASH_BWD_SRC, flash_bwd_cases,
                     "train-global bf16", main_launches["flash_attention_bwd"]),
        kernel_entry("mamba_scan_bwd", SCAN_BWD_SRC, scan_bwd_cases,
                     scan_bwd_cases[0]["case"], main_launches["mamba_scan_bwd"]),
    ]}, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
