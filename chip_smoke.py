"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the eight hand-written Hopper kernel libraries from
``src/repro_torch/csrc`` (``matmul``, ``glm_fused``, ``flash_attention``,
``flash_attention_bwd``, ``mamba_scan``, ``mamba_scan_bwd``, ``mamba_step``,
``mamba2_step``; one ``nvcc`` each, all at once), holds
each against its plain PyTorch version at its main path's shapes and times
both (CUDA events), then drives the main paths at full width:

- the block runtime: the paper's logistic-regression Newton loop (n = 2**22
  rows x 256 features, float64, 32 row blocks on a 4-node x 8-worker
  simulated cluster) and a 16384^2 block DGEMM, on backend ``cuda`` (every
  2-D block product through the matmul kernel) and on backend ``torch``
  (plain torch ops): both agree and schedule identically, and the runtime's
  bitwise contracts hold on the card;
- the paper's other block workloads, on the same cluster at f64: CP-ALS
  (``cpals_loop``, a 1024^3 tensor, rank 8, 3 sweeps through reshard) on
  backends ``cuda`` and ``torch`` (the same factors and schedule; fewer
  moved elements than the naive reshard, counted on the sim backend; the fit
  improves), indirect TSQR of the Newton loop's X, a 16384^2 Cholesky and
  its solve, a randomized SVD at rank 32 + 8 of a 2**22 x 256 matrix, L-BFGS
  logistic regression on the paper's data at 2**20 rows in the Newton
  loop's blocks (cuda and torch agree, the loss falls), and lineage checkpoints of the Newton
  loop (a node dies after the checkpoint and recovery reads the archive; a
  fresh context restores the same bits); each comm ratio equals the sim
  backend's on the same graph;
- fault tolerance and observability of the block runtime: the Newton loop
  at n = 2**22 traced and untraced on backends ``cuda`` and ``torch`` (the
  same bits and simulated clocks, the traced/untraced wall within the
  reference's 1.10 gate, the host wall per op kind from the trace report's
  histograms, the critical path summing to 100%, the Perfetto file under
  ``build/fault_obs/``); the reference's chaos scenario on the card at
  n = 2**21 x 256 (bit identity with the fault-free leg, determinism, one
  matmul launch per 2-D product executed, lineage replays included), its
  makespan gate on the reference's own scenario, and a controller leg; a
  calibration profile fitted on the card, whose drift on a held-out traced
  Newton run, per op kind, must fall to half the default cost model's;
- LM serving: hymba-1.5b at its published configuration (32 layers,
  d 1600, bf16, random weights from a seeded generator on the card) serves
  8 prompts of 2048 tokens and generates 32 tokens each through
  ``serve_demo``, with every layer's attention on the flash-attention
  kernel and every layer's prefill scan on the selective-scan kernel; the
  same weights served through the plain versions (teacher-forced with the
  kernel run's tokens) give the same logits to a bf16 tolerance, which a
  planted fault (the local layers' window removed) is shown to exceed; an
  f32 run at full width and 8 layers agrees to 1e-4 with the same tokens;
- continuous batching (``serve.ContinuousBatcher``): hymba-1.5b as published
  (bf16, 8 slots over caches of 4096, 20 requests with seeded prompts of
  64-3072 tokens and 8-48 new tokens) and falcon-mamba-7b as published
  (attention-free, 64 layers, d 4096, 7.27 B parameters in bf16; 4 slots
  over 2048, 8 requests of 128-1536 and 8-24), every request submitted
  before the run; each admission's prefill and every decode step's
  attention on the flash-attention kernel with one query offset per slot,
  each admission's scan on the selective-scan kernel, launches exact.
  Each request's logits agree with its own B = 1 prefill and decode
  teacher-forced with the batcher's tokens to the bf16 serve tolerance,
  which a planted fault (every row at slot 0's offset) is shown to
  exceed; in f32 at full width and 8 layers every request's tokens equal
  its standalone run's, logits to 1e-4.  A line per model reports wall
  time, tokens/s, decode seconds per step, time to first token, mean
  active slots, admissions and peak memory;
- the dense and VLM decoders: gemma3-4b, gemma-7b (head dim 256),
  nemotron-4-15b, command-r-35b (30.28 B parameters, 60.6 GB of bf16
  weights) and qwen2-vl-7b (M-RoPE, embedding prompts), each as published
  in bf16, serve 4 prompts of 2048 tokens and generate 16 through
  ``serve_demo``, one model at a time: every layer's attention on the
  flash-attention kernel, the plain route teacher-forced with the kernel
  route's tokens within the bf16 serve tolerance, a planted fault (a
  window of 1024 on every layer; gemma3-4b's local layers unwindowed)
  shown to exceed it, launch counts exact, and an f32 leg at full width
  and 4 layers with the same tokens;
- the MoE decoders: qwen3-moe-235b-a22b (128 experts, top 8, 64 query
  heads over 4 kv heads) and phi3.5-moe-42b-a6.6b (16 experts, top 2,
  layernorm) at their published width, cut in depth to 11 of 94 and 22 of
  32 layers (57.2 and 57.7 GB of bf16 weights), serve 4 prompts of 2048
  tokens and generate 16 through ``serve_demo`` with the "einsum" dispatch,
  as ``serve_dense`` runs its models (routes, planted fault, launches, the
  share of tokens each layer's prefill routed to other experts on the two
  routes), and an f32 leg at 2 layers where "gather" agrees with "einsum";
- the hybrid Mamba-2 decoder: granite-4.0-h-small at its published width,
  cut to one whole period of 10 layers (9 Mamba-2, attention at 5, the MoE
  of 72 experts and a shared expert on all; 8.36 B parameters in bf16),
  through ``serve.ContinuousBatcher``: 4 prompts of 100-1100 tokens
  admitted in prefill chunks of 512 (the SSD prefill continuing its state
  across chunks and ending mid SSD chunk), then 8 decode steps, each
  Mamba-2 layer's step on the ``mamba2_step`` kernel, launches exact; the
  plain route teacher-forced with the kernel route's tokens and routing
  within the bf16 serve tolerance, step by step;
- the encoder-decoder: whisper-small as published (12 encoder + 12
  decoder layers, d 768, bf16, seeded weights) serves 8 requests of 1500
  frames (30 s of audio; the stub frontend's frames drawn by numpy) with a
  4-token prompt and 64 generated tokens through ``make_prefill`` and
  ``make_serve_step``: the encoder's attention and every decoder layer's
  cross-attention on the flash-attention kernel without a mask (split-KV
  at decode), self-attention causal, launches exact; the plain route
  teacher-forced within the bf16 serve tolerance, a planted fault (the
  encoder's attention made causal) beyond it, an f32 leg at 2 + 2 layers
  with the same tokens;
- LM training: hymba-1.5b at its published configuration (1.66 B
  parameters, f32 master weights and AdamW state, bf16 compute, full remat)
  trains on batches of 4 x 2048 tokens through ``train_loop`` (1 warm-up
  step, 3 timed), with every layer's attention and scan on their kernels
  forward (twice: forward and recompute) and backward, launches counted per
  step; one step's loss and every gradient leaf agree with the plain route
  on the same weights and batch to a bf16 tolerance that a planted fault
  (the window dropped in the backward kernel only) exceeds, and in f32 at
  8 layers to 1e-4; two backward runs give the same bits.  Both routes
  then run the schedule's first two steps at 8 layers, and both loss
  curves are printed.  Then gemma3-4b at its published width
  (d 2560, head dim 256, 262144-token vocabulary) cut to 12 layers (two
  5:1 groups; at full depth its f32 masters and AdamW state alone take 62
  GB) trains the same way (``train_dense``: 1 + 3 steps, launches exact),
  its gradients held to the plain route at 12 layers (a planted fault
  caught) and in f32 at 6 layers, bitwise across two runs.  Then
  whisper-small as published (``train_whisper``) trains on 8 requests of
  1500 frames and 448 target tokens through ``make_train_step`` (1 + 3
  steps and one profiled, launches exact: every encoder, decoder-self and
  cross-attention call forward twice and backward once), its gradients
  held to the plain route (a planted fault, cross-attention made causal,
  caught) and in f32 at 2 + 2 layers, bitwise across two runs.  Every
  train run takes the plan that the LSHS plan optimizer picks on the H100
  table (``choose_plan`` over a 1 x 1 mesh: full remat, bf16 gradients);
- SPMD sharding (``spmd``): those choices, their ranking and estimated
  memory beside each train run's measured peak; gemma3-4b's step time
  against the H100 roofline (model FLOPs utilisation); then one gradient
  step of gemma3-4b (12 layers) and hymba-1.5b at 4 x 2048 under fsdp+tp
  on a 1 x 1 CUDA mesh (NCCL, world of one): parameters and batch as
  DTensors, the attention and scan kernels launched on each rank's local
  shards through ``local_map``, as often as in the same step on plain
  tensors, which it must equal bit for bit; the collectives it issued are
  counted.

Each phase prints one JSON line (a matmul case also names the loader it
took, tma, vector or scalar; an attention-backward case the device time of
each of its kernels); the kernel line, the card's name and power limit, and a
final ``{"ok": true, ...}`` line close the output.  The compiler's register
report of every kernel goes to standard error; a register spill in the
libraries redesigned for Hopper (``REDESIGNED``) fails the run, as does a
Newton or DGEMM product on the scalar loader, or an f64 kernel case with
N > 8 off the TMA ring.  The attention forward is timed
at prefill and at decode, where it splits the keys (two device kernels per
call, whose device times a decode case also reports), also with one offset
per row (``decode-ragged``: 8 slots at their own positions), and at the
dense decoders' shapes (head dim 256, 6 to 8 query heads per kv head) and
whisper-small's with no mask (the encoder, cross prefill and decode) and
the MoE decoders' (rep 16 and 4 at head dim 128), and in f32 at 64 query
heads per kv head at head dim 256 (the most the kernels take); the
attention backward at hymba-1.5b's, gemma3-4b's and whisper-small's train
shapes and at that f32 one; the
scan forward with its checkpoints written, and the scan backward on both
its routes (from the forward's checkpoints, the one training takes, and
without them), which must give the same bits.  The block phases make each
large random block on the host once (``HostBlocks``).  Any failure raises
and exits non-zero.

Needs one CUDA device; exits non-zero without printing a result where there
is none, or where ``src/repro_torch`` is not beside this script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, distribute_tensor  # noqa: E402

from repro_torch.configs.glm_logreg import CONFIG  # noqa: E402
from repro_torch.core import (ArrayContext, ClusterSpec, CostModel,  # noqa: E402
                              Executor, FlightRecorder)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, launches, ops, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_ref, kv_splits,  # noqa: E402
                                                 query_tiles, visible)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.glm_fused import glm_fused_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan_bwd_ref, mamba_scan_ref  # noqa: E402
from repro_torch.kernels.mamba_step import conv_step_ref, state_step_ref  # noqa: E402
from repro_torch.kernels.mamba2_step import state_step_ref as state_step2_ref  # noqa: E402
from repro_torch.kernels.matmul import loaders, matmul_ref, tiles  # noqa: E402
from repro_torch.launch import chaos as chaos_driver  # noqa: E402
from repro_torch.launch.chaos import _newton_iteration  # noqa: E402
from repro_torch.launch.serve import serve_demo  # noqa: E402
from repro_torch.launch.shapes import fit_plan_to_mesh  # noqa: E402
from repro_torch.launch.trace_report import histogram_stats, wall_histograms  # noqa: E402
from repro_torch.launch.train import batch_to, train_loop  # noqa: E402
from repro_torch.launch.workloads import (cpals_loop, dgemm_graph,  # noqa: E402
                                          logreg_newton_loop)
from repro_torch.glm import LogisticRegression, paper_bimodal  # noqa: E402
from repro_torch.linalg import cholesky, cholesky_solve, rsvd, tsqr_indirect  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.obs import analyze, drift_report, run_calibration  # noqa: E402
from repro_torch.obs.calibrate import fastest_retires  # noqa: E402
from repro_torch.serve import ContinuousBatcher  # noqa: E402
from repro_torch.models.partitioning import fit_spec, spec_placements  # noqa: E402
from repro_torch.sharding import (H100_SXM, CollectiveCounter, Plan,  # noqa: E402
                                  activation_rules, batch_specs, choose_plan,
                                  local_param_numel, shard_tree)
from repro_torch.sharding.roofline import mfu, roofline  # noqa: E402
from repro_torch.train import (AdamConfig, DataConfig, TokenPipeline,  # noqa: E402
                               init_opt_state, make_grad_fn, make_prefill,
                               make_serve_step, make_train_step)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import _leaves  # noqa: E402

#: which of ``H100_SXM``'s peaks (dense, at the full 700 W limit) bounds a
#: kernel of each dtype, and that peak's name
PEAK = {torch.float64: (H100_SXM.peak_fp64, "FP64 tensor"),
        torch.float32: (H100_SXM.peak_fp32, "FP32"),
        torch.bfloat16: (H100_SXM.peak_bf16, "BF16 tensor")}
PEAK_NAME = {dt: f"{name} {peak / 1e12:g} TFLOP/s" for dt, (peak, name) in PEAK.items()}
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
#: the paper's other block workloads, on the Newton loop's cluster, f64:
#: CP-ALS on a dim^3 tensor (8.6 GB, the size of the Newton loop's X) in q
#: row slabs; TSQR of the Newton loop's X; Cholesky of an n^2 SPD matrix on a
#: (g, g) grid; a randomized SVD (its sample has rank + oversample columns,
#: and the matrix has exactly that rank, which tsqr_indirect's Q = Y R^-1
#: needs: at rank 32 alone the sketch's last 8 columns are rank-deficient);
#: L-BFGS on the paper's data at 2**20 rows in 8 blocks (the Newton loop's
#: block shape, 131072 x 256; at the Newton loop's 2**22 rows numpy took
#: about 60 s to make the data), with the ridge of the reference's own
#: paper-data test (tests/test_glm.py): the data are separable, and without
#: a ridge the first step takes the loss to exactly 0 and the fit stops
#: after 2 iterations
CPALS = dict(dim=1024, rank=8, q=4, sweeps=3)
CHOL = dict(n=16384, g=4)
RSVD = dict(rank=32, oversample=8)
LBFGS = dict(n=1 << 20, q=8, iters=10, reg=1e-2)
#: CP-ALS and L-BFGS, backend cuda against torch: relative to max|factor| /
#: max|beta| (another summation order); TSQR, Cholesky and the rSVD: the
#: reference's own limits at f64 (tests/test_linalg_ca.py), Frobenius norms
BLOCK_RTOL = 1e-8
QR_TOL = dict(residual=1e-12, orthogonality=1e-10)
CHOL_TOL = dict(factor=1e-12, solve=1e-10)
RSVD_TOL = 1e-10
CONTRACT_N = 1 << 16
#: the fault-tolerance and observability phase, on the Newton loop's
#: cluster and size: traced against untraced passes (alternating, after one
#: warm-up), the median of the pairs' wall ratios within the reference's gate
FAULT_OBS = dict(runs=61, trace_gate=1.10, dir=Path(__file__).resolve().parent
                 / "build" / "fault_obs")
#: the reference's chaos scenario (its driver's defaults: 8 nodes x 2
#: workers, 1 dead node, 2 stragglers at 4x, transient fault probability
#: 0.02, 3 iterations) at d = 256.  n is cut from the Newton loop's 2**22 to
#: 2**21 (2**20 for the controller's legs): the driver runs three legs, each
#: creating X on the host and holding it on the card
CHAOS = dict(nodes=8, workers=2, n=1 << 21, d=CONFIG.n_features, iters=3, fail_nodes=1,
             stragglers=2, slowdown=4.0, fault_prob=0.02)
CHAOS_CONTROLLER_N = 1 << 20
#: the reference's makespan gate (``launch.chaos --assert-gate``: degraded
#: <= 1.5x fault-free) holds on its own scenario (n = 64 x nodes, d = 32).
#: The ratio is simulated, so it is the reference's on any backend, and it
#: grows with the blocks: at 2**16 x 256 it is already 2.6, since 4x
#: stragglers on compute-heavy blocks find no faster duplicate.  The gate
#: is therefore held on the reference's scenario on the card, and the
#: ratio at CHAOS's size is recorded.
CHAOS_GATE = dict(scenario=dict(nodes=8, workers=2, iters=3, fail_nodes=1, stragglers=2,
                                slowdown=4.0, fault_prob=0.02), limit=1.5)
#: calibration on the card: the Newton loop's body at the main path's block
#: shape (2**20 rows in 8 blocks of 131072 x 256) and a block-size sweep up
#: to that shape, each op's fastest of ``repeats`` passes; then a held-out
#: traced Newton run at the main path's size, whose drift (|ln predicted /
#: measured| over op seconds) must fall to DRIFT_GATE x the default cost
#: model's (the reference's gate), taken per op kind and averaged over the
#: kinds.  The reference gates the drift of the total instead; on the card
#: the default model's total lands within e^0.2-0.6 of the measured one
#: while it misses the small ops by e^2-e^7, so the total's ratio mostly
#: measures how the host's speed moved between calibration and hold-out
#: (PERF.md §6).  Both are printed.
CALIB = dict(nodes=4, workers=8, n=1 << 20, d=CONFIG.n_features, q=8, iters=2,
             sweep=(64, 128, 256, (8192, 256), (32768, 256), (131072, 256)), repeats=3)
DRIFT_GATE = 0.5
#: profiled passes of the held-out run; each op's fastest counts, as in the
#: calibration: the host's stalls (~5% a pass there) only ever add time
HELD_OUT_PASSES = 3
#: the serve path: hymba-1.5b at its published width and depth
SERVE = dict(arch="hymba-1.5b", batch=8, prompt_len=2048, gen=32)
#: the f32 check: full width, 8 layers (layer 7 is the first global one)
SERVE_F32_LAYERS = 8
#: a continuous-batching decode step's attention: 8 slots at their own
#: positions over serve_batched's hymba cache, from the first key to the last
RAGGED = dict(max_len=4096, offsets=(0, 63, 1023, 1024, 2047, 2500, 3071, 4095))
#: depth of the warm-up runs before each timed pair of serve runs (and before
#: each serve_batched model)
SERVE_WARM_LAYERS = 2
#: continuous batching (serve/batcher.py): each model at its published width
#: and depth, bf16, seeded weights; every request submitted before the run,
#: prompt lengths and max_new drawn by numpy over these inclusive ranges
SERVE_BATCHED = (
    dict(arch="hymba-1.5b", slots=8, max_len=4096, requests=20, prompt=(64, 3072),
         new=(8, 48)),
    dict(arch="falcon-mamba-7b", slots=4, max_len=2048, requests=8, prompt=(128, 1536),
         new=(8, 24)),
)
#: the dense and VLM decoders (serve_dense): each as published (width and
#: depth) in bf16 with seeded weights, served a batch of prompts through
#: serve_demo (max_len = prompt_len + gen + 1 = 2065)
SERVE_DENSE = dict(archs=("gemma3-4b", "gemma-7b", "nemotron-4-15b", "command-r-35b",
                          "qwen2-vl-7b"), batch=4, prompt_len=2048, gen=16)
#: each one's f32 leg: full width, 4 layers
SERVE_DENSE_F32 = dict(layers=4, batch=2, prompt_len=512, gen=8)
#: the planted fault of a model without a window: this window on every layer
#: (gemma3-4b's fault is serve_phase's, its local layers' window removed)
DENSE_FAULT_WINDOW = 1024
#: block values of at least this many elements that the block phases make
#: once on the host and hand out again (HostBlocks)
HOST_BLOCK_MIN = 1 << 20
#: the train path: hymba-1.5b at its published width and depth, f32 master
#: weights and AdamW state, bf16 compute, full remat; 1 warm-up step, then
#: TRAIN["steps"] timed ones, then one step under torch.profiler
TRAIN = dict(arch="hymba-1.5b", batch=4, seq=2048, warm=1, steps=3, lr=1e-2)
#: the f32 attention at the most query heads per kv head the kernels take
#: (64) and head dim 256, causal, forward and backward, batch 1
REP64_F32 = dict(q=(1, 64, 1024, 256), kv=(1, 1, 1024, 256))
#: device kernels of a train step by what they do, matched on their names
KERNEL_GROUPS = (
    ("attention forward", ("flash_fwd_f32_kernel", "flash_fwd_mma_kernel",
                           "flash_split_combine_kernel")),
    ("attention backward", ("dkv_f32_kernel", "dq_f32_kernel", "dkv_mma_kernel",
                            "dq_mma_kernel", "delta_kernel")),
    ("scan forward", ("mamba_scan_kernel",)),
    ("scan backward", ("scan_bwd_kernel", "dc_sum_kernel")),
    ("matrix products (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
)
#: depth of the plain route's gradient step held against the kernel route
TRAIN_PLAIN_LAYERS = 32
#: the loss curves of both routes: TRAIN's first steps under its lr schedule
#: at TRAIN_PLAIN_CURVE_LAYERS layers (the plain route takes about 35 s a
#: step at the published 32): enough to show both curves agree at step 0 and
#: part by rounding at step 1
TRAIN_PLAIN_STEPS = 2
TRAIN_PLAIN_CURVE_LAYERS = 8
#: the f32 gradient check: full width, 8 layers (layer 7 global), batch 1
TRAIN_F32 = dict(layers=8, batch=1)
#: the dense train path (train_dense): gemma3-4b at its published width, cut
#: to 12 layers (two whole 5:1 groups: 10 local, 2 global), because at full
#: depth 3.88 B parameters x 16 bytes of f32 masters, gradients and AdamW
#: moments (62 GB) and the bf16 copy and the 262144-wide logits pass the
#: card's 80 GB; otherwise as TRAIN but for the peak lr, 1e-3 (at TRAIN's
#: 1e-2 the loss rose from 11.6 to 31.5 at step 4 on an NVIDIA H100 80GB
#: HBM3 at 700.00 W)
TRAIN_DENSE = dict(arch="gemma3-4b", layers=12, batch=4, seq=2048, warm=1, steps=3, lr=1e-3)
#: its f32 gradient check: full width, 6 layers (layer 5 global), batch 1
TRAIN_DENSE_F32 = dict(layers=6, batch=1)
#: the encoder-decoder serve path (serve_whisper): whisper-small as published
#: (12 + 12 layers), bf16, seeded weights; 8 requests of 30 s of audio (1500
#: frames at 20 ms: the enc_max_len users feed), a 4-token prompt, 64 tokens
SERVE_WHISPER = dict(arch="whisper-small", batch=8, frames=1500, prompt_len=4, gen=64)
#: its f32 leg: full width, 2 + 2 layers, the same requests
SERVE_WHISPER_F32 = dict(layers=2, enc_layers=2)
#: the MoE decoders (serve_moe): each at its published width (every expert,
#: the router, top-k, d_model, heads, vocabulary) cut in depth so that its
#: bf16 weights stay near command-r-35b's 60.6 GB beside the plain route's
#: work: qwen3-moe-235b-a22b at 11 of 94 layers (57.2 GB: 2.488 B
#: parameters a layer, 1.245 B in the embedding and head) and
#: phi3.5-moe-42b-a6.6b at 22 of 32 (57.7 GB: 1.300 B a layer); bf16,
#: seeded weights, served a batch of prompts through serve_demo
SERVE_MOE = dict(layers={"qwen3-moe-235b-a22b": 11, "phi3.5-moe-42b-a6.6b": 22}, batch=4,
                 prompt_len=2048, gen=16, dispatch_mode="einsum")
#: each one's f32 leg: full width, 2 layers; there "gather" must agree with
#: "einsum" to MOE_MODES_TOL of max|logit| (another summation order) with
#: the same tokens
SERVE_MOE_F32 = dict(layers=2, batch=2, prompt_len=512, gen=8)
MOE_MODES_TOL = 1e-5
#: granite-4.0-h-small through the batcher at its published width, cut to
#: one whole period (granite-decode-256's stage: Mamba-2 at 0-4 and 6-9,
#: attention at 5); the prompts end mid SSD chunk (256) and the longer ones
#: cross prefill chunks; seeded prompts and weights, bf16
SERVE_GRANITE = dict(arch="granite-4.0-h-small", layers=10, prompts=(100, 300, 517, 1100),
                     prefill_chunk=512, max_len=1280, steps=8)
#: the encoder-decoder train path (train_whisper): whisper-small as published
#: (12 + 12 layers), f32 masters and AdamW, bf16 compute, full remat; 8
#: requests of 1500 frames and 448 target tokens (whisper's text context);
#: 1 warm-up step, 3 timed, 1 under torch.profiler
TRAIN_WHISPER = dict(arch="whisper-small", batch=8, frames=1500, seq=448, warm=1, steps=3,
                     lr=1e-3)
#: its f32 gradient check: full width, 2 + 2 layers, batch 1
TRAIN_WHISPER_F32 = dict(layers=2, enc_layers=2, batch=1)
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
#: the plan optimizer's mesh on one card: the train phases take its choice
#: (train_loop's plan=None), and so does train_whisper
ONE_CARD = {"data": 1, "model": 1}
#: the sharded path (spmd): on a 1 x 1 CUDA mesh, one gradient step of each
#: model at its train phase's width and shape (gemma3-4b at TRAIN_DENSE's 12
#: layers) under fsdp+tp with the dots policy, parameters and batch as
#: DTensors and the attention and scan kernels on local shards, against the
#: same step on plain tensors: every collective moves nothing, so the two
#: must agree bit for bit
SPMD = dict(models=(("gemma3-4b", 12), ("hymba-1.5b", None)), batch=4, seq=2048,
            plan=Plan("fsdp_tp", tp_axis="model", fsdp_axis=("data",), remat="dots"))
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
#: replaces no TPU kernel: the reference's Mamba decode step is plain JAX
STEP_SRC = ("src/repro_torch/csrc/mamba_step.cu",
            "none (the reference's decode step, src/repro/models/ssm.py, is plain JAX)")
#: the Mamba decode step at jamba-decode-32's shapes: 32 rows, Jamba's widths
#: (DI 8192, N 16, dt_rank 256, the dt/B/C norms), bf16; kernels against the
#: plain versions relative to the largest plain value, as
#: tests/test_torch_mamba_step.py holds them (the plain versions round to
#: bf16 where the kernels keep f32)
STEP = dict(arch="jamba2-mini", batch=32, tol={"y": 3e-2, "ssm": 1e-2})
#: replaces no TPU kernel: the reference has no Mamba-2
STEP2_SRC = ("src/repro_torch/csrc/mamba2_step.cu", "none (the reference has no Mamba-2)")
#: the Mamba-2 decode step at granite-decode-256's shapes: 256 rows, 128 heads
#: of 64, N 128, one group, bf16; the kernels against the plain version
#: relative to the largest plain value, as tests/test_torch_granite.py holds
#: them (both keep f32 until y rounds to bf16)
STEP2 = dict(arch="granite-4.0-h-small", batch=256, tol={"y": 8e-3, "ssm": 1e-5})
#: the libraries whose kernels were redesigned for Hopper (tensor cores,
#: asynchronous copies, split-KV, the scan's checkpoints); their ptxas report
#: must show no register spills
REDESIGNED = ("matmul", "flash_attention", "flash_attention_bwd", "mamba_scan",
              "mamba_scan_bwd", "mamba_step", "mamba2_step")
#: every kernel library, built at once
KERNELS = ["matmul", "glm_fused", "flash_attention", "flash_attention_bwd", "mamba_scan",
           "mamba_scan_bwd", "mamba_step", "mamba2_step"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def check(ok, what) -> None:
    """Fail the run (a plain ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def _release() -> None:
    """Free what the dropped objects held on the card (a block context holds
    reference cycles, so only the collector frees its store)."""
    gc.collect()
    torch.cuda.empty_cache()


class HostBlocks:
    """The block runtime makes every random block with numpy on the host (the
    same bits on every backend), seeded by the context's seed and the order
    of creation, so the block phases create the same blocks again and again:
    the Newton loop's 8.6 GB X in seven runs, the CP-ALS tensor in two, the
    DGEMM's operands in two.  Inside this context ``Executor.create`` hands a
    random or uniform block of at least HOST_BLOCK_MIN elements the array
    made the first time, as the block's value (which a lineage replay then
    reuses): the same bits, made once.  What it saves is host time that no
    phase measures (each phase's clock starts after its operands exist)."""

    def __enter__(self):
        self.arrays = {}
        real = self.real = Executor.create

        def create(ex, vid, shape, placement, kind="zeros", value=None, seed=None,
                   ckpt=None):
            if (value is None and kind in ("random", "uniform") and ex.mode != "sim"
                    and math.prod(shape) >= HOST_BLOCK_MIN):
                key = (kind, seed, tuple(shape))
                if key not in self.arrays:
                    rng = np.random.default_rng(seed)
                    self.arrays[key] = (rng.standard_normal(shape) if kind == "random"
                                        else rng.random(shape))
                value = self.arrays[key]
            return real(ex, vid, shape, placement, kind, value, seed, ckpt)

        Executor.create = create
        return self

    def __exit__(self, *exc):
        Executor.create = self.real
        self.arrays.clear()


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
    t_ops = ops_count / PEAK[dtype][0] * 1e3
    t_bytes = bytes_count / H100_SXM.hbm_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def matmul_case(name, a, b):
    dtype = a.dtype
    reset_launches()
    got = ops.matmul(a, b)
    loader = next((k for k, n in loaders.items() if n), "none")  # the launch's loader
    block_tile = next((k for k, n in tiles.items() if n), None)  # f64 wide: its block tile
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
                loader=loader, tile=block_tile, max_abs_err=err, rel_err=rel,
                tol=MATMUL_TOL[dtype],
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
    sq = [x.double() for x in sq]
    # the DGEMM cells' tiles (16384^2 on 4 x 4 and 16 x 16 grids)
    matmul_cases.append(matmul_case("DGEMM tile f64 4096^3", sq[0], sq[1]))
    sq = [x[:1024, :1024].contiguous() for x in sq]
    matmul_cases.append(matmul_case("DGEMM tile f64 1024^3", sq[0], sq[1]))
    del sq
    scalar = [c["case"] for c in matmul_cases if c["dtype"] != "bfloat16"
              and c["loader"] == "scalar"]
    check(not scalar, f"matmul cases on the scalar loader: {scalar}")
    # f64 with N > 8 on aligned operands fills dmma_kernel's ring by TMA
    off_tma = [c["case"] for c in matmul_cases if c["dtype"] == "float64"
               and c["shape"][2] > 8 and c["loader"] != "tma"]
    check(not off_tma, f"f64 wide matmul cases off the TMA ring: {off_tma}")
    matmul_cases += block_matmul_cases(dev, g)
    glm_cases = []
    for n in (1 << 22, n_blk):
        z = torch.randn(n, 1, device=dev, dtype=torch.float64, generator=g) * 4
        y = (torch.rand(n, 1, device=dev, generator=g) > 0.5).double()
        glm_cases.append(glm_case(f"({n}, 1) f64", z, y))
    return matmul_cases, glm_cases


def block_matmul_cases(dev, g):
    """The matmul kernel at the products of the block-algorithms phase, f64:
    CP-ALS's MTTKRP (a row slab of the mode unfolding by the Khatri-Rao
    product) and Gram, the randomized SVD's products (and the build of its
    low-rank input), Cholesky's build and solve products.  L-BFGS's X @ beta
    and X^T r are the Newton cases above.  A shape that takes the scalar
    loader, or loses to torch.matmul, is recorded, not failed."""
    def rnd(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.float64, generator=g)

    dim, rank = CPALS["dim"], CPALS["rank"]
    X, kr = rnd(dim // CPALS["q"], dim * dim), rnd(dim * dim, rank)
    cases = [matmul_case("CP-ALS MTTKRP f64", X, kr)]
    del X, kr
    F = rnd(dim, rank)
    cases.append(matmul_case("CP-ALS Gram f64", F.mT, F))
    n_blk, d = NEWTON["n"] // NEWTON["q"], NEWTON["d"]
    sketch = RSVD["rank"] + RSVD["oversample"]
    A, omega, Q, ub = rnd(n_blk, d), rnd(d, sketch), rnd(n_blk, sketch), rnd(sketch, sketch)
    cases += [matmul_case("rSVD A@Omega f64", A, omega),
              matmul_case("rSVD A^T Q f64", A.mT, Q),
              matmul_case("rSVD Q@Ub^T f64", Q, ub.mT),
              matmul_case("rSVD build U@V^T f64", Q, omega.mT)]
    del A, omega, Q, ub
    b = CHOL["n"] // CHOL["g"]
    M, y = rnd(b, b), rnd(b, 1)
    cases += [matmul_case("Cholesky build M@M^T tile f64", M, M.mT),
              matmul_case("Cholesky solve L@y f64", M, y),
              matmul_case("Cholesky solve L^T x f64", M.mT, y)]
    del M, y
    _release()
    return cases


def serve_shapes():
    """The serve path's attention and scan shapes: hymba-1.5b's heads, state
    and window, at SERVE's batch and prompt, over a cache of max_len."""
    cfg = get_config(SERVE["arch"])
    B, S = SERVE["batch"], SERVE["prompt_len"]
    max_len = S + SERVE["gen"] + 1
    return dict(B=B, S=S, max_len=max_len, H=cfg.n_heads, KV=cfg.n_kv_heads,
                hd=cfg.resolved_head_dim, window=cfg.window,
                DI=cfg.ssm.d_inner(cfg.d_model), N=cfg.ssm.d_state)


def flash_case(name, q, k, v, window, q_offset, causal=True):
    """One attention case; ``q_offset`` an int, or a tuple of per-row offsets
    (handed to the kernel as a (B,) int32 tensor on the card with its host
    max, as continuous batching hands them); ``causal`` False sees every
    key (whisper's encoder and cross-attention)."""
    dtype = q.dtype
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    per_row = isinstance(q_offset, tuple)
    offset, host_max = q_offset, q_offset
    if per_row:
        offset = torch.tensor(q_offset, dtype=torch.int32, device=q.device)
        host_max = max(q_offset)
    kw = dict(causal=causal, window=window, q_offset=offset,
              max_offset=host_max if per_row else None)
    got = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, causal, window, offset)
    sync()
    check(torch.equal(got, again), f"flash_attention {name}: two launches differ")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    mask = visible(Sq, Skv, causal, window, offset, q.device)  # (B,) Sq, Skv
    rows = mask if per_row else mask.expand(B, Sq, Skv)
    pairs = int(rows.sum().item())               # (query, key) pairs this run needs
    keys = int(rows.any(dim=1).sum().item())     # keys any query of each row sees
    sdpa_mask = mask[:, None] if per_row else mask
    # QK^T and PV: 2 flops each per (pair, head, dim)
    bound_ms, bound_by = bound(4.0 * H * pairs * hd,
                               (2 * B * H * Sq * hd + 2 * KV * keys * hd)
                               * q.element_size(), dtype)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=sdpa_mask, enable_gqa=True)
    splits = kv_splits(B, KV, H // KV, Sq, Skv, hd, causal, window, host_max)
    case = dict(case=name, dtype=str(dtype).replace("torch.", ""),
                q=list(q.shape), kv=list(k.shape), causal=causal, window=window,
                q_offset=list(q_offset) if per_row else q_offset,
                splits=splits, blocks=B * KV * query_tiles(H // KV, Sq) * splits,
                max_abs_err=err, rel_err=rel, tol=FLASH_TOL[dtype],
                ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, causal, window,
                                                             offset)),
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


def step_case(dev, g):
    """The Mamba decode step at STEP's shapes: the two kernels around the
    x_proj product against the plain versions on copies of one cache row;
    device time of each kernel, the whole step's CUDA-event time on both
    routes, and the kernels' byte bound (the SSM state read and written,
    dt_proj, the conv state, x, z and y; the x_proj product is not theirs)."""
    cfg = get_config(STEP["arch"])
    s, B, D = cfg.ssm, STEP["batch"], cfg.d_model
    DI, N, K, R = s.d_inner(D), s.d_state, s.d_conv, s.resolved_dt_rank(D)

    def u(*shape, scale=1.0, dtype=torch.bfloat16):
        return ((torch.rand(shape, device=dev, generator=g) * 2 - 1) * scale).to(dtype)

    p = {"conv_w": u(K, DI, scale=0.5), "conv_b": u(DI, scale=0.3),
         "x_proj": u(DI, R + 2 * N, scale=DI ** -0.5), "dt_proj": u(R, DI, scale=R ** -0.5),
         "dt_bias": u(DI, scale=0.5) - 4.6, "D": torch.ones(DI, device=dev).bfloat16(),
         "A_log": torch.log(torch.arange(1, N + 1, device=dev).float()).expand(DI, N)
         .contiguous().bfloat16(),
         "norms": [u(R, scale=0.3), u(N, scale=0.3), u(N, scale=0.3)]}
    xz = u(B, 1, 2 * DI)
    conv0, ssm0 = u(B, K - 1, DI), u(B, DI, N, dtype=torch.float32)

    def step(conv, state, plain=False):
        conv_step, state_step = ((conv_step_ref, state_step_ref) if plain
                                 else (ops.mamba_conv_step, ops.mamba_state_step))
        x, z = torch.chunk(xz, 2, dim=-1)
        x, _ = conv_step(x, conv, p["conv_w"], p["conv_b"])
        y, _ = state_step(x @ p["x_proj"], x, z, state, p["dt_proj"], p["dt_bias"],
                          p["A_log"], p["D"], *p["norms"], eps=cfg.norm_eps)
        return y

    kern = {"conv": conv0.clone(), "ssm": ssm0.clone()}
    plain = {"conv": conv0.clone(), "ssm": ssm0.clone()}
    reset_launches()
    y, y_ref = step(kern["conv"], kern["ssm"]), step(plain["conv"], plain["ssm"], plain=True)
    sync()
    check(launches["mamba_step"] == 1, f"mamba_step launches {launches['mamba_step']}")
    check(torch.equal(kern["conv"], plain["conv"]), "mamba_step: the conv states differ")
    err = {"y": ((y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()).item(),
           "ssm": ((kern["ssm"] - plain["ssm"]).abs().max()
                   / plain["ssm"].abs().max()).item()}
    state_bytes = (8 * B * DI * N + 2 * (R * DI + DI * N + 3 * B * DI + B * (R + 2 * N)))
    conv_bytes = 2 * (2 * B * (K - 1) * DI + 2 * B * DI + K * DI)
    # f32 arithmetic off the tensor cores: dt's product over R, then ~12 a lane
    bound_ms, bound_by = bound(B * DI * (2.0 * R + 12 * N), state_bytes + conv_bytes,
                               torch.float32)
    device = device_ms_by_kernel(lambda: step(kern["conv"], kern["ssm"]),
                                 {"conv": "conv_step_kernel", "state": "state_step_kernel"})
    case = dict(case=f"decode B {B} DI {DI} N {N} R {R} bf16", dtype="bfloat16",
                shape=[B, DI, N, R], max_abs_err=max(err.values()), rel_err=err,
                tol=STEP["tol"], ms=device["conv"] + device["state"], device_ms=device,
                step_ms=time_ms(lambda: step(kern["conv"], kern["ssm"])),
                plain_ms=time_ms(lambda: step(plain["conv"], plain["ssm"], plain=True)),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                peak=PEAK_NAME[torch.float32])
    emit("kernel_case", kernel="mamba_step", **case)
    check(all(err[k] <= STEP["tol"][k] for k in err), f"mamba_step: rel err {err}")
    return case


def step2_case(dev, g):
    """The Mamba-2 decode step after its conv at STEP2's shapes: the state
    and norm kernels against the plain version on copies of the state;
    device time of each kernel, the call's CUDA-event time on both routes,
    and the byte bound (the f32 state read and written, xBC, dt and z read,
    y written, the head parameters and the norm's scale read)."""
    cfg = get_config(STEP2["arch"])
    s, B = cfg.ssm, STEP2["batch"]
    H, P, N, G = s.n_heads, s.head_dim, s.d_state, s.n_groups
    DI, CC = H * P, H * P + 2 * G * N

    def u(*shape, scale=1.0, dtype=torch.bfloat16):
        return ((torch.rand(shape, device=dev, generator=g) * 2 - 1) * scale).to(dtype)

    xbc, dt, z = u(B, 1, CC), u(B, 1, H), u(B, 1, DI)
    params = (u(H, scale=0.5) - 4.6,
              torch.log(torch.arange(1, H + 1, device=dev).float()).bfloat16(),
              torch.ones(H, device=dev).bfloat16(), u(DI, scale=0.3))
    state0 = u(B, H, P, N, dtype=torch.float32)
    kern, plain = state0.clone(), state0.clone()

    def step(state, route=ops.mamba2_state_step):
        return route(xbc, dt, z, state, *params, eps=cfg.norm_eps)[0]

    reset_launches()
    y, y_ref = step(kern), step(plain, state_step2_ref)
    sync()
    check(launches["mamba2_step"] == 1, f"mamba2_step launches {launches['mamba2_step']}")
    err = {"y": ((y.float() - y_ref.float()).abs().max() / y_ref.float().abs().max()).item(),
           "ssm": ((kern - plain).abs().max() / plain.abs().max()).item()}
    state_bytes = 8 * B * H * P * N + 2 * (B * (CC + H + 2 * DI) + 3 * H + DI)
    # two fused multiply-adds a state element, then ~8 an output channel
    bound_ms, bound_by = bound(4.0 * B * H * P * N + 8.0 * B * DI, state_bytes,
                               torch.float32)
    device = device_ms_by_kernel(lambda: step(kern), {"state": "mamba2_state_kernel",
                                                      "norm": "mamba2_norm_kernel"})
    case = dict(case=f"decode B {B} H {H} P {P} N {N} bf16", dtype="bfloat16",
                shape=[B, H, P, N], max_abs_err=max(err.values()), rel_err=err,
                tol=STEP2["tol"], ms=device["state"] + device["norm"], device_ms=device,
                step_ms=time_ms(lambda: step(kern)),
                plain_ms=time_ms(lambda: step(plain, state_step2_ref), max_reps=5),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                peak=PEAK_NAME[torch.float32])
    emit("kernel_case", kernel="mamba2_step", **case)
    check(all(err[k] <= STEP2["tol"][k] for k in err), f"mamba2_step: rel err {err}")
    return case


def ragged_decode_cases(dev, g):
    """A continuous-batching decode step of hymba-1.5b: 8 slots, each at its
    own position in a cache of RAGGED["max_len"], global and local."""
    cfg = get_config(SERVE["arch"])
    B, H, KV, hd = len(RAGGED["offsets"]), cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (torch.rand((B, H, 1, hd), device=dev, generator=g) * 2 - 1).bfloat16()
    k, v = ((torch.rand((B, KV, RAGGED["max_len"], hd), device=dev, generator=g) * 2 - 1)
            .bfloat16() for _ in range(2))
    cases = [flash_case("decode-ragged bf16", q, k, v, None, RAGGED["offsets"]),
             flash_case("decode-ragged-local bf16", q, k, v, cfg.window, RAGGED["offsets"])]
    del q, k, v
    return cases


def serve_kernel_phase(dev):
    """Both new kernels at the serve path's shapes: prefill of the global and
    the local layers, a decode step at the last prompt position, a ragged
    decode step (each row at its own position, as continuous batching runs
    it), and the prefill scan."""
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
            flash += ragged_decode_cases(dev, g)
        del q, k, v
        _release()
    N, DI = sh["N"], sh["DI"]
    dA = torch.rand(B, S, DI, N, device=dev, generator=g) * 0.49 + 0.5
    dBx = torch.rand(B, S, DI, N, device=dev, generator=g) * 2 - 1
    C = torch.rand(B, S, N, device=dev, generator=g) * 2 - 1
    scan = [scan_case(f"prefill {list(dA.shape)} f32", dA, dBx, C)]
    del dA, dBx, C
    _release()
    return flash, scan, [step_case(dev, g)]


def dense_kernel_cases(dev):
    """The attention kernel at serve_dense's shapes, bf16 unless named:
    gemma3-4b (hd 256, rep 2) prefill of its global and local layers, a
    decode step, a ragged decode step over a 4096 cache and an f32 prefill
    (batch 1); an f32 prefill at REP64_F32 (rep 64, hd 256); gemma-7b's
    prefill (hd 256, rep 1); command-r-35b's prefill and decode step (hd
    128, rep 8); qwen2-vl-7b's prefill (hd 128, rep 7)."""
    g = torch.Generator(device=dev).manual_seed(2)
    B, S = SERVE_DENSE["batch"], SERVE_DENSE["prompt_len"]
    max_len = S + SERVE_DENSE["gen"] + 1

    def u(*shape, dtype=torch.bfloat16):
        return (torch.rand(shape, device=dev, generator=g) * 2 - 1).to(dtype)

    def heads(arch):
        cfg = get_config(arch)
        return cfg, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    cases = []
    cfg, H, KV, hd = heads("gemma3-4b")
    q, k, v = u(B, H, S, hd), u(B, KV, max_len, hd), u(B, KV, max_len, hd)
    cases += [flash_case("gemma3-4b prefill-global bf16", q, k, v, None, 0),
              flash_case("gemma3-4b prefill-local bf16", q, k, v, cfg.window, 0),
              flash_case("gemma3-4b decode bf16", q[:, :, :1].contiguous(), k, v, None, S)]
    q32, k32, v32 = (t[:1].float() for t in (q, k, v))
    cases.append(flash_case("gemma3-4b prefill-global f32 (batch 1)", q32, k32, v32, None, 0))
    del q, k, v, q32, k32, v32
    q, k, v = (u(*REP64_F32[n], dtype=torch.float32) for n in ("q", "kv", "kv"))
    cases.append(flash_case("rep 64 hd 256 prefill-global f32 (batch 1)", q, k, v, None, 0))
    del q, k, v
    rows = len(RAGGED["offsets"])
    q, k, v = u(rows, H, 1, hd), u(rows, KV, RAGGED["max_len"], hd), u(rows, KV,
                                                                        RAGGED["max_len"], hd)
    cases.append(flash_case("gemma3-4b decode-ragged bf16", q, k, v, None, RAGGED["offsets"]))
    del q, k, v
    _, H, KV, hd = heads("gemma-7b")
    q, k, v = u(B, H, S, hd), u(B, KV, max_len, hd), u(B, KV, max_len, hd)
    cases.append(flash_case("gemma-7b prefill-global bf16", q, k, v, None, 0))
    del q, k, v
    _release()
    _, H, KV, hd = heads("command-r-35b")
    q, k, v = u(B, H, S, hd), u(B, KV, max_len, hd), u(B, KV, max_len, hd)
    cases += [flash_case("command-r-35b prefill-global bf16", q, k, v, None, 0),
              flash_case("command-r-35b decode bf16", q[:, :, :1].contiguous(), k, v, None, S)]
    del q, k, v
    _release()
    _, H, KV, hd = heads("qwen2-vl-7b")
    q, k, v = u(B, H, S, hd), u(B, KV, max_len, hd), u(B, KV, max_len, hd)
    cases.append(flash_case("qwen2-vl-7b prefill-global bf16", q, k, v, None, 0))
    del q, k, v
    _release()
    return cases


def whisper_kernel_cases(dev):
    """The attention kernel at serve_whisper's shapes, no mask (whisper-small:
    12 heads, rep 1, hd 64): the encoder over SERVE_WHISPER's frames (1500,
    a ragged length), cross-attention at prefill (the prompt's queries over
    the frames) and at a decode step (one query: split-KV), bf16; and the
    encoder in f32 (batch 1)."""
    g = torch.Generator(device=dev).manual_seed(3)
    cfg = get_config(SERVE_WHISPER["arch"])
    B, T, P = SERVE_WHISPER["batch"], SERVE_WHISPER["frames"], SERVE_WHISPER["prompt_len"]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def u(*shape, dtype=torch.bfloat16):
        return (torch.rand(shape, device=dev, generator=g) * 2 - 1).to(dtype)

    q, k, v = u(B, H, T, hd), u(B, KV, T, hd), u(B, KV, T, hd)
    cases = [flash_case("whisper-small encoder bf16", q, k, v, None, 0, causal=False),
             flash_case("whisper-small cross-prefill bf16", q[:, :, :P].contiguous(), k, v,
                        None, 0, causal=False),
             flash_case("whisper-small cross-decode bf16", q[:, :, :1].contiguous(), k, v,
                        None, 0, causal=False)]
    q32, k32, v32 = (t[:1].float() for t in (q, k, v))
    cases.append(flash_case("whisper-small encoder f32 (batch 1)", q32, k32, v32, None, 0,
                            causal=False))
    del q, k, v, q32, k32, v32
    _release()
    return cases


def moe_kernel_cases(dev):
    """The attention kernel at serve_moe's shapes, bf16 (head dim 128):
    qwen3-moe-235b-a22b's prefill and decode step (64 query heads over 4
    kv heads: rep 16) and phi3.5-moe-42b-a6.6b's prefill (rep 4)."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, S = SERVE_MOE["batch"], SERVE_MOE["prompt_len"]
    max_len = S + SERVE_MOE["gen"] + 1

    def u(*shape):
        return (torch.rand(shape, device=dev, generator=g) * 2 - 1).bfloat16()

    cases = []
    for arch, decode in (("qwen3-moe-235b-a22b", True), ("phi3.5-moe-42b-a6.6b", False)):
        cfg = get_config(arch)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q, k, v = u(B, H, S, hd), u(B, KV, max_len, hd), u(B, KV, max_len, hd)
        cases.append(flash_case(f"{arch} prefill-global bf16", q, k, v, None, 0))
        if decode:
            cases.append(flash_case(f"{arch} decode bf16", q[:, :, :1].contiguous(), k, v,
                                    None, S))
        del q, k, v
        _release()
    return cases


def whisper_bwd_cases(dev):
    """The backward kernels at train_whisper's shapes (12 heads, rep 1, hd
    64): the encoder over its 1500 frames (no mask, ragged against the key
    tile), cross-attention (448 target positions over the 1500 frames, no
    mask) and the decoder's self-attention (448, causal), bf16; the encoder
    in f32 at batch 1."""
    g = torch.Generator(device=dev).manual_seed(5)
    cfg = get_config(TRAIN_WHISPER["arch"])
    B, T, S = TRAIN_WHISPER["batch"], TRAIN_WHISPER["frames"], TRAIN_WHISPER["seq"]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def u(*shape):
        return (torch.rand(shape, device=dev, generator=g) * 2 - 1).bfloat16()

    q, k, v = u(B, H, T, hd), u(B, KV, T, hd), u(B, KV, T, hd)
    qs, ks, vs = u(B, H, S, hd), u(B, KV, S, hd), u(B, KV, S, hd)
    cases = [flash_bwd_case("whisper-small encoder bf16", q, k, v, None, causal=False),
             flash_bwd_case("whisper-small cross bf16", qs, k, v, None, causal=False),
             flash_bwd_case("whisper-small decoder-self bf16", qs, ks, vs, None)]
    q32, k32, v32 = (t[:1].float() for t in (q, k, v))
    cases.append(flash_bwd_case("whisper-small encoder f32 (batch 1)", q32, k32, v32, None,
                                causal=False))
    del q, k, v, qs, ks, vs, q32, k32, v32
    _release()
    return cases


def train_shapes():
    """The train path's attention and scan shapes: hymba-1.5b's heads, state
    and window at TRAIN's batch and sequence."""
    cfg = get_config(TRAIN["arch"])
    return dict(B=TRAIN["batch"], S=TRAIN["seq"], H=cfg.n_heads, KV=cfg.n_kv_heads,
                hd=cfg.resolved_head_dim, window=cfg.window,
                DI=cfg.ssm.d_inner(cfg.d_model), N=cfg.ssm.d_state)


def flash_bwd_case(name, q, k, v, window, causal=True):
    """The backward kernels (dK/dV and dQ) on the forward kernel's own output
    and lse, against the plain backward on the same inputs; ``causal`` False
    sees every key (whisper's encoder and cross-attention)."""
    dtype = q.dtype
    kw = dict(causal=causal, window=window, q_offset=0)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    do = (torch.rand(out.shape, device=q.device, generator=torch.Generator(
        device=q.device).manual_seed(7)) * 2 - 1).to(dtype)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window, 0)
    sync()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {name}: two launches differ")
    errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
    rels = [e / r.float().abs().max().item() for e, r in zip(errs, ref)]
    del got, again, ref
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    mask = visible(Sq, Skv, causal, window, 0, q.device)
    pairs = int(mask.sum().item())
    # the five products S, dP, dV, dK, dQ: 2 flops each per (pair, head, dim);
    # q, o, do, dq and k, v, dk, dv once each, lse in f32
    bound_ms, bound_by = bound(10.0 * B * H * pairs * hd,
                               (4 * B * H * Sq * hd + 4 * B * KV * Skv * hd)
                               * q.element_size() + 4 * B * H * Sq, dtype)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    every_key = not causal and window is None  # no mask: SDPA may take its flash backend
    o_lib = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, attn_mask=None if every_key else mask, enable_gqa=True)
    library = lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do,  # noqa: E731
                                          retain_graph=True)
    case = dict(case=name, dtype=str(dtype).replace("torch.", ""), q=list(q.shape),
                kv=list(k.shape), causal=causal, window=window, max_abs_err=max(errs),
                rel_err={"dq": rels[0], "dk": rels[1], "dv": rels[2]},
                tol=FLASH_TOL[dtype],
                ms=time_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)),
                plain_ms=time_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                                 causal, window, 0),
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
    """Both backward kernels at the train paths' shapes: attention of
    hymba-1.5b's global and local layers (bf16) and of a global layer in
    f32, gemma3-4b's (head dim 256) likewise, f32 at REP64_F32 (64 query
    heads over one kv head at head dim 256), and the scan's backward."""
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
        _release()
    # gemma3-4b at train_dense's shapes: head dim 256, rep 2
    cfg = get_config(TRAIN_DENSE["arch"])
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    Bd, Sd = TRAIN_DENSE["batch"], TRAIN_DENSE["seq"]
    q, k, v = (u(Bd, n, Sd, hd, dtype=torch.bfloat16) for n in (H, KV, KV))
    flash.append(flash_bwd_case("gemma3-4b train-global bf16", q, k, v, None))
    flash.append(flash_bwd_case("gemma3-4b train-local bf16", q, k, v, cfg.window))
    q, k, v = (t[:1].float() for t in (q, k, v))
    flash.append(flash_bwd_case("gemma3-4b train-global f32 (batch 1)", q, k, v, None))
    q, k, v = (u(*REP64_F32[n], dtype=torch.float32) for n in ("q", "kv", "kv"))
    flash.append(flash_bwd_case("rep 64 hd 256 train-global f32 (batch 1)", q, k, v, None))
    del q, k, v
    _release()
    N, DI = sh["N"], sh["DI"]
    dA = torch.rand(B, S, DI, N, device=dev, generator=g) * 0.49 + 0.5
    dBx = torch.rand(B, S, DI, N, device=dev, generator=g) * 2 - 1
    C = torch.rand(B, S, N, device=dev, generator=g) * 2 - 1
    dy = torch.rand(B, S, DI, device=dev, generator=g) * 2 - 1
    scan = [scan_bwd_case(f"train {list(dA.shape)} f32", dA, dBx, C, dy)]
    del dA, dBx, C, dy
    _release()
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
    _release()
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
    _release()
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


# ---------------------------------------------------------------------------
# the paper's other block workloads: CP-ALS, TSQR, Cholesky, rSVD, L-BFGS and
# lineage checkpoints, on the Newton loop's cluster
# ---------------------------------------------------------------------------

def _block_ctx(backend, dev, node_grid=(4, 1)):
    return ArrayContext(cluster=ClusterSpec(4, 8), node_grid=node_grid, backend=backend,
                        dtype="float64", pipeline=True, plan_cache=True, seed=0,
                        device=str(dev))


def _timed(ctx, fn):
    """``fn()``'s result and its wall seconds, pipelined ops drained and the
    device synchronized."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    ctx.flush()
    sync()
    return out, time.perf_counter() - t0


def _dev_blocks(ga):
    """A GraphArray's blocks as the tensors on the card, in index order."""
    ex = ga.ctx.executor
    return [ex.get(ga.block(idx).vid) for idx in ga.grid.iter_indices()]


def _rows(ga):
    """A (q, 1)- or (q, q)-blocked GraphArray assembled on the card."""
    g = ga.grid.grid
    blocks = _dev_blocks(ga)
    if len(g) == 1 or g[1] == 1:
        return torch.cat(blocks)
    return torch.cat([torch.cat(blocks[i * g[1]:(i + 1) * g[1]], dim=1) for i in range(g[0])])


def _fro(t) -> float:
    return torch.linalg.vector_norm(t).item()


def _kernel_launch_check(ctx, name, backend):
    """On backend cuda every 2-D block product launched the kernel; on torch
    none did.  Returns the launches."""
    n = launches["matmul"]
    want = _matmul_dispatches(ctx) if backend == "cuda" else 0
    check(n == want, f"{name} {backend}: {n} matmul launches vs {want} 2-D matmul dispatches")
    return n


def _factor_sweeps(ex):
    """CP-ALS's factors after every sweep, off the card: each mode update ends
    in the in-loop reshard that gathers the factor to one block (a
    ``concat_blocks`` of shape (dim, rank)), three a sweep."""
    shape = (CPALS["dim"], CPALS["rank"])
    got = [ex.get(v) for v, rec in ex.lineage.items()
           if rec.op == "concat_blocks" and ex.shapes[v] == shape]
    check(len(got) == 3 * CPALS["sweeps"], f"CP-ALS factor gathers: {len(got)}")
    return [got[3 * i:3 * i + 3] for i in range(CPALS["sweeps"])]


def _cp_fit(x_slabs, factors) -> float:
    """1 - ||X - [[A, B, C]]|| / ||X||, on the card, one row slab at a time."""
    A, B, C = factors
    err = norm = 0.0
    row = 0
    for x in x_slabs:
        approx = torch.einsum("if,jf,kf->ijk", A[row:row + x.shape[0]], B, C)
        row += x.shape[0]
        err += (x - approx).square().sum().item()
        norm += x.square().sum().item()
        del approx
    return 1.0 - float(np.sqrt(err / norm))


def cpals_run(backend, dev, method="reshard"):
    """``cpals_loop`` (CPALS["sweeps"] sweeps, plan cache on) on ``backend``;
    on a data backend also the factors after every sweep and the fit after
    the first and the last, on the card."""
    ctx = _block_ctx(backend, dev, (4, 1, 1))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    A, loop_s = _timed_workload(ctx, lambda c: cpals_loop(
        c, CPALS["dim"], rank=CPALS["rank"], q=CPALS["q"], iters=CPALS["sweeps"],
        method=method))
    st = ctx.sched_stats
    out = dict(schedule=_schedule(ctx, A), moved=st.reshard_moved_elements,
               reshards=st.reshards, hit_rate=st.hit_rate())
    fields = dict(backend=backend, method=method, dim=CPALS["dim"], rank=CPALS["rank"],
                  q=CPALS["q"], sweeps=CPALS["sweeps"], reshard_moved_elements=out["moved"],
                  reshards=out["reshards"], plan_hit_rate=out["hit_rate"])
    if backend != "sim":
        ex = ctx.executor
        sweeps = _factor_sweeps(ex)
        x_slabs = _blocks(ex, "create:random")
        out.update(factors=[f.cpu().numpy() for f in sweeps[-1]],
                   fit=[_cp_fit(x_slabs, sweeps[0]), _cp_fit(x_slabs, sweeps[-1])],
                   launches=_kernel_launch_check(ctx, "CP-ALS", backend),
                   loaders=dict(loaders))
        fields.update(loop_s=loop_s, s_per_sweep=loop_s / CPALS["sweeps"],
                      fit_after_sweep=dict(zip((1, CPALS["sweeps"]), out["fit"])),
                      max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                      mem_peak_store_bytes=ex.memory.peak_bytes(),
                      matmul_launches=out["launches"], matmul_loaders=out["loaders"])
        del ex, sweeps, x_slabs
    emit(f"cpals_{backend}" + ("" if method == "reshard" else f"_{method}"), **fields)
    return out


def cpals_phase(dev):
    runs = {}
    for backend in ("cuda", "torch", "sim"):
        runs[backend] = cpals_run(backend, dev)
        _release()
    naive = cpals_run("sim", dev, method="naive")
    cuda, plain = runs["cuda"], runs["torch"]
    rel = max(_rel(a, b) for a, b in zip(cuda["factors"], plain["factors"]))
    res = dict(factor_rel_err=rel, rtol=BLOCK_RTOL,
               same_schedule=cuda["schedule"] == plain["schedule"] == runs["sim"]["schedule"],
               moved_elements={"cuda": cuda["moved"], "torch": plain["moved"],
                               "sim": runs["sim"]["moved"], "naive (sim)": naive["moved"]},
               moved_vs_naive=cuda["moved"] / naive["moved"], fit=cuda["fit"])
    emit("cpals_parity", **res)
    check(rel <= BLOCK_RTOL, f"CP-ALS factors cuda vs torch: {rel}")
    check(res["same_schedule"], "CP-ALS schedules differ between backends")
    check(cuda["moved"] == plain["moved"] == runs["sim"]["moved"] < naive["moved"],
          f"CP-ALS moved elements {res['moved_elements']}")
    check(np.isfinite(cuda["fit"]).all() and cuda["fit"][1] > cuda["fit"][0],
          f"CP-ALS fit does not improve: {cuda['fit']}")
    return cuda["launches"]


def _tsqr(ctx):
    X = ctx.random((NEWTON["n"], NEWTON["d"]), grid=(NEWTON["q"], 1))
    ctx.reset_loads()
    return X, _timed(ctx, lambda: tsqr_indirect(ctx, X))


def tsqr_phase(dev):
    """Indirect TSQR of the Newton loop's X on backend cuda, and its comm
    ratio against the sim backend's on the same graph."""
    ctx = _block_ctx("cuda", dev)
    reset_launches()
    X, ((Q, R), tsqr_s) = _tsqr(ctx)
    n = _kernel_launch_check(ctx, "TSQR", "cuda")
    Rt = _dev_blocks(R)[0]
    xs, qs = _dev_blocks(X), _dev_blocks(Q)
    resid = np.sqrt(sum(_fro(q @ Rt - x) ** 2 for q, x in zip(qs, xs))
                    / sum(_fro(x) ** 2 for x in xs))
    gram = sum(q.mT @ q for q in qs)
    orth = _fro(gram - torch.eye(gram.shape[0], dtype=gram.dtype, device=dev))
    ratio = ctx.loads()["comm_ratio_tsqr"]
    sim = _block_ctx("sim", dev)
    _tsqr(sim)
    res = dict(n=NEWTON["n"], d=NEWTON["d"], q=NEWTON["q"], s=tsqr_s, residual=resid,
               orthogonality=orth, tol=QR_TOL, comm_ratio_tsqr=ratio,
               comm_ratio_tsqr_sim=sim.loads()["comm_ratio_tsqr"], matmul_launches=n)
    emit("tsqr", **res)
    check(resid <= QR_TOL["residual"] and orth <= QR_TOL["orthogonality"], f"TSQR {res}")
    check(ratio == res["comm_ratio_tsqr_sim"], f"TSQR comm ratio {res}")
    return n


def _cholesky(ctx):
    """A = M M^T / n + I from the seed (its products on the runtime), a
    right-hand side, then the factorization and the solve."""
    n, g = CHOL["n"], CHOL["g"]
    M = ctx.random((n, n), grid=(g, g))
    A = ((M @ M.T) * (1.0 / n) + ctx.from_numpy(np.eye(n), grid=(g, g))).compute()
    b = ctx.random((n, 1), grid=(g, 1))
    ctx.flush()
    ctx.reset_loads()
    L, chol_s = _timed(ctx, lambda: cholesky(ctx, A))
    x, solve_s = _timed(ctx, lambda: cholesky_solve(ctx, L, b))
    return A, b, L, x, chol_s, solve_s


def cholesky_phase(dev):
    ctx = _block_ctx("cuda", dev)
    reset_launches()
    A, b, L, x, chol_s, solve_s = _cholesky(ctx)
    n = _kernel_launch_check(ctx, "Cholesky", "cuda")
    At, Lt, bt, xt = _rows(A), _rows(L), _rows(b), _rows(x)
    factor = _fro(Lt @ Lt.mT - At) / _fro(At)
    solve = _fro(At @ xt - bt) / _fro(bt)
    upper_zero = bool((torch.triu(Lt, 1) == 0).all().item())
    ratio = ctx.loads()["comm_ratio_cholesky"]
    del At, Lt, bt, xt
    sim = _block_ctx("sim", dev)
    _cholesky(sim)
    res = dict(n=CHOL["n"], grid=[CHOL["g"]] * 2, cholesky_s=chol_s, solve_s=solve_s,
               factor_residual=factor, solve_residual=solve, tol=CHOL_TOL,
               strict_upper_zero=upper_zero, comm_ratio_cholesky=ratio,
               comm_ratio_cholesky_sim=sim.loads()["comm_ratio_cholesky"],
               matmul_launches=n)
    emit("cholesky", **res)
    check(factor <= CHOL_TOL["factor"] and solve <= CHOL_TOL["solve"] and upper_zero,
          f"Cholesky {res}")
    check(ratio == res["comm_ratio_cholesky_sim"], f"Cholesky comm ratio {res}")
    return n


def _rsvd(ctx):
    """An exactly rank-(rank + oversample) matrix U V^T from the seed (its
    products on the runtime), then the randomized SVD."""
    r = RSVD["rank"] + RSVD["oversample"]
    U = ctx.random((NEWTON["n"], r), grid=(NEWTON["q"], 1))
    V = ctx.random((NEWTON["d"], r), grid=(1, 1))
    A = (U @ V.T).compute()
    ctx.flush()
    ctx.reset_loads()
    return A, _timed(ctx, lambda: rsvd(ctx, A, rank=RSVD["rank"],
                                       oversample=RSVD["oversample"], seed=1))


def rsvd_phase(dev):
    ctx = _block_ctx("cuda", dev)
    reset_launches()
    A, ((U, S, V), rsvd_s) = _rsvd(ctx)
    n = _kernel_launch_check(ctx, "rSVD", "cuda")
    St, Vt = _dev_blocks(S)[0], _dev_blocks(V)[0]
    us_vt = [(u * St) @ Vt.mT for u in _dev_blocks(U)]
    xs = _dev_blocks(A)
    recon = np.sqrt(sum(_fro(r - x) ** 2 for r, x in zip(us_vt, xs))
                    / sum(_fro(x) ** 2 for x in xs))
    ratio = ctx.loads()["comm_ratio_rsvd"]
    del us_vt, xs
    sim = _block_ctx("sim", dev)
    _rsvd(sim)
    res = dict(m=NEWTON["n"], d=NEWTON["d"], q=NEWTON["q"], **RSVD,
               matrix_rank=RSVD["rank"] + RSVD["oversample"], s=rsvd_s,
               reconstruction=recon, tol=RSVD_TOL, comm_ratio_rsvd=ratio,
               comm_ratio_rsvd_sim=sim.loads()["comm_ratio_rsvd"], matmul_launches=n)
    emit("rsvd", **res)
    check(recon <= RSVD_TOL, f"rSVD {res}")
    check(ratio == res["comm_ratio_rsvd_sim"], f"rSVD comm ratio {res}")
    return n


def lbfgs_phase(dev):
    """LogisticRegression(solver="lbfgs") on the paper's data at LBFGS's
    size, on backends cuda and torch; the fit is timed without the data's
    creation."""
    X, y = paper_bimodal(LBFGS["n"], NEWTON["d"], seed=0)
    runs = {}
    for backend in ("cuda", "torch"):
        ctx = _block_ctx(backend, dev)
        Xg = ctx.from_numpy(X, grid=(LBFGS["q"], 1))
        yg = ctx.from_numpy(y, grid=(LBFGS["q"], 1))
        ctx.flush()
        model = LogisticRegression(ctx, solver="lbfgs", max_iter=LBFGS["iters"],
                                   reg=LBFGS["reg"])
        reset_launches()
        _, fit_s = _timed(ctx, lambda: model.fit(Xg, yg))
        res = model.result
        runs[backend] = dict(beta=model.beta, objectives=res.objectives,
                             launches=_kernel_launch_check(ctx, "L-BFGS", backend))
        emit(f"lbfgs_{backend}", n=LBFGS["n"], d=NEWTON["d"], q=LBFGS["q"],
             reg=LBFGS["reg"], iterations=res.iterations, fit_s=fit_s, s_per_iter=fit_s / res.iterations,
             objectives=res.objectives, grad_norms=res.grad_norms,
             matmul_launches=runs[backend]["launches"])
        del ctx, Xg, yg, model, res
        _release()
    cuda, plain = runs["cuda"], runs["torch"]
    obj = cuda["objectives"]
    res = dict(beta_rel_err=_rel(cuda["beta"], plain["beta"]), rtol=BLOCK_RTOL,
               loss_first=obj[0], loss_last=obj[-1],
               decreasing=all(b < a for a, b in zip(obj, obj[1:])))
    emit("lbfgs_parity", **res)
    check(res["beta_rel_err"] <= BLOCK_RTOL, f"L-BFGS beta cuda vs torch {res}")
    check(res["decreasing"] and np.isfinite(obj).all(), f"L-BFGS loss {obj}")
    return cuda["launches"]


def _ancestors(ex, vids) -> int:
    """Ops in the lineage below ``vids``: what a replay walks without a
    checkpoint when every block is lost."""
    seen, stack = set(), [ex.resolve(v) for v in vids]
    while stack:
        v = stack.pop()
        if v not in seen:
            seen.add(v)
            stack.extend(ex.resolve(i) for i in ex.lineage[v].in_ids)
    return len(seen)


def checkpoint_phase(dev):
    """The Newton loop's beta and H checkpointed after iteration 2: the node
    holding beta dies and recovery reads the archive, not the lineage; a
    fresh context restored from the archive holds the same bits on the card."""
    ctx = _block_ctx("cuda", dev)
    reset_launches()
    _g, H, beta = logreg_newton_loop(ctx, NEWTON["n"], NEWTON["d"], NEWTON["q"], iters=2)
    ctx.flush()
    n = _kernel_launch_check(ctx, "checkpoint Newton", "cuda")
    ex = ctx.executor
    vids = [beta.block((0, 0)).vid, H.block((0, 0)).vid]
    depth = _ancestors(ex, vids)
    bits = [beta.to_numpy().tobytes(), H.to_numpy().tobytes()]
    with tempfile.TemporaryDirectory() as tmp:
        _, ckpt_s = _timed(ctx, lambda: ctx.checkpoint([beta, H], tmp))
        node = ex.memory.node_of[ex.resolve(vids[0])]
        lost = ex.fail_node(node)
        replayed = ex.recover(vids)
        survived = [beta.to_numpy().tobytes(), H.to_numpy().tobytes()] == bits
        roots = sorted({ex.lineage[ex.resolve(v)].op for v in vids})
        del ctx, ex, beta, H, _g
        _release()
        _restored, (beta2, H2) = ArrayContext.restore(tmp)
        same = [beta2.to_numpy().tobytes(), H2.to_numpy().tobytes()] == bits
        devices = sorted({str(t.device) for t in _dev_blocks(beta2) + _dev_blocks(H2)})
    res = dict(n=NEWTON["n"], d=NEWTON["d"], iters_before=2, checkpoint_s=ckpt_s,
               failed_node=node, blocks_lost=len(lost), replayed=replayed,
               lineage_ops_without_checkpoint=depth, bits_survive=survived, roots=roots,
               restored_bits_equal=same, restored_on=devices, matmul_launches=n)
    emit("checkpoint", **res)
    check(survived and roots == ["create:restore"] and replayed <= len(vids) < depth,
          f"checkpoint recovery {res}")
    check(same and devices == [str(dev)], f"checkpoint restore {res}")
    return n


def block_algorithms_phase(dev):
    """The paper's other block workloads at full size on the card; returns
    the matmul kernel's launches on backend cuda (each workload's counts set
    to 0 just before it and read just after)."""
    phases = {"cpals": cpals_phase, "tsqr": tsqr_phase, "cholesky": cholesky_phase,
              "rsvd": rsvd_phase, "lbfgs": lbfgs_phase, "checkpoint": checkpoint_phase}
    counts, wall = {}, {}
    for name, phase in phases.items():
        t0 = time.perf_counter()
        counts[name] = phase(dev)
        _release()
        wall[name] = time.perf_counter() - t0
    emit("block_algorithms", wall_s=sum(wall.values()), wall_s_by_workload=wall,
         matmul_launches=counts)
    return sum(counts.values())


# ---------------------------------------------------------------------------
# fault tolerance and observability of the block runtime: the flight
# recorder, the chaos runtime and calibration
# ---------------------------------------------------------------------------

def _untrace(ctx) -> None:
    """Detach the context's flight recorder (every tap ``_install_tracer``
    set), so the same context and data run untraced."""
    ctx.tracer = ctx.executor.tracer = ctx.state.tracer = None
    ctx.state.clocks_sync.recorder = ctx.state.clocks_pipe.recorder = None


def _newton_ctx(backend, dev, **kw):
    """The Newton loop's context and operands (created once: numpy makes the
    8.6 GB X on the host).  Refcount GC frees each pass's intermediates
    (three 8.6 GB w * X a pass), so that many passes fit one card."""
    ctx = ArrayContext(cluster=ClusterSpec(4, 8), node_grid=(4, 1), backend=backend,
                       dtype="float64", pipeline=True, plan_cache=True, seed=0,
                       device=str(dev), gc=True, **kw)
    n, d, q = NEWTON["n"], NEWTON["d"], NEWTON["q"]
    ops_ = (ctx.random((n, d), grid=(q, 1)), ctx.uniform((n, 1), grid=(q, 1)),
            ctx.from_numpy(1e-3 * np.eye(d), grid=(1, 1)))
    ctx.flush()
    return ctx, ops_


def _newton_pass(ctx, operands, rec=None, profile_sync=False):
    """NEWTON["iters"] Newton iterations from beta = 0 on the context's
    operands, clocks and counters reset first, traced by ``rec`` (or not);
    returns beta, the wall seconds (device synchronized), the simulated
    makespans and the host split per iteration."""
    X, y, eye = operands
    if rec is None:
        _untrace(ctx)
    else:
        ctx._install_tracer(rec)
    ctx.reset_loads()  # clears the recorder too: detach the previous one first
    ctx.executor.profile_sync = profile_sync
    iters = NEWTON["iters"]
    # as the reference's own overhead gate does: the collector runs before
    # the pass and is paused during it, traced or not
    gc.collect()
    gc.disable()
    try:
        sync()
        t0 = time.perf_counter()
        beta = ctx.zeros((NEWTON["d"], 1), grid=(1, 1))
        for _ in range(iters):
            beta = _newton_iteration(ctx, X, y, beta, eye)
        ctx.flush()
        sync()
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
    ctx.executor.profile_sync = False
    loads = ctx.loads()
    return dict(beta=beta.to_numpy(), wall_s=wall,
                makespans=(ctx.state.makespan(pipeline=False),
                           ctx.state.makespan(pipeline=True)),
                per_iter_s={"wall": wall / iters,
                            "dispatch": loads["dispatch_s"] / iters,
                            "scheduler": loads["sched_overhead_s"] / iters,
                            "drain": loads["drain_s"] / iters},
                n_rfc_per_iter=loads["n_rfc"] / iters)


def _matmul_executions(ctx) -> int:
    """Executions of 2-D block products in a traced run: retirements and
    lineage replays (a replay runs the backend's op again)."""
    ex = ctx.executor
    return sum(1 for e in ctx.tracer.of("retire", "replay") if e.name == "matmul"
               and all(len(ex.shapes[ex.resolve(i)]) == 2
                       for i in ex.lineage[e.args["out"]].in_ids))


def traced_newton(backend, dev):
    """The Newton loop at the main path's size, untraced and traced (no
    profile_sync: a retire's wall is the host's dispatch of the op), in
    alternating passes after one warm-up: the same bits and simulated
    clocks every pass, the traced/untraced wall ratio (median), the host
    wall per op kind from the last traced pass's Perfetto file, its
    critical-path decomposition, and the host split per iteration."""
    ctx, operands = _newton_ctx(backend, dev)
    reset_launches()
    warm = _newton_pass(ctx, operands)
    passes = {"traced": [], "untraced": []}
    rec = None
    for _ in range(FAULT_OBS["runs"]):
        rec = FlightRecorder()
        passes["traced"].append(_newton_pass(ctx, operands, rec))
        passes["untraced"].append(_newton_pass(ctx, operands))
    FAULT_OBS["dir"].mkdir(parents=True, exist_ok=True)
    path = FAULT_OBS["dir"] / f"newton_{backend}.json"
    ctx._install_tracer(rec)  # the last traced pass's events
    doc = ctx.export_trace(str(path))
    analysis = analyze(doc)
    host = histogram_stats(wall_histograms(doc), clamp=True)
    matmul_launches = launches["matmul"]
    runs = [warm] + [p for v in passes.values() for p in v]
    same_bits = all(p["beta"].tobytes() == warm["beta"].tobytes() for p in runs)
    same_clocks = all(p["makespans"] == warm["makespans"] for p in runs)
    med = {k: float(np.median([p["wall_s"] for p in passes[k]])) for k in ("traced",
                                                                          "untraced")}
    # each traced pass against the untraced pass right after it: the median
    # of the pairs' ratios, which the host's drift between pairs cancels from
    pairs = [t["wall_s"] / u["wall_s"] for t, u in zip(passes["traced"], passes["untraced"])]
    ratio = float(np.median(pairs))
    per_iter = {k: {part: float(np.median([p["per_iter_s"][part] for p in passes[k]]))
                    for part in ("wall", "dispatch", "scheduler", "drain")}
                for k in ("traced", "untraced")}
    emit(f"fault_obs_trace_{backend}", n=NEWTON["n"], d=NEWTON["d"], q=NEWTON["q"],
         iters=NEWTON["iters"], cluster=[4, 8], runs=FAULT_OBS["runs"],
         python_gc="collected before each pass, paused during it",
         wall_s={k: [p["wall_s"] for p in v] for k, v in passes.items()},
         median_wall_s=med, pair_ratios=pairs, traced_over_untraced=ratio,
         gate=FAULT_OBS["trace_gate"],
         host_split_per_iter_s=per_iter, n_rfc_per_iter=warm["n_rfc_per_iter"],
         host_wall_per_op_s=host, host_wall_is="dispatch (no profile_sync)",
         makespans=warm["makespans"], same_bits=same_bits, same_clocks=same_clocks,
         trace=str(path), events=analysis["events"], dropped=analysis["dropped"],
         critical_path_len=analysis["critical_path_len"],
         breakdown_pct=analysis["breakdown_pct"], top_stall=analysis["top_stall"],
         decomposition_total_pct=analysis["decomposition_total_pct"],
         matmul_launches=matmul_launches)
    check(same_bits and same_clocks,
          f"{backend}: traced and untraced Newton passes differ (bits {same_bits}, "
          f"clocks {same_clocks})")
    check(abs(analysis["decomposition_total_pct"] - 100.0) <= 1.0,
          f"{backend}: decomposition sums to {analysis['decomposition_total_pct']}%")
    check(ratio <= FAULT_OBS["trace_gate"],
          f"{backend}: traced/untraced wall {ratio} > {FAULT_OBS['trace_gate']}")
    check(analysis["dropped"] == 0, f"{backend}: the recorder dropped events")
    out = dict(beta=warm["beta"], launches=matmul_launches, per_iter=per_iter["untraced"])
    del ctx, operands, passes, runs, rec
    _release()
    return out


def chaos_scenario(dev):
    """``run_chaos_scenario`` on the card (fault-free leg, chaos leg,
    determinism re-run), every leg traced so that the matmul launches can
    be held to the 2-D products each leg executed, its replays included;
    then the controller's legs.  Returns the matmul launches."""
    legs = []
    real = chaos_driver.run_scenario

    def traced_leg(plan, **kw):
        legs.append(real(plan, **dict(kw, trace=True)))
        return legs[-1]

    kw = CHAOS
    chaos_driver.run_scenario = traced_leg
    try:
        reset_launches()
        t0 = time.perf_counter()
        report = chaos_driver.run_chaos_scenario(backend="cuda", device=str(dev), **kw)
        sync()
        wall = time.perf_counter() - t0
        n_launch = launches["matmul"]
        executions = sum(_matmul_executions(leg["ctx"]) for leg in legs)
        replays = sum(1 for leg in legs for e in leg["ctx"].tracer.of("replay")
                      if e.name == "matmul")
    finally:
        chaos_driver.run_scenario = real
    del legs
    _release()
    keys = ("makespan_faultfree", "makespan_chaos", "makespan_ratio", "identical",
            "deterministic", "chaos_transient_faults", "chaos_retries", "chaos_escalations",
            "chaos_speculated", "chaos_spec_wins", "chaos_nodes_failed", "chaos_blocks_lost",
            "chaos_blocks_replayed", "chaos_rerouted_ops", "chaos_dead_nodes")
    emit("fault_obs_chaos", **kw, backend="cuda", wall_s=wall,
         **{k: report[k] for k in keys}, matmul_launches=n_launch,
         matmul_executions=executions, matmul_replays=replays)
    check(report["identical"] and report["deterministic"],
          f"chaos: identical {report['identical']}, deterministic {report['deterministic']}")
    check(report["chaos_retries"] > 0 and report["chaos_blocks_replayed"] > 0,
          f"chaos: retries {report['chaos_retries']}, "
          f"replays {report['chaos_blocks_replayed']}")
    check(n_launch == executions > 0 and replays > 0,
          f"chaos: {n_launch} matmul launches vs {executions} 2-D product executions "
          f"({replays} replays)")

    reset_launches()
    ref = chaos_driver.run_chaos_scenario(backend="cuda", device=str(dev),
                                          **CHAOS_GATE["scenario"])
    gate_launches = launches["matmul"]
    limit = CHAOS_GATE["limit"]
    emit("fault_obs_chaos_gate", **CHAOS_GATE["scenario"], n=ref["n"], d=ref["d"],
         backend="cuda", makespan_ratio=ref["makespan_ratio"], limit=limit,
         identical=ref["identical"], deterministic=ref["deterministic"],
         replays=ref["chaos_blocks_replayed"], matmul_launches=gate_launches)
    check(ref["identical"] and ref["deterministic"] and ref["makespan_ratio"] <= limit,
          f"chaos gate: identical {ref['identical']}, deterministic "
          f"{ref['deterministic']}, ratio {ref['makespan_ratio']} (limit {limit})")

    reset_launches()
    t0 = time.perf_counter()
    ctl = chaos_driver.run_chaos_scenario(backend="cuda", device=str(dev),
                                          **dict(kw, n=CHAOS_CONTROLLER_N), controller=True)
    sync()
    ctl_launches = launches["matmul"]
    _release()
    emit("fault_obs_controller", **dict(kw, n=CHAOS_CONTROLLER_N), backend="cuda",
         wall_s=time.perf_counter() - t0, identical=ctl["identical"],
         deterministic=ctl["deterministic"], makespan_ratio=ctl["makespan_ratio"],
         actions=ctl["controller_actions"], final_nodes=ctl["controller_final_nodes"],
         matmul_launches=ctl_launches)
    check(ctl["controller_n_actions"] >= 1 and ctl["deterministic"] and ctl["identical"],
          f"controller: {ctl['controller_n_actions']} actions, deterministic "
          f"{ctl['deterministic']}, identical {ctl['identical']}")
    return n_launch + gate_launches + ctl_launches


def _drift_under(rec, cost_model) -> dict:
    """``drift_report``'s totals and per-kind drift for the retired ops of a
    profiled run, each op predicted by ``cost_model`` (the duration a clock
    track of that model gives it: ``compute_seconds(work, kind)``)."""
    per_kind = {}
    for e in rec.of("retire"):
        row = per_kind.setdefault(e.name, [0.0, 0.0])
        row[0] += cost_model.compute_seconds(e.args["work"], e.name)
        row[1] += e.args["wall_s"]
    pred, meas = (sum(r[i] for r in per_kind.values()) for i in (0, 1))
    return dict(predicted_s=pred, measured_s=meas, drift=abs(math.log(pred / meas)),
                per_kind={k: abs(math.log(p / m)) for k, (p, m) in sorted(per_kind.items())})


def calibration(dev, smi, newton):
    """``run_calibration`` on the card, its profile saved; then a held-out
    Newton run at the main path's size with the profile, traced with
    profile_sync in HELD_OUT_PASSES passes: the drift of each op's fastest
    pass, against the default cost model's drift over the same ops (a
    second run would add the host's drift between runs to the comparison),
    and the values against the uncalibrated run's.  Returns the matmul
    launches."""
    reset_launches()
    t0 = time.perf_counter()
    prof = run_calibration(backend="cuda", device=str(dev), dtype="float64", **CALIB)
    cal_s = time.perf_counter() - t0
    path = FAULT_OBS["dir"] / "profile_cuda.json"
    prof.save(str(path))
    emit("fault_obs_calibration", nvidia_smi=smi, device=prof.metadata["device"],
         wall_s=cal_s, compute_coeffs=prof.compute_coeffs,
         compute_default=prof.compute_default, transfer_coeffs=prof.transfer_coeffs,
         gamma_s=prof.gamma_s, samples=prof.metadata["samples"], profile=str(path),
         sweep=prof.metadata["sweep"])
    ctx, operands = _newton_ctx("cuda", dev, calibration=str(path))
    recs = [FlightRecorder() for _ in range(HELD_OUT_PASSES)]
    runs = [_newton_pass(ctx, operands, rec, profile_sync=True) for rec in recs]
    n_launch = launches["matmul"]
    last = drift_report(recs[-1])  # the reference's report of one pass
    check(abs(_drift_under(recs[-1], ctx.state.cost_model)["drift"] - last["drift"])
          <= 1e-6 * max(last["drift"], 1.0),
          f"drift from the clocks {last['drift']} vs from the profile")
    fastest = fastest_retires(recs)
    drift = _drift_under(fastest, ctx.state.cost_model)
    default = _drift_under(fastest, CostModel())
    by_kind = {name: sum(d["per_kind"].values()) / len(d["per_kind"])
               for name, d in (("calibrated", drift), ("default", default))}
    rel = max(_rel(run["beta"], newton["beta"]) for run in runs)
    emit("fault_obs_drift", n=NEWTON["n"], track=last["track"], passes=HELD_OUT_PASSES,
         kind_mean_drift=by_kind, ratio=by_kind["calibrated"] / by_kind["default"],
         gate=DRIFT_GATE, drift_calibrated=drift["drift"], drift_default=default["drift"],
         total_ratio=drift["drift"] / default["drift"],
         predicted_s={"calibrated": drift["predicted_s"], "default": default["predicted_s"]},
         measured_s=drift["measured_s"], per_kind=drift["per_kind"],
         per_kind_default=default["per_kind"], n_ops=last["n_ops"],
         one_pass={"drift_calibrated": last["drift"], "measured_s": last["measured_s"]},
         beta_rel_err_vs_uncalibrated=rel, rtol=RTOL)
    check(by_kind["calibrated"] <= DRIFT_GATE * by_kind["default"],
          f"calibrated drift per op kind {by_kind['calibrated']} > {DRIFT_GATE} x default "
          f"{by_kind['default']}")
    check(rel <= RTOL, f"calibrated Newton beta differs from uncalibrated by {rel}")
    del ctx, operands, recs
    _release()
    return n_launch


def fault_obs_phase(dev, smi):
    """The block runtime's flight recorder, chaos runtime and calibration on
    the card; returns the matmul kernel's launches (each part's counts set
    to 0 just before it and read just after)."""
    t0 = time.perf_counter()
    newton = traced_newton("cuda", dev)
    plain = traced_newton("torch", dev)
    check(plain["launches"] == 0, "backend torch launched the matmul kernel")
    check(_rel(newton["beta"], plain["beta"]) <= RTOL, "traced Newton: cuda vs torch")
    emit("fault_obs_host_gap", per_iter_s={"cuda": newton["per_iter"],
                                           "torch": plain["per_iter"]},
         gap_per_iter_s={k: newton["per_iter"][k] - plain["per_iter"][k]
                         for k in newton["per_iter"]})
    n = newton["launches"] + chaos_scenario(dev) + calibration(dev, smi, newton)
    emit("fault_obs", wall_s=time.perf_counter() - t0, matmul_launches=n)
    return n


def serve_run(dev, cfg, params, impl, forced=None, gen=None, spec=SERVE,
              dispatch_mode="einsum"):
    """One serve_demo run of model ``cfg`` at ``spec``'s batch and prompt on
    the card, with its launches and peak memory; the launch counts are set
    to 0 just before it."""
    record = {}
    _release()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    tokens = serve_demo(cfg, spec["batch"], spec["prompt_len"], gen or spec["gen"],
                        device=dev, params=params, impl=impl, forced=forced, record=record,
                        dispatch_mode=dispatch_mode,
                        log_fn=lambda line: print(f"# {line}", file=sys.stderr))
    record.update(tokens=tokens, launches=dict(launches),
                  max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    return record


def serve_compare(label, kern, plain, tol, spec=SERVE, **fields):
    """Kernel route against plain route, step by step (step 0 is prefill's
    last position), relative to max|logit| of the plain route, which must
    not be 0; ``fields`` join the emitted line."""
    lk, lp = kern["logits"], plain["logits"]
    scale = float(np.abs(lp).max())
    check(scale > 0, f"serve {label}: every logit of the plain route is 0")
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
    emit(f"serve_{label}", arch=spec["arch"], batch=spec["batch"],
         prompt_len=spec["prompt_len"], gen=spec["gen"], max_len=kern["max_len"], **fields,
         **res)
    return finite and max(per_step) <= tol


def serve_warm_up(dev, cfg, spec=SERVE):
    """Both routes at SERVE_WARM_LAYERS layers and the same shapes, so that
    the timed runs after it find the libraries' kernels for these shapes
    chosen and the allocator's pool grown, whichever route runs first."""
    cfg = dataclasses.replace(cfg, n_layers=SERVE_WARM_LAYERS)
    for impl in ("kernel", "plain"):
        serve_run(dev, cfg, None, impl, spec=spec)


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
    check(serve_compare("bf16", kern, plain, SERVE_TOL["bfloat16"]),
          "serve bf16: kernel and plain routes part")
    want = {"flash_attention": L * SERVE["gen"], "mamba_scan": L,
            "mamba_step": L * (SERVE["gen"] - 1)}
    got = {k: kern["launches"][k] for k in want}
    check(got == want, f"serve bf16 kernel launches {got} != {want}")
    check(all(plain["launches"][k] == 0 for k in want),
          f"serve bf16 plain route launched kernels: {plain['launches']}")
    main_launches = kern["launches"]
    planted_faults(dev, cfg, params, plain)
    del params, kern, plain

    cfg32 = dataclasses.replace(cfg, n_layers=SERVE_F32_LAYERS, dtype="float32")
    serve_warm_up(dev, cfg32)
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(0))
    kern = serve_run(dev, cfg32, params, "kernel")
    plain = serve_run(dev, cfg32, params, "plain", forced=kern["tokens"])
    check(serve_compare("f32", kern, plain, SERVE_TOL["float32"]),
          "serve f32: kernel and plain routes part")
    check(np.array_equal(kern["tokens"], plain["tokens"]),
          "serve f32: greedy tokens differ between the routes")
    want = {"flash_attention": cfg32.n_layers * SERVE["gen"], "mamba_scan": cfg32.n_layers,
            "mamba_step": cfg32.n_layers * (SERVE["gen"] - 1)}
    check({k: kern["launches"][k] for k in want} == want,
          f"serve f32 kernel launches {kern['launches']} != {want}")
    del params, kern, plain
    _release()
    return main_launches


def dense_params(dev, cfg):
    """Seeded weights on the card.  A layernorm model (nemotron-4-15b,
    whisper-small: its encoder's norms and cross norms too) gets every
    norm's scale set to ones, the layernorm's own init, the same for both
    routes: under the reference's scheme the final norm's 1-D scale
    and bias are zero, so every logit would be exactly 0, and each layer's
    stacked scales are N(0, 1) / sqrt(L), about 0.18, which shrinks every
    sublayer's input so far that attention hardly reaches the logits (a
    window of 1024 on every layer moved them by 0.022 of max|logit|, under
    the rounding limit: NVIDIA H100 80GB HBM3, 700.00 W)."""
    _release()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    if cfg.norm == "layernorm":
        for tree in [params] + ([params["encoder"]] if cfg.encdec else []):
            for norm in [tree["final_norm"]] + [g for name, g in tree["layers"].items()
                                                if name.startswith("norm")]:
                norm["scale"] = torch.ones_like(norm["scale"])
    return params


def serve_dense_model(dev, arch):
    """One dense or VLM decoder as published, bf16: served on the kernel
    route and on the plain route teacher-forced with the kernel route's
    tokens (logits within SERVE_TOL, launches exact), a planted fault that
    the limit must catch (gemma3-4b's local layers without their window;
    on a model without a window, DENSE_FAULT_WINDOW on every layer), then
    the f32 leg at full width and SERVE_DENSE_F32's depth (tokens equal).
    Returns the bf16 kernel run's launches."""
    cfg = get_config(arch)
    spec = dict(SERVE_DENSE, arch=arch)
    L, gen = cfg.n_layers, spec["gen"]
    serve_warm_up(dev, cfg, spec)
    params = dense_params(dev, cfg)
    weight_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    kern = serve_run(dev, cfg, params, "kernel", spec=spec)
    plain = serve_run(dev, cfg, params, "plain", forced=kern["tokens"], spec=spec)
    fault_cfg = (dataclasses.replace(cfg, window=None) if cfg.window is not None else
                 dataclasses.replace(cfg, window=DENSE_FAULT_WINDOW, local_global_ratio=0))
    fault = serve_run(dev, fault_cfg, params, "kernel", gen=1, spec=spec)
    scale = float(np.abs(plain["logits"][0]).max())
    fault_err = float(np.abs(fault["logits"][0] - plain["logits"][0]).max() / scale)
    fault_name = "local layers without their window" if cfg.window is not None else \
        f"window {DENSE_FAULT_WINDOW} on every layer"
    ok = serve_compare(
        "dense", kern, plain, SERVE_TOL["bfloat16"], spec, dtype=cfg.dtype, layers=L,
        d_model=cfg.d_model, head_dim=cfg.resolved_head_dim,
        rep=cfg.n_heads // cfg.n_kv_heads, params=cfg.param_count(),
        weight_gb=weight_bytes / 1e9,
        planted_fault={"fault": fault_name, "rel_err_prefill": fault_err})
    check(ok, f"serve_dense {arch}: kernel and plain routes part")
    want = {"flash_attention": L * gen, "mamba_scan": 0}
    got = {k: kern["launches"][k] for k in want}
    check(got == want, f"serve_dense {arch} kernel launches {got} != {want}")
    check(not any(plain["launches"].values()),
          f"serve_dense {arch} plain route launched kernels: {plain['launches']}")
    check(fault_err > SERVE_TOL["bfloat16"],
          f"serve_dense {arch}: the bf16 limit misses the planted fault ({fault_err})")
    launched = kern["launches"]
    del params, kern, plain, fault

    cfg32 = dataclasses.replace(cfg, n_layers=SERVE_DENSE_F32["layers"], dtype="float32")
    spec32 = dict(SERVE_DENSE_F32, arch=arch)
    params = dense_params(dev, cfg32)
    kern = serve_run(dev, cfg32, params, "kernel", spec=spec32)
    plain = serve_run(dev, cfg32, params, "plain", forced=kern["tokens"], spec=spec32)
    ok = serve_compare("dense_f32", kern, plain, SERVE_TOL["float32"], spec32,
                       dtype="float32", layers=cfg32.n_layers)
    check(ok, f"serve_dense f32 {arch}: kernel and plain routes part")
    check(np.array_equal(kern["tokens"], plain["tokens"]),
          f"serve_dense f32 {arch}: greedy tokens differ between the routes")
    want = {"flash_attention": cfg32.n_layers * spec32["gen"], "mamba_scan": 0}
    check({k: kern["launches"][k] for k in want} == want,
          f"serve_dense f32 {arch} kernel launches {kern['launches']} != {want}")
    del params, kern, plain
    _release()
    return launched


def serve_dense_phase(dev):
    """The dense and VLM decoders, one model at a time, each freed before the
    next; returns their bf16 kernel runs' launches, summed."""
    total = {"flash_attention": 0, "mamba_scan": 0}
    for arch in SERVE_DENSE["archs"]:
        launched = serve_dense_model(dev, arch)
        for k in total:
            total[k] += launched[k]
    return total


class RoutingTap:
    """Over ``moe._top_k`` (the router's top-k inside ``moe_block``) while
    installed: records every call's expert choices in order (on the card,
    no sync) or, given ``replay`` (another run's records), makes each call
    choose those experts, its gates still taken from its own router
    probabilities.  The MoE routing is then teacher-forced, as ``forced``
    tokens teacher-force the greedy picks: a near-tie between two experts'
    router logits, which bf16 rounding on either route tips, no longer
    sends a token through other experts."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        self.picks = []
        real = self.real = moe._top_k

        def tap(probs, k):
            if self.replay is None:
                vals, idx = real(probs, k)
            else:
                idx = self.replay[len(self.picks)]
                check(idx.shape == probs.shape[:-1] + (k,),
                      f"routing replay: call {len(self.picks)} is {tuple(probs.shape)}")
                vals = torch.gather(probs, -1, idx)
            self.picks.append(idx)
            return vals, idx

        moe._top_k = tap
        return self

    def __exit__(self, *exc):
        moe._top_k = self.real


def routing_parts(kern, plain, layers):
    """Per layer, the share of prefill tokens (the first ``layers`` calls)
    whose set of experts differs between two runs' ``RoutingTap.picks``,
    and the first layer where any does."""
    shares = [float((a.sort(-1).values != b.sort(-1).values).any(-1).float().mean())
              for a, b in zip(kern[:layers], plain[:layers])]
    first = next((i for i, sh in enumerate(shares) if sh > 0), None)
    return dict(tokens_rerouted_share=shares, first_layer_rerouted=first)


def serve_moe_model(dev, arch):
    """One MoE decoder at its published width and SERVE_MOE's depth, bf16,
    dispatch "einsum": served on the kernel route, then on the plain route
    teacher-forced with the kernel route's tokens twice: with its own
    routing (read only: where and how far the routes part) and with the
    kernel route's routing (``RoutingTap``), which must agree within
    SERVE_TOL, launches exact; a planted fault (DENSE_FAULT_WINDOW on every
    layer, the kernel route's routing) that the limit must catch.  Then the
    f32 leg at full width and SERVE_MOE_F32's depth, the same way: both
    routes' tokens equal, and "gather" against "einsum" within MOE_MODES_TOL
    with equal tokens.  Returns the bf16 kernel run's launches."""
    L = SERVE_MOE["layers"][arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=L)
    spec = dict(SERVE_MOE, arch=arch)
    gen, mode = spec["gen"], spec["dispatch_mode"]
    serve_warm_up(dev, cfg, spec)
    params = dense_params(dev, cfg)
    weight_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    with RoutingTap() as kern_tap:
        kern = serve_run(dev, cfg, params, "kernel", spec=spec, dispatch_mode=mode)
    with RoutingTap() as free_tap:
        free = serve_run(dev, cfg, params, "plain", forced=kern["tokens"], spec=spec,
                         dispatch_mode=mode)
    with RoutingTap(replay=kern_tap.picks):
        plain = serve_run(dev, cfg, params, "plain", forced=kern["tokens"], spec=spec,
                          dispatch_mode=mode)
    fault_cfg = dataclasses.replace(cfg, window=DENSE_FAULT_WINDOW, local_global_ratio=0)
    with RoutingTap(replay=kern_tap.picks):
        fault = serve_run(dev, fault_cfg, params, "kernel", gen=1, spec=spec,
                          dispatch_mode=mode)
    scale = float(np.abs(plain["logits"][0]).max())
    fault_err = float(np.abs(fault["logits"][0] - plain["logits"][0]).max() / scale)
    free_scale = float(np.abs(free["logits"]).max())
    own_routing = dict(routing_parts(kern_tap.picks, free_tap.picks, L),
                       rel_err_per_step=(np.abs(kern["logits"] - free["logits"]).max(axis=(1, 2))
                                         / free_scale).tolist(),
                       greedy_agree=float((kern["tokens"] == free["tokens"]).mean()))
    e = cfg.moe
    ok = serve_compare(
        "moe", kern, plain, SERVE_TOL["bfloat16"], spec, dtype=cfg.dtype, layers=L,
        published_layers=get_config(arch).n_layers, d_model=cfg.d_model,
        head_dim=cfg.resolved_head_dim, rep=cfg.n_heads // cfg.n_kv_heads,
        experts=e.num_experts, top_k=e.top_k, d_ff_expert=e.d_ff_expert,
        dispatch_mode=mode, params=cfg.param_count(),
        active_params=cfg.active_param_count(), weight_gb=weight_bytes / 1e9,
        routing="the kernel route's, on both", plain_own_routing=own_routing,
        planted_fault={"fault": f"window {DENSE_FAULT_WINDOW} on every layer",
                       "rel_err_prefill": fault_err})
    check(ok, f"serve_moe {arch}: kernel and plain routes part")
    want = {"flash_attention": L * gen, "mamba_scan": 0}
    got = {k: kern["launches"][k] for k in want}
    check(got == want, f"serve_moe {arch} kernel launches {got} != {want}")
    check(not any(plain["launches"].values()) and not any(free["launches"].values()),
          f"serve_moe {arch} plain route launched kernels: {plain['launches']}")
    check(fault_err > SERVE_TOL["bfloat16"],
          f"serve_moe {arch}: the bf16 limit misses the planted fault ({fault_err})")
    launched = kern["launches"]
    del params, kern, free, plain, fault, kern_tap, free_tap

    cfg32 = dataclasses.replace(cfg, n_layers=SERVE_MOE_F32["layers"], dtype="float32")
    spec32 = dict(SERVE_MOE_F32, arch=arch)
    params = dense_params(dev, cfg32)
    with RoutingTap() as kern_tap:
        kern = serve_run(dev, cfg32, params, "kernel", spec=spec32)
    with RoutingTap() as free_tap:
        free = serve_run(dev, cfg32, params, "plain", forced=kern["tokens"], spec=spec32)
    with RoutingTap(replay=kern_tap.picks):
        plain = serve_run(dev, cfg32, params, "plain", forced=kern["tokens"], spec=spec32)
    with RoutingTap(replay=kern_tap.picks):
        gather = serve_run(dev, cfg32, params, "kernel", spec=spec32, dispatch_mode="gather")
    modes_err = float(np.abs(gather["logits"] - kern["logits"]).max()
                      / np.abs(kern["logits"]).max())
    modes_same = bool(np.array_equal(gather["tokens"], kern["tokens"]))
    own_routing = dict(routing_parts(kern_tap.picks, free_tap.picks, cfg32.n_layers),
                       rel_err_max=float(np.abs(kern["logits"] - free["logits"]).max()
                                         / np.abs(free["logits"]).max()),
                       tokens_equal=bool(np.array_equal(kern["tokens"], free["tokens"])))
    ok = serve_compare("moe_f32", kern, plain, SERVE_TOL["float32"], spec32, dtype="float32",
                       layers=cfg32.n_layers, routing="the kernel route's, on both",
                       plain_own_routing=own_routing,
                       gather_vs_einsum={"rel_err": modes_err, "tol": MOE_MODES_TOL,
                                         "tokens_equal": modes_same,
                                         "launches": gather["launches"]})
    check(ok and np.array_equal(kern["tokens"], plain["tokens"]),
          f"serve_moe f32 {arch}: the routes part or their greedy tokens differ")
    check(modes_err <= MOE_MODES_TOL and modes_same,
          f"serve_moe f32 {arch}: gather against einsum {modes_err}, tokens equal {modes_same}")
    want = {"flash_attention": cfg32.n_layers * spec32["gen"], "mamba_scan": 0}
    for rec in (kern, gather):
        check({k: rec["launches"][k] for k in want} == want,
              f"serve_moe f32 {arch} kernel launches {rec['launches']} != {want}")
    del params, kern, free, plain, gather, kern_tap, free_tap
    _release()
    return launched


def serve_moe_phase(dev):
    """The MoE decoders, one model at a time, each freed before the next;
    returns their bf16 kernel runs' launches, summed."""
    total = {"flash_attention": 0, "mamba_scan": 0}
    for arch in SERVE_MOE["layers"]:
        launched = serve_moe_model(dev, arch)
        for k in total:
            total[k] += launched[k]
    return total


def granite_run(dev, cfg, params, impl, spec, forced=None, replay=None):
    """SERVE_GRANITE's prompts through one ContinuousBatcher on route
    ``impl``: every prompt admitted, then ``spec["steps"] + 1`` decode steps
    of every row, fed the greedy tokens or ``forced`` ones (another run's,
    teacher forcing), routed as the router picks or as ``replay`` (another
    run's ``RoutingTap.picks``).  Returns the prompt logits and each step's
    (rows, V) f32 logits on the host, the tokens fed, the picks, the launches
    from the first admission on, the host wall of each decode step, and the
    Mamba-2 state after the last step."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in spec["prompts"]]
    _release()
    batcher = ContinuousBatcher(cfg, params, max_slots=len(prompts), max_len=spec["max_len"],
                                impl=impl, prefill_chunk=spec["prefill_chunk"])
    for prompt in prompts:
        batcher.submit(prompt, max_new=spec["steps"] + 2)
    fed, logits, wall = [], [], []
    sync()
    reset_launches()
    with RoutingTap(replay=replay) as tap:
        batcher._admit()  # the first step's own admission: nothing left to admit
        for i in range(spec["steps"] + 1):
            if forced is not None:
                batcher.cur_tokens = forced[i].clone()
            fed.append(batcher.cur_tokens.clone())
            t0 = time.perf_counter()
            batcher.step()
            sync()
            wall.append(time.perf_counter() - t0)
            logits.append(batcher.logits.float().cpu())
    prompt_logits = torch.stack(batcher.prompt_logits).float().cpu()
    return dict(logits=torch.stack([prompt_logits] + logits).numpy(), fed=fed,
                picks=tap.picks, launches=dict(launches), wall_s=wall,
                ssm=batcher.cache["ssm"].clone(), prompts=[p.size for p in prompts])


def serve_granite_phase(dev):
    """granite-4.0-h-small at its published width and SERVE_GRANITE's depth
    through the batcher: the kernel route, then the plain route fed the
    kernel route's tokens and routing; step by step (step 0 is the prompts'
    last positions) within SERVE_TOL of the plain route's max|logit|; the
    kernel route launches ``mamba2_step`` once a Mamba-2 layer and decode
    step and nothing of Mamba-1, the plain route nothing.  Returns the
    kernel route's launches."""
    spec = SERVE_GRANITE
    cfg = dataclasses.replace(get_config(spec["arch"]), n_layers=spec["layers"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    weight_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    kern = granite_run(dev, cfg, params, "kernel", spec)
    plain = granite_run(dev, cfg, params, "plain", spec, forced=kern["fed"],
                        replay=kern["picks"])
    scale = np.abs(plain["logits"]).max(axis=(1, 2))
    err = (np.abs(kern["logits"] - plain["logits"]).max(axis=(1, 2)) / scale).tolist()
    ssm_err = float((kern["ssm"] - plain["ssm"]).abs().max() / plain["ssm"].abs().max())
    steps = spec["steps"] + 1
    chunks = sum(-(-n // spec["prefill_chunk"]) for n in kern["prompts"])
    mamba2 = cfg.layer_count("ssm")
    want = {"mamba2_step": mamba2 * steps, "mamba_step": 0, "mamba_scan": 0,
            "flash_attention": cfg.layer_count("attn") * (chunks + steps)}
    got = {k: kern["launches"][k] for k in want}
    decode = kern["wall_s"][1:]
    emit("serve_granite", arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         published_layers=get_config(spec["arch"]).n_layers, mamba2_layers=mamba2,
         params=cfg.param_count(), weight_gb=weight_bytes / 1e9, prompts=kern["prompts"],
         prefill_chunk=spec["prefill_chunk"], decode_steps=steps,
         rel_err_per_step=err, tol=SERVE_TOL["bfloat16"], ssm_state_rel_err=ssm_err,
         routing="the kernel route's, on both", launches=got,
         decode_s_per_step=dict(mean=float(np.mean(decode)), max=max(decode)))
    check(max(err) <= SERVE_TOL["bfloat16"], f"serve_granite: the routes part: {err}")
    check(got == want, f"serve_granite kernel launches {got} != {want}")
    check(not any(plain["launches"].values()),
          f"serve_granite plain route launched kernels: {plain['launches']}")
    launched = kern["launches"]
    del params, kern, plain
    _release()
    return launched


def whisper_inputs(dev, cfg, spec, seed=0):
    """SERVE_WHISPER's requests from numpy, as the reference driver draws an
    encoder-decoder's (frames first, then prompt tokens), at its frames."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((spec["batch"], spec["frames"], cfg.d_model))
    tokens = rng.integers(0, cfg.vocab, (spec["batch"], spec["prompt_len"]))
    return {"frames": torch.from_numpy(frames).to(dev, getattr(torch, cfg.dtype)),
            "tokens": torch.from_numpy(tokens).to(dev)}


def whisper_serve(dev, cfg, params, inputs, impl, gen):
    """Prefill and ``gen - 1`` greedy decode steps through the serving entry
    points (``make_prefill``, ``make_serve_step``): tokens, times, launches
    (prefill's, and the decode steps' together) and peak memory, in the
    fields ``serve_compare`` reads; the launch counts are set to 0 just
    before the run."""
    max_len = SERVE_WHISPER["prompt_len"] + gen + 1
    prefill_fn = make_prefill(cfg, max_len=max_len, impl=impl)
    step_fn = make_serve_step(cfg, impl=impl)
    _release()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, inputs)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    sync()
    t1 = time.perf_counter()
    prefill_launches = launches["flash_attention"]
    toks = [tok]
    for _ in range(gen - 1):
        tok, cache = step_fn(params, tok, cache)
        toks.append(tok)
    tokens = torch.cat(toks, dim=1).cpu().numpy()
    t2 = time.perf_counter()
    return dict(tokens=tokens, prefill_s=t1 - t0, decode_s_per_token=(t2 - t1) / (gen - 1),
                tokens_per_s=tokens.size / (t2 - t0), max_len=max_len,
                launches={"prefill": prefill_launches,
                          "decode": launches["flash_attention"] - prefill_launches},
                max_memory_allocated=torch.cuda.max_memory_allocated(dev))


def whisper_logits(cfg, params, inputs, impl, forced):
    """Every step's logits (f32 on the host) of prefill and the decode steps
    teacher-forced with ``forced`` (B, n) tokens: n + 1 steps, or prefill's
    alone when ``forced`` has no column."""
    logits, cache = make_prefill(cfg, max_len=SERVE_WHISPER["prompt_len"] + forced.shape[1] + 1,
                                 impl=impl)(params, inputs)
    steps = [logits[:, -1].float()]
    for i in range(forced.shape[1]):
        logits, cache = decode_step(params, forced[:, i:i + 1], cache, cfg, impl=impl)
        steps.append(logits[:, -1].float())
    return torch.stack(steps).cpu().numpy()


def whisper_routes(dev, cfg, params, inputs):
    """Both routes served (``whisper_serve``), then both teacher-forced with
    the kernel route's tokens for every step's logits."""
    runs = [whisper_serve(dev, cfg, params, inputs, impl, SERVE_WHISPER["gen"])
            for impl in ("kernel", "plain")]
    forced = torch.from_numpy(runs[0]["tokens"][:, :-1]).to(dev)
    for rec, impl in zip(runs, ("kernel", "plain")):
        rec["logits"] = whisper_logits(cfg, params, inputs, impl, forced)
    return runs


def serve_whisper_phase(dev):
    """whisper-small as published (bf16), SERVE_WHISPER's requests: the
    encoder, every decoder layer's self- and cross-attention on the
    attention kernel (no mask for the encoder and cross), served through
    make_prefill / make_serve_step with launches exact (per prefill 12
    encoder + 12 self + 12 cross, per decode step 12 + 12); the plain route
    teacher-forced with those tokens within SERVE_TOL of max|logit|; a
    planted fault (the encoder's attention made causal) beyond it; an f32
    leg at full width and 2 + 2 layers with equal tokens.  Returns the
    bf16 kernel run's launches."""
    spec = SERVE_WHISPER
    cfg = get_config(spec["arch"])
    inputs = whisper_inputs(dev, cfg, spec)
    warm = dataclasses.replace(cfg, n_layers=SERVE_WARM_LAYERS, n_enc_layers=SERVE_WARM_LAYERS)
    warm_params = dense_params(dev, warm)
    for impl in ("kernel", "plain"):
        whisper_serve(dev, warm, warm_params, inputs, impl, 2)
    del warm_params
    params = dense_params(dev, cfg)
    kern, plain = whisper_routes(dev, cfg, params, inputs)

    # planted fault: the encoder's attention (its only Sq == Skv no-mask call) causal
    def causal_encoder(real):
        def attention(q, k, v, **kw):
            if not kw.get("causal", True) and q.shape[2] == k.shape[2]:
                kw["causal"] = True
            return real(q, k, v, **kw)

        return attention

    with patched(ops, "flash_attention", causal_encoder):
        fault = whisper_logits(cfg, params, inputs, "kernel", torch.zeros(
            (spec["batch"], 0), dtype=torch.long, device=dev))
    fault_err = float(np.abs(fault[0] - plain["logits"][0]).max()
                      / np.abs(plain["logits"][0]).max())
    L, Le, gen = cfg.n_layers, cfg.n_enc_layers, spec["gen"]
    ok = serve_compare("whisper", kern, plain, SERVE_TOL["bfloat16"], spec, dtype=cfg.dtype,
                       frames=spec["frames"], layers=[Le, L], params=cfg.param_count(),
                       planted_fault={"fault": "the encoder's attention causal",
                                      "rel_err_prefill": fault_err})
    check(ok, "serve_whisper: kernel and plain routes part")
    want = {"prefill": Le + 2 * L, "decode": 2 * L * (gen - 1)}
    check(kern["launches"] == want, f"serve_whisper launches {kern['launches']} != {want}")
    check(plain["launches"] == {"prefill": 0, "decode": 0},
          f"serve_whisper plain route launched kernels: {plain['launches']}")
    check(fault_err > SERVE_TOL["bfloat16"],
          f"serve_whisper: the bf16 limit misses the planted fault ({fault_err})")
    launched = {"flash_attention": sum(kern["launches"].values())}
    del params, kern, plain

    cfg32 = dataclasses.replace(cfg, n_layers=SERVE_WHISPER_F32["layers"],
                                n_enc_layers=SERVE_WHISPER_F32["enc_layers"], dtype="float32")
    inputs = whisper_inputs(dev, cfg32, spec)
    params = dense_params(dev, cfg32)
    kern, plain = whisper_routes(dev, cfg32, params, inputs)
    ok = serve_compare("whisper_f32", kern, plain, SERVE_TOL["float32"], spec,
                       dtype="float32", layers=[cfg32.n_enc_layers, cfg32.n_layers])
    check(ok and np.array_equal(kern["tokens"], plain["tokens"]),
          "serve_whisper f32: the routes part or their greedy tokens differ")
    want = {"prefill": cfg32.n_enc_layers + 2 * cfg32.n_layers,
            "decode": 2 * cfg32.n_layers * (gen - 1)}
    check(kern["launches"] == want, f"serve_whisper f32 launches {kern['launches']} != {want}")
    del params, inputs, kern, plain
    _release()
    return launched


def batched_requests(cfg, spec, seed=0):
    """spec["requests"] (prompt, max_new) pairs drawn by numpy from ``seed``:
    prompt lengths and max_new uniform over their inclusive ranges."""
    rng = np.random.default_rng(seed)
    n = spec["requests"]
    lengths = rng.integers(spec["prompt"][0], spec["prompt"][1] + 1, n)
    news = rng.integers(spec["new"][0], spec["new"][1] + 1, n)
    return [(rng.integers(0, cfg.vocab, int(s)), int(m)) for s, m in zip(lengths, news)]


def batched_run(dev, cfg, params, spec, requests):
    """Every request submitted to one ContinuousBatcher on the card, then
    ``run()`` to the end, timed by the host clock (the per-request logits
    the batcher records are copied to the host inside it); the launch
    counts are set to 0 just before ``run()``."""
    _release()
    torch.cuda.reset_peak_memory_stats(dev)
    record = {}
    batcher = ContinuousBatcher(cfg, params, max_slots=spec["slots"],
                                max_len=spec["max_len"], record=record)
    rids = [batcher.submit(p, m) for p, m in requests]
    sync()
    reset_launches()
    t0 = time.perf_counter()
    out = batcher.run()
    sync()
    record.update(wall_s=time.perf_counter() - t0, launches=dict(launches),
                  tokens=[out[r] for r in rids], logits=[record["logits"][r] for r in rids],
                  max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    return record


def standalone(dev, cfg, params, prompt, n, max_len, forced=None):
    """One request alone (B = 1) on the kernel route: prefill, then n - 1
    decode steps fed ``forced`` tokens (teacher forcing) or the greedy ones;
    its (n, V) f32 logits."""
    logits, cache = prefill(params, {"tokens": torch.as_tensor(prompt[None], device=dev)},
                            cfg, max_len)
    rows = [logits[0, -1]]
    for i in range(n - 1):
        tok = (torch.argmax(rows[-1])[None, None] if forced is None
               else torch.tensor([[forced[i]]], device=dev))
        logits, cache = decode_step(params, tok, cache, cfg)
        rows.append(logits[0, -1])
    return torch.stack(rows).float().cpu().numpy()


def _rel_rows(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def slot0_offsets(flash):
    """``ops.flash_attention`` with a planted fault: every row of a per-row
    call gets the first row's offset."""
    def faulty(q, k, v, *, q_offset=0, **kw):
        if isinstance(q_offset, torch.Tensor):
            q_offset = q_offset[:1].expand(q_offset.shape[0]).contiguous()
        return flash(q, k, v, q_offset=q_offset, **kw)
    return faulty


def batched_summary(cfg, spec, rec) -> dict:
    steps = rec["steps"]
    decode = [st["wall_s"] for st in steps if st["admitted"] == 0]
    ttft = list(rec["ttft_s"].values())
    generated = sum(len(t) for t in rec["tokens"])
    return dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers, slots=spec["slots"],
                max_len=spec["max_len"], requests=spec["requests"],
                wall_s=rec["wall_s"], generated_tokens=generated,
                tokens_per_s=generated / rec["wall_s"],
                decode_s_per_step=dict(mean=float(np.mean(decode)),
                                       p50=float(np.median(decode)), max=max(decode),
                                       steps=len(decode)),
                ttft_s=dict(p50=float(np.median(ttft)), max=max(ttft)),
                mean_active_slots=float(np.mean([st["active"] for st in steps])),
                admissions=sum(st["admitted"] for st in steps), steps=len(steps),
                max_memory_allocated=rec["max_memory_allocated"],
                launches={k: rec["launches"][k]
                          for k in ("flash_attention", "mamba_scan", "mamba_step")})


def batched_launch_check(cfg, rec) -> None:
    L, steps = cfg.n_layers, len(rec["steps"])
    admissions = sum(st["admitted"] for st in rec["steps"])
    flash = 0 if cfg.attention_free else L * (admissions + steps)
    want = {"flash_attention": flash, "mamba_scan": L * admissions,
            "mamba_step": cfg.layer_count("ssm") * steps}
    got = {k: rec["launches"][k] for k in want}
    check(got == want, f"serve_batched {cfg.name} launches {got} != {want}")


def batched_warm_up(dev, cfg, spec):
    """SERVE_WARM_LAYERS layers, two requests of the shortest prompt, the
    pool's shapes."""
    cfg = dataclasses.replace(cfg, n_layers=SERVE_WARM_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    short = dict(spec, requests=2, prompt=(spec["prompt"][0],) * 2, new=(4, 4))
    batched_run(dev, cfg, params, spec, batched_requests(cfg, short))


def serve_batched_model(dev, spec):
    """One model through the batcher in bf16 at its published configuration:
    each request's logits against its own B = 1 run teacher-forced with the
    batcher's tokens (SERVE_TOL); for attention, a planted fault (every row
    at slot 0's offset) on the first decode step of the first pool of
    requests must exceed that limit.  Returns the run's launches."""
    cfg = get_config(spec["arch"])
    batched_warm_up(dev, cfg, spec)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    requests = batched_requests(cfg, spec)
    rec = batched_run(dev, cfg, params, spec, requests)
    batched_launch_check(cfg, rec)
    tol = SERVE_TOL["bfloat16"]
    errs, agree, alone = [], [], []
    for (prompt, _), toks, got in zip(requests, rec["tokens"], rec["logits"]):
        want = standalone(dev, cfg, params, prompt, len(toks), spec["max_len"], forced=toks)
        errs.append(_rel_rows(got, want))
        agree.append(float(np.mean(want.argmax(-1) == np.asarray(toks))))
        alone.append(want)
    finite = all(np.isfinite(g).all() for g in rec["logits"])
    res = dict(rel_err_max=max(errs), rel_err_per_request=errs, tol=tol, finite=finite,
               greedy_agree=float(np.mean(agree)))
    if not cfg.attention_free:
        first = [(p, 2) for p, _ in requests[:spec["slots"]]]
        flash = ops.flash_attention
        ops.flash_attention = slot0_offsets(flash)
        try:
            fault = batched_run(dev, cfg, params, spec, first)
        finally:
            ops.flash_attention = flash
        res["planted_fault_rel_err"] = max(_rel_rows(f[1], w[1])
                                           for f, w in zip(fault["logits"], alone))
    emit("serve_batched", **batched_summary(cfg, spec, rec), teacher_forced=res)
    check(finite and max(errs) <= tol, f"serve_batched {cfg.name}: rel err {errs} > {tol}")
    if not cfg.attention_free:
        check(res["planted_fault_rel_err"] > tol,
              f"serve_batched: the bf16 limit misses the planted fault: {res}")
    launched = rec["launches"]
    del params, rec, alone
    _release()
    return launched


def serve_batched_f32(dev, spec):
    """hymba-1.5b in f32 at full width and SERVE_F32_LAYERS layers through the
    batcher: every request's greedy tokens equal its own B = 1 run's, its
    logits to SERVE_TOL["float32"]."""
    cfg = dataclasses.replace(get_config(spec["arch"]), n_layers=SERVE_F32_LAYERS,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    requests = batched_requests(cfg, spec)
    rec = batched_run(dev, cfg, params, spec, requests)
    batched_launch_check(cfg, rec)
    errs, same = [], []
    for (prompt, _), toks, got in zip(requests, rec["tokens"], rec["logits"]):
        want = standalone(dev, cfg, params, prompt, len(toks), spec["max_len"])
        errs.append(_rel_rows(got, want))
        same.append(want.argmax(-1).tolist() == toks)
    tol = SERVE_TOL["float32"]
    emit("serve_batched_f32", **batched_summary(cfg, spec, rec), rel_err_max=max(errs),
         tol=tol, tokens_equal=sum(same))
    check(all(same), f"serve_batched f32: tokens differ from standalone for "
                     f"{[i for i, ok in enumerate(same) if not ok]}")
    check(max(errs) <= tol, f"serve_batched f32: rel err {max(errs)} > {tol}")
    del params, rec
    _release()


def serve_batched_phase(dev):
    """Continuous batching on the card: each SERVE_BATCHED model in bf16 at
    its published configuration, then the f32 check.  Returns the bf16
    runs' launches, summed."""
    main = {"flash_attention": 0, "mamba_scan": 0, "mamba_step": 0}
    for spec in SERVE_BATCHED:
        launched = serve_batched_model(dev, spec)
        for k in main:
            main[k] += launched[k]
        if spec["arch"] == SERVE["arch"]:
            serve_batched_f32(dev, spec)
    return main


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd")


def train_launches_per_step(cfg):
    """Kernel launches of one train step under full remat: each attention
    call (a decoder layer's; an encoder-decoder's encoder layers' and cross-
    attention too) and each layer's scan forward twice (forward and
    recompute), backward once."""
    L, scan = cfg.n_layers, cfg.ssm is not None
    calls = L + (cfg.n_enc_layers + L if cfg.encdec else 0)
    return {"flash_attention": 2 * calls, "flash_attention_bwd": calls,
            "mamba_scan": 2 * L if scan else 0, "mamba_scan_bwd": L if scan else 0}


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(owner.name)`` inside the block: a
    planted fault."""
    real = getattr(owner, name)
    setattr(owner, name, wrap(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


#: f32 attention launches of the main paths (their f32 legs and planted
#: faults; the kernel cases' comparisons excluded), by kernel library
F32_LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}


def f32_counter(name):
    """A wrap for ``patched``: the launcher, counting its f32 calls in
    ``F32_LAUNCHES[name]``."""
    def wrap(real):
        def counted(q, *args, **kw):
            F32_LAUNCHES[name] += int(q.dtype == torch.float32)
            return real(q, *args, **kw)
        return counted
    return wrap


#: the planted fault of the hymba and gemma train checks: the local layers'
#: window dropped in the backward kernel only
WINDOW_DROPPED = ("window dropped in the backward kernel",
                  lambda: patched(ops, "flash_attention_bwd",
                                  lambda real: lambda *a, **kw: real(*a, **dict(kw, window=None))))


def train_run(dev, cfg, spec, tag, n_leaves):
    """Model ``cfg`` trained through ``train_loop`` on the kernel route at
    ``spec``'s batch, sequence and lr: one warm-up step, spec["steps"] timed
    ones, then one under torch.profiler.  The launch counts are set to 0
    just before the run and read (and set to 0 again) after every step.
    Emits ``train_{tag}kernel`` and ``train_{tag}profile``; returns the
    launches of the whole run and the steps."""
    L = cfg.n_layers
    steps = []

    def on_step(step, metrics):
        steps.append(dict(metrics, step=step, launches={k: launches[k] for k in TRAIN_KERNELS},
                          max_memory_allocated=torch.cuda.max_memory_allocated(dev)))
        reset_launches()

    profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
    last_timed = spec["warm"] + spec["steps"] - 1

    def on_step_profiled(step, metrics):
        on_step(step, metrics)
        if step == last_timed:
            profiler.start()  # the next step runs under the profiler
        elif step == last_timed + 1:
            profiler.stop()

    _release()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    state, history = train_loop(cfg, steps=last_timed + 2,
                                batch=spec["batch"], seq=spec["seq"], reduced=False,
                                lr=spec["lr"], log_every=1, device=dev,
                                on_step=on_step_profiled,
                                log_fn=lambda line: print(f"# {line}", file=sys.stderr))
    n_params = sum(t.numel() for _, t in _leaves(state["params"]))
    got_leaves = len(list(_leaves(state["params"])))
    del state
    _release()
    timed = steps[spec["warm"]:last_timed + 1]
    s_per_step = sum(st["s"] for st in timed) / len(timed)
    profile = train_profile(profiler, steps[-1]["s"])
    want = train_launches_per_step(cfg)
    emit(f"train_{tag}kernel", arch=spec["arch"], n_layers=L, d_model=cfg.d_model,
         params=n_params, leaves=got_leaves, batch=spec["batch"], seq=spec["seq"],
         dtype=cfg.dtype, master="float32", plan=steps[0]["plan"],
         s_per_step=s_per_step, tokens_per_s=spec["batch"] * spec["seq"] / s_per_step,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         steps=[{k: st[k] for k in ("step", "s", "loss", "grad_norm", "lr", "launches",
                                    "max_memory_allocated")} for st in steps],
         launches_per_step_expected=want)
    emit(f"train_{tag}profile", **profile)
    check(all(np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"]) for st in steps),
          f"train {spec['arch']}: non-finite loss or grad norm {history}")
    check(got_leaves == n_leaves,
          f"train {spec['arch']}: {got_leaves} parameter leaves, not {n_leaves}")
    for st in steps:
        check(st["launches"] == want, f"train {spec['arch']} step {st['step']} launches "
                                      f"{st['launches']} != {want}")
    return {k: sum(st["launches"][k] for st in steps) for k in TRAIN_KERNELS}, steps


def train_plain_curve(dev, schedule_steps):
    """TRAIN's first TRAIN_PLAIN_STEPS steps at TRAIN_PLAIN_CURVE_LAYERS
    layers on both routes (``impl="kernel"`` and ``"plain"``), from the same
    seed and batches under the train run's lr schedule (``schedule_steps``):
    both loss curves and gradient norms, launches exact on the kernel route
    and none on the plain one.  The curves agree at step 0 and part by bf16
    rounding from step 1; the losses must agree to TRAIN_TOL over these
    steps.  (Later steps diverge chaotically under the schedule's lr 1e-2
    warm-up on either route: PERF.md, Queue 3 (g).)"""
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=TRAIN_PLAIN_CURVE_LAYERS)
    runs = {}
    for impl in ("kernel", "plain"):
        steps = []
        _release()
        reset_launches()
        state, _ = train_loop(cfg, steps=TRAIN_PLAIN_STEPS, batch=TRAIN["batch"],
                              seq=TRAIN["seq"], reduced=False, lr=TRAIN["lr"], log_every=1,
                              schedule_steps=schedule_steps, device=dev, impl=impl,
                              on_step=lambda step, metrics: steps.append(dict(metrics,
                                                                              step=step)),
                              log_fn=lambda line: print(f"# {line}", file=sys.stderr))
        del state
        _release()
        runs[impl] = steps
        got = {k: launches[k] for k in TRAIN_KERNELS}
        want = {k: n * TRAIN_PLAIN_STEPS if impl == "kernel" else 0
                for k, n in train_launches_per_step(cfg).items()}
        check(got == want, f"train curve {impl} route launches {got} != {want}")
    curves = {name: {k: [st[k] for st in run] for k in ("loss", "grad_norm", "lr", "s")}
              for name, run in runs.items()}
    diff = [abs(a - b) / abs(b) for a, b in zip(curves["kernel"]["loss"],
                                                curves["plain"]["loss"])]
    emit("train_plain_curve", n_layers=cfg.n_layers, steps=TRAIN_PLAIN_STEPS, curves=curves,
         loss_rel_diff=diff, tol=TRAIN_TOL["bfloat16"])
    check(all(np.isfinite(st["loss"]) for run in runs.values() for st in run),
          f"train curves: {curves}")
    check(max(diff) <= TRAIN_TOL["bfloat16"], f"train curves part: {diff}")


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


def _grads(cfg, params, batch, impl, compute_dtype, plan, rules=None):
    """(loss, [(path, grad)]) of one gradient step of ``cfg`` under ``plan``
    (and ``rules``), and the seconds it took."""
    sync()
    t0 = time.perf_counter()
    loss, _aux, grads = make_grad_fn(cfg, plan, rules, compute_dtype=compute_dtype,
                                     impl=impl)(params, batch)
    sync()
    return loss, list(_leaves(grads)), time.perf_counter() - t0


def _cut(params, layers):
    return dict(params, layers={g: {k: v[:layers] for k, v in leaves.items()}
                                for g, leaves in params["layers"].items()})


def _leaf_errs(got, want):
    """max|got - want| / max|want| per gradient leaf, keyed by path.  A key
    bias (``bk``: softmax over keys is blind to it, so its exact gradient is
    0 and both routes hold rounding) is taken relative to the max|want| of
    the same projection's weight, ``wk``."""
    scale = {path: b.float().abs().max().clamp_min(1e-30) for path, b in want}
    return {"/".join(path): ((a.float() - b.float()).abs().max()
                             / scale[path[:-1] + ("wk",) if path[-1] == "bk" else path]).item()
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


def pipeline_batch(dev, cfg, spec):
    """train_loop's first batch at ``spec``'s batch and sequence."""
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                    global_batch=spec["batch"]))
    return batch_to(next(pipe), dev)


def grad_checks(dev, cfg, spec, tag, plain_layers, f32, batch, fault, plan):
    """The gradients of one step of ``cfg`` under ``plan``, the train run's
    (full remat, bf16 compute on f32 masters, bf16 gradients;
    ``dense_params``' weights) on ``batch``: two kernel runs
    bitwise equal, the kernel route against the plain route at
    ``plain_layers`` (TRAIN_TOL), a planted fault that the limit must catch
    (``fault``: its name and a context that plants it), then f32 (f32
    gradients too) at full width, ``f32["layers"]`` (and
    ``f32["enc_layers"]``) and the batch's first ``f32["batch"]`` rows
    (1e-4, launches exact).  Emitted as ``train_{tag}...``."""
    params = dense_params(dev, dataclasses.replace(cfg, dtype="float32"))

    # determinism: the same backward twice at the train run's depth
    first = _grads(cfg, params, batch, "kernel", "bfloat16", plan)
    second = _grads(cfg, params, batch, "kernel", "bfloat16", plan)
    same = (torch.equal(first[0], second[0])
            and all(torch.equal(a, b) for (_, a), (_, b) in zip(first[1], second[1])))
    emit(f"train_{tag}determinism", n_layers=cfg.n_layers, bitwise_equal=same,
         kernel_s=[first[2], second[2]])
    check(same, f"train {spec['arch']}: two backward runs on the card differ")
    del second

    cut = dataclasses.replace(cfg, n_layers=plain_layers)
    cparams = _cut(params, plain_layers)
    kern = first if plain_layers == cfg.n_layers else _grads(cut, cparams, batch, "kernel",
                                                             "bfloat16", plan)
    del first
    reset_launches()
    plain = _grads(cut, cparams, batch, "plain", "bfloat16", plan)
    check(all(launches[k] == 0 for k in TRAIN_KERNELS),
          f"train plain route launched kernels: {dict(launches)}")
    train_compare(f"{tag}bf16", kern, plain, TRAIN_TOL["bfloat16"])
    del kern

    fault_name, plant = fault
    with plant():
        planted = _grads(cut, cparams, batch, "kernel", "bfloat16", plan)
    per_leaf = _leaf_errs(planted[1], plain[1])
    worst = max(per_leaf, key=per_leaf.get)
    emit(f"train_{tag}bf16_planted_fault", fault=fault_name, worst_leaf=worst,
         worst_rel_err=per_leaf[worst], tol=TRAIN_TOL["bfloat16"])
    check(per_leaf[worst] > TRAIN_TOL["bfloat16"],
          f"the bf16 train limit misses a planted fault: {worst} {per_leaf[worst]}")
    del planted, plain, cparams, params
    _release()

    cfg32 = dataclasses.replace(cfg, n_layers=f32["layers"], dtype="float32",
                                n_enc_layers=f32.get("enc_layers", cfg.n_enc_layers))
    params = dense_params(dev, cfg32)
    batch = {k: (v[:f32["batch"]].float() if v.is_floating_point() else v[:f32["batch"]])
             for k, v in batch.items()}
    plan32 = dataclasses.replace(plan, grad_dtype="float32")
    reset_launches()
    kern = _grads(cfg32, params, batch, "kernel", "float32", plan32)
    want = train_launches_per_step(cfg32)
    got = {k: launches[k] for k in TRAIN_KERNELS}
    check(got == want, f"train {spec['arch']} f32 kernel launches {got} != {want}")
    plain = _grads(cfg32, params, batch, "plain", "float32", plan32)
    train_compare(f"{tag}f32", kern, plain, TRAIN_TOL["float32"])
    del kern, plain, params
    _release()


def train_phase(dev):
    """Training hymba-1.5b through the kernels (``train_run``), both routes'
    loss curves at a cut depth (``train_plain_curve``), then the gradient
    checks (``grad_checks``: bitwise at the published depth, the plain route
    at TRAIN_PLAIN_LAYERS, a planted fault, f32 at 8 layers).  Returns the
    launches of the train run (the main path's) and the run (``train_run``'s
    steps, with the config and shape)."""
    cfg = get_config(TRAIN["arch"])
    main_launches, kernel_steps = train_run(dev, cfg, TRAIN, "", 21)
    train_plain_curve(dev, len(kernel_steps))
    grad_checks(dev, cfg, TRAIN, "", TRAIN_PLAIN_LAYERS, TRAIN_F32,
                pipeline_batch(dev, cfg, TRAIN), WINDOW_DROPPED, chosen_plan(cfg, TRAIN))
    return main_launches, dict(cfg=cfg, spec=TRAIN, steps=kernel_steps)


def train_dense_phase(dev):
    """Training gemma3-4b at its published width and TRAIN_DENSE's depth
    through the kernels (``train_run``: every layer's attention forward and
    backward on its kernels, head dim 256), then ``grad_checks`` at the same
    depth (f32 at TRAIN_DENSE_F32).  Returns the train run's launches and
    the run."""
    cfg = dataclasses.replace(get_config(TRAIN_DENSE["arch"]), n_layers=TRAIN_DENSE["layers"])
    main_launches, steps = train_run(dev, cfg, TRAIN_DENSE, "dense_", 13)
    grad_checks(dev, cfg, TRAIN_DENSE, "dense_", cfg.n_layers, TRAIN_DENSE_F32,
                pipeline_batch(dev, cfg, TRAIN_DENSE), WINDOW_DROPPED,
                chosen_plan(cfg, TRAIN_DENSE))
    return main_launches, dict(cfg=cfg, spec=TRAIN_DENSE, steps=steps)


def whisper_train_batch(dev, cfg, spec, seed=0):
    """A train batch of TRAIN_WHISPER's requests from numpy, drawn as
    ``whisper_inputs`` draws a serve batch (frames first, then token ids):
    the decoder reads ``seq`` ids and is scored on the next ones."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((spec["batch"], spec["frames"], cfg.d_model))
    ids = torch.from_numpy(rng.integers(0, cfg.vocab, (spec["batch"], spec["seq"] + 1)))
    return {"frames": torch.from_numpy(frames).to(dev, getattr(torch, cfg.dtype)),
            "tokens": ids[:, :-1].to(dev), "labels": ids[:, 1:].to(dev)}


def chosen_plan(cfg, spec) -> Plan:
    """The LSHS plan optimizer's choice on one card at ``spec``'s shape,
    fitted to the 1 x 1 mesh (the plan ``train_loop`` takes when given
    none)."""
    return fit_plan_to_mesh(choose_plan(cfg, ONE_CARD, "train", spec["batch"],
                                        spec["seq"]).plan, ONE_CARD)


def whisper_train_run(dev, cfg, spec):
    """whisper-small trained through ``make_train_step`` on the kernel route
    (f32 masters, bf16 compute, under ``chosen_plan``: full remat, bf16
    gradients) on one seeded batch: one warm-up step, spec["steps"] timed
    ones, one under torch.profiler, each step's launches read and set to 0
    after it.  Returns the launches of the whole run and its steps."""
    steps_n = spec["warm"] + spec["steps"] + 1
    opt = AdamConfig(lr=spec["lr"], warmup_steps=max(steps_n // 20, 5),  # train_loop's
                     total_steps=steps_n)
    params = dense_params(dev, dataclasses.replace(cfg, dtype="float32"))  # f32 masters
    state = {"params": params, "opt": init_opt_state(params)}
    del params
    plan = chosen_plan(cfg, spec)
    step_fn = make_train_step(cfg, plan, opt)
    batch = whisper_train_batch(dev, cfg, spec)
    profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    steps = []
    for i in range(steps_n):
        if i == steps_n - 1:
            profiler.start()
        sync()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = metrics["loss"].item()
        sync()
        steps.append(dict(step=i, s=time.perf_counter() - t0, loss=loss, plan=plan.describe(),
                          grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
                          launches={k: launches[k] for k in TRAIN_KERNELS},
                          max_memory_allocated=torch.cuda.max_memory_allocated(dev)))
        reset_launches()
    profiler.stop()
    n_params = sum(t.numel() for _, t in _leaves(state["params"]))
    del state
    _release()
    timed = steps[spec["warm"]:spec["warm"] + spec["steps"]]
    s_per_step = sum(st["s"] for st in timed) / len(timed)
    want = train_launches_per_step(cfg)
    B, T, S = spec["batch"], spec["frames"], spec["seq"]
    emit("train_whisper_kernel", arch=spec["arch"], layers=[cfg.n_enc_layers, cfg.n_layers],
         d_model=cfg.d_model, params=n_params, batch=B, frames=T, seq=S, dtype=cfg.dtype,
         master="float32", plan=plan.describe(), s_per_step=s_per_step,
         tokens_per_s=B * S / s_per_step, frames_per_s=B * T / s_per_step,
         max_memory_allocated=max(st["max_memory_allocated"] for st in steps),
         steps=steps, launches_per_step_expected=want)
    emit("train_whisper_profile", **train_profile(profiler, steps[-1]["s"]))
    check(all(np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"]) for st in steps),
          f"train_whisper: non-finite loss or grad norm {steps}")
    for st in steps:
        check(st["launches"] == want,
              f"train_whisper step {st['step']} launches {st['launches']} != {want}")
    return {k: sum(st["launches"][k] for st in steps) for k in TRAIN_KERNELS}, steps


def causal_cross(real):
    """``ops.flash_attention`` with every call over another length of keys
    than of queries (cross-attention) made causal: each target position
    then sees only the frames up to its own index."""
    def attention(q, k, v, **kw):
        if not kw.get("causal", True) and q.shape[2] != k.shape[2]:
            kw["causal"] = True
        return real(q, k, v, **kw)

    return attention


def train_whisper_phase(dev):
    """Training whisper-small as published through the kernels
    (``whisper_train_run``: the encoder's and cross-attention's forward and
    backward with no mask, the decoder's causal), then ``grad_checks`` at
    the same depth (a planted fault: cross-attention made causal; f32 at
    TRAIN_WHISPER_F32).  Returns the train run's launches and the run."""
    cfg = get_config(TRAIN_WHISPER["arch"])
    main_launches, steps = whisper_train_run(dev, cfg, TRAIN_WHISPER)
    grad_checks(dev, cfg, TRAIN_WHISPER, "whisper_", cfg.n_layers, TRAIN_WHISPER_F32,
                whisper_train_batch(dev, cfg, TRAIN_WHISPER),
                ("cross-attention causal", lambda: patched(ops, "flash_attention",
                                                           causal_cross)),
                chosen_plan(cfg, TRAIN_WHISPER))
    return main_launches, dict(cfg=cfg, spec=TRAIN_WHISPER, steps=steps)


def spmd_plans(runs):
    """The plan optimizer on the H100 table (``choose_plan`` over a 1 x 1
    mesh) for each train run's model at its shape: the top four of the
    ranking, the chosen plan, its estimated memory against the run's
    measured peak; the choice fits, is the plan the run took, and the peak
    is under the card's memory."""
    for run in runs:
        cfg, spec, steps = run["cfg"], run["spec"], run["steps"]
        choice = choose_plan(cfg, ONE_CARD, "train", spec["batch"], spec["seq"])
        peak = max(st["max_memory_allocated"] for st in steps)
        chosen = chosen_plan(cfg, spec).describe()
        emit("spmd_plan", arch=spec["arch"], n_layers=cfg.n_layers, batch=spec["batch"],
             seq=spec["seq"], chosen=chosen, ranking=choice.ranking[:4],
             mem_bytes=choice.est.mem_bytes, measured_peak=peak,
             estimate_err=(choice.est.mem_bytes - peak) / peak, hbm_bytes=H100_SXM.hbm_bytes,
             run_plan=steps[0]["plan"])
        check(choice.est.fits and peak < H100_SXM.hbm_bytes and steps[0]["plan"] == chosen,
              f"spmd plan {spec['arch']}: {chosen} fits {choice.est.fits}, "
              f"peak {peak}, run took {steps[0]['plan']}")


def spmd_roofline(run):
    """gemma3-4b's train_loop(plan=None) run (train_dense) against the H100
    roofline: its seconds a step beside the analytic compute and memory
    times, and its model FLOPs utilisation (6 N tokens over 989 TFLOP/s x
    the measured step)."""
    cfg, spec, steps = run["cfg"], run["spec"], run["steps"]
    B, S = spec["batch"], spec["seq"]
    timed = steps[spec["warm"]:spec["warm"] + spec["steps"]]
    s_step = sum(st["s"] for st in timed) / len(timed)
    plan = chosen_plan(cfg, spec)
    terms = roofline(cfg, "train", B, S, 1, local_param_numel(cfg, plan, ONE_CARD), 0.0,
                     plan.remat, plan.dispatch_mode)
    emit("spmd_roofline", arch=spec["arch"], n_layers=cfg.n_layers, plan=plan.describe(),
         s_per_step=s_step, compute_s=terms.compute_s, memory_s=terms.memory_s,
         collective_s=terms.collective_s, dominant=terms.dominant, flops=terms.flops,
         model_flops=terms.model_flops, mfu=mfu(cfg, "train", B, S, s_step),
         hw=H100_SXM.name)


def spmd_step(dev, mesh, cfg):
    """One gradient step of ``cfg`` under SPMD["plan"] on plain tensors,
    then on the 1 x 1 mesh as DTensors under the plan's rules: launches
    equal, the loss and every gradient leaf equal bit for bit, the
    collectives counted.  Returns the sharded step's launches."""
    plan = fit_plan_to_mesh(SPMD["plan"], mesh)
    params = dense_params(dev, dataclasses.replace(cfg, dtype="float32"))
    batch = pipeline_batch(dev, cfg, SPMD)
    _grads(cfg, params, batch, "kernel", "bfloat16", plan)  # warm both paths' caches
    reset_launches()
    plain = _grads(cfg, params, batch, "kernel", "bfloat16", plan)
    plain_launches = {k: launches[k] for k in TRAIN_KERNELS}
    sharded_params = shard_tree(params, cfg, plan, mesh)
    specs = batch_specs(cfg, plan, "train")
    sharded_batch = {k: distribute_tensor(v, mesh, spec_placements(
        mesh, fit_spec(mesh, specs[k], v.shape))) for k, v in batch.items()}
    rules = activation_rules(plan, mesh, cfg)
    _grads(cfg, sharded_params, sharded_batch, "kernel", "bfloat16", plan, rules)
    reset_launches()
    with CollectiveCounter() as cc:
        sharded = _grads(cfg, sharded_params, sharded_batch, "kernel", "bfloat16", plan,
                         rules)
    got = {k: launches[k] for k in TRAIN_KERNELS}
    local = [(path, g.to_local() if isinstance(g, DTensor) else g) for path, g in sharded[1]]
    bitwise = torch.equal(sharded[0], plain[0]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(local, plain[1]))
    errs = _leaf_errs(local, plain[1])
    worst = max(errs, key=errs.get)
    emit("spmd_step", arch=cfg.name, n_layers=cfg.n_layers, batch=SPMD["batch"],
         seq=SPMD["seq"], plan=plan.describe(), mesh="1x1 cuda", launches_sharded=got,
         launches_plain=plain_launches, loss=sharded[0].item(), loss_plain=plain[0].item(),
         bitwise_equal=bitwise, worst_leaf=worst, worst_rel_err=errs[worst],
         collectives=cc.result(), sharded_s=sharded[2], plain_s=plain[2],
         dtensor_overhead=sharded[2] / plain[2] - 1)
    check(got == plain_launches and got["flash_attention"] > 0,
          f"spmd {cfg.name}: sharded launches {got} != plain {plain_launches}")
    if cfg.ssm is not None:
        check(got["mamba_scan"] > 0 and got["mamba_scan_bwd"] > 0,
              f"spmd {cfg.name}: the scan kernels did not run: {got}")
    # one rank: every collective is the identity, so nothing but a fault
    # of the sharded path can move a bit
    check(bitwise, f"spmd {cfg.name}: sharded step not bit-equal to the plain step: loss "
          f"{sharded[0].item()} vs {plain[0].item()}, {worst} {errs[worst]}")
    del params, sharded_params, plain, sharded, local
    _release()
    return got


def spmd_phase(dev, runs):
    """SPMD sharding on the card: the plan optimizer's choices on the H100
    table against the train runs' measured peaks (``spmd_plans``), the
    roofline and mfu of gemma3-4b's ``train_loop(plan=None)`` run
    (``spmd_roofline``), then the sharded path's step on a 1 x 1 CUDA mesh
    for each SPMD model (``spmd_step``).  Returns the sharded steps'
    launches."""
    spmd_plans(runs)
    spmd_roofline(next(r for r in runs if r["spec"] is TRAIN_DENSE))
    total = {k: 0 for k in TRAIN_KERNELS}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        for arch, layers in SPMD["models"]:
            cfg = get_config(arch)
            if layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            got = spmd_step(dev, mesh, cfg)
            total = {k: total[k] + got[k] for k in TRAIN_KERNELS}
    finally:
        dist.destroy_process_group()
    return total


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

    phase_s = {"build": build_s}  # host wall per phase, for the time limit's budget
    t_phase = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now

    matmul_cases, glm_cases = kernel_phase(dev)
    _release()
    flash_cases, scan_cases, step_cases = serve_kernel_phase(dev)
    step2_cases = [step2_case(dev, torch.Generator(device=dev).manual_seed(2))]
    _release()
    flash_cases += dense_kernel_cases(dev)
    flash_cases += whisper_kernel_cases(dev)
    flash_cases += moe_kernel_cases(dev)
    flash_bwd_cases, scan_bwd_cases = train_kernel_phase(dev)
    flash_bwd_cases += whisper_bwd_cases(dev)
    lap("kernel_cases")
    # from here on, count the f32 attention launches (F32_LAUNCHES)
    f32_counting = contextlib.ExitStack()
    for name in ("flash_attention", "flash_attention_bwd"):
        f32_counting.enter_context(patched(ops, f"{name}_cuda", f32_counter(name)))

    # the block phases make their large random blocks once (HostBlocks)
    with HostBlocks():
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
        lap("runtime")
        # the paper's other block workloads (CP-ALS, TSQR, Cholesky, rSVD,
        # L-BFGS, checkpoints), their products on the kernel on backend cuda
        block_launches = block_algorithms_phase(dev)
        lap("block_algorithms")
        # the block runtime's flight recorder, chaos runtime and calibration
        fault_obs_launches = fault_obs_phase(dev, smi)
        lap("fault_obs")

    # main path 2: LM serving, through the attention and scan kernels: one
    # fixed batch, then continuous batching (each slot at its own position)
    serve_launches = serve_phase(dev)
    lap("serve")
    batched_launches = serve_batched_phase(dev)
    lap("serve_batched")
    # the dense and VLM decoders, through the attention kernel (head dim 256
    # on gemma3-4b and gemma-7b)
    dense_launches = serve_dense_phase(dev)
    lap("serve_dense")
    # the MoE decoders at their published width, cut in depth
    moe_launches = serve_moe_phase(dev)
    lap("serve_moe")
    # the hybrid Mamba-2 decoder through the batcher, every Mamba-2 decode
    # step on the mamba2_step kernel
    granite_launches = serve_granite_phase(dev)
    lap("serve_granite")
    # the encoder-decoder: whisper-small's encoder, self- and cross-attention
    # through the attention kernel (no mask on the encoder and cross)
    whisper_launches = serve_whisper_phase(dev)
    lap("serve_whisper")
    # main path 3: LM training, through the attention and scan kernels and
    # their backward kernels; then gemma3-4b (head dim 256) at 12 layers
    train_launches, hymba_run = train_phase(dev)
    lap("train")
    dense_train_launches, dense_run = train_dense_phase(dev)
    lap("train_dense")
    # whisper-small trained: the attention backward with no mask (encoder,
    # cross-attention over 1500 frames) and causal (decoder)
    whisper_train_launches, whisper_run = train_whisper_phase(dev)
    lap("train_whisper")
    # SPMD sharding: the plan optimizer on the H100 table, and the sharded
    # path's step (DTensors, kernels on local shards) on a 1 x 1 CUDA mesh
    spmd_launches = spmd_phase(dev, [hymba_run, dense_run, whisper_run])
    lap("spmd")
    f32_counting.close()
    emit("f32_launches", **F32_LAUNCHES)
    emit("timing", phase_s=phase_s, total_s=time.perf_counter() - t0)

    # launches of the main paths' own runs: the block runtime on backend
    # cuda (like the reference's backend, it never routes to glm_fused, held
    # against its plain version above at the main path's shapes), the bf16
    # serve run through the kernels, the bf16 continuous-batching runs of
    # both models, the dense decoders' and the MoE decoders' bf16 runs,
    # whisper-small's bf16 run, and the three train runs
    main_launches = {k: cuda["launches"][k] + dg_cuda["launches"][k]
                     for k in ("matmul", "glm_fused")}
    main_launches["matmul"] += block_launches + fault_obs_launches
    main_launches.update({k: serve_launches[k] + batched_launches[k] + dense_launches[k]
                          + moe_launches[k] + train_launches[k] + dense_train_launches[k]
                          + whisper_train_launches[k] + spmd_launches[k]
                          for k in ("flash_attention", "mamba_scan")})
    main_launches["flash_attention"] += (whisper_launches["flash_attention"]
                                         + granite_launches["flash_attention"])
    main_launches["mamba_step"] = serve_launches["mamba_step"] + batched_launches["mamba_step"]
    main_launches.update({k: train_launches[k] + dense_train_launches[k]
                          + whisper_train_launches[k] + spmd_launches[k]
                          for k in ("flash_attention_bwd", "mamba_scan_bwd")})
    check(all(whisper_train_launches[k] > 0 for k in ("flash_attention", "flash_attention_bwd"))
          and moe_launches["flash_attention"] > 0,
          f"the new paths' launches: {moe_launches}, {whisper_train_launches}")
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
        kernel_entry("mamba_step", STEP_SRC, step_cases, step_cases[0]["case"],
                     main_launches["mamba_step"]),
        kernel_entry("mamba2_step", STEP2_SRC, step2_cases, step2_cases[0]["case"],
                     granite_launches["mamba2_step"]),
    ]}, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
