"""Does a 5-step bf16 train run rise or spike because of a kernel, or by
rounding?  (ROADMAP Queue 3 (g): hymba-1.5b's step-4 spike; (i): gemma3-4b
at 12 layers rising at lr 1e-2.)

    python scripts/train_spike_probe.py             # hymba-1.5b, one H100, ~9 min
    python scripts/train_spike_probe.py bf16_KK f32_KK  # some runs only
    python scripts/train_spike_probe.py --arch gemma3-4b --layers 12
    python scripts/train_spike_probe.py --cpu       # a 2-layer rehearsal

Same seed, batches and lr schedule as chip_smoke.py's train runs (4 x 2048,
lr 1e-2 unless ``--lr``, 5 steps, warm-up 5; hymba-1.5b as published, or
``--arch`` at ``--layers``), under SINGLE_CARD (full remat, f32 gradients).
Runs:
 1. f32 on both routes (kernel route takes the scalar f32 kernels);
 2. bf16 with the attention/scan forwards and backwards swapped between the
    kernels and their plain versions (flash_attention_ref, mamba_scan_ref,
    flash_attention_bwd_ref, mamba_scan_bwd_ref: f32 math);
 3. at step 3 of the bf16 kernel run, the gradients of that state and batch
    by the kernel route, the plain route and the all-reference swap, leaf by
    leaf (held on the host, so that three gradient trees of gemma3-4b fit
    beside its state); the same in f32.
Prints one JSON line per run, and appends it to build/train_spike_probe.jsonl.
The swaps live in this script only: it replaces the four wrappers on
``repro_torch.kernels.ops`` for the duration of a run.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, launches, ops, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import (FlashAttention,  # noqa: E402
                                                     flash_attention_bwd_ref)
from repro_torch.kernels.mamba_scan import (MambaScan, mamba_scan_bwd_ref,  # noqa: E402
                                            mamba_scan_ref)
from repro_torch.launch.train import batch_to  # noqa: E402
from repro_torch.models.transformer import _leaves  # noqa: E402
from repro_torch.sharding.plans import SINGLE_CARD  # noqa: E402
from repro_torch.train import (AdamConfig, DataConfig, TokenPipeline,  # noqa: E402
                               init_train_state, make_grad_fn, make_train_step)

OUT = Path(__file__).resolve().parents[1] / "build" / "train_spike_probe.jsonl"
_ap = argparse.ArgumentParser()
_ap.add_argument("runs", nargs="*", help="run names (default: all)")
_ap.add_argument("--cpu", action="store_true")
_ap.add_argument("--arch", default="hymba-1.5b")
_ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: published)")
_ap.add_argument("--lr", type=float, default=1e-2)
ARGS = _ap.parse_args()
STEPS, BATCH, SEQ, LR = 5, 4, 2048, ARGS.lr
CPU = ARGS.cpu
DEV = torch.device("cpu") if CPU else torch.device("cuda", 0)
if CPU:
    SEQ, BATCH = 40, 2
REAL = {k: getattr(ops, k) for k in ("flash_attention", "flash_attention_bwd",
                                     "mamba_scan", "mamba_scan_bwd")}


def sync():
    if not CPU:
        torch.cuda.synchronize()


def emit(**kw):
    line = json.dumps(kw, default=float)
    print(line, flush=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


def plain_fa(q, k, v, *, causal=True, window=None, q_offset=0, max_offset=None,
             return_lse=False):
    if ops._wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return flash_attention_ref(q, k, v, causal, window, q_offset, return_lse)


def plain_scan(dA, dBx, C, *, checkpoints=False):
    if ops._wants_grad(dA, dBx, C):
        return MambaScan.apply(dA, dBx, C)
    return mamba_scan_ref(dA, dBx, C, checkpoints)


def plain_fa_bwd(q, k, v, o, lse, do, *, causal=True, window=None, q_offset=0):
    return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window, q_offset)


def plain_scan_bwd(dA, dBx, C, dy, dh=None, *, checkpoints=None):
    return mamba_scan_bwd_ref(dA, dBx, C, dy, dh, checkpoints)


def swap(fwd: str, bwd: str):
    """Install the forward ('K' kernel, 'R' plain f32 reference) and the
    backward on ops (the kernel route's autograd Functions look them up
    there)."""
    ops.flash_attention = REAL["flash_attention"] if fwd == "K" else plain_fa
    ops.mamba_scan = REAL["mamba_scan"] if fwd == "K" else plain_scan
    ops.flash_attention_bwd = REAL["flash_attention_bwd"] if bwd == "K" else plain_fa_bwd
    ops.mamba_scan_bwd = REAL["mamba_scan_bwd"] if bwd == "K" else plain_scan_bwd


def cfg_of(dtype):
    cfg = get_config(ARGS.arch)
    if ARGS.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=ARGS.layers)
    if CPU:
        cfg = dataclasses.replace(cfg.reduced(), n_layers=2)
    return dataclasses.replace(cfg, dtype=dtype)


def leaf_errs(got, want):
    return {"/".join(p): ((a.float() - b.float()).abs().max()
                          / b.float().abs().max().clamp_min(1e-30)).item()
            for (p, a), (_, b) in zip(got, want)}


def grads(cfg, dtype, params, batch, impl, route):
    swap(*route)
    try:
        sync()
        t0 = time.perf_counter()
        loss, _aux, g = make_grad_fn(cfg, SINGLE_CARD, compute_dtype=dtype,
                                     impl=impl)(params, batch)
        sync()
        s = time.perf_counter() - t0
        return loss.item(), [(p, t.cpu()) for p, t in _leaves(g)], s
    finally:
        swap("K", "K")


def run(label, dtype, impl="kernel", route=("K", "K"), compare_at=None):
    cfg = cfg_of(dtype)
    opt = AdamConfig(lr=LR, warmup_steps=max(STEPS // 20, 5), total_steps=STEPS)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                    corpus="pattern", seed=0))
    state = init_train_state(cfg, torch.Generator(device=DEV).manual_seed(0))
    losses, norms, secs, comp = [], [], [], None
    reset_launches()
    t_run = time.perf_counter()
    for step in range(STEPS):
        batch = batch_to(next(pipe), DEV)
        if step == compare_at:
            params = state["params"]
            res = {r: grads(cfg, dtype, params, batch, i, rt)
                   for r, (i, rt) in {"kernel": ("kernel", ("K", "K")),
                                      "plain": ("plain", ("K", "K")),
                                      "ref_fwd_ref_bwd": ("kernel", ("R", "R"))}.items()}
            gn = {r: torch.sqrt(sum((g.float() ** 2).sum() for _, g in v[1])).item()
                  for r, v in res.items()}
            comp = {"step": step, "loss": {r: v[0] for r, v in res.items()},
                    "grad_norm": gn, "s": {r: v[2] for r, v in res.items()}}
            for a, b in (("kernel", "plain"), ("kernel", "ref_fwd_ref_bwd"),
                         ("ref_fwd_ref_bwd", "plain")):
                e = leaf_errs(res[a][1], res[b][1])
                worst = max(e, key=e.get)
                comp[f"{a}_vs_{b}"] = {"worst_leaf": worst, "worst": e[worst], "per_leaf": e}
            del res
        swap(*route)
        try:
            step_fn = make_train_step(cfg, SINGLE_CARD, opt, compute_dtype=dtype, impl=impl)
            sync()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
        finally:
            swap("K", "K")
        print(f"# {label} step {step} loss {losses[-1]:.4f} gnorm {norms[-1]:.2f} "
              f"{secs[-1]:.1f}s", file=sys.stderr, flush=True)
    emit(run=label, arch=cfg.name, n_layers=cfg.n_layers, lr=LR, dtype=dtype, impl=impl,
         fwd=route[0], bwd=route[1], loss=losses,
         grad_norm=norms, s=secs, launches=dict(launches),
         total_s=time.perf_counter() - t_run, compare=comp,
         peak_gb=0 if CPU else torch.cuda.max_memory_allocated(DEV) / 1e9)
    del state
    if not CPU:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(DEV)


def main():
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text("")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = "" if CPU else subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(run="device", nvidia_smi=smi.strip(), torch=torch.__version__)
    t0 = time.perf_counter()
    if not CPU:
        build.build(["flash_attention", "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd"])
    emit(run="build", s=time.perf_counter() - t0)
    only = set(ARGS.runs)

    def want(name):
        return not only or name in only

    if want("bf16_KK"):   # the spike as chip_smoke.py shows it; step-3 gradients
        run("bf16_kernel", "bfloat16", compare_at=3)
    if want("f32_KK"):
        run("f32_kernel", "float32", compare_at=3)
    if want("f32_plain"):
        run("f32_plain", "float32", impl="plain")
    for fwd, bwd in (("K", "R"), ("R", "K"), ("R", "R")):
        if want(f"bf16_{fwd}{bwd}"):
            run(f"bf16_fwd{fwd}_bwd{bwd}", "bfloat16", route=(fwd, bwd))


if __name__ == "__main__":
    main()
