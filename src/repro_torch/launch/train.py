"""End-to-end training driver (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch hymba-1.5b --device cpu --steps 20
    python -m repro_torch.launch.train --arch hymba-1.5b --full --batch 4 --seq 2048

The model trains on the card unless ``--device cpu`` is given; without
``--full`` it is the reduced configuration (``cfg.reduced()``).  Deterministic
data pipeline (``TokenPipeline``), AdamW with warmup-cosine, f32 master
weights with a bf16 compute cast, remat per layer, checkpoint/restart
(auto-resume from the latest step, exact data-cursor replay) with atomic
publication.  Attention and the SSM scan run forward and backward through
the hand-written kernels (their plain versions on the CPU).  The reference
picks its sharding plan over a jax mesh; the port trains on one card and
takes a ``Plan`` (default: ``remat="full"``, no accumulation).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.backend.torch_backend import resolve_device
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.models.transformer import _tree_map
from repro_torch.sharding.plans import SINGLE_CARD, Plan
from repro_torch.train import (AdamConfig, DataConfig, TokenPipeline, init_train_state,
                               make_train_step)


def batch_to(batch_np, device) -> dict:
    """A pipeline batch (numpy int32) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
            for k, v in batch_np.items()}


def train_loop(
    arch: str,
    steps: int = 100,
    batch: int = 8,
    seq: int = 64,
    reduced: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    lr: float = 1e-2,
    log_every: int = 10,
    seed: int = 0,
    corpus: str = "pattern",
    plan: Optional[Plan] = None,
    schedule_steps: Optional[int] = None,
    log_fn=print,
    *,
    device=None,
    impl: str = "kernel",
    on_step: Optional[Callable[[int, dict], None]] = None,
):
    """Train ``arch`` for ``steps`` steps; returns (state, loss history).

    ``device`` None means the card (and raises where there is none).
    ``impl`` is the route of attention and the scan ("kernel" or "plain").
    ``on_step(step, metrics)`` is called after each step, once its loss has
    reached the host, with float metrics (loss, grad_norm, lr) and the
    step's wall seconds."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    plan = plan or SINGLE_CARD
    sched = schedule_steps or steps
    opt_cfg = AdamConfig(lr=lr, warmup_steps=max(sched // 20, 5), total_steps=sched)
    step_fn = make_train_step(cfg, plan, opt_cfg, impl=impl)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                          corpus=corpus, seed=seed)

    start_step = 0
    state = None
    pipe = TokenPipeline(data_cfg)
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        raw, meta = restore(ckpt_dir)
        state = _tree_map(lambda a: torch.from_numpy(a).to(dev), raw)
        start_step = int(meta["step"])
        pipe = TokenPipeline.restore(data_cfg, meta["data"])
        log_fn(f"[resume] step {start_step} from {ckpt_dir}")
    if state is None:
        state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(seed))

    history = []
    t0 = time.time()
    for step in range(start_step, steps):
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch_to(next(pipe), dev))
        loss = float(metrics["loss"])  # waits for the step
        history.append(loss)
        if on_step is not None:
            on_step(step, {"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                           "lr": float(metrics["lr"]),
                           "s": time.perf_counter() - t_step})
        if step % log_every == 0 or step == steps - 1:
            tok_s = (batch * seq * (step - start_step + 1)) / max(time.time() - t0, 1e-9)
            log_fn(f"[step {step:5d}] loss={loss:.4f} "
                   f"gnorm={float(metrics['grad_norm']):.3f} "
                   f"lr={float(metrics['lr']):.2e} tok/s={tok_s:,.0f}")
        if ckpt_dir and ((step + 1) % ckpt_every == 0 or step == steps - 1):
            save(ckpt_dir, step + 1, state, meta={"data": pipe.state(),
                                                  "arch": arch, "loss": loss})
    return state, history


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true", help="full (not reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", default="pattern", choices=["pattern", "random"])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    train_loop(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=not args.full, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, lr=args.lr, seed=args.seed,
        corpus=args.corpus, device=args.device,
    )


if __name__ == "__main__":
    main()
