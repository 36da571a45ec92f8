"""Batched serving driver (counterpart of ``repro.launch.serve``): prefill a
batch of prompts, then greedy-decode.

    python -m repro_torch.launch.serve --device cpu           # reduced hymba-1.5b
    python -m repro_torch.launch.serve --arch gemma3-4b --device cpu
    python -m repro_torch.launch.serve --full --batch 8 --prompt-len 2048 --gen 32

The model runs on the card unless ``--device cpu`` is given.  Attention and
the prefill scan go through the hand-written kernels (their plain versions
on the CPU).  ``--full`` serves the published configuration; without it the
reduced one (``cfg.reduced()``).  Weights are random, from a seeded
``torch.Generator`` on the device; prompts come from numpy with the same
seed, as in the reference's ``launch/serve.py``: token ids, or for a model
that takes embeddings (``cfg.embed_inputs``, qwen2-vl-7b's stub vision
frontend) standard-normal (batch, prompt_len, d_model) embeddings, or for
an encoder-decoder (whisper-small) standard-normal (batch, 16, d_model)
frames for its stub audio frontend, then token ids.  Decoding feeds token
ids either way.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.backend.torch_backend import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import ModelConfig, decode_step, init_params, param_shapes
from repro_torch.models.transformer import _leaves
from repro_torch.train import make_prefill

#: frames an encoder-decoder's prompts carry (the reference driver's)
ENC_FRAMES = 16


def make_prompts(cfg, batch: int, prompt_len: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The prefill batch from numpy, as the reference's ``launch/serve.py``
    draws it: for an encoder-decoder, ``{"frames": (batch, 16, d_model)
    float64}`` standard normal and then ``{"tokens": (batch, prompt_len)}``
    ids from the same generator; ``{"embeds": (batch, prompt_len, d_model)
    float64}`` standard normal for a model that takes embeddings; else the
    ids alone."""
    rng = np.random.default_rng(seed)
    if cfg.encdec:
        frames = rng.standard_normal((batch, ENC_FRAMES, cfg.d_model))
        return {"frames": frames,
                "tokens": rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int64)}
    if cfg.embed_inputs:
        return {"embeds": rng.standard_normal((batch, prompt_len, cfg.d_model))}
    return {"tokens": rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int64)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_demo(cfg: ModelConfig, batch: int = 4, prompt_len: int = 16, gen: int = 16,
               seed: int = 0, log_fn=print, *, device=None,
               params: Optional[Dict[str, Any]] = None, impl: str = "kernel",
               forced: Optional[np.ndarray] = None,
               record: Optional[Dict[str, Any]] = None,
               dispatch_mode: str = "einsum") -> np.ndarray:
    """Serve one batch of model ``cfg``: prefill ``prompt_len`` tokens, then
    ``gen - 1`` greedy decode steps; returns the (batch, gen) generated
    tokens.

    ``device`` None means the card.  ``params`` are carried-in weights (e.g.
    ``interop.params_from_jax``) in place of random ones.  ``impl`` is the
    route of attention and the scan (``"kernel"`` or ``"plain"``).
    ``forced`` (batch, gen) tokens are fed back in place of the greedy ones
    (teacher forcing: the returned tokens are still the greedy picks).
    ``record``, when given, receives the timings and every step's logits.
    ``dispatch_mode`` is an MoE model's ("einsum" or "gather")."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    want = dict(_leaves(param_shapes(cfg)))
    got = {path: tuple(t.shape) for path, t in _leaves(params)}
    if got != want:
        raise ValueError(f"serve_demo: params do not fit {cfg.name} "
                         f"({cfg.n_layers} layers)")
    if forced is not None and tuple(forced.shape) != (batch, gen):
        raise ValueError(f"serve_demo: forced tokens {tuple(forced.shape)} are not "
                         f"(batch, gen) = {(batch, gen)}")
    max_len = prompt_len + gen + 1
    prefill_fn = make_prefill(cfg, max_len=max_len, impl=impl, dispatch_mode=dispatch_mode)
    prompts = {k: torch.from_numpy(v).to(dev, torch.int64 if k == "tokens"
                                         else getattr(torch, cfg.dtype))
               for k, v in make_prompts(cfg, batch, prompt_len, seed).items()}
    forced_t = None if forced is None else torch.from_numpy(
        np.asarray(forced, np.int64)).to(dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, prompts)
    steps = [logits[:, -1]]
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(gen - 1):
        tok = torch.argmax(steps[-1], dim=-1)[:, None]
        if forced_t is not None:
            tok = forced_t[:, i:i + 1]
        logits, cache = decode_step(params, tok, cache, cfg, impl=impl,
                                    dispatch_mode=dispatch_mode)
        steps.append(logits[:, -1])
    seqs = torch.stack([torch.argmax(s, dim=-1) for s in steps], dim=1)
    _sync(dev)
    t2 = time.perf_counter()
    dt = t2 - t0
    log_fn(f"[serve] {cfg.name}: batch={batch} prompt={prompt_len} gen={gen} "
           f"in {dt:.2f}s ({batch * gen / dt:.1f} tok/s)")
    if record is not None:
        record.update(device=dev, prefill_s=t1 - t0, decode_s=t2 - t1,
                      decode_s_per_token=(t2 - t1) / max(gen - 1, 1),
                      tokens_per_s=batch * gen / dt, max_len=max_len,
                      logits=torch.stack(steps).float().cpu().numpy())
    return seqs.cpu().numpy()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    serve_demo(cfg if args.full else cfg.reduced(), args.batch, args.prompt_len, args.gen,
               seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
