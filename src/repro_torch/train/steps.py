"""Serving step builders (counterpart of ``repro.train.steps``
``make_prefill`` / ``make_serve_step``).  The reference's ``Plan`` carries
sharding and remat choices that one card does not need; ``rules`` must be
None until SPMD sharding is ported (ROADMAP Queue 1 item 7).  The train
step and ``cross_entropy`` come with training (ROADMAP Queue 1 item 6)."""
from __future__ import annotations

import torch

from repro_torch.models import decode_step, prefill, use_rules
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, rules=None, impl: str = "kernel"):
    """One decode step: (params, tokens, cache) -> (next_tokens, cache),
    greedy."""

    def serve_step(params, tokens, cache):
        with use_rules(rules):
            logits, cache = decode_step(params, tokens, cache, cfg, impl=impl)
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return next_tok, cache

    return serve_step


def make_prefill(cfg: ModelConfig, max_len: int, rules=None, impl: str = "kernel"):
    def prefill_fn(params, batch):
        with use_rules(rules):
            return prefill(params, batch, cfg, max_len=max_len, impl=impl)

    return prefill_fn
