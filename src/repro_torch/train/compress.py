"""Gradient compression (counterpart of ``repro.train.compress``).

Two levels for cross-pod gradient reduction:
  * bf16 cast (``plan.grad_dtype="bfloat16"``) — halves all-reduce bytes;
    used by the ``*_bf16g`` plans.
  * int8 stochastic rounding — 4x compression for the slow hop between pods
    of a hierarchical all-reduce: reduce-scatter in bf16 within a pod,
    quantize the pod-local partials to int8 for the exchange across pods,
    dequantize, all-gather.  Stochastic rounding keeps E[q(x)] = x, so
    SGD's unbiasedness is preserved.

The random draws come from an explicit ``torch.Generator`` (the reference
takes a jax key); ``compress_tree`` draws each leaf's after the previous
one's, in the tree's sorted key order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.transformer import _leaves


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor-scaled int8 with stochastic rounding; returns (q, scale),
    scale an f32 scalar (max|x| / 127, or 1 for an all-zero x)."""
    amax = torch.max(torch.abs(x)).to(torch.float32)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    y = x.to(torch.float32) / scale
    lo = torch.floor(y)
    p_up = y - lo
    up = torch.rand(x.shape, generator=generator, device=x.device) < p_up
    q = torch.clamp(lo + up.to(torch.float32), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _rebuild(tree, by_path, prefix=()):
    """``tree``'s structure with each leaf replaced by ``by_path[its path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, prefix + (k,)) for k, v in tree.items()}
    return by_path[prefix]


def compress_tree(grads, generator: torch.Generator):
    """Quantize every leaf; returns (int8 tree, scale tree)."""
    out = {path: quantize_int8(g, generator) for path, g in _leaves(grads)}
    return (_rebuild(grads, {p: q for p, (q, _) in out.items()}),
            _rebuild(grads, {p: s for p, (_, s) in out.items()}))


def decompress_tree(qs, scales, dtype: torch.dtype = torch.float32):
    scale_of = dict(_leaves(scales))
    return _rebuild(qs, {p: dequantize_int8(q, scale_of[p], dtype) for p, q in _leaves(qs)})
