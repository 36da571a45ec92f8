"""Step builders (counterpart of ``repro.train.steps``): the train step and
the serving steps.

``make_train_step`` returns a (state, batch) -> (state, metrics) function:
f32 master parameters cast to the compute dtype inside the step, the
forward with the plan's remat policy, the loss's gradient by autograd
(through the attention and scan kernels' backward kernels on the kernel
route), optional accumulation over ``plan.accum_steps`` microbatches, the
optional bf16 gradients (``plan.grad_dtype``), and an AdamW update, in
place.  The forward takes the plan's MoE ``dispatch_mode``; the serving
builders have no plan: ``dispatch_mode`` is their keyword.

``rules`` (``sharding.activation_rules``) shard the step: the state is then
a tree of DTensors (``sharding.shard_tree``) and the batch DTensors split
over the plan's batch axes; the model's ``constrain`` calls redistribute
activations, the attention and scan kernels run on each rank's local
shards, and each gradient comes back with its parameter's placements.  The
loss returned is a plain tensor, the same on every rank.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import decode_step, forward, init_params, prefill, use_rules
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _leaves, _tree_map
from repro_torch.sharding.plans import Plan

from .optim import AdamConfig, adam_update, init_opt_state


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    return nll.mean()


def _unflatten(paths, leaves) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def make_grad_fn(cfg: ModelConfig, plan: Plan, rules=None,
                 compute_dtype: str = "bfloat16", impl: str = "kernel"):
    """(params, batch) -> (loss, aux, grads): the loss of one batch and its
    gradient with respect to every parameter leaf (a tree like ``params``).

    Leaves are cast to the compute dtype inside; where the model's
    activation dtype (``cfg.dtype``) is wider, they are then widened to it,
    as jax's type promotion does where the reference's f32 activations meet
    its bf16 weights.

    bf16 gradients (``plan.grad_dtype``, the reference's compressed
    all-reduce) under a bf16 compute dtype are taken with respect to the
    bf16 compute copy: each is born in bf16, the same bits as the f32
    gradient cast to bf16 (the cast's backward rounds it there first), and
    no f32 gradient tree is built.  Otherwise the gradient is the f32
    masters', cast afterwards where the plan asks for bf16."""
    cast = getattr(torch, compute_dtype)
    wide = torch.promote_types(cast, getattr(torch, cfg.dtype))
    born_bf16 = plan.grad_dtype == "bfloat16" and cast == torch.bfloat16

    def grad_fn(params, batch):
        paths, masters = zip(*_leaves(params))
        leaves = [(p.detach().to(cast) if born_bf16 else p.detach()).requires_grad_()
                  for p in masters]
        with torch.enable_grad(), use_rules(rules):
            cparams = _tree_map(lambda p: p.to(cast).to(wide), _unflatten(paths, leaves))
            logits, aux = forward(cparams, batch, cfg, remat=plan.remat, impl=impl,
                                  dispatch_mode=plan.dispatch_mode)
            loss = cross_entropy(logits, batch["labels"]) + aux
            if isinstance(loss, DTensor):  # one value on every rank
                loss = loss.full_tensor()
            if isinstance(aux, DTensor):
                aux = aux.full_tensor()
            del cparams, logits
            grads = [_like(g, p) for g, p in zip(torch.autograd.grad(loss, leaves), leaves)]
        if plan.grad_dtype == "bfloat16" and not born_bf16:
            grads = [g.to(torch.bfloat16) for g in grads]
        return loss.detach(), aux.detach(), _unflatten(paths, grads)

    return grad_fn


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient with its parameter's placements (the optimizer updates
    each shard in place)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, plan: Plan, opt_cfg: AdamConfig, rules=None,
                    compute_dtype: str = "bfloat16", impl: str = "kernel"):
    """One train step: (state, batch) -> (state, metrics).  ``state`` is
    ``{"params", "opt"}`` (``init_train_state``), updated in place and
    returned; ``batch`` holds "tokens" and "labels" (B, S) tensors on the
    state's device (and an encoder-decoder's "frames", (B, T, D)).  ``impl`` is the route of attention and the scan
    ("kernel" or "plain")."""
    one_grad = make_grad_fn(cfg, plan, rules, compute_dtype, impl)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        if plan.accum_steps > 1:
            a = plan.accum_steps
            grads = _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(a):
                mb = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                mb_loss, _aux, g = one_grad(params, mb)
                for (_, acc), (_, gl) in zip(_leaves(grads), _leaves(g)):
                    acc.copy_(acc + gl.float() / a)
                loss = loss + mb_loss / a
        else:
            loss, _aux, grads = one_grad(params, batch)
        with use_rules(rules):
            params, opt, metrics = adam_update(opt_cfg, params, grads, opt)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     param_dtype: str = "float32") -> Dict[str, Any]:
    """Random parameters (``init_params`` on the generator's device) and a
    fresh optimizer state."""
    params = init_params(cfg, generator, dtype=param_dtype)
    return {"params": params, "opt": init_opt_state(params)}


def make_serve_step(cfg: ModelConfig, rules=None, impl: str = "kernel",
                    dispatch_mode: str = "einsum"):
    """One decode step: (params, tokens, cache) -> (next_tokens, cache),
    greedy.  Under ``rules`` the parameters, tokens and cache are
    DTensors."""

    def serve_step(params, tokens, cache):
        with use_rules(rules):
            logits, cache = decode_step(params, tokens, cache, cfg, impl=impl,
                                        dispatch_mode=dispatch_mode)
        last = logits[:, -1]
        if isinstance(last, DTensor):  # each row's whole vocabulary on its ranks:
            # DTensor's argmax over a split dim gathers (value, index) pairs,
            # which fails on some meshes
            last = last.redistribute(last.device_mesh, tuple(
                p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in last.placements))
        next_tok = torch.argmax(last, dim=-1)[:, None]
        return next_tok, cache

    return serve_step


def make_prefill(cfg: ModelConfig, max_len: int, rules=None, impl: str = "kernel",
                 dispatch_mode: str = "einsum"):
    def prefill_fn(params, batch):
        with use_rules(rules):
            return prefill(params, batch, cfg, max_len=max_len, impl=impl,
                           dispatch_mode=dispatch_mode)

    return prefill_fn
