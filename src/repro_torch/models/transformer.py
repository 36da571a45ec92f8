"""The LM of the zoo (counterpart of ``repro.models.transformer``):
decoder-only dense and hybrid stacks, for training and serving.

Parameters are a nested dict of tensors in the reference's layout: layer
leaves are stacked with a leading L dimension, and the stack is a Python
loop over layers (the reference's ``lax.scan``), so each layer's attention
gets its own window: ``cfg.window`` on local layers, none on global ones.

Three entry points share all code paths:
    forward(params, batch, cfg, remat)       -> logits, aux  [training]
    prefill(params, batch, cfg, max_len)     -> logits, cache
    decode_step(params, tokens, cache, cfg)  -> logits, cache
Each runs where its parameters lie (``init_params`` puts them on the
device of the generator it is given).  ``impl`` picks the route of
attention and of the scan (see ``layers.py``); ``"kernel"`` is the default,
and autograd runs through its kernels' backward kernels.  ``forward`` is
differentiable, with the reference's remat policies per layer; ``prefill``
and ``decode_step`` run without autograd.  Decoding updates the cache
tensors in place and returns the cache with its position advanced; the
position is a host int that the whole batch shares.  MoE and
encoder-decoder wait for later slices and raise ``NotImplementedError``
naming their ROADMAP items.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint as torch_checkpoint

from .config import ModelConfig
from .layers import CausalMask, apply_norm, attention_block, mlp_block, softcap_logits
from .partitioning import constrain
from .ssm import ssm_block

_MOE = "MoE layers are not ported yet: ROADMAP Queue 1 item 6 (the MoE configs)"
_ENCDEC = ("encoder-decoder models are not ported yet: ROADMAP Queue 1 item 6 "
           "(whisper-small)")
REMATS = ("none", "dots", "full")

# ---------------------------------------------------------------------------
# Parameter shapes / init
# ---------------------------------------------------------------------------


def _norm_shape(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": (d,)}
    return {"scale": (d,), "bias": (d,)}


def _attn_shapes(cfg) -> Dict[str, tuple]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd), "wo": (H * hd, D)}
    if cfg.attn_bias:
        s.update({"bq": (H * hd,), "bk": (KV * hd,), "bv": (KV * hd,)})
    if cfg.qk_norm:
        s.update({"q_norm": (hd,), "k_norm": (hd,)})
    return s


def _mlp_shapes(cfg, d_ff=None) -> Dict[str, tuple]:
    F = d_ff or cfg.d_ff
    D = cfg.d_model
    s = {"w_up": (D, F), "w_down": (F, D)}
    if cfg.gated_mlp:
        s["w_gate"] = (D, F)
    return s


def _moe_shapes(cfg) -> Dict[str, tuple]:
    e = cfg.moe
    D, F, E = cfg.d_model, e.d_ff_expert, e.num_experts
    s = {"router": (D, E), "w_up": (E, D, F), "w_down": (E, F, D)}
    if cfg.gated_mlp:
        s["w_gate"] = (E, D, F)
    return s


def _ssm_shapes(cfg) -> Dict[str, tuple]:
    s = cfg.ssm
    D = cfg.d_model
    DI = s.d_inner(D)
    N, R = s.d_state, s.resolved_dt_rank(D)
    return {
        "in_proj": (D, 2 * DI),
        "conv_w": (s.d_conv, DI),
        "conv_b": (DI,),
        "x_proj": (DI, R + 2 * N),
        "dt_proj": (R, DI),
        "dt_bias": (DI,),
        "A_log": (DI, N),
        "D": (DI,),
        "out_proj": (DI, D),
    }


def decoder_layer_shapes(cfg) -> Dict[str, Any]:
    s: Dict[str, Any] = {"norm1": _norm_shape(cfg)}
    if not cfg.attention_free:
        s["attn"] = _attn_shapes(cfg)
    if cfg.ssm is not None:
        s["ssm"] = _ssm_shapes(cfg)
    if cfg.moe is not None:
        s["moe"] = _moe_shapes(cfg)
        s["norm2"] = _norm_shape(cfg)
    elif cfg.d_ff:
        s["mlp"] = _mlp_shapes(cfg)
        s["norm2"] = _norm_shape(cfg)
    if cfg.encdec:  # decoder gains cross-attention
        s["cross"] = _attn_shapes(cfg)
        s["norm_cross"] = _norm_shape(cfg)
    return s


def encoder_layer_shapes(cfg) -> Dict[str, Any]:
    return {
        "norm1": _norm_shape(cfg),
        "attn": _attn_shapes(cfg),
        "norm2": _norm_shape(cfg),
        "mlp": _mlp_shapes(cfg),
    }


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted key order (the reference's flatten order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab
    tree: Dict[str, Any] = {
        "embed": (V, D),
        "final_norm": _norm_shape(cfg),
        "layers": _tree_map(lambda s: (cfg.n_layers,) + s, decoder_layer_shapes(cfg)),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (V, D)
    if cfg.learned_pos:
        tree["pos_embed"] = (cfg.max_seq_len, D)
    if cfg.encdec:
        tree["encoder"] = {
            "layers": _tree_map(lambda s: (cfg.n_enc_layers,) + s,
                                encoder_layer_shapes(cfg)),
            "final_norm": _norm_shape(cfg),
        }
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: Optional[str] = None) -> Dict[str, Any]:
    """Random parameters on the generator's device, by the reference's
    scheme: 1-D leaves zero, every other leaf N(0, 1) / sqrt(shape[-2]) drawn
    in f32 (stacked layer leaves included, so stacked norm scales are
    random); SSM A_log = log(1..N), D = 1, dt_bias = -4.6.  The numbers
    differ from the reference's (another generator); carry the reference's
    weights with ``interop.params_from_jax`` to compare like with like."""
    dt = getattr(torch, dtype or cfg.dtype)
    dev = generator.device
    params: Dict[str, Any] = {}
    for path, shape in _leaves(param_shapes(cfg)):
        if len(shape) == 1:
            leaf = torch.zeros(shape, dtype=dt, device=dev)
        else:
            leaf = (torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
                    / math.sqrt(shape[-2])).to(dt)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    if cfg.ssm is not None:
        ssm = params["layers"]["ssm"]
        N = cfg.ssm.d_state
        A = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev))
        ssm["A_log"] = A.expand(ssm["A_log"].shape).to(dt).contiguous()
        ssm["D"] = torch.ones_like(ssm["D"])
        ssm["dt_bias"] = torch.full_like(ssm["dt_bias"], -4.6)
    return params


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _mix(cfg, lp, x, positions, mask, cache, cache_pos, impl):
    """Token-mixing sublayer: attention / SSM / both in parallel (hymba)."""
    h = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    outs = []
    new_cache: Dict[str, Any] = {}
    if not cfg.attention_free:
        kv_cache = None
        if cache is not None:
            kv_cache = {"k": cache["k"], "v": cache["v"], "pos": cache_pos}
        a_out, a_cache = attention_block(lp["attn"], h, cfg, positions, mask, kv_cache,
                                         impl=impl)
        outs.append(a_out)
        if a_cache is not None:
            new_cache.update({"k": a_cache["k"], "v": a_cache["v"]})
    if cfg.ssm is not None:
        s_cache = None
        if cache is not None:
            s_cache = {"conv": cache["conv"], "ssm": cache["ssm"]}
        s_out, s_cache_new = ssm_block(lp["ssm"], h, cfg, s_cache, impl)
        outs.append(s_out)
        if s_cache_new is not None:
            new_cache.update(s_cache_new)
    mixed = outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1])
    return x + mixed, (new_cache if cache is not None else None)


def _channel(cfg, lp, x):
    """Channel-mixing sublayer: dense MLP (MoE, the one source of an aux
    loss, waits for its slice)."""
    if cfg.moe is not None:
        raise NotImplementedError(_MOE)
    if cfg.d_ff:
        h = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
        return x + mlp_block(lp["mlp"], h, cfg)
    return x


def decoder_layer(cfg, lp, x, positions, mask, cache, cache_pos, impl="kernel"):
    if cfg.encdec:
        raise NotImplementedError(_ENCDEC)
    x, new_cache = _mix(cfg, lp, x, positions, mask, cache, cache_pos, impl)
    return _channel(cfg, lp, x), new_cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _dots_saveable():
    """The reference's ``dots_with_no_batch_dims_saveable`` policy as torch's
    selective checkpoint: the outputs of plain matrix products (``x @ W``,
    aten.mm/addmm) are saved, everything else is recomputed."""
    policy_enum = torch_checkpoint.CheckpointPolicy
    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return policy_enum.MUST_SAVE if op in saved else policy_enum.PREFER_RECOMPUTE

    return functools.partial(torch_checkpoint.create_selective_checkpoint_contexts, policy)


def decoder_stack(cfg, layers, x, positions, mask: Optional[CausalMask], caches,
                  cache_pos, impl="kernel", remat: str = "none"):
    """Apply every layer in turn.  ``mask`` is the global layers' mask; a
    local layer takes it with ``cfg.window``.  Each layer's new cache state
    is written into the stacked ``caches`` in place.  ``remat`` ("none",
    "dots", "full") checkpoints each layer for the backward, as the
    reference's ``jax.checkpoint`` of its scan body does; it needs
    ``caches`` None.

    The stacked (L, ...) leaves are split once with ``unbind``: indexing
    ``t[i]`` per layer would make every layer's backward allocate a zero
    tensor the size of the whole stacked leaf."""
    if remat not in REMATS:
        raise ValueError(f"decoder_stack: remat must be one of {REMATS}, got {remat!r}")
    if remat != "none" and caches is not None:
        raise ValueError("decoder_stack: remat is for training; the serving caches "
                         "are written in place")
    context_fn = _dots_saveable() if remat == "dots" else None
    per_layer = _tree_map(lambda t: t.unbind(0), layers)
    for i in range(cfg.n_layers):
        lp = _tree_map(lambda parts: parts[i], per_layer)
        layer_mask = mask
        if mask is not None and cfg.is_local_layer(i):
            layer_mask = dataclasses.replace(mask, window=cfg.window)
        if remat != "none":
            def run(x_in, lp_in, layer_mask=layer_mask):
                return decoder_layer(cfg, lp_in, x_in, positions, layer_mask, None, None,
                                     impl)[0]

            kw = {} if context_fn is None else {"context_fn": context_fn}
            x = torch_checkpoint.checkpoint(run, x, lp, use_reentrant=False, **kw)
            continue
        cache_l = None if caches is None else {k: t[i] for k, t in caches.items()}
        x, new_cache = decoder_layer(cfg, lp, x, positions, layer_mask, cache_l,
                                     cache_pos, impl)
        if caches is not None:
            for k in ("conv", "ssm"):  # k and v were written in place
                if k in new_cache:
                    caches[k][i].copy_(new_cache[k])
    return x, caches


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _embed_inputs(cfg, params, batch):
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = params["embed"][batch["tokens"]]
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    if cfg.learned_pos:
        S = x.shape[1]
        off = batch.get("pos_offset", 0)
        x = x + params["pos_embed"][off:off + S][None]
    return constrain(x.to(getattr(torch, cfg.dtype)), "batch", "seq", "embed")


def _lm_logits(cfg, params, x):
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = constrain(x @ head.T, "batch", "seq", "vocab")
    return softcap_logits(logits, cfg.logit_softcap)


def _make_caches(cfg, B, max_len, dtype, device):
    L = cfg.n_layers
    per: Dict[str, Any] = {}
    if not cfg.attention_free:
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        # keys are written at their absolute positions, so the cache holds
        # max_len of them on every model.  (The reference bounds a
        # sliding-window-only model's cache at the window and then overflows
        # it past that many tokens: ROADMAP Queue 3 (f).)
        per["k"] = torch.zeros((L, B, max_len, KV, hd), dtype=dtype, device=device)
        per["v"] = torch.zeros((L, B, max_len, KV, hd), dtype=dtype, device=device)
    if cfg.ssm is not None:
        s = cfg.ssm
        DI = s.d_inner(cfg.d_model)
        per["conv"] = torch.zeros((L, B, s.d_conv - 1, DI), dtype=dtype, device=device)
        per["ssm"] = torch.zeros((L, B, DI, s.d_state), dtype=torch.float32, device=device)
    return per


def _positions(B, S, offset, device):
    return torch.arange(offset, offset + S, device=device).expand(B, S)


def forward(params, batch, cfg: ModelConfig, remat: str = "none", impl: str = "kernel"):
    """Training forward: full-sequence logits (+ the MoE aux loss, 0 here).
    Differentiable; ``remat`` checkpoints each layer (see
    ``decoder_stack``)."""
    if cfg.encdec:
        raise NotImplementedError(_ENCDEC)
    x = _embed_inputs(cfg, params, batch)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None and cfg.rope != "none":
        positions = _positions(B, S, 0, x.device)
    x, _ = decoder_stack(cfg, params["layers"], x, positions, CausalMask(S, S), None,
                         None, impl, remat)
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _lm_logits(cfg, params, x), torch.zeros((), device=x.device)


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, max_len: int, impl: str = "kernel"):
    """Process the prompt, returning last-position logits + serving cache."""
    if cfg.encdec:
        raise NotImplementedError(_ENCDEC)
    x = _embed_inputs(cfg, params, batch)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None and cfg.rope != "none":
        positions = _positions(B, S, 0, x.device)
    caches = _make_caches(cfg, B, max_len, getattr(torch, cfg.dtype), x.device)
    S_kv = caches["k"].shape[2] if "k" in caches else S
    x, caches = decoder_stack(cfg, params["layers"], x, positions, CausalMask(S, S_kv),
                              caches, 0, impl)
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = _lm_logits(cfg, params, x[:, -1:])
    return logits, {"layers": caches, "pos": S}


def _host_pos(pos) -> int:
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1:
            raise NotImplementedError(
                "per-row decode positions (continuous batching) need a per-row query "
                "offset in the attention kernel: ROADMAP Queue 1 item 6 "
                "(serve/batcher.py)")
        pos = pos.item()
    return int(pos)


@torch.no_grad()
def decode_step(params, tokens, cache, cfg: ModelConfig, impl: str = "kernel"):
    """One serving step: tokens (B, 1) -> logits (B, 1, V), updated cache."""
    if cfg.encdec:
        raise NotImplementedError(_ENCDEC)
    pos = _host_pos(cache["pos"])
    key = "embeds" if tokens.is_floating_point() else "tokens"
    x = _embed_inputs(cfg, params, {key: tokens, "pos_offset": pos})
    B = x.shape[0]
    positions = _positions(B, 1, pos, x.device)
    layers_cache = cache["layers"]
    mask = None
    if "k" in layers_cache:
        mask = CausalMask(1, layers_cache["k"].shape[2], q_offset=pos)
    x, layers_cache = decoder_stack(cfg, params["layers"], x, positions, mask,
                                    layers_cache, pos, impl)
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = _lm_logits(cfg, params, x)
    return logits, {"layers": layers_cache, "pos": pos + 1}
