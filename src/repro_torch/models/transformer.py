"""The LM of the zoo (counterpart of ``repro.models.transformer``):
decoder-only dense and hybrid stacks, and the encoder-decoder
(whisper-small), for training and serving.

Parameters are a nested dict of tensors in the reference's layout: layer
leaves are stacked with a leading L dimension, and the stack is a Python
loop over layers (the reference's ``lax.scan``), so each layer's attention
gets its own window: ``cfg.window`` on local layers, none on global ones.
A config with a layer schedule (``ModelConfig.scheduled``: Jamba's attention
and Mamba layers, MoE and dense MLPs; Granite's attention and Mamba-2 layers)
stacks each part over the layers that have it (``layers["attn"]`` over the
attention layers, ``layers["ssm"]`` over the SSM layers, ...; the norms over
all L), and its serving caches likewise:
keys and values for the attention layers, conv and SSM state for the SSM
layers (``ModelConfig.layer_slots`` maps a layer to its rows).  The SSM
mixer's module, ``models/ssm.py`` (Mamba-1) or ``models/ssd.py`` (Mamba-2),
chosen by the type of the config's ``ssm``, owns its parameter and cache
shapes, its span and its block.

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
position is a host int that the whole batch shares, or a tuple of host ints,
one per row (``serve.ContinuousBatcher``'s slots).  An encoder-decoder
model takes ``batch["frames"]`` (B, T, D), the stub frontend's frames, runs
the encoder over them (attention with no mask) and gives every decoder
layer a cross-attention sublayer over the encoder's output; prefill
projects each layer's cross keys and values once into the cache (``ck``,
``cv``), which decoding reads.  An MoE model's channel sublayer is
``moe.moe_block`` (``dispatch_mode`` and ``capacity_factor`` are keywords
of all three entry points); its load-balancing loss, summed over layers in
f32, is ``forward``'s aux.  ``prefill`` takes ``chunk`` (the prompt in pieces
that each continue the state) and ``caches`` (write into given caches, such
as one slot's views of a batcher's pool); ``prefill`` and ``decode_step``
take ``counters`` (``models.counters.LMCounters``).  While ``torch.profiler``
records, each sublayer opens its span (``repro_torch.lm.*``, ``core/trace.py``).
Granite's multipliers (``ScheduledModelConfig.embedding_multiplier``,
``residual_multiplier``, ``attention_scale``, ``logits_scaling``) apply only
where a config sets them, so every other config runs the ops it ran before.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as torch_checkpoint
from torch.distributed.tensor import distribute_tensor

from ..core.trace import LM_ATTENTION, LM_HEAD, LM_MLP, LM_MOE, maybe_span, profiling
from . import ssd, ssm
from .config import Mamba2Config, ModelConfig, SSMConfig
from .layers import CausalMask, apply_norm, attention_block, mlp_block, softcap_logits
from .moe import moe_block
from .partitioning import constrain, gather_weights, get_rules

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
    shared = getattr(cfg, "shared_d_ff", 0)
    if shared:
        s.update({f"shared_{k}": v for k, v in _mlp_shapes(cfg, shared).items()})
    return s


#: the SSM mixer of each kind of SSM config: the module that owns its
#: parameter and cache shapes, its span and its block
_MIXERS = {SSMConfig: ssm, Mamba2Config: ssd}


def _mixer(cfg):
    return _MIXERS[type(cfg.ssm)]


def _ssm_shapes(cfg) -> Dict[str, tuple]:
    return _mixer(cfg).param_shapes(cfg)


#: a layer's parts, each stacked over the layers that have it under a schedule
_PART_SHAPES = {"attn": _attn_shapes, "ssm": _ssm_shapes, "moe": _moe_shapes,
                "mlp": _mlp_shapes}


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


def _layer_tree_shapes(cfg) -> Dict[str, Any]:
    """Every layer leaf stacked over all L, or under a schedule each part
    over the layers that have it and the norms over all L."""
    L = cfg.n_layers
    if not cfg.scheduled:
        return _tree_map(lambda s: (L,) + s, decoder_layer_shapes(cfg))
    if cfg.encdec:
        raise NotImplementedError("a layer schedule is for decoder-only models")
    tree: Dict[str, Any] = {"norm1": _tree_map(lambda s: (L,) + s, _norm_shape(cfg))}
    if cfg.moe is not None or cfg.d_ff:
        tree["norm2"] = _tree_map(lambda s: (L,) + s, _norm_shape(cfg))
    for kind, shapes in _PART_SHAPES.items():
        n = cfg.layer_count(kind)
        if n:
            tree[kind] = _tree_map(lambda s, n=n: (n,) + s, shapes(cfg))
    return tree


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab
    tree: Dict[str, Any] = {
        "embed": (V, D),
        "final_norm": _norm_shape(cfg),
        "layers": _layer_tree_shapes(cfg),
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
    random); SSM A_log = log(1..N) along its last axis (Mamba-1's state,
    Mamba-2's heads), D = 1, dt_bias = -4.6.  A stacked layer
    leaf (L, ...) is drawn one layer's slice at a time, so the f32 draw
    never holds more than one layer of it (command-r-35b's (40, 8192, 22528)
    MLP leaves would take 29.5 GB each whole).  The numbers differ from the
    reference's (another generator); carry the reference's weights with
    ``interop.params_from_jax`` to compare like with like."""
    dt = getattr(torch, dtype or cfg.dtype)
    dev = generator.device

    def draw(shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
                / math.sqrt(fan_in)).to(dt)

    params: Dict[str, Any] = {}
    for path, shape in _leaves(param_shapes(cfg)):
        if len(shape) == 1:
            leaf = torch.zeros(shape, dtype=dt, device=dev)
        elif "layers" in path:
            leaf = torch.empty(shape, dtype=dt, device=dev)
            for i in range(shape[0]):
                leaf[i] = draw(shape[1:], shape[-2])
        else:
            leaf = draw(shape, shape[-2])
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    if cfg.ssm is not None:
        mixer = params["layers"]["ssm"]
        N = mixer["A_log"].shape[-1]
        A = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev))
        mixer["A_log"] = A.expand(mixer["A_log"].shape).to(dt).contiguous()
        mixer["D"] = torch.ones_like(mixer["D"])
        mixer["dt_bias"] = torch.full_like(mixer["dt_bias"], -4.6)
    return params


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _mix(cfg, lp, x, positions, mask, cache, cache_pos, impl, spans=False):
    """Token-mixing sublayer: attention / SSM / both in parallel (hymba), as
    the layer's parameters hold them."""
    h = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    outs = []
    new_cache: Dict[str, Any] = {}
    if "attn" in lp:
        kv_cache = None
        if cache is not None:
            kv_cache = {"k": cache["k"], "v": cache["v"], "pos": cache_pos}
        with maybe_span(spans, LM_ATTENTION):
            a_out, a_cache = attention_block(lp["attn"], h, cfg, positions, mask, kv_cache,
                                             impl=impl)
        outs.append(a_out)
        if a_cache is not None:
            new_cache.update({"k": a_cache["k"], "v": a_cache["v"]})
    if "ssm" in lp:
        s_cache = None
        if cache is not None:
            s_cache = {"conv": cache["conv"], "ssm": cache["ssm"]}
        mixer = _mixer(cfg)
        with maybe_span(spans, mixer.SPAN):
            s_out, s_cache_new = mixer.block(lp["ssm"], h, cfg, s_cache, impl)
        outs.append(s_out)
        if s_cache_new is not None:
            new_cache.update(s_cache_new)
    mixed = outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1])
    return _residual(cfg, x, mixed), (new_cache if cache is not None else None)


def _residual(cfg, x, out):
    """x + out, the sublayer's output scaled by ``residual_multiplier`` where
    the config sets one (Granite)."""
    scale = getattr(cfg, "residual_multiplier", 1.0)
    if scale != 1.0:
        out = out * scale
    return x + out


def _channel(cfg, lp, x, dispatch_mode, capacity_factor, spans=False, route_tap=None):
    """Channel-mixing sublayer: dense MLP or MoE, as the layer's parameters
    hold them.  Returns the new x and the layer's aux loss (None without
    MoE, its one source)."""
    if "moe" in lp:
        h = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
        with maybe_span(spans, LM_MOE):
            out, aux = moe_block(lp["moe"], h, cfg, capacity_factor, dispatch_mode,
                                 route_tap)
        return _residual(cfg, x, out), aux
    if "mlp" in lp:
        h = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
        with maybe_span(spans, LM_MLP):
            out = mlp_block(lp["mlp"], h, cfg)
        return _residual(cfg, x, out), None
    return x, None


def decoder_layer(cfg, lp, x, positions, mask, cache, cache_pos, impl="kernel",
                  enc_out=None, dispatch_mode="einsum", capacity_factor=1.25,
                  spans=False, route_tap=None):
    """Self-attention and/or SSM, then (encoder-decoder) cross-attention over
    ``enc_out``, or at decode (``enc_out`` None) over the cache's static
    ``ck``, ``cv``, then the MLP or MoE: the parts ``lp`` holds.  Returns
    (x, new cache, aux), aux None without MoE.  Under sharding rules the
    layer's weights are gathered over their FSDP axes first
    (``gather_weights``).  ``spans``: open the sublayers' profiler spans;
    ``route_tap``: the MoE router's tap (``moe.moe_block``)."""
    lp = gather_weights(lp)
    x, new_cache = _mix(cfg, lp, x, positions, mask, cache, cache_pos, impl, spans)
    if cfg.encdec:
        h = apply_norm(x, lp["norm_cross"], cfg.norm, cfg.norm_eps)
        c_cache = None
        if cache is not None and enc_out is None:
            c_cache = {"k": cache["ck"], "v": cache["cv"]}
        c_out, _ = attention_block(lp["cross"], h, cfg, None, None, c_cache, kv_x=enc_out,
                                   cross=True, impl=impl)
        x = x + c_out
    x, aux = _channel(cfg, lp, x, dispatch_mode, capacity_factor, spans, route_tap)
    return x, new_cache, aux


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


#: the cache leaves of each layer part; any other leaf (cross-attention's
#: ``ck``, ``cv``) has a row per layer
_CACHE_PART = {"k": "attn", "v": "attn", "conv": "ssm", "ssm": "ssm"}


def _layer_params(per_layer, slots, i):
    """Layer ``i``'s parameters from the unbound stacked leaves: each part
    its row (``slots``), the norms and any other leaf row ``i``."""
    return {name: _tree_map(lambda parts, j=slots.get(name, i): parts[j], sub)
            for name, sub in per_layer.items()
            if name in slots or name not in _PART_SHAPES}


def _layer_cache(caches, slots, i):
    out = {}
    for name, t in caches.items():
        part = _CACHE_PART.get(name)
        if part is None:
            out[name] = t[i]
        elif part in slots:
            out[name] = t[slots[part]]
    return out


def decoder_stack(cfg, layers, x, positions, mask: Optional[CausalMask], caches,
                  cache_pos, impl="kernel", remat: str = "none", enc_out=None,
                  dispatch_mode="einsum", capacity_factor=1.25, counters=None):
    """Apply every layer in turn; returns (x, caches, aux), aux the layers'
    MoE losses summed in f32 from zero.  ``mask`` is the global layers' mask; a
    local layer takes it with ``cfg.window``.  Each layer's new cache state
    is written into the stacked ``caches`` in place.  ``remat`` ("none",
    "dots", "full") checkpoints each layer for the backward, as the
    reference's ``jax.checkpoint`` of its scan body does; it needs
    ``caches`` None.  ``enc_out`` is the encoder's output that every layer's
    cross-attention reads (encoder-decoder, training and prefill).
    ``counters`` (``LMCounters``) receives each MoE layer's routing.

    The stacked (L, ...) leaves are split once with ``unbind``: indexing
    ``t[i]`` per layer would make every layer's backward allocate a zero
    tensor the size of the whole stacked leaf."""
    if remat not in REMATS:
        raise ValueError(f"decoder_stack: remat must be one of {REMATS}, got {remat!r}")
    if remat != "none" and caches is not None:
        raise ValueError("decoder_stack: remat is for training; the serving caches "
                         "are written in place")
    context_fn = _dots_saveable() if remat == "dots" else None
    moe_kw = dict(dispatch_mode=dispatch_mode, capacity_factor=capacity_factor,
                  spans=profiling())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = _tree_map(lambda t: t.unbind(0), layers)
    for i, slots in enumerate(cfg.layer_slots()):
        lp = _layer_params(per_layer, slots, i)
        layer_mask = mask
        if mask is not None and cfg.is_local_layer(i):
            layer_mask = dataclasses.replace(mask, window=cfg.window)
        if remat != "none":
            def run(x_in, lp_in, enc_in, layer_mask=layer_mask):
                x_out, _, a = decoder_layer(cfg, lp_in, x_in, positions, layer_mask, None,
                                            None, impl, enc_in, **moe_kw)
                return x_out, a

            kw = {} if context_fn is None else {"context_fn": context_fn}
            x, a = torch_checkpoint.checkpoint(run, x, lp, enc_out, use_reentrant=False,
                                               **kw)
        else:
            cache_l = None if caches is None else _layer_cache(caches, slots, i)
            tap = None
            if counters is not None and "moe" in slots:
                tap = functools.partial(counters.routed, slots["moe"])
            x, new_cache, a = decoder_layer(cfg, lp, x, positions, layer_mask, cache_l,
                                            cache_pos, impl, enc_out, route_tap=tap,
                                            **moe_kw)
        if a is not None:
            aux = aux + a
        if caches is not None:
            # k and v were written in place, and so was a decode step's conv
            # and SSM state, which the layer hands back as the cache's own rows
            for k in ("conv", "ssm"):
                if k in new_cache and new_cache[k] is not cache_l[k]:
                    caches[k][slots["ssm"]].copy_(new_cache[k])
    return x, caches, aux


def encoder_stack(cfg, enc_params, frames, remat: str = "none", impl: str = "kernel"):
    """Whisper-style encoder over the stub frontend's frames (B, T, D):
    sinusoidal positions, pre-norm blocks of attention with no mask and an
    MLP, and the final norm.  ``remat`` other than "none" checkpoints each
    block whole (the reference's ``jax.checkpoint`` of its scan body)."""
    if remat not in REMATS:
        raise ValueError(f"encoder_stack: remat must be one of {REMATS}, got {remat!r}")
    x = frames
    T = x.shape[1]
    pos = torch.arange(T, dtype=torch.float32, device=x.device)
    half = cfg.d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos[:, None] * freqs[None]
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None].to(x.dtype)

    def block(xc, lp):
        lp = gather_weights(lp)
        h = apply_norm(xc, lp["norm1"], cfg.norm, cfg.norm_eps)
        xc = xc + attention_block(lp["attn"], h, cfg, None, None, impl=impl)[0]
        h = apply_norm(xc, lp["norm2"], cfg.norm, cfg.norm_eps)
        return xc + mlp_block(lp["mlp"], h, cfg)

    per_layer = _tree_map(lambda t: t.unbind(0), enc_params["layers"])
    for i in range(cfg.n_enc_layers):
        lp = _tree_map(lambda parts: parts[i], per_layer)
        if remat != "none":
            x = torch_checkpoint.checkpoint(block, x, lp, use_reentrant=False)
        else:
            x = block(x, lp)
    return apply_norm(x, enc_params["final_norm"], cfg.norm, cfg.norm_eps)


def _cross_kv(cfg, layers, enc_out):
    """Every decoder layer's cross-attention keys and values over the
    encoder's output, (L, B, T, KV, hd) each, computed once at prefill as
    the reference's ``prefill`` does (with the biases, no norm)."""
    B, T = enc_out.shape[0], enc_out.shape[1]
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cross = gather_weights(layers["cross"])
    ks, vs = [], []
    for i in range(cfg.n_layers):
        k = (enc_out @ cross["wk"][i]).reshape(B, T, KV, hd)
        v = (enc_out @ cross["wv"][i]).reshape(B, T, KV, hd)
        if cfg.attn_bias:
            k = k + cross["bk"][i].reshape(1, 1, KV, hd)
            v = v + cross["bv"][i].reshape(1, 1, KV, hd)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _embed_inputs(cfg, params, batch):
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        # an embedding lookup: the rows indexing gives, but DTensor shards
        # its backward (indexing's, an index_put, fails on some versions)
        x = F.embedding(batch["tokens"], gather_weights(params["embed"]))
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    if getattr(cfg, "embedding_multiplier", 1.0) != 1.0:
        x = x * cfg.embedding_multiplier
    if cfg.learned_pos:
        S = x.shape[1]
        off = batch.get("pos_offset", 0)
        if isinstance(off, torch.Tensor):  # per row: (B,) offsets on the device
            x = x + gather_weights(params["pos_embed"])[off[:, None]
                                                        + torch.arange(S, device=off.device)]
        else:
            x = x + gather_weights(params["pos_embed"])[off:off + S][None]
    return constrain(x.to(getattr(torch, cfg.dtype)), "batch", "seq", "embed")


def _lm_logits(cfg, params, x):
    head = gather_weights(params["embed"] if cfg.tie_embeddings else params["lm_head"])
    logits = constrain(x @ head.T, "batch", "seq", "vocab")
    if getattr(cfg, "logits_scaling", 1.0) != 1.0:
        logits = logits / cfg.logits_scaling
    return softcap_logits(logits, cfg.logit_softcap)


def _make_caches(cfg, B, max_len, dtype, device):
    """Zeroed serving caches: keys and values with a row per attention layer,
    conv and SSM state with a row per SSM layer (every layer of a config
    without a schedule); under sharding rules, DTensors split as the rules
    split the batch, the kv heads and d_inner."""
    rules = get_rules()

    def zeros(shape, dt, *names):
        t = torch.zeros(shape, dtype=dt, device=device)
        return t if rules is None else distribute_tensor(t, rules.mesh,
                                                         rules.placements(*names))

    per: Dict[str, Any] = {}
    if not cfg.attention_free:
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        # keys are written at their absolute positions, so the cache holds
        # max_len of them on every model.  (The reference bounds a
        # sliding-window-only model's cache at the window and then overflows
        # it past that many tokens: ROADMAP Queue 3 (f).)
        kv = (None, "batch", None, "kv_heads", None)
        La = cfg.layer_count("attn")
        per["k"] = zeros((La, B, max_len, KV, hd), dtype, *kv)
        per["v"] = zeros((La, B, max_len, KV, hd), dtype, *kv)
    if cfg.ssm is not None:
        Ls = cfg.layer_count("ssm")
        for name, (shape, dt, axes) in _mixer(cfg).cache_shapes(cfg).items():
            per[name] = zeros((Ls, B) + shape, dt or dtype, None, "batch", *axes)
    return per


def _positions(B, S, offset, device):
    return torch.arange(offset, offset + S, device=device).expand(B, S)


def forward(params, batch, cfg: ModelConfig, remat: str = "none", impl: str = "kernel",
            dispatch_mode: str = "einsum", capacity_factor: float = 1.25):
    """Training forward: full-sequence logits and the MoE aux loss (an f32
    zero without MoE).  Differentiable; ``remat`` checkpoints each layer
    (see ``decoder_stack``)."""
    x = _embed_inputs(cfg, params, batch)
    B, S = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None and cfg.rope != "none":
        positions = _positions(B, S, 0, x.device)
    enc_out = None
    if cfg.encdec:
        enc_out = encoder_stack(cfg, params["encoder"], batch["frames"], remat, impl)
    x, _, aux = decoder_stack(cfg, params["layers"], x, positions, CausalMask(S, S), None,
                              None, impl, remat, enc_out, dispatch_mode, capacity_factor)
    return _head(cfg, params, x), aux


def _head(cfg, params, x):
    """The final norm and the logits, in the span ``repro_torch.lm.head``."""
    with maybe_span(profiling(), LM_HEAD):
        x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        return _lm_logits(cfg, params, x)


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, max_len: int, impl: str = "kernel",
            dispatch_mode: str = "einsum", capacity_factor: float = 1.25, *,
            chunk: Optional[int] = None, caches: Optional[Dict[str, Any]] = None,
            counters=None):
    """Process the prompt, returning last-position logits + serving cache
    (with an encoder-decoder model, the encoder's output's cross keys and
    values too).

    ``chunk``: take the prompt in pieces of at most ``chunk`` positions, in
    order; each continues the conv and SSM state the one before left in the
    cache and writes its keys and values at its offset, so no piece's
    activations (the scan's (B, S, DI, N) dA and dBx among them) are built
    for more than ``chunk`` positions.  ``caches``: write into these, of B
    rows, in place of fresh zeroed ones of ``max_len`` positions (their conv
    and SSM state must be zero: the state before the first position).
    ``counters``: an ``LMCounters``, which counts the chunks, the tokens and
    the routing."""
    key = "embeds" if "embeds" in batch else "tokens"
    B, S = batch[key].shape[0], batch[key].shape[1]
    if chunk is not None and chunk < 1:
        raise ValueError(f"prefill: chunk must be None or >= 1, got {chunk!r}")
    step = S if chunk is None else chunk
    dev = params["embed"].device
    if caches is None:
        caches = _make_caches(cfg, B, max_len, getattr(torch, cfg.dtype), dev)
    enc_out = None
    if cfg.encdec:
        enc_out = encoder_stack(cfg, params["encoder"], batch["frames"], impl=impl)
        caches["ck"], caches["cv"] = _cross_kv(cfg, params["layers"], enc_out)
    S_kv = caches["k"].shape[2] if "k" in caches else S
    given = batch.get("positions")
    if counters is not None:
        counters.decoding = False
    for off in range(0, S, step):
        c = min(step, S - off)
        whole = c == S  # the prompt as given (a sharded batch is not sliced)
        x = _embed_inputs(cfg, params, {key: batch[key] if whole else batch[key][:, off:off + c],
                                        "pos_offset": off})
        positions = given if given is None or whole else given[..., off:off + c]
        if positions is None and cfg.rope != "none":
            positions = _positions(B, c, off, dev)
        x, caches, _ = decoder_stack(cfg, params["layers"], x, positions,
                                     CausalMask(c, S_kv, q_offset=off), caches, off, impl,
                                     enc_out=enc_out, dispatch_mode=dispatch_mode,
                                     capacity_factor=capacity_factor, counters=counters)
        if counters is not None:
            counters.prefill_chunks += 1
            counters.prefill_tokens += B * c
    logits = _head(cfg, params, x[:, -1:])
    return logits, {"layers": caches, "pos": S}


@torch.no_grad()
def decode_step(params, tokens, cache, cfg: ModelConfig, impl: str = "kernel",
                dispatch_mode: str = "einsum", capacity_factor: float = 1.25,
                counters=None):
    """One serving step: tokens (B, 1) -> logits (B, 1, V), updated cache.
    ``cache["pos"]`` is a host int that every row shares, or a sequence of B
    host ints, one per row: row b's token then sits at its own position for
    the position embedding, the cache write and the causal mask.  The
    per-row positions go to the device once, as one (B,) int32 tensor that
    every layer shares.  ``counters``: an ``LMCounters``, which counts the
    step and its routing."""
    pos = cache["pos"]
    B = tokens.shape[0]
    dev = params["embed"].device
    per_row = isinstance(pos, (tuple, list))
    if per_row:
        pos = tuple(int(p) for p in pos)
        if len(pos) != B or min(pos) < 0:
            raise ValueError(f"decode_step: per-row positions {pos} for {B} rows")
        offsets = torch.tensor(pos, dtype=torch.int32, device=dev)
        positions, pos_offset = offsets[:, None], offsets
    else:
        pos = int(pos)
        positions, pos_offset = _positions(B, 1, pos, dev), pos
    key = "embeds" if tokens.is_floating_point() else "tokens"
    x = _embed_inputs(cfg, params, {key: tokens, "pos_offset": pos_offset})
    layers_cache = cache["layers"]
    mask = None
    if "k" in layers_cache:
        mask = CausalMask(1, layers_cache["k"].shape[2], q_offset=pos,
                          offsets=offsets if per_row else None)
    if counters is not None:
        counters.decoding = True
    x, layers_cache, _ = decoder_stack(cfg, params["layers"], x, positions, mask,
                                       layers_cache, pos, impl, dispatch_mode=dispatch_mode,
                                       capacity_factor=capacity_factor, counters=counters)
    logits = _head(cfg, params, x)
    if counters is not None:
        counters.decode_steps += 1
    new_pos = tuple(p + 1 for p in pos) if per_row else pos + 1
    return logits, {"layers": layers_cache, "pos": new_pos}
