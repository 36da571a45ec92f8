"""Transformer building blocks (counterpart of ``repro.models.layers``):
norms, RoPE and M-RoPE, GQA attention (causal, sliding-window, and
unmasked: the encoder's and cross-attention's), MLP variants, logit
soft-capping.

All functions are pure apart from the KV-cache update, which writes the new
keys and values into the cache tensors in place (the reference returns an
updated copy; in place saves a cache-sized copy per layer and step).  The
cache position is one host int for the batch, or one per row (continuous
batching: each slot decodes at its own position).
Parameters are plain dicts of tensors in the reference's layouts (``x @ W``
with W (D, H*hd)).  Softmax and norm statistics are computed in float32
regardless of the compute dtype.

Attention has two routes, chosen by ``impl``: ``"kernel"`` (the default)
goes through ``kernels.ops.flash_attention`` — the hand-written kernel on a
CUDA tensor, its plain version on a CPU tensor — and takes the masks of the
forms that kernel takes (a :class:`CausalMask`, or None: every key
visible); ``"plain"`` is the reference's dense einsum path, ported, for any
mask.  Nothing picks ``"plain"`` by itself: it is there to hold the kernel
route against it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..kernels import ops
from ..kernels.flash_attention import visible
from .partitioning import constrain, local_call

IMPLS = ("kernel", "plain")

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scales by (1 + scale), in f32: a zero-initialised scale is the
    identity (the gemma convention the reference follows)."""
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(dtype)


def apply_norm(x, params, kind: str, eps: float):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps)
    return layernorm(x, params["scale"], params["bias"], eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Half-split rotation (the
    two halves of each head rotate together), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions (3, B, S), the temporal, height
    and width streams, each rotating its own band of ``sections`` of the
    hd/2 frequencies (in that order); half-split rotation as in
    ``apply_rope``."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim/2 = {half}")
    freqs = _rope_freqs(hd, theta, x.device)                  # (half,)
    band = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                   torch.tensor(sections, device=x.device))
    pos = positions.float()[band]                             # (half, B, S)
    ang = pos.permute(1, 2, 0) * freqs                        # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def position_embed(x, positions, cfg):
    """RoPE or M-RoPE by ``cfg.rope``.  M-RoPE takes (3, B, S) positions, or
    (B, S) ones (text, or one decode step's (B, 1) per-row positions),
    which it gives all three streams."""
    if cfg.rope == "none" or positions is None:
        return x
    if cfg.rope == "mrope":
        if positions.ndim == 2:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def make_causal_mask(q_len: int, kv_len: int, window: Optional[int] = None,
                     q_offset: Union[int, torch.Tensor] = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask; True = attend.  ``window`` bounds the
    lookback (sliding-window attention).  A (B,) tensor of per-row offsets
    gives a (B, q_len, kv_len) mask."""
    return visible(q_len, kv_len, True, window, q_offset, device)


@dataclass(frozen=True)
class CausalMask:
    """The causal mask of a block of ``q_len`` queries at absolute positions
    ``q_offset ...`` over ``kv_len`` keys, with an optional sliding
    ``window``: the one form of mask the flash-attention kernel takes.
    ``q_offset`` is a host int that the whole batch shares, or a tuple of
    host ints, one per batch row.  With a tuple, ``offsets`` may carry the
    same offsets as a (B,) int32 tensor on the device, built once and shared
    by every layer; it is left out of equality and hashing, so the mask
    stays a hashable value."""
    q_len: int
    kv_len: int
    window: Optional[int] = None
    q_offset: Union[int, Tuple[int, ...]] = 0
    offsets: Optional[torch.Tensor] = field(default=None, compare=False, repr=False)

    @property
    def per_row(self) -> bool:
        return isinstance(self.q_offset, tuple)

    def device_offsets(self, device) -> torch.Tensor:
        """The per-row offsets as a (B,) int32 tensor: ``offsets``, or else
        built on ``device``."""
        if self.offsets is not None:
            return self.offsets
        return torch.tensor(self.q_offset, dtype=torch.int32, device=device)

    def dense(self, device=None) -> torch.Tensor:
        """(q_len, kv_len) boolean mask; (B, q_len, kv_len) per row."""
        offset = self.device_offsets(device or "cpu") if self.per_row else self.q_offset
        return make_causal_mask(self.q_len, self.kv_len, self.window, offset, device)


ATTN_CHUNK = 1024   # q-chunk size above which chunked attention kicks in
ATTN_CHUNK_MIN_SQ = 2048


def _attention_dense(qg, k, v, mask, softcap, hd, scale=None):
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float()
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    return torch.einsum("bkrqs,bskd->bqkrd", probs, v)


def _attention_plain(q, k, v, mask, softcap, scale=None):
    """The reference's grouped-query attention: dense scores, in q chunks of
    ATTN_CHUNK for long queries so the (Sq, Skv) matrix is never whole."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    if mask is not None:  # broadcastable to (B, KV, rep, Sq, Skv)
        if mask.ndim == 2:
            mask = mask[None, None, None]
        elif mask.ndim == 3:  # (B, Sq, Skv)
            mask = mask[:, None, None]
    if Sq < ATTN_CHUNK_MIN_SQ or Sq % ATTN_CHUNK:
        return _attention_dense(qg, k, v, mask, softcap, hd, scale).reshape(B, Sq, H, hd)
    chunks = []
    for q0 in range(0, Sq, ATTN_CHUNK):
        mc = mask
        if mask is not None and mask.shape[3] == Sq:
            mc = mask[:, :, :, q0:q0 + ATTN_CHUNK]
        chunks.append(_attention_dense(qg[:, q0:q0 + ATTN_CHUNK], k, v, mc, softcap, hd,
                                       scale))
    return torch.cat(chunks, dim=1).reshape(B, Sq, H, hd)


def attention_scores(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Skv, KV, hd)
    v: torch.Tensor,            # (B, Skv, KV, hd)
    mask: Union[None, torch.Tensor, CausalMask],
    softcap: Optional[float] = None,
    impl: str = "kernel",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention, (B, Sq, H, hd) out.  ``mask`` is a
    :class:`CausalMask`, None (every key visible to every query: the
    encoder's self-attention and cross-attention) or, on the plain route,
    any boolean tensor broadcastable to (B, H, Sq, Skv).  ``scale``
    multiplies the scores (None: 1/sqrt(hd))."""
    if impl == "plain":
        if isinstance(mask, CausalMask):
            mask = mask.dense(q.device)
        return _attention_plain(q, k, v, mask, softcap, scale)
    if impl != "kernel":
        raise ValueError(f"attention_scores: impl must be one of {IMPLS}, got {impl!r}")
    if softcap is not None:
        raise NotImplementedError("attention logit soft-capping is not in the "
                                  "flash-attention kernel (nor in the reference's): ROADMAP "
                                  "Queue 1 item 6 (attention logit soft-capping)")
    if mask is None:
        return local_call(_flash, (q, k, v), _ATTN_DIMS, _ATTN_DIMS[:1], causal=False,
                          scale=scale)
    if not isinstance(mask, CausalMask):
        raise ValueError("attention_scores: the kernel route takes a CausalMask or None; "
                         "a boolean mask tensor is for impl='plain'")
    if (mask.q_len, mask.kv_len) != (q.shape[1], k.shape[1]):
        raise ValueError(f"attention_scores: mask is ({mask.q_len}, {mask.kv_len}) for "
                         f"{q.shape[1]} queries and {k.shape[1]} keys")
    offset, max_offset = mask.q_offset, None
    if mask.per_row:
        if isinstance(q, DTensor):
            raise NotImplementedError("attention_scores: per-row query offsets (continuous "
                                      "batching) are for one card, not under sharding rules")
        offset, max_offset = mask.device_offsets(q.device), max(mask.q_offset)
    return local_call(_flash, (q, k, v), _ATTN_DIMS, _ATTN_DIMS[:1], causal=True,
                      window=mask.window, q_offset=offset, max_offset=max_offset,
                      scale=scale)


#: attention's operands and output, (B, S, heads, hd), by role: the batch
#: (dim 0) and the heads (dim 2) split over ranks, each rank's query heads
#: with their kv heads
_ATTN_DIMS = ((0, 2), (0, 2), (0, 2))


def _flash(q, k, v, **kw):
    """``ops.flash_attention`` on (B, S, heads, hd) operands."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    return out.transpose(1, 2)


def attention_block(
    params: Dict,
    x: torch.Tensor,              # (B, S, D)
    cfg,
    positions: Optional[torch.Tensor],
    mask: Union[None, torch.Tensor, CausalMask],
    cache: Optional[Dict] = None,  # {"k","v": (B, S_max, KV, hd), "pos": int or ints}
    kv_x: Optional[torch.Tensor] = None,
    cross: bool = False,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention; with a cache, writes this block's keys and values at
    positions pos .. pos + S - 1 (in place) and attends over the whole
    cache.  With one ``pos`` per row (a tuple of host ints), row b's keys
    and values go to its own positions, ``positions[b]`` on the device, in
    one indexed write.

    ``cross``: cross-attention, without rotary embedding, of x's queries
    over keys and values projected from ``kv_x`` (the encoder's output), or,
    with ``kv_x`` None, over the static ``cache["k"]``, ``cache["v"]`` that
    prefill projected from it (decode)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    # the projections are split by whole heads, or not at all, before they
    # are viewed as heads (a no-op without sharding rules)
    q = constrain(x @ params["wq"], "batch", "seq", "heads").reshape(B, S, H, hd)
    if cross and kv_x is None:
        if cfg.attn_bias:
            q = q + params["bq"].reshape(1, 1, H, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        out = attention_scores(q, cache["k"], cache["v"], mask, cfg.logit_softcap, impl,
                               getattr(cfg, "attention_scale", None))
        out = out.reshape(B, S, H * hd) @ params["wo"]
        return constrain(out, "batch", "seq", "embed"), None
    src = x if kv_x is None else kv_x
    k = constrain(src @ params["wk"], "batch", "seq", "kv_heads").reshape(
        B, src.shape[1], KV, hd)
    v = constrain(src @ params["wv"], "batch", "seq", "kv_heads").reshape(
        B, src.shape[1], KV, hd)
    if cfg.attn_bias:
        q = q + params["bq"].reshape(1, 1, H, hd)
        k = k + params["bk"].reshape(1, 1, KV, hd)
        v = v + params["bv"].reshape(1, 1, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if not cross:
        q = position_embed(q, positions, cfg)
        k = position_embed(k, positions, cfg)
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    new_cache = None
    if cache is not None and not cross:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        last = max(pos) if isinstance(pos, tuple) else pos
        if last + S > ck.shape[1]:
            raise ValueError(f"KV cache of {ck.shape[1]} positions cannot take "
                             f"positions {last}..{last + S - 1}")
        if isinstance(pos, tuple):
            if positions is None or tuple(positions.shape) != (B, S):
                raise ValueError("attention_block: per-row cache positions need the "
                                 "(B, S) positions of the new keys")
            rows = torch.arange(B, device=ck.device)[:, None]
            ck[rows, positions] = k.to(ck.dtype)
            cv[rows, positions] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv, "pos": tuple(p + S for p in pos)}
        else:
            ck[:, pos:pos + S] = k.to(ck.dtype)
            cv[:, pos:pos + S] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv, "pos": pos + S}
        k, v = ck, cv
    out = attention_scores(q, k, v, mask, cfg.logit_softcap, impl,
                           getattr(cfg, "attention_scale", None))
    out = constrain(out, "batch", "seq", "heads", None)
    out = out.reshape(B, S, H * hd) @ params["wo"]
    return constrain(out, "batch", "seq", "embed"), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

_ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


def mlp_block(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    act = _ACT[cfg.act]
    if cfg.gated_mlp:
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = act(x @ params["w_up"])
    h = constrain(h, "batch", "seq", "ff")
    return constrain(h @ params["w_down"], "batch", "seq", "embed")


def softcap_logits(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap
