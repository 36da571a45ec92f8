"""Plain PyTorch forward pass of Jamba (AI21's ``JambaForCausalLM``), the
reference the port's ``jamba2-mini`` is held to.

Float32 throughout, TF32 off (``no_tf32``), one sequence at a time, with no
kernel, cache or batching: the layer equations written out, and the Mamba
recurrence taken one position after another.  It imports nothing of the port.

The model: an embedding, then ``num_hidden_layers`` pre-norm layers, each
``x + mixer(rmsnorm(x))`` and then ``x + channel(rmsnorm(x))``, a final
RMSNorm and an untied head.  Layer i's mixer is attention where
``i % attn_layer_period == attn_layer_offset``, else Mamba-1; its channel is
the MoE where ``i % expert_layer_period == expert_layer_offset``, else a
gated-SiLU MLP.

- Attention: grouped-query, causal, softmax scale 1/sqrt(head_dim), no
  positional embedding, no biases.
- Mamba-1: in_proj to (x, z); a causal depthwise conv of width ``d_conv``
  with bias, then SiLU; x_proj to (dt, B, C) of widths (dt_rank, d_state,
  d_state); an RMSNorm on each of dt, B and C; dt = softplus(dt_proj(dt) +
  dt_bias); A = -exp(A_log); h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t from
  h = 0; y_t = h_t C_t + D x_t; y * SiLU(z); out_proj.  No bias on in_proj,
  x_proj or out_proj.
- MoE: router logits x @ router, softmax over all experts, the top
  ``num_experts_per_tok`` of them; their probabilities are the gates, not
  renormalised; each chosen expert's gated-SiLU MLP times its gate, summed.
  Nothing is dropped.

Where this file departs from HF's ``modeling_jamba.py``:

- Norm scales follow the port's convention: RMSNorm multiplies by
  ``1 + scale`` (a zero scale is the identity), where HF multiplies by
  ``weight`` (initialised to ones).  All norms are RMSNorms with
  ``rms_norm_eps``.
- Weights are laid out as the port's, ``x @ W`` with W (in, out); HF's
  ``nn.Linear`` keeps (out, in).  The conv weight is (d_conv, d_inner).
- Everything is float32: HF casts back to the input dtype inside the norms
  and the routing weights to the hidden dtype.
- Among equal router probabilities the lower expert index is taken first
  (``torch.sort(stable=True)``); ``torch.topk`` promises no order.
- ``choices``, one (S, top_k) tensor of expert indices per MoE layer, may
  force the routing (teacher forcing: the gates are then the softmax's
  probabilities of the given experts); the experts the router itself picks
  are returned either way.
- Logits are returned at every position (HF's ``num_logits_to_keep`` keeps
  the last); no padding mask, cache or attention dropout.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """Float32 products in float32 on a card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def is_attention(cfg: Dict, i: int) -> bool:
    return i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def is_moe(cfg: Dict, i: int) -> bool:
    return i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def attention(x: torch.Tensor, p: Dict, cfg: Dict) -> torch.Tensor:
    S = x.shape[0]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    q = (x @ p["wq"]).reshape(S, H, hd).transpose(0, 1)
    k = (x @ p["wk"]).reshape(S, KV, hd).transpose(0, 1)
    v = (x @ p["wv"]).reshape(S, KV, hd).transpose(0, 1)
    k = k.repeat_interleave(H // KV, dim=0)
    v = v.repeat_interleave(H // KV, dim=0)
    scores = q @ k.transpose(1, 2) / math.sqrt(hd)
    seen = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~seen, -math.inf), dim=-1)
    return (probs @ v).transpose(0, 1).reshape(S, H * hd) @ p["wo"]


def mamba(x: torch.Tensor, p: Dict, cfg: Dict) -> torch.Tensor:
    S = x.shape[0]
    eps = cfg["rms_norm_eps"]
    N, R, K = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)                       # (S, DI) each
    padded = torch.cat([xs.new_zeros(K - 1, xs.shape[1]), xs])
    xs = F.silu(sum(padded[i:i + S] * p["conv_w"][i] for i in range(K)) + p["conv_b"])
    dt, B, C = torch.split(xs @ p["x_proj"], [R, N, N], dim=-1)
    dt = rms_norm(dt, p["dt_norm"], eps)
    B = rms_norm(B, p["b_norm"], eps)
    C = rms_norm(C, p["c_norm"], eps)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])                  # (S, DI)
    A = -torch.exp(p["A_log"])                                         # (DI, N)
    h = xs.new_zeros(xs.shape[1], N)
    ys = []
    for t in range(S):
        h = torch.exp(dt[t, :, None] * A) * h + dt[t, :, None] * B[t] * xs[t, :, None]
        ys.append(h @ C[t])
    y = torch.stack(ys) + p["D"] * xs
    return (y * F.silu(z)) @ p["out_proj"]


def mlp(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def moe(x: torch.Tensor, p: Dict, cfg: Dict, forced: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, the router's own top-k choices (S, K)); ``forced`` (S, K)
    replaces the choices the output is computed with."""
    K = cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ p["router"], dim=-1)                     # (S, E)
    own = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :K]
    chosen = own if forced is None else forced.to(own.device, torch.long)
    gates = probs.gather(1, chosen)
    out = torch.zeros_like(x)
    for e in range(probs.shape[1]):
        rows, slot = torch.nonzero(chosen == e, as_tuple=True)
        if rows.numel():
            expert = {name: p[name][e] for name in ("w_gate", "w_up", "w_down")}
            out.index_add_(0, rows, gates[rows, slot, None] * mlp(x[rows], expert))
    return out, own


def forward(weights: Dict, tokens: torch.Tensor, cfg: Dict,
            choices: Optional[Sequence[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Logits (S, vocab) of one sequence of token ids (S,), and the router's
    own choices (S, K) of each MoE layer.  ``choices``, one (S, K) per MoE
    layer in order, forces the routing.  ``weights``: ``embed``, ``lm_head``
    (vocab, hidden), ``final_norm``, and ``layers``, one dict a layer with
    ``norm1``, ``norm2``, ``attn`` or ``mamba``, and ``moe`` or ``mlp``."""
    eps = cfg["rms_norm_eps"]
    x = weights["embed"][tokens]
    own: List[torch.Tensor] = []
    for i, lw in enumerate(weights["layers"]):
        h = rms_norm(x, lw["norm1"], eps)
        x = x + (attention(h, lw["attn"], cfg) if is_attention(cfg, i)
                 else mamba(h, lw["mamba"], cfg))
        h = rms_norm(x, lw["norm2"], eps)
        if is_moe(cfg, i):
            forced = None if choices is None else choices[len(own)]
            out, picked = moe(h, lw["moe"], cfg, forced)
            own.append(picked)
        else:
            out = mlp(h, lw["mlp"])
        x = x + out
    return rms_norm(x, weights["final_norm"], eps) @ weights["lm_head"].T, own
