"""Plain PyTorch forward pass of IBM Granite 4.0-H (HF's
``GraniteMoeHybridForCausalLM``), the reference the port's
``granite-4.0-h-small`` is held to.

Float32 throughout, TF32 off (``no_tf32``), one sequence at a time, with no
kernel, cache or batching: the layer equations written out, and the Mamba-2
recurrence taken one position after another.  It imports nothing of the port.

The model: x = ``embedding_multiplier`` x the embedding, then
``num_hidden_layers`` pre-norm layers, each
``h = x + residual_multiplier * mixer(rmsnorm(x))`` and then
``x = h + residual_multiplier * (moe(u) + shared(u))`` with u = rmsnorm(h);
a final RMSNorm, the tied head, and the logits divided by
``logits_scaling``.  Layer i's mixer is attention where
``i % attn_layer_period == attn_layer_offset`` (``layer_types``), else
Mamba-2.

- Attention: grouped-query, causal, softmax scale ``attention_multiplier``
  (q k^T times it, not over sqrt(head_dim)), no positional embedding
  (``nope``), no biases.
- Mamba-2: in_proj to (z, xBC, dt) of widths (H*P, H*P + 2*G*N, H); a
  causal depthwise conv of width ``mamba_d_conv`` over xBC with bias, then
  SiLU; xBC split into x (H heads of P), B and C (G groups of N; head h
  reads group h // (H / G)); dt = softplus(dt + dt_bias), A = -exp(A_log),
  per head; S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T from S = 0, a (P, N)
  state a head; y_t = S_t C_t + D x_t; then the gated RMSNorm of y * SiLU(z)
  over all H*P channels; out_proj.  No bias on in_proj or out_proj.
- MoE: router logits x @ router; the top ``num_experts_per_tok`` of them and
  a softmax over those as the gates (HF's ``GraniteMoeTopKGating``); each
  chosen expert's gated-SiLU MLP times its gate, summed.  Nothing is dropped.
- Shared expert: a gated-SiLU MLP of ``shared_intermediate_size`` over every
  token, added to the routed output, not gated by the router.

Where this file departs from HF's ``modeling_granitemoehybrid.py``:

- Norm scales follow the port's convention: RMSNorm multiplies by
  ``1 + scale`` (a zero scale is the identity), where HF multiplies by
  ``weight`` (initialised to ones); the Mamba-2 gated norm likewise.
- Weights are laid out as the port's, ``x @ W`` with W (in, out); HF's
  ``nn.Linear`` keeps (out, in) and fuses the experts' gate and up
  projections into one ``input_linear``, which this file keeps apart
  (``w_gate``, ``w_up``; the shared expert's ``shared_w_gate``,
  ``shared_w_up``).  The conv weight is (d_conv, channels).
- Everything is float32: HF casts back to the input dtype inside the norms
  and the gates to the hidden dtype.
- Among equal router logits the lower expert index is taken first
  (``torch.sort(stable=True)``); ``torch.topk`` promises no order.
- ``choices``, one (S, top_k) tensor of expert indices per MoE layer, may
  force the routing (teacher forcing: the gates are then the softmax over
  the given experts' logits); the experts the router itself picks are
  returned either way.
- Logits are returned at every position; no padding mask, cache, dt limit
  (HF's default ``time_step_limit`` (0, inf) clamps nothing) or dropout.
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
    return cfg["layer_types"][i] == "attention"


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def attention(x: torch.Tensor, p: Dict, cfg: Dict) -> torch.Tensor:
    S = x.shape[0]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    q = (x @ p["wq"]).reshape(S, H, hd).transpose(0, 1)
    k = (x @ p["wk"]).reshape(S, KV, hd).transpose(0, 1).repeat_interleave(H // KV, dim=0)
    v = (x @ p["wv"]).reshape(S, KV, hd).transpose(0, 1).repeat_interleave(H // KV, dim=0)
    scores = q @ k.transpose(1, 2) * cfg["attention_multiplier"]
    seen = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~seen, -math.inf), dim=-1)
    return (probs @ v).transpose(0, 1).reshape(S, H * hd) @ p["wo"]


def mamba2(x: torch.Tensor, p: Dict, cfg: Dict, state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 mixer over one sequence (S, hidden), position by position
    from ``state`` (H, P, N) (zero where None).  Returns the output and the
    state after the last position."""
    S = x.shape[0]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N, G, K = cfg["mamba_d_state"], cfg["mamba_n_groups"], cfg["mamba_d_conv"]
    DI = H * P
    z, xbc, dt = torch.split(x @ p["in_proj"], [DI, DI + 2 * G * N, H], dim=-1)
    padded = torch.cat([xbc.new_zeros(K - 1, xbc.shape[1]), xbc])
    xbc = F.silu(sum(padded[i:i + S] * p["conv_w"][i] for i in range(K)) + p["conv_b"])
    xs, B, C = torch.split(xbc, [DI, G * N, G * N], dim=-1)
    xs = xs.reshape(S, H, P)
    B = B.reshape(S, G, N).repeat_interleave(H // G, dim=1)          # (S, H, N)
    C = C.reshape(S, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt + p["dt_bias"])                                # (S, H)
    A = -torch.exp(p["A_log"])                                        # (H,)
    h = xs.new_zeros(H, P, N) if state is None else state
    ys = []
    for t in range(S):
        h = torch.exp(dt[t] * A)[:, None, None] * h \
            + (dt[t, :, None] * xs[t])[..., None] * B[t, :, None, :]
        ys.append((h @ C[t, :, :, None])[..., 0] + p["D"][:, None] * xs[t])
    y = torch.stack(ys).reshape(S, DI) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg["rms_norm_eps"])
    return y @ p["out_proj"], h


def mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor
        ) -> torch.Tensor:
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe(x: torch.Tensor, p: Dict, cfg: Dict, forced: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(routed output + shared expert's, the router's own top-k choices
    (S, K)); ``forced`` (S, K) replaces the choices the output is computed
    with."""
    K = cfg["num_experts_per_tok"]
    logits = x @ p["router"]                                          # (S, E)
    own = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :K]
    chosen = own if forced is None else forced.to(own.device, torch.long)
    gates = torch.softmax(logits.gather(1, chosen), dim=-1)
    out = torch.zeros_like(x)
    for e in range(logits.shape[1]):
        rows, slot = torch.nonzero(chosen == e, as_tuple=True)
        if rows.numel():
            w = [p[name][e] for name in ("w_gate", "w_up", "w_down")]
            out.index_add_(0, rows, gates[rows, slot, None] * mlp(x[rows], *w))
    shared = mlp(x, p["shared_w_gate"], p["shared_w_up"], p["shared_w_down"])
    return out + shared, own


def forward(weights: Dict, tokens: torch.Tensor, cfg: Dict,
            choices: Optional[Sequence[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Logits (S, vocab) of one sequence of token ids (S,), the router's own
    choices (S, K) of each MoE layer, and the final state (H, P, N) of each
    Mamba-2 layer.  ``choices``, one (S, K) per MoE layer in order, forces
    the routing.  ``weights``: ``embed`` (vocab, hidden), tied to the head,
    ``final_norm``, and ``layers``, one dict a layer with ``norm1``,
    ``norm2``, ``attn`` or ``mamba``, and ``moe``."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = weights["embed"][tokens] * cfg["embedding_multiplier"]
    own: List[torch.Tensor] = []
    states: List[torch.Tensor] = []
    for i, lw in enumerate(weights["layers"]):
        h = rms_norm(x, lw["norm1"], eps)
        if is_attention(cfg, i):
            mixed = attention(h, lw["attn"], cfg)
        else:
            mixed, state = mamba2(h, lw["mamba"], cfg)
            states.append(state)
        x = x + r * mixed
        forced = None if choices is None else choices[len(own)]
        out, picked = moe(rms_norm(x, lw["norm2"], eps), lw["moe"], cfg, forced)
        own.append(picked)
        x = x + r * out
    logits = rms_norm(x, weights["final_norm"], eps) @ weights["embed"].T
    return logits / cfg["logits_scaling"], own, states
