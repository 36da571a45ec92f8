"""Plain PyTorch forward pass of Granite 4.0-H (HF's
``GraniteMoeHybridForCausalLM``) over many rows at once, the reference that
``lm_decode_granite`` cells are judged against.

The benchmark's own copy of ``tests/granite_reference.py``, with the same
equations and the same departures from HF's code (listed there: norm scales
are ``1 + scale``, the gated Mamba-2 norm's too; weights are (in, out), the
experts' gate and up apart; everything in float32; the lower expert index
first among equal router logits; routing forced by given choices), batched
and blocked so that 256 rows of up to ~10k positions fit on one card beside
the weights:

- the rows' activations are kept as one (positions, hidden) float32 tensor,
  layer after layer; each weight is made float32 only while it is used;
- attention runs per row over blocks of queries;
- Mamba-2 runs per row in the chunked SSD form of Dao & Gu
  (arXiv:2405.21060, its ``ssd_minimal_discrete`` listing): the
  intra-chunk products, each chunk's state, the states passed between
  chunks, and the outputs of the passed states, in chunks of
  ``mamba_chunk_size`` (the last padded with positions of dt 0); in place of
  the test reference's position-by-position recurrence, which at 161k
  positions would take a run's hours;
- the shared expert and each routed expert run over blocks of rows;
- the last layer's channel and the head run only at the positions asked for.

Float32 throughout, with TF32 off.  It imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

ROWS_AT_ONCE = 8192   # rows of a product block (experts, the shared expert)
QUERIES_AT_ONCE = 512  # queries of an attention block


def is_attention(cfg: Dict, i: int) -> bool:
    return cfg["layer_types"][i] == "attention"


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def attention_row(h: torch.Tensor, p: Dict, cfg: Dict) -> torch.Tensor:
    """Causal GQA of one row (S, hidden), no positional embedding, scores
    scaled by ``attention_multiplier``."""
    S = h.shape[0]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    q = (h @ p["wq"]).reshape(S, H, hd).transpose(0, 1)
    k = (h @ p["wk"]).reshape(S, KV, hd).transpose(0, 1).repeat_interleave(H // KV, 0)
    v = (h @ p["wv"]).reshape(S, KV, hd).transpose(0, 1).repeat_interleave(H // KV, 0)
    out = torch.empty_like(q)
    for q0 in range(0, S, QUERIES_AT_ONCE):
        q1 = min(S, q0 + QUERIES_AT_ONCE)
        scores = q[:, q0:q1] @ k[:, :q1].transpose(1, 2) * cfg["attention_multiplier"]
        seen = (torch.arange(q1, device=h.device)[None, :]
                <= torch.arange(q0, q1, device=h.device)[:, None])
        out[:, q0:q1] = torch.softmax(scores.masked_fill(~seen, -math.inf), -1) @ v[:, :q1]
    return out.transpose(0, 1).reshape(S, H * hd) @ p["wo"]


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry (i, j) the sum of a over j+1 .. i for
    i >= j, -inf above the diagonal."""
    T = a.shape[-1]
    a = a[..., None].expand(*a.shape, T)
    a = a.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1), 0)
    out = a.cumsum(-2)
    return out.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=a.device).tril(), -math.inf)


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, chunk: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence S_t = exp(A_t) S_{t-1} + X_t B_t^T, y_t = S_t C_t
    from S = 0, for X (b, T, h, p) (x times dt), A (b, T, h) (dt times A),
    B and C (b, T, h, n), T a multiple of ``chunk``.  Returns y (b, T, h, p)
    and the last state (b, h, p, n)."""
    b, T, h, p = X.shape
    c = T // chunk
    X, B, C = (t.reshape(b, c, chunk, *t.shape[2:]) for t in (X, B, C))
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)                 # (b, h, c, l)
    A_cumsum = A.cumsum(-1)
    L = torch.exp(segsum(A))                                          # (b, h, c, l, s)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, L, X)
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[..., -1], (1, 0))))  # (b, h, c+1, c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final = new_states[:, :-1], new_states[:, -1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states, torch.exp(A_cumsum))
    return (y_diag + y_off).reshape(b, T, h, p), final


def mamba2_row(h: torch.Tensor, p: Dict, cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 mixer of one row (S, hidden) from zero state: its output
    and its state after the last position (H, P, N)."""
    S = h.shape[0]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N, G, K = cfg["mamba_d_state"], cfg["mamba_n_groups"], cfg["mamba_d_conv"]
    DI, chunk = H * P, cfg["mamba_chunk_size"]
    z, xbc, dt = torch.split(h @ p["in_proj"], [DI, DI + 2 * G * N, H], dim=-1)
    padded = torch.cat([xbc.new_zeros(K - 1, xbc.shape[1]), xbc])
    xbc = F.silu(sum(padded[i:i + S] * p["conv_w"][i] for i in range(K)) + p["conv_b"])
    xs, B, C = torch.split(xbc, [DI, G * N, G * N], dim=-1)
    xs = xs.reshape(S, H, P)
    dt = F.softplus(dt + p["dt_bias"])                                # (S, H)
    T = -(-S // chunk) * chunk
    X = F.pad(xs * dt[..., None], (0, 0, 0, 0, 0, T - S))
    A = F.pad(dt * -torch.exp(p["A_log"]), (0, 0, 0, T - S))         # dt 0 past the row
    Bh, Ch = (F.pad(t.reshape(S, G, N).repeat_interleave(H // G, 1), (0, 0, 0, 0, 0, T - S))
              for t in (B, C))
    y, state = ssd(X[None], A[None], Bh[None], Ch[None], chunk)
    y = (y[0, :S] + p["D"][:, None] * xs).reshape(S, DI) * F.silu(z)
    return rms_norm(y, p["norm"], cfg["rms_norm_eps"]) @ p["out_proj"], state[0]


def _mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe_rows(h: torch.Tensor, p: Dict, cfg: Dict, forced: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE channel over rows ``h`` with the experts ``forced`` (positions,
    K), gates a softmax over those experts' router logits, plus the shared
    expert over every row.  Returns the output and the router's own top-K."""
    K = cfg["num_experts_per_tok"]
    logits = h @ p["router"].float()
    own = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :K]
    gates = torch.softmax(logits.gather(1, forced), dim=-1)
    out = torch.empty_like(h)
    shared = [p[f"shared_{name}"].float() for name in ("w_gate", "w_up", "w_down")]
    for r0 in range(0, h.shape[0], ROWS_AT_ONCE):
        out[r0:r0 + ROWS_AT_ONCE] = _mlp(h[r0:r0 + ROWS_AT_ONCE], *shared)
    for e in range(logits.shape[1]):
        rows, slot = torch.nonzero(forced == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        w = [p[name][e].float() for name in ("w_gate", "w_up", "w_down")]
        for r0 in range(0, rows.numel(), ROWS_AT_ONCE):
            r, s = rows[r0:r0 + ROWS_AT_ONCE], slot[r0:r0 + ROWS_AT_ONCE]
            out.index_add_(0, r, gates[r, s, None] * _mlp(h[r], *w))
    return out, own


def logits_at(weights: Dict, rows: Sequence[torch.Tensor], cfg: Dict,
              choices: Sequence[Sequence[torch.Tensor]], at: Sequence[Sequence[int]],
              state_layers: Sequence[int]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Logits (rows, len(at[b]), vocab) of each row of token ids at the
    positions ``at[b]``, with the routing forced by ``choices[b][j]``
    ((positions, K) of MoE layer j); for each row, the (position, MoE layer)
    pairs whose router's own top-K set differs from the forced one, and all
    its pairs (both (rows,) int64); and for each layer of ``state_layers``
    (Mamba-2 layers) every row's state after its last position (rows, H, P,
    N).  ``weights``: as ``tests/granite_reference.py`` takes them (any float
    dtype)."""
    no_tf32()
    eps, res = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    lengths = [int(r.numel()) for r in rows]
    starts = [0]
    for n in lengths[:-1]:
        starts.append(starts[-1] + n)
    x = weights["embed"][torch.cat(list(rows))].float() * cfg["embedding_multiplier"]
    forced = [torch.cat([c[j] for c in choices]).long() for j in range(len(choices[0]))]
    picked = torch.cat([torch.as_tensor(a, device=x.device) + s for a, s in zip(at, starts)])
    row_of = torch.repeat_interleave(torch.arange(len(rows), device=x.device),
                                     torch.as_tensor(lengths, device=x.device))
    differ = torch.zeros(len(rows), dtype=torch.int64, device=x.device)
    seen = torch.zeros_like(differ)
    states: List[torch.Tensor] = []
    layers = weights["layers"]
    for i, lw in enumerate(layers):
        h = rms_norm(x, lw["norm1"], eps)
        mixed = torch.empty_like(h)
        if is_attention(cfg, i):
            p = _f32(lw["attn"])
            for s, n in zip(starts, lengths):
                mixed[s:s + n] = attention_row(h[s:s + n], p, cfg)
        else:
            p = _f32(lw["mamba"])
            kept = []
            for s, n in zip(starts, lengths):
                mixed[s:s + n], state = mamba2_row(h[s:s + n], p, cfg)
                if i in state_layers:
                    kept.append(state)
            if kept:
                states.append(torch.stack(kept))
        del p
        x = x + res * mixed
        del h, mixed
        take = slice(None)
        if i == len(layers) - 1:  # nothing after the last layer reads other positions
            x, take = x[picked], picked
        chosen = forced[i][take]
        out, own = moe_rows(rms_norm(x, lw["norm2"], eps), lw["moe"], cfg, chosen)
        other = (own.sort(-1)[0] != chosen.sort(-1)[0]).any(-1)
        differ.index_add_(0, row_of[take], other.long())
        seen.index_add_(0, row_of[take], torch.ones_like(other, dtype=torch.int64))
        x = x + res * out
        del out
    logits = rms_norm(x, weights["final_norm"], eps) @ weights["embed"].float().T
    logits = logits / cfg["logits_scaling"]
    return logits.reshape(len(rows), -1, logits.shape[-1]), differ, seen, states
