"""Plain PyTorch forward pass of Jamba (HF's ``JambaForCausalLM``) over many
rows at once, the reference that ``lm_decode`` cells are judged against.

The benchmark's own copy of ``tests/jamba_reference.py``, with the same
equations and the same departures from HF's code (listed there: the norm
scale is ``1 + scale``, weights are (in, out), everything in float32, the
lower expert index first among equal router probabilities, routing forced
by given choices), batched and blocked so that whole rows of up to ~17k
positions fit on one card beside the weights:

- the rows' activations are kept as one (positions, hidden) float32 tensor,
  layer after layer; each weight is made float32 only while it is used;
- attention runs per row over blocks of queries;
- the Mamba recurrence steps through time once for all rows together, in
  blocks of ``block`` positions, each block's in_proj, conv, x_proj and norms
  computed from the rows' inputs just before it;
- the MLP and each expert run over blocks of rows;
- the last layer's channel and the head run only at the positions asked for.

Float32 throughout, with TF32 off.  It imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

ROWS_AT_ONCE = 8192   # rows of a product block (MLP, experts)
QUERIES_AT_ONCE = 512  # queries of an attention block


def is_attention(cfg: Dict, i: int) -> bool:
    return i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def is_moe(cfg: Dict, i: int) -> bool:
    return i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]


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
    """Causal GQA of one row (S, hidden), no positional embedding."""
    S = h.shape[0]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    q = (h @ p["wq"]).reshape(S, H, hd).transpose(0, 1)
    k = (h @ p["wk"]).reshape(S, KV, hd).transpose(0, 1).repeat_interleave(H // KV, 0)
    v = (h @ p["wv"]).reshape(S, KV, hd).transpose(0, 1).repeat_interleave(H // KV, 0)
    out = torch.empty_like(q)
    for q0 in range(0, S, QUERIES_AT_ONCE):
        q1 = min(S, q0 + QUERIES_AT_ONCE)
        scores = q[:, q0:q1] @ k[:, :q1].transpose(1, 2) / math.sqrt(hd)
        seen = (torch.arange(q1, device=h.device)[None, :]
                <= torch.arange(q0, q1, device=h.device)[:, None])
        out[:, q0:q1] = torch.softmax(scores.masked_fill(~seen, -math.inf), -1) @ v[:, :q1]
    return out.transpose(0, 1).reshape(S, H * hd) @ p["wo"]


def mamba_rows(h: torch.Tensor, starts: Sequence[int], lengths: Sequence[int], p: Dict,
               cfg: Dict, block: int) -> torch.Tensor:
    """The Mamba-1 mixer of every row: ``h`` (positions, hidden) holds row b
    at ``starts[b]`` .. + ``lengths[b]``; rows go longest first, so the rows
    still running at a time are a prefix."""
    eps = cfg["rms_norm_eps"]
    N, R, K = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    D = h.shape[1]
    order = sorted(range(len(lengths)), key=lambda b: -lengths[b])
    A = -torch.exp(p["A_log"])                                        # (DI, N)
    DI = A.shape[0]
    state = h.new_zeros(len(order), DI, N)
    out = torch.empty_like(h)
    for t0 in range(0, max(lengths), block):
        live = [b for b in order if lengths[b] > t0]
        n = len(live)
        T = min(block, max(lengths[b] for b in live) - t0)
        # each live row's inputs t0 - (K - 1) .. t0 + T - 1 (zeros before 0 and past its end)
        window = h.new_zeros(n, T + K - 1, D)
        for j, b in enumerate(live):
            lo, hi = max(0, t0 - (K - 1)), min(lengths[b], t0 + T)
            first = t0 - (K - 1)
            window[j, lo - first:hi - first] = h[starts[b] + lo:starts[b] + hi]
        # in_proj has no bias: the zero rows before position 0 project to the
        # conv's zero padding
        xs, z = (window @ p["in_proj"]).chunk(2, dim=-1)             # (n, T+K-1, DI)
        xs = F.silu(sum(xs[:, i:i + T] * p["conv_w"][i] for i in range(K)) + p["conv_b"])
        z = z[:, K - 1:]
        dt, B, C = torch.split(xs @ p["x_proj"], [R, N, N], dim=-1)
        dt = F.softplus(rms_norm(dt, p["dt_norm"], eps) @ p["dt_proj"] + p["dt_bias"])
        B, C = rms_norm(B, p["b_norm"], eps), rms_norm(C, p["c_norm"], eps)
        dA = torch.exp(dt[..., None] * A)                             # (n, T, DI, N)
        dBx = dt[..., None] * B[:, :, None, :] * xs[..., None]
        h_run = state[:n]
        ys = []
        for t in range(T):  # h = dA h + dBx; y = h C
            h_run = torch.addcmul(dBx[:, t], dA[:, t], h_run)
            ys.append(torch.bmm(h_run, C[:, t, :, None])[..., 0])
        state[:n] = h_run
        y = (torch.stack(ys, 1) + p["D"] * xs) * F.silu(z)
        y = y @ p["out_proj"]                                         # (n, T, hidden)
        for j, b in enumerate(live):
            hi = min(lengths[b], t0 + T)
            out[starts[b] + t0:starts[b] + hi] = y[j, :hi - t0]
    return out


def _mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    return (F.silu(x @ gate) * (x @ up)) @ down


def mlp_rows(h: torch.Tensor, p: Dict) -> torch.Tensor:
    out = torch.empty_like(h)
    w = _f32(p)
    for r0 in range(0, h.shape[0], ROWS_AT_ONCE):
        out[r0:r0 + ROWS_AT_ONCE] = _mlp(h[r0:r0 + ROWS_AT_ONCE], w["w_gate"], w["w_up"],
                                         w["w_down"])
    return out


def moe_rows(h: torch.Tensor, p: Dict, cfg: Dict, forced: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE channel over rows ``h`` with the experts ``forced`` (positions,
    K); the gates are the router's softmax probabilities of those experts,
    not renormalised.  Returns the output and the router's own top-K."""
    K = cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    own = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :K]
    gates = probs.gather(1, forced)
    out = torch.zeros_like(h)
    for e in range(probs.shape[1]):
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
              block: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Logits (rows, len(at[b]), vocab) of each row of token ids at the
    positions ``at[b]``, with the routing forced by ``choices[b][j]``
    ((positions, K) of MoE layer j); and for each row, the (position, MoE
    layer) pairs whose router's own top-K set differs from the forced one,
    and all its pairs (both (rows,) int64).  ``weights``: as
    ``tests/jamba_reference.py`` takes them (any float dtype)."""
    no_tf32()
    eps = cfg["rms_norm_eps"]
    lengths = [int(r.numel()) for r in rows]
    starts = [0]
    for n in lengths[:-1]:
        starts.append(starts[-1] + n)
    x = weights["embed"][torch.cat(list(rows))].float()
    forced = [torch.cat([c[j] for c in choices]).long()
              for j in range(len(choices[0]))]
    picked = torch.cat([torch.as_tensor(a, device=x.device) + s for a, s in zip(at, starts)])
    row_of = torch.repeat_interleave(torch.arange(len(rows), device=x.device),
                                     torch.as_tensor(lengths, device=x.device))
    differ = torch.zeros(len(rows), dtype=torch.int64, device=x.device)
    seen = torch.zeros_like(differ)
    layers = weights["layers"]
    moe_layer = 0
    for i, lw in enumerate(layers):
        h = rms_norm(x, lw["norm1"], eps)
        if is_attention(cfg, i):
            p = _f32(lw["attn"])
            mixed = torch.cat([attention_row(h[s:s + n], p, cfg)
                               for s, n in zip(starts, lengths)])
        else:
            mixed = mamba_rows(h, starts, lengths, _f32(lw["mamba"]), cfg, block)
        x = x + mixed
        del h, mixed
        take = slice(None)
        if i == len(layers) - 1:  # nothing after the last layer reads other positions
            x, take = x[picked], picked
        h = rms_norm(x, lw["norm2"], eps)
        if is_moe(cfg, i):
            chosen = forced[moe_layer][take]
            out, own = moe_rows(h, lw["moe"], cfg, chosen)
            other = (own.sort(-1)[0] != chosen.sort(-1)[0]).any(-1)
            differ.index_add_(0, row_of[take], other.long())
            seen.index_add_(0, row_of[take], torch.ones_like(other, dtype=torch.int64))
            moe_layer += 1
        else:
            out = mlp_rows(h, lw["mlp"])
        x = x + out
        del h, out
    logits = rms_norm(x, weights["final_norm"], eps) @ weights["lm_head"].float().T
    return logits.reshape(len(rows), -1, logits.shape[-1]), differ, seen
