"""Operations and bytes of one decode step of Granite 4.0-H (Mamba-2 and
attention layers by ``layer_types``, a MoE with a shared expert on every
layer, tied embeddings), counted from the configuration's published keys
(HF's names), with nothing of the port: the yardstick of ``step_mfu``,
``step_hbm_share`` and ``mamba2_step_roofline`` in the
``lm_decode_granite`` cells.

The bytes are what a step must move and nothing more: every weight of the
stack that the step uses read once (the routed experts only where a token
was routed to them, counted from the port's experts-hit counter by the
metric; the shared experts with the other weights), each row's keys and
values up to its position read and the new ones written, the Mamba-2 state
(f32) and conv state read and written, each row's embedding row read and
its logits written.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from portbench.counts import ITEMSIZE
from portbench.lm_counts import mean_prompt


def layer_kinds(config: Dict) -> List[str]:
    """The mixer of each of the ``n_layers`` layers run: "attn" or "mamba"
    (every layer's channel is the MoE)."""
    return ["attn" if kind == "attention" else "mamba"
            for kind in config["layer_types"][:config["n_layers"]]]


def _widths(config: Dict) -> Dict[str, int]:
    d = config["hidden_size"]
    heads = config["num_attention_heads"]
    h, p = config["mamba_n_heads"], config["mamba_d_head"]
    n, g = config["mamba_d_state"], config["mamba_n_groups"]
    return {"d": d, "hd": d // heads, "heads": heads, "kv": config["num_key_value_heads"],
            "h": h, "p": p, "n": n, "di": h * p, "cc": h * p + 2 * g * n,
            "conv": config["mamba_d_conv"], "f": config["intermediate_size"],
            "fs": config["shared_intermediate_size"], "e": config["num_local_experts"],
            "k": config["num_experts_per_tok"], "v": config["vocab_size"]}


def part_params(config: Dict) -> Dict[str, int]:
    """Parameters of one layer's part of each kind, the layer norms aside:
    "attn", "mamba" (conv bias, dt_bias, A_log, D and the gated norm
    included), "router", "expert" (one routed expert's gate, up and down),
    "shared" (the shared expert)."""
    w = _widths(config)
    d = w["d"]
    return {
        "attn": 2 * d * w["heads"] * w["hd"] + 2 * d * w["kv"] * w["hd"],
        "mamba": (d * (w["di"] + w["cc"] + w["h"]) + (w["conv"] + 1) * w["cc"] + 3 * w["h"]
                  + w["di"] + w["di"] * d),
        "router": d * w["e"],
        "expert": 3 * d * w["f"],
        "shared": 3 * d * w["fs"],
    }


def _dense_params(config: Dict) -> int:
    """Parameters a step reads whatever the routing: every layer's mixer,
    router, shared expert and norms, the final norm and the tied head."""
    parts, d = part_params(config), config["hidden_size"]
    total = d + config["vocab_size"] * d
    for mixer in layer_kinds(config):
        total += parts[mixer] + parts["router"] + parts["shared"] + 2 * d
    return total


def step_flops(config: Dict, traffic: Dict) -> float:
    """Model operations of one decode step of all rows: 2 per active
    parameter in a product (every layer's mixer, router, shared expert and
    top-k of its experts, the head; not the embedding lookup) a row, plus
    attention's q k^T and p v over each row's context, taken at the
    expected prompt length."""
    parts, w = part_params(config), _widths(config)
    matmul = config["vocab_size"] * w["d"]
    attention = 0.0
    for mixer in layer_kinds(config):
        matmul += parts[mixer] + parts["router"] + parts["shared"] + w["k"] * parts["expert"]
        if mixer == "attn":
            attention += 4.0 * w["heads"] * w["hd"] * mean_prompt(traffic)
    return traffic["sessions"] * (2.0 * matmul + attention)


def expert_bytes(config: Dict, dtype: str) -> float:
    """Bytes of one routed expert's weights."""
    return float(ITEMSIZE[dtype] * part_params(config)["expert"])


def mamba2_step_bytes(config: Dict, dtype: str, rows: int) -> float:
    """Bytes one Mamba-2 decode step (``ops.mamba2_state_step``: the state
    kernel and the gated norm) of ``rows`` rows must move: the f32 state read
    and written, the conv's output (x | B | C), dt and z read, the normed
    output written, dt_bias, A_log, D and the norm's scale read."""
    w = _widths(config)
    item = ITEMSIZE[dtype]
    state = 2 * 4 * rows * w["h"] * w["p"] * w["n"]
    return float(state + item * (rows * (w["cc"] + w["h"] + 2 * w["di"]) + 3 * w["h"]
                                 + w["di"]))


def window_bytes(config: Dict, dtype: str, positions: Sequence[int], steps: int
                 ) -> Dict[str, float]:
    """Bytes that ``steps`` decode steps must move, the routed experts
    aside, for rows whose first step of the window sits at ``positions``:
    "weights" (every weight but the routed experts, once a step), "kv" (keys
    and values up to each row's position read, the new ones written),
    "state" (the Mamba-2 state in f32 and the conv state read and written),
    "io" (embedding rows read, logits written)."""
    w = _widths(config)
    item, rows = ITEMSIZE[dtype], len(positions)
    kinds = layer_kinds(config)
    n_attn = kinds.count("attn")
    n_mamba = len(kinds) - n_attn
    kv_row = 2 * w["kv"] * w["hd"] * item * n_attn
    keys = sum(steps * p + steps * (steps - 1) / 2 for p in positions)
    state = n_mamba * rows * (w["h"] * w["p"] * w["n"] * 4 + (w["conv"] - 1) * w["cc"] * item)
    return {
        "weights": float(steps * item * _dense_params(config)),
        "kv": float(kv_row * (keys + steps * rows)),
        "state": float(2 * steps * state),
        "io": float(steps * rows * item * (w["d"] + config["vocab_size"])),
    }
