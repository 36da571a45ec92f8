"""Operations and bytes of one decode step of a layer-scheduled LM (Jamba),
counted from the configuration's published keys (HF's names), with nothing
of the port: the yardstick of ``step_mfu`` and ``step_hbm_share`` in the
``lm_decode`` cells.

The bytes are what a step must move and nothing more: every weight of the
stack that the step uses read once (the experts only where a token was routed
to them, counted from the port's experts-hit counter by the metric), each
row's keys and values up to its position read and the new ones written, the
SSM and conv state read and written, each row's embedding row read and its
logits written.  So a step that moved less would not have computed the step.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from portbench.counts import ITEMSIZE


def layer_kinds(config: Dict) -> List[Tuple[str, str]]:
    """(mixer, channel) of each of the ``n_layers`` layers run: ("attn" or
    "mamba", "moe" or "mlp")."""
    return [("attn" if i % config["attn_layer_period"] == config["attn_layer_offset"]
             else "mamba",
             "moe" if i % config["expert_layer_period"] == config["expert_layer_offset"]
             else "mlp")
            for i in range(config["n_layers"])]


def _widths(config: Dict) -> Dict[str, int]:
    d = config["hidden_size"]
    heads = config["num_attention_heads"]
    return {"d": d, "hd": d // heads, "heads": heads, "kv": config["num_key_value_heads"],
            "di": config["mamba_expand"] * d, "n": config["mamba_d_state"],
            "r": config["mamba_dt_rank"], "conv": config["mamba_d_conv"],
            "f": config["intermediate_size"], "e": config["num_experts"],
            "k": config["num_experts_per_tok"], "v": config["vocab_size"]}


def part_params(config: Dict) -> Dict[str, int]:
    """Parameters of one layer's part of each kind, the norms aside: "attn",
    "mamba" (its inner norms and conv bias included), "router", "expert"
    (one expert's gate, up and down), "mlp"."""
    w = _widths(config)
    d, di = w["d"], w["di"]
    return {
        "attn": 2 * d * w["heads"] * w["hd"] + 2 * d * w["kv"] * w["hd"],
        "mamba": (d * 2 * di + di * w["conv"] + di + di * (w["r"] + 2 * w["n"])
                  + w["r"] * di + di + di * w["n"] + di + di * d + w["r"] + 2 * w["n"]),
        "router": d * w["e"],
        "expert": 3 * d * w["f"],
        "mlp": 3 * d * w["f"],
    }


def _dense_params(config: Dict) -> int:
    """Parameters a step reads whatever the routing: every layer's mixer,
    MLP or router and norms, the final norm and the head."""
    parts, d = part_params(config), config["hidden_size"]
    total = d + config["vocab_size"] * d  # final norm, head
    for mixer, channel in layer_kinds(config):
        total += parts[mixer] + (parts["router"] if channel == "moe" else parts["mlp"]) + 2 * d
    return total


def mean_prompt(traffic: Dict) -> float:
    """The expected prompt length: log-uniform over [prompt_min, prompt_max],
    rounded down to a multiple of ``prompt_multiple`` (about half of one
    lost)."""
    lo, hi = traffic["prompt_min"], traffic["prompt_max"]
    return (hi - lo) / math.log(hi / lo) - (traffic["prompt_multiple"] - 1) / 2


def step_flops(config: Dict, traffic: Dict) -> float:
    """Model operations of one decode step of all rows: 2 per active
    parameter in a product (every layer's mixer and channel with top-k of
    its experts, the head; not the embedding lookup) a row, plus attention's
    q k^T and p v over each row's context, taken at the expected prompt
    length."""
    parts, w = part_params(config), _widths(config)
    matmul = config["vocab_size"] * w["d"]
    attention = 0.0
    for mixer, channel in layer_kinds(config):
        matmul += parts[mixer]
        matmul += (parts["router"] + w["k"] * parts["expert"] if channel == "moe"
                   else parts["mlp"])
        if mixer == "attn":
            attention += 4.0 * w["heads"] * w["hd"] * mean_prompt(traffic)
    return traffic["sessions"] * (2.0 * matmul + attention)


def expert_bytes(config: Dict, dtype: str) -> float:
    """Bytes of one expert's weights."""
    return float(ITEMSIZE[dtype] * part_params(config)["expert"])


def window_bytes(config: Dict, dtype: str, positions: Sequence[int], steps: int
                 ) -> Dict[str, float]:
    """Bytes that ``steps`` decode steps must move, the experts aside, for
    rows whose first step of the window sits at ``positions``: "weights"
    (every weight but the experts, once a step), "kv" (keys and values up
    to each row's position read, the new ones written), "state" (SSM state
    in f32 and conv state read and written), "io" (embedding rows read,
    logits written)."""
    w = _widths(config)
    item, rows = ITEMSIZE[dtype], len(positions)
    kinds = layer_kinds(config)
    n_attn = sum(mixer == "attn" for mixer, _ in kinds)
    n_mamba = len(kinds) - n_attn
    kv_row = 2 * w["kv"] * w["hd"] * item * n_attn          # k and v of one position
    # a row at position p reads the p cached keys and values before it and
    # writes its own (counted once); over the window p runs p0 .. p0 + steps - 1
    keys = sum(steps * p + steps * (steps - 1) / 2 for p in positions)
    state = n_mamba * rows * (w["di"] * w["n"] * 4 + (w["conv"] - 1) * w["di"] * item)
    return {
        "weights": float(steps * item * _dense_params(config)),
        "kv": float(kv_row * (keys + steps * rows)),
        "state": float(2 * steps * state),
        "io": float(steps * rows * item * (w["d"] + config["vocab_size"])),
    }
