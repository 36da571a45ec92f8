"""``expert_load_max``: over the window, the tokens routed to the busiest
expert of a MoE layer over the mean of that layer's experts, the largest of
the layers (1 is an even load); from the port's per-expert routing counts
(``moe<j>.expert<e>.tokens``)."""

import re

KEY = re.compile(r"moe(\d+)\.expert(\d+)\.tokens")


def read(obs):
    layers = {}
    for key, value in obs.loads.items():
        match = KEY.fullmatch(key)
        if match:
            layers.setdefault(match.group(1), []).append(value)
    loads = [max(v) * len(v) / sum(v) for v in layers.values() if sum(v) > 0]
    return max(loads) if loads else None
