"""``step_hbm_share``: the bytes the window's decode steps must move over the
card's busy time in the traced window (the union of its operations, which
the profiler's host overhead does not lengthen) and the card's published
HBM bandwidth, in percent.  The bytes (``portbench/lm_counts.py``): every
weight but the experts once a step, the experts that received a token (the
port's ``moe<j>.experts_hit``, summed over the window's steps), the keys and
values each row reads up to its position and writes, the SSM and conv state
read and written, embedding rows and logits."""


def read(obs):
    counted = obs.extra.get("lm_bytes")
    hits = [v for k, v in obs.loads.items() if k.endswith(".experts_hit")]
    if obs.trace is None or obs.steps == 0 or counted is None or not hits:
        return None
    busy_s = obs.trace.busy_s
    if busy_s <= 0:
        return None
    total = sum(counted.values()) + obs.extra["expert_bytes"] * sum(hits)
    return 100.0 * total / (busy_s * obs.peaks["hbm_bytes_per_s"])
