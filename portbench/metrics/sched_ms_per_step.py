"""``sched_ms_per_step``: the scheduler's own time a step (LSHS, plan
fingerprinting and replay, without the dispatch inside them), from the
port's ``sched_overhead_s`` over the window."""


def read(obs):
    if obs.steps == 0:
        return None
    return 1e3 * obs.loads["sched_overhead_s"] / obs.steps
