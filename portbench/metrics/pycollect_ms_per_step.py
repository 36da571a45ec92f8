"""``pycollect_ms_per_step``: the seconds Python's cyclic collector ran a
step, over the whole process (the port's ``pycollect_s``)."""


def read(obs):
    if obs.steps == 0 or "pycollect_s" not in obs.loads:
        return None
    return 1e3 * obs.loads["pycollect_s"] / obs.steps
