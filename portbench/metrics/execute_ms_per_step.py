"""``execute_ms_per_step``: the host's time inside the backend's ``execute``
a step (the port's ``execute_s``); ``drain_ms_per_step`` less it is the
executor's own bookkeeping."""


def read(obs):
    if obs.steps == 0 or "execute_s" not in obs.loads:
        return None
    return 1e3 * obs.loads["execute_s"] / obs.steps
