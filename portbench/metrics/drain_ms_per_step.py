"""``drain_ms_per_step``: the executor's time draining its pipelined queues
a step (the port's ``drain_s``)."""


def read(obs):
    if obs.steps == 0:
        return None
    return 1e3 * obs.loads["drain_s"] / obs.steps
