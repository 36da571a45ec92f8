"""``dispatch_ms_per_step``: the executor's enqueue time a step (the port's
``dispatch_s``: ``transition`` and ``run_op`` inside schedules)."""


def read(obs):
    if obs.steps == 0:
        return None
    return 1e3 * obs.loads["dispatch_s"] / obs.steps
