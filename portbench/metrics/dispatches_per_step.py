"""``dispatches_per_step``: block operations the backend executed a step
(the port's ``backend_dispatches``)."""


def read(obs):
    if obs.steps == 0:
        return None
    return obs.loads["backend_dispatches"] / obs.steps
