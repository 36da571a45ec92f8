"""``step_s``: the window's host seconds over the whole steps it completed."""


def read(obs):
    if obs.steps == 0:
        return None
    return obs.window_s / obs.steps
