"""``step_mfu``: the model operations of the traced window's steps over its
host time and the card's published peak in the configuration's dtype, in
percent."""


def read(obs):
    if obs.steps == 0 or obs.window_s <= 0:
        return None
    peak = obs.peaks["flops_per_s"][obs.dtype]
    return 100.0 * obs.step_flops * obs.steps / (obs.window_s * peak)
