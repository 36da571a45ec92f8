"""``device_idle``: the share of the traced window in which no operation
ran on the card, in percent (1 - the union of device intervals)."""


def read(obs):
    if obs.trace is None or obs.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
