"""``step_p95_s``: the 95th percentile of every step's host seconds in the
window (``statistics.quantiles``, inclusive)."""

import statistics


def read(obs):
    if obs.steps < 2:
        return None
    return statistics.quantiles(obs.step_times, n=20, method="inclusive")[-1]
