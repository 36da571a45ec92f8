"""``plan_hit_rate``: schedules of the window that replayed a cached plan,
in percent of all schedules (the port's ``plan_hits`` and ``plan_misses``)."""


def read(obs):
    total = obs.loads["plan_hits"] + obs.loads["plan_misses"]
    if total == 0:
        return None
    return 100.0 * obs.loads["plan_hits"] / total
