"""``sched_idle_ms_per_step``: milliseconds a step in which the card is idle
while the host's innermost program span is the scheduler's
(``repro_torch.sched.*``: fingerprint, plan replay, cold LSHS)."""

from portbench.spans import idle_ms_per_step


def read(obs):
    return idle_ms_per_step(obs, "sched")
