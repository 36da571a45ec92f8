"""``drain_idle_ms_per_step``: milliseconds a step in which the card is idle
while the host's innermost program span is the executor's drain or a
backend op in it (``repro_torch.exec.*``, ``repro_torch.backend.*``)."""

from portbench.spans import idle_ms_per_step


def read(obs):
    return idle_ms_per_step(obs, "drain")
