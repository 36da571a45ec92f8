"""``mamba2_idle_ms_per_step``: milliseconds a decode step in which the card
is idle while the host's innermost program span is ``repro_torch.lm.mamba2``
(the Mamba-2 mixer)."""

from portbench.lm_spans import idle_ms_per_step


def read(obs):
    return idle_ms_per_step(obs, "repro_torch.lm.mamba2")
