"""``setup_s``: host seconds from the start of the process to the start of
the window: imports, the card's start, the inputs, the port's blocks, the
warm-up (and, in a checkout's first run, building the kernels)."""


def read(obs):
    return obs.setup_s
