"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated`` over the port's
set-up and window, in GiB."""


def read(obs):
    if obs.memory_peak_bytes <= 0:
        return None
    return obs.memory_peak_bytes / 2 ** 30
