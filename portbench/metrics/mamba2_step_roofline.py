"""``mamba2_step_roofline``: the bytes the traced window's Mamba-2 decode
steps must move (``portbench/lm_counts_granite.py::mamba2_step_bytes``, one
call a Mamba-2 layer and step), over the device time of the kernels of
``csrc/mamba2_step.cu`` in the trace and the card's published HBM bandwidth,
in percent."""

#: the kernels of ``csrc/mamba2_step.cu``, matched as parts of the trace's names
KERNELS = ("mamba2_state_kernel", "mamba2_norm_kernel")


def read(obs):
    per_call = obs.extra.get("mamba2_step_bytes")
    if obs.trace is None or obs.steps == 0 or per_call is None:
        return None
    device_s = obs.trace.seconds_of(KERNELS)
    launched = obs.launches.get("mamba2_step", 0)
    if device_s <= 0:
        if launched > 0:
            obs.note(f"mamba2_step_roofline: the kernels ran {launched} times but the trace "
                     "holds no device time under their names; no share reported")
        return None
    calls = obs.steps * obs.extra["mamba2_layers"]
    if launched != calls:
        obs.note(f"mamba2_step_roofline: {launched} mamba2_step launches against {calls} "
                 "Mamba-2 layer steps")
    return 100.0 * calls * per_call / (device_s * obs.peaks["hbm_bytes_per_s"])
