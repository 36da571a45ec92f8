"""``matmul_roofline``: the summed roofline bound of every block product the
traced window's steps make, counted from their shapes
(``portbench.counts``), over the device time of the matmul kernels of
``csrc/matmul.cu`` in the trace, in percent."""

from portbench.counts import products_bound_s

#: the kernels of ``csrc/matmul.cu``, matched as parts of the trace's names
KERNELS = ("dmma_kernel", "sgemm_kernel", "skinny_mfast_kernel", "skinny_kfast_kernel",
           "matmul_tile_kernel", "splitk_reduce_kernel")


def read(obs):
    if obs.trace is None or obs.steps == 0:
        return None
    device_s = obs.trace.seconds_of(KERNELS)
    if device_s <= 0:
        if obs.launches.get("matmul", 0) > 0:
            obs.note("matmul_roofline: the matmul kernels ran "
                     f"{obs.launches['matmul']} times but the trace holds no device "
                     "time under their names; no share reported")
        return None
    counted = obs.steps * sum(count for *_shape, count in obs.step_products)
    if obs.launches.get("matmul", counted) != counted:
        obs.note(f"matmul_roofline: {obs.launches['matmul']} matmul launches against "
                 f"{counted} products counted from the shapes")
    bound_s = obs.steps * products_bound_s(obs.step_products, obs.dtype, obs.peaks)
    return 100.0 * bound_s / device_s
