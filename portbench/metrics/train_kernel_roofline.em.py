"""train_kernel_roofline.em: The train step's least time
(costs.fused_step_least_s, whatever kernels compute it) over the device's
busy time per step."""

from portbench import readers

LAYER = "Kernels"
UNIT = "%"
MOVES = "em_samples_per_s"


def read(ctx: dict):
    return readers.train_step_roofline(ctx)
