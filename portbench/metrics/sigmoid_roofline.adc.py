"""sigmoid_roofline.adc: The sketch-map losses' least time, forward and
backward (costs.sigmoid_bound at the cell's shapes), over the device time of
the sigmoid-loss kernels, found by name; nothing where they did not run."""

from portbench import readers

LAYER = "Kernels"
UNIT = "%"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return readers.sigmoid_roofline(ctx)
