"""device_ops_per_step.adc: Device operations (kernels, copies, sets) the
profiler saw over the traced sub-window, per step."""

from portbench import readers

LAYER = "Chunk trainer"
UNIT = "ops/step"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return readers.ops_per_step(ctx)
