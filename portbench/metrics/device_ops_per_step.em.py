"""device_ops_per_step.em: Device operations (kernels, copies, sets) the
profiler saw over the traced sub-window, per step."""

from portbench import readers

LAYER = "Chunk trainer"
UNIT = "ops/step"
MOVES = "em_samples_per_s"


def read(ctx: dict):
    return readers.ops_per_step(ctx)
