"""mfu.em: The step's model FLOPs over the measured window's wall time, as a
share of the card's float32 peak (67 TFLOP/s)."""

from portbench import readers

LAYER = "Chunk trainer"
UNIT = "%"
MOVES = "em_samples_per_s"


def read(ctx: dict):
    return readers.mfu(ctx)
