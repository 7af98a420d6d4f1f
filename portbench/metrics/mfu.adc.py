"""mfu.adc: The step's model FLOPs over the measured window's wall time, as a
share of the card's float32 peak (67 TFLOP/s)."""

from portbench import readers

LAYER = "Chunk trainer"
UNIT = "%"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return readers.mfu(ctx)
