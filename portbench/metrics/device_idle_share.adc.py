"""device_idle_share.adc: The share of the traced sub-window in which no device
operation ran."""

from portbench import readers

LAYER = "Device"
UNIT = "%"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return readers.idle_share(ctx)
