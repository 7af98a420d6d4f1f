"""device_idle_share.em: The share of the traced sub-window in which no device
operation ran."""

from portbench import readers

LAYER = "Device"
UNIT = "%"
MOVES = "em_samples_per_s"


def read(ctx: dict):
    return readers.idle_share(ctx)
