"""wall_samples_per_s.adc: Samples that ``train()`` trained in the measured
window over its wall time, by the host's clock. The rate users wait on; on
this host-bound cell its runs spread too far for any bound, so it is a
per-layer reading here."""

from portbench import readers

LAYER = "Entry point"
UNIT = "samples/s"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return readers.wall_samples_per_s(ctx)
