"""adc_device_ms_per_step: End-to-end. The card's busy time per training
step, the union of its operation intervals over the traced chunks (the same
number of whole chunks in every run, after the measured window) over their
steps: what a step of the ADC costs the card, whatever the host does."""

from portbench import readers

UNIT = "ms"


def read(ctx: dict):
    return readers.device_ms_per_step(ctx)
