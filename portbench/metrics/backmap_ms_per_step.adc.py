"""backmap_ms_per_step.adc: Device ms per step under the backmap's autograd
function (ops/backmap.py::_OneWay, forward and backward), by the profiler's
attribution of kernels to the host op that launched them; nothing where it
attributes none."""

from portbench import readers

LAYER = "ADC step"
UNIT = "ms"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return readers.backmap_ms_per_step(ctx)
