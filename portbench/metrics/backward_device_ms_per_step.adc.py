"""backward_device_ms_per_step.adc: Device ms a traced step of
the operations launched under the span ``step.backward`` (autograd's
backward, from its device thread too)."""

from portbench import spans

LAYER = "Chunk trainer"
UNIT = "ms"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return spans.readings(ctx.get("spans") or {}).get("backward_device_ms_per_step")
