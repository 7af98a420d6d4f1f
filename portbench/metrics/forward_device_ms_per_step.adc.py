"""forward_device_ms_per_step.adc: Device ms a traced step of
the operations launched under the span ``step.forward`` (the ADC's
encode, decode, backmap and losses), whatever thread launched them."""

from portbench import spans

LAYER = "Chunk trainer"
UNIT = "ms"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return spans.readings(ctx.get("spans") or {}).get("forward_device_ms_per_step")
