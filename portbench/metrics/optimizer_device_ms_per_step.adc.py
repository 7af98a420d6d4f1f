"""optimizer_device_ms_per_step.adc: Device ms a traced step
of the operations launched under the span ``step.optimizer`` (the
clipped Adam update of every leaf)."""

from portbench import spans

LAYER = "Chunk trainer"
UNIT = "ms"
MOVES = "adc_device_ms_per_step"


def read(ctx: dict):
    return spans.readings(ctx.get("spans") or {}).get("optimizer_device_ms_per_step")
