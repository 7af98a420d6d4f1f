"""multimer_backmap_ms_per_step.adc: Device ms a traced step of the
multimer backmap (ops/backmap.py::backmap_multimer), forward and backward:
the operations launched under the span ``adc.backmap`` and under the span
``adc.backmap_backward``, whatever thread launched them (the spans of
sidechain_backmap_ms_per_step.adc, read as it reads them); nothing where
the backward has no span of its own."""

from pathlib import Path

from portbench import harness

LAYER = "ADC step"
UNIT = "ms"
MOVES = "adc_device_ms_per_step"


def device_s(ctx: dict):
    """Device seconds under the backmap's two spans over the traced chunks,
    or None."""
    spanned = harness.load_module(Path(__file__).with_name(
        "sidechain_backmap_ms_per_step.adc.py"), "portbench_metric_backmap_spans_s")
    return spanned.device_s(ctx)


def read(ctx: dict):
    s = device_s(ctx)
    return None if s is None else 1e3 * s / ctx["spans"]["traced_steps"]
