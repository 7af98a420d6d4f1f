"""sidechain_backmap_ms_per_step.adc: Device ms a traced step of the
sidechain backmap (ops/backmap_sidechains.py), forward and backward: the
operations launched under the span ``adc.backmap`` and under the span
``adc.backmap_backward``, whatever thread launched them; nothing where the
backward has no span of its own."""

from portbench import spans

LAYER = "ADC step"
UNIT = "ms"
MOVES = "adc_device_ms_per_step"
#: the spans of the backmap's forward and of its backward
SPANS = ("adc.backmap", "adc.backmap_backward")


def device_s(ctx: dict):
    """Device seconds under :data:`SPANS` over the traced chunks, or None."""
    sp = ctx.get("spans") or {}
    incl = (sp.get("trace") or {}).get("device_incl_s", {})
    parts = [incl.get(name) for name in SPANS]
    return sum(parts) if all(parts) and sp.get("traced_steps") else None


def read(ctx: dict):
    s = device_s(ctx)
    return None if s is None else 1e3 * s / ctx["spans"]["traced_steps"]
