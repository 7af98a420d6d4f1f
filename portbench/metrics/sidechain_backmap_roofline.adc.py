"""sidechain_backmap_roofline.adc: The sidechain backmap's least time,
forward and backward, over its device time (``device_s`` of
sidechain_backmap_ms_per_step.adc), in %. The least time is the
compulsory bytes at the card's HBM peak: forward, each row reads its
internal coordinates (the four angle groups the decoder gives, ``enc_d``
values, and ``n_atoms - 1`` bond lengths) and writes ``3 n_atoms``
coordinates; backward, it reads the coordinates' cotangents and the
internal coordinates and writes the gradients of the four angle groups;
float32, as the configuration trains. The rows are the program's counter
``sidechain_backmap`` over the traced chunks. It counts the work, not a
kernel: a later kernel is held to the same bound. Nothing where the
counter or the spans are not there."""

from pathlib import Path

from portbench import costs, harness

LAYER = "Kernels"
UNIT = "%"
MOVES = "adc_device_ms_per_step"
BYTES = 4


def row_bytes(enc_d: int, n_atoms: int) -> tuple[int, int]:
    """Compulsory bytes of one row, forward and backward."""
    inputs, coords = enc_d + n_atoms - 1, 3 * n_atoms
    return BYTES * (inputs + coords), BYTES * (coords + inputs + enc_d)


def read(ctx: dict):
    timed = harness.load_module(Path(__file__).with_name(
        "sidechain_backmap_ms_per_step.adc.py"), "portbench_metric_sidechain_backmap_s")
    dev_s = timed.device_s(ctx)
    rows = ((ctx.get("spans") or {}).get("counters") or {}).get("sidechain_backmap", {})
    if dev_s is None or not rows.get("rows_fwd") or not rows.get("rows_bwd"):
        return None
    fwd, bwd = row_bytes(ctx["shapes"]["enc_d"], ctx["shapes"]["n_atoms"])
    least_s = (rows["rows_fwd"] * fwd + rows["rows_bwd"] * bwd) / costs.PEAK_BYTES_PER_S
    return 100.0 * least_s / dev_s
