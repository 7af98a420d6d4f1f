"""multimer_backmap_roofline.adc: The multimer backmap's least time, forward
and backward, over its device time (``device_s`` of
multimer_backmap_ms_per_step.adc), in %. The least time is the compulsory
bytes at the card's HBM peak: forward, each row reads its internal
coordinates (``n_atoms - c`` bond lengths, ``n_atoms - 2 c`` angles and
``n_atoms - 3 c`` dihedrals of its ``c`` chains) and the ``16 (c - 1)``
transform entries and writes ``3 n_atoms`` coordinates; backward, it reads
the coordinates' cotangents and the same inputs and writes the gradients of
the decoded angles, dihedrals and transform entries (the bond lengths are
data, batch means, and take none); float32, as the configuration trains.
The rows and chains are the program's counter ``multimer_backmap`` over the
traced chunks (``proteins`` over ``fwd`` chains a call). It counts the work,
not a kernel: a later kernel is held to the same bound. Nothing where the
counter or the spans are not there."""

from pathlib import Path

from portbench import costs, harness

LAYER = "Kernels"
UNIT = "%"
MOVES = "adc_device_ms_per_step"
BYTES = 4


def row_bytes(n_atoms: int, chains: int) -> tuple[int, int]:
    """Compulsory bytes of one row, forward and backward."""
    bonds, angles, dihedrals = n_atoms - chains, n_atoms - 2 * chains, n_atoms - 3 * chains
    decoded = angles + dihedrals + 16 * (chains - 1)
    coords = 3 * n_atoms
    return BYTES * (bonds + decoded + coords), BYTES * (coords + bonds + 2 * decoded)


def read(ctx: dict):
    timed = harness.load_module(Path(__file__).with_name(
        "multimer_backmap_ms_per_step.adc.py"), "portbench_metric_multimer_backmap_s")
    dev_s = timed.device_s(ctx)
    rows = ((ctx.get("spans") or {}).get("counters") or {}).get("multimer_backmap", {})
    if dev_s is None or not rows.get("rows_fwd") or not rows.get("rows_bwd") \
            or not rows.get("proteins"):
        return None
    fwd, bwd = row_bytes(ctx["shapes"]["n_atoms"], rows["proteins"] // rows["fwd"])
    least_s = (rows["rows_fwd"] * fwd + rows["rows_bwd"] * bwd) / costs.PEAK_BYTES_PER_S
    return 100.0 * least_s / dev_s
