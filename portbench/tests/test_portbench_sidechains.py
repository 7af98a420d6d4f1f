"""The ADC's sidechain-reconstruction cell, ``adc-trpcage-sidechains-b256``,
on the CPU: a run comes out correct at a small frame count with the
program's span and counter of the sidechain backmap read over its traced
chunk, the reference's sweep places every atom where the program's
backmaps do, and the planted faults of ``test_portbench_faults.py`` that
the ADC's numbers catch come out not correct."""

import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import sidechains

CELL = "adc-trpcage-sidechains-b256"
#: enough rows for the checked steps' four batches of different rows
FRAMES = 1200
SEED = 2 ** 31 + 977
FAULTS = harness.load_module(Path(__file__).with_name("test_portbench_faults.py"),
                             "portbench_test_faults")


def _run(trace=False, seed=SEED, context=None):
    with contextlib.redirect_stdout(sys.stderr):
        return harness.run(CELL, seed, 0.01, trace, time.perf_counter(), device="cpu",
                           frames=FRAMES, trace_chunks=1, context=context)


def _metric(name: str):
    return harness.load_module(harness.ROOT / "portbench" / "metrics" / f"{name}.py",
                               "portbench_metric_" + name.replace(".", "_"))


def test_a_run_is_correct_and_its_backmap_is_counted_and_spanned():
    ctx: dict = {}
    r = _run(trace=True, context=ctx)
    assert r["correct"], r["checks"]
    sp = ctx["spans"]
    steps = sp["traced_steps"]
    assert steps == 100
    assert sp["counters"]["sidechain_backmap"] == {"fwd": steps, "rows_fwd": 256 * steps,
                                                   "bwd": steps, "rows_bwd": 256 * steps}
    assert sp["window"]["adc.backmap_backward"][0] == steps
    assert sp["window"]["adc.backmap"][0] == steps
    assert ctx["shapes"]["enc_d"] == 206 and ctx["shapes"]["n_atoms"] == 114
    assert ctx["shapes"]["n_ca"] == 37
    # the CPU's trace holds no device operation: the readers find nothing
    for name in ("sidechain_backmap_ms_per_step.adc", "sidechain_backmap_roofline.adc"):
        assert name not in r["metrics"]
        assert _metric(name).read(ctx) is None


def test_the_backmap_readers_read_the_spans_and_the_counter():
    """From a traced run's context: the device time under the backmap's two
    spans a step, and its compulsory bytes (2,644 a row forward and 3,468
    backward on trp-cage in float32) at the card's peak over that time;
    nothing where the backward has no span or the counter is missing, as
    on a program without them."""
    ms, roof = _metric("sidechain_backmap_ms_per_step.adc"), _metric(
        "sidechain_backmap_roofline.adc")
    assert roof.row_bytes(206, 114) == (2644, 3468)
    rows = {"fwd": 100, "rows_fwd": 25600, "bwd": 100, "rows_bwd": 25600}
    ctx = {"shapes": {"enc_d": 206, "n_atoms": 114},
           "spans": {"traced_steps": 100, "counters": {"sidechain_backmap": rows},
                     "trace": {"device_incl_s": {"adc.backmap": 0.05,
                                                 "adc.backmap_backward": 0.10}}}}
    assert ms.read(ctx) == pytest.approx(1.5)
    least = 25600 * (2644 + 3468) / 3.35e12
    assert roof.read(ctx) == pytest.approx(100 * least / 0.15)
    no_backward = {"device_incl_s": {"adc.backmap": 0.05}}
    parent = {**ctx, "spans": {**ctx["spans"], "trace": no_backward}}
    assert ms.read(parent) is None and roof.read(parent) is None
    no_counter = {**ctx, "spans": {**ctx["spans"], "counters": {}}}
    assert roof.read(no_counter) is None and ms.read(no_counter) == pytest.approx(1.5)
    assert ms.read({}) is None and roof.read({}) is None


@pytest.mark.parametrize("signs", ["in_range", "either_sign"])
def test_the_reference_sweep_places_every_atom_as_the_program_does(signs):
    """The reference's sweep against the program's sequential sweep
    measured exactly and its fast form, float64, B=8, on the cell's
    trp-cage: data in the traffic's ranges, and angles on (-pi, pi] as
    the decoder gives them."""
    from encodermap_tpu_torch.ops import backmap_sidechains as prog

    cell = harness.load_cell(CELL)
    info = cell["config"]["parameters"]["sidechain_info"]
    spec = prog.make_spec({int(k): int(v) for k, v in info.items()})
    data = harness.make_data(cell, SEED, "cpu", 8)
    order = ("central_distances", "central_angles", "central_dihedrals", "side_distances",
             "side_angles", "side_dihedrals")
    x = [torch.as_tensor(data[k], dtype=torch.float64) for k in order]
    if signs == "either_sign":
        gen = torch.Generator().manual_seed(5)
        for i in (1, 4):
            x[i] = (2 * torch.rand(x[i].shape, generator=gen, dtype=torch.float64) - 1) * np.pi
    ref = sidechains.sweep(info, *x)
    assert ref.shape == (8, 114, 3)
    for got in (prog.backmap_sidechains(spec, *x, angle_clip=None),
                prog.backmap_sidechains_fast(spec, *x)):
        assert float((got - ref).abs().max()) < 1e-9
    if signs == "in_range":
        # the traffic's coordinates are the sweep's, in float32
        xyz = torch.as_tensor(data["all_cartesians"], dtype=torch.float64)
        assert float((xyz - ref).abs().max()) < 1e-5


#: the faults the cell's numbers catch on every seed: as in the backbone
#: ADC cell, the multi-step chunk's two faults (Adam's count stops, the same
#: batch again) read inside the program's float32 tail of the later steps'
#: numbers, which its limits leave room for (PERF.md §2)
CAUGHT = (FAULTS._unchanged, FAULTS._half_batch, FAULTS._update_x1_3)


@pytest.mark.parametrize("fault", CAUGHT, ids=lambda f: f.__name__)
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    from encodermap_tpu_torch.train.autoencoder import Autoencoder

    make = Autoencoder._make_train_step
    monkeypatch.setattr(Autoencoder, "_make_train_step", lambda self: fault(make(self)))
    r = _run()
    assert not r["correct"]
    assert [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
