"""The ADC's multimer cell, ``adc-diubi-dimer-b256``, on the CPU: the
cell's files in a copy of the checkout, shrunk to a trp-cage homodimer and
B=64 so that a run fits a CPU test, come out correct with the program's
span and counter of the multimer backmap read over the traced chunk, and
the planted faults that the ADC's numbers catch come out not correct."""

import contextlib
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

from portbench import harness

CELL = "adc-diubi-dimer-b256"
FRAMES, BATCH, CHUNK = 1200, 64, 20
SEED = 2 ** 31 + 977
FAULTS = harness.load_module(Path(__file__).with_name("test_portbench_faults.py"),
                             "portbench_test_faults")


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """A copy of the benchmark whose multimer cell trains a trp-cage dimer
    ([20, 20], 40 CAs) at B=64 in chunks of 20 steps."""
    out = tmp_path_factory.mktemp("multimer")
    shutil.copy(harness.ROOT / "BENCHMARK.json", out)
    shutil.copytree(harness.ROOT / "portbench", out / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = out / "portbench" / "configs" / "adc-multimer-128-128-2.json"
    c = json.loads(cfg.read_text())
    c["parameters"].update(multimer_lengths=[20, 20], batch_size=BATCH, steps_per_scan=CHUNK)
    cfg.write_text(json.dumps(c))
    mix = out / "portbench" / "traffic" / "diubi-dimer-cvs-500k.json"
    t = json.loads(mix.read_text())
    t["protein"] = {"name": "trp-cage"}
    mix.write_text(json.dumps(t))
    return out


def _run(root, trace=False, context=None):
    with contextlib.redirect_stdout(sys.stderr):
        return harness.run(CELL, SEED, 0.01, trace, time.perf_counter(), device="cpu",
                           frames=FRAMES, root=root, trace_chunks=1, context=context)


def test_a_run_is_correct_and_its_backmap_is_counted_and_spanned(root):
    ctx: dict = {}
    r = _run(root, trace=True, context=ctx)
    assert r["correct"], r["checks"]
    sp = ctx["spans"]
    steps = sp["traced_steps"]
    assert steps == CHUNK
    assert sp["counters"]["multimer_backmap"] == {
        "fwd": steps, "rows_fwd": BATCH * steps, "proteins": 2 * steps, "bwd": steps,
        "rows_bwd": BATCH * steps}
    assert sp["window"]["adc.backmap_backward"][0] == steps
    assert sp["window"]["adc.backmap"][0] == steps
    s = ctx["shapes"]
    assert s["dims"][0] == 2 * 304 + 780 and s["dims"][-1] == 2 * 304 + 16
    assert (s["enc_d"], s["n_atoms"], s["n_ca"]) == (304, 120, 40)
    # the CPU's trace holds no device operation: the readers find nothing
    for name in ("multimer_backmap_ms_per_step.adc", "multimer_backmap_roofline.adc"):
        assert name not in r["metrics"]


#: the faults the cell's numbers catch, as in the other ADC cells: the
#: multi-step chunk's two faults read inside the program's float32 tail of
#: the later steps' numbers (PERF.md §2)
CAUGHT = (FAULTS._unchanged, FAULTS._half_batch, FAULTS._update_x1_3)


@pytest.mark.parametrize("fault", CAUGHT, ids=lambda f: f.__name__)
def test_a_broken_train_step_is_not_correct(root, monkeypatch, fault):
    from encodermap_tpu_torch.train.autoencoder import Autoencoder

    make = Autoencoder._make_train_step
    monkeypatch.setattr(Autoencoder, "_make_train_step", lambda self: fault(make(self)))
    r = _run(root)
    assert not r["correct"]
    assert [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
