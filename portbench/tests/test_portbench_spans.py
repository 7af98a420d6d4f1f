"""The program's spans in a trace (``portbench/spans.py``): idle gaps and
device time put down to spans on synthetic events, and a cell's run with
the spans on, on the CPU."""

import contextlib
import sys
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import spans
from portbench.tests.conftest import SEED, TINY_FRAMES


def _ev(name, start, end, device=DeviceType.CPU, id=0, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, id=id, thread=thread)


def _kernel(start, end, id):
    return _ev("elementwise_kernel", start, end, DeviceType.CUDA, id)


#: one step on the host (µs): step.forward 0-100 with adc.backmap 40-80 in
#: it, step.backward 100-200, and train.log 300-320 after the step; the
#: backward's kernel is launched from autograd's device thread (thread 2)
STEP = [
    _ev("trainer.step", 0, 250),
    _ev("step.forward", 0, 100),
    _ev("adc.backmap", 40, 80),
    _ev("cudaLaunchKernel", 50, 52, id=11),
    _ev("step.backward", 100, 200),
    _ev("cudaLaunchKernel", 150, 152, id=12, thread=2),
    _ev("train.log", 300, 320),
    _ev("cudaMemcpyAsync", 400, 401, id=13),
    _ev("aten::mul", 45, 55),
    _kernel(60, 90, 11),       # launched in adc.backmap
    _kernel(160, 170, 12),     # launched from thread 2 in step.backward
    _kernel(410, 415, 13),     # launched outside every span
    _kernel(600, 604, 99),     # its launch is not in the trace
    _ev("step.backward", 160, 170, DeviceType.CUDA),   # a span's mirror on the device
]


def test_an_idle_gap_is_cut_along_the_innermost_spans_it_overlaps():
    got = spans.summarize(STEP)
    # gap 90-160: step.forward to 100, then step.backward; gap 170-410:
    # step.backward to 200, trainer.step's own time to 250, none to 300,
    # train.log to 320, none after; gap 415-600: none
    assert got["idle_s"] == pytest.approx({
        "step.forward": 10e-6, "step.backward": 90e-6, "trainer.step": 50e-6,
        "train.log": 20e-6, spans.OUTSIDE: (50 + 90 + 185) * 1e-6})
    assert got["idle_total_s"] == pytest.approx(495e-6)
    # a span started later is the innermost where two overlap
    moved = spans.summarize(STEP + [_ev("train.fetch", 280, 310)])
    assert moved["idle_s"]["train.fetch"] == pytest.approx(20e-6)
    assert moved["idle_s"]["train.log"] == pytest.approx(20e-6)
    assert moved["span_counts"]["train.fetch"] == 1


def test_device_time_goes_to_the_spans_open_at_its_launch_whatever_thread():
    got = spans.summarize(STEP)
    assert got["device_s"] == pytest.approx({"adc.backmap": 30e-6, "step.backward": 10e-6,
                                             spans.OUTSIDE: 5e-6 + 4e-6})
    incl = got["device_incl_s"]
    assert incl["step.forward"] == pytest.approx(30e-6)   # adc.backmap's kernel
    assert incl["step.backward"] == pytest.approx(10e-6)
    assert incl["trainer.step"] == pytest.approx(40e-6)
    assert got["unlinked_s"] == pytest.approx(4e-6)
    assert got["annotations"] == 1
    assert got["busy_s"] == pytest.approx(49e-6)
    assert got["device_total_s"] == pytest.approx(49e-6)


def test_time_outside_every_span_is_reported_as_such():
    got = spans.summarize([_kernel(0, 10, 1), _kernel(20, 30, 2),
                           _ev("cudaLaunchKernel", 0, 1, id=1),
                           _ev("cudaLaunchKernel", 5, 6, id=2)])
    assert got["idle_s"] == pytest.approx({spans.OUTSIDE: 10e-6})
    assert spans.summarize([_kernel(0, 10, 1)])["idle_s"] == {}
    assert got["device_s"] == pytest.approx({spans.OUTSIDE: 20e-6})
    assert got["device_incl_s"] == {}


def test_readings_split_the_idle_time_and_read_the_windows():
    sp = {"trace": spans.summarize(STEP), "traced_chunks": 1, "traced_steps": 1,
          "setup": {"train.upload": (2, 1.5, 1.5)},
          "window": {"trainer.step": (10, 0.15, 0.01)}}
    got = spans.readings(sp)
    assert got["entry_idle_ms_per_chunk"] == pytest.approx(1e3 * 345e-6)
    assert got["trainer_idle_ms_per_chunk"] == pytest.approx(1e3 * 150e-6)
    assert got["forward_device_ms_per_step"] == pytest.approx(0.03)
    assert got["backward_device_ms_per_step"] == pytest.approx(0.01)
    assert "optimizer_device_ms_per_step" not in got
    assert got["dispatch_ms_per_step"] == pytest.approx(15.0)
    assert got["upload_s"] == 1.5
    assert spans.readings({}) == {}


def test_window_subtracts_two_snapshots():
    before = {"a": (1, 1.0, 0.5), "b": (2, 2.0, 2.0)}
    after = {"a": (3, 4.0, 1.5), "b": (2, 2.0, 2.0), "c": (1, 0.1, 0.1)}
    assert spans.window(before, after) == {"a": (2, 3.0, 1.0), "c": (1, 0.1, 0.1)}


def test_a_traced_run_with_spans_on_reads_the_window_and_the_setup():
    cell = "em-ala2-b256"
    with contextlib.redirect_stdout(sys.stderr):
        result, sp = spans.traced_run(cell, SEED, 0.01, time.perf_counter(), device="cpu",
                                      frames=TINY_FRAMES[cell], trace_chunks=1)
    assert result["correct"], result["checks"]
    # the window's steps, counted by the program's spans and by the harness
    assert sp["window"]["trainer.step"][0] == result["attempted"]
    assert sp["window"]["train.chunk"][0] == result["attempted"] // 100
    assert sp["traced_chunks"] == 1 and sp["traced_steps"] == 100
    # the traced chunk's spans are in the trace, nested: no device on the CPU
    assert sp["trace"]["span_counts"]["trainer.step"] == 100
    got = spans.readings(sp)
    assert set(got) == {"dispatch_ms_per_step", "upload_s"}
    from encodermap_tpu_torch.misc import profiling

    assert not profiling.spans_enabled()


def test_the_cost_run_times_blocks_with_spans_off_and_on():
    with contextlib.redirect_stdout(sys.stderr):
        got = spans.cost_run("em-ala2-b256", SEED, blocks=1, chunks=1, device="cpu",
                             frames=TINY_FRAMES["em-ala2-b256"])
    assert [b["on"] for b in got["blocks"]] == [False, True]
    assert got["pairs_on_slower"] in (0, 1)
    assert got["span_us"]["on"] > got["span_us"]["off"] > 0
    # spans counted in the block with spans on only: one chunk of 100 steps
    assert got["spans_on"]["trainer.step"][0] == 100
    assert got["spans_on"]["train.chunk"][0] == 1
