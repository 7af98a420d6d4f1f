# tests/test_torch_tracing.py
"""The port's spans and counters (``misc/profiling.py``) on the CPU: off by
default and then silent, on under ``record_spans``, ``trace`` and
``profile_steps``, placed at the layers of ``train()``, the chunk trainers
and the ADC step, and nested in the profiler's trace as in the code."""

import gzip
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import encodermap_tpu_torch as emt
from encodermap_tpu_torch.misc import profiling as P
from encodermap_tpu_torch.ops import _build
from encodermap_tpu_torch.ops import fused_train as FT

TRAIN = {"train.upload", "train.chunk", "train.fetch", "train.log", "train.persist",
         "train.callback.ProgressBar", "train.callback.NaNInterrupt",
         "train.callback.CheckpointSaver"}
STEP = {"step.forward", "step.backward", "step.optimizer", "step.metrics"}
ADC = {"adc.encode", "adc.decode", "adc.backmap", "adc.losses"}
#: the sidechain backmap's backward, under step.backward
SIDE = {"adc.backmap_backward"}
STEPS, CHUNK, ROWS = 12, 4, 32


def _emap(tmp_path, steps=STEPS):
    data, _ = emt.create_n_cube(3, points_along_edge=10, seed=0)
    p = emt.Parameters(main_path=str(tmp_path / "em"), periodicity=float("inf"),
                       n_steps=steps, steps_per_scan=CHUNK, batch_size=32, seed=3,
                       n_neurons=[16, 16, 2])
    return emt.EncoderMap(p, data, device="cpu")


def _fused(tmp_path):
    """An EncoderMap whose train() takes the fused trainer (its plain
    version on the CPU)."""
    emap = _emap(tmp_path)
    emap._maybe_fused_trainer = lambda steps: FT.make_fused_trainer(
        emap.p, steps, emap.p.batch_size)
    return emap


def _adc(tmp_path, steps=STEPS):
    from encodermap_tpu_torch.ops.backmap import backmap

    rng = np.random.default_rng(0)
    n_atoms, n = 15, 128
    ang = rng.uniform(1.6, 2.4, (n, n_atoms - 2))
    dih = rng.uniform(-3.1, 3.1, (n, n_atoms - 3))
    dist = rng.uniform(0.13, 0.155, (n, n_atoms - 1))
    cart = backmap(*(torch.tensor(x) for x in (dist, ang, dih))).numpy()
    cvs = {"central_angles": ang, "central_dihedrals": dih, "central_cartesians": cart,
           "central_distances": dist, "side_dihedrals": rng.uniform(-3.1, 3.1, (n, 10))}
    ap = emt.ADCParameters(main_path=str(tmp_path / "adc"), n_steps=steps,
                           steps_per_scan=CHUNK, batch_size=32, cartesian_pwd_start=1,
                           cartesian_pwd_step=3, use_backbone_angles=True,
                           use_sidechains=True, n_neurons=[16, 16, 2])
    return emt.AngleDihedralCartesianEncoderMap(cvs, ap, device="cpu")


def _sidechains(tmp_path, steps=STEPS):
    """A reconstruct-mode ADC on trp-cage CVs made from a seed."""
    from chip_smoke import TRP_CAGE_SIDECHAIN_INFO, sidechain_cvs

    ap = emt.ADCParameters(main_path=str(tmp_path / "sidechains"), n_steps=steps,
                           steps_per_scan=CHUNK, batch_size=ROWS, n_neurons=[16, 16, 2],
                           reconstruct_sidechains=True,
                           sidechain_info=TRP_CAGE_SIDECHAIN_INFO, use_backbone_angles=True)
    return emt.AngleDihedralCartesianEncoderMap(sidechain_cvs(128, device="cpu"), ap,
                                                device="cpu")


def _multimer(tmp_path, steps=STEPS):
    """A multimer ADC on a dimer of unequal chains made from a seed."""
    from chip_smoke import dimer_cvs

    ap = emt.ADCParameters(main_path=str(tmp_path / "multimer"), n_steps=steps,
                           steps_per_scan=CHUNK, batch_size=ROWS, n_neurons=[16, 16, 2],
                           multimer_training="homogeneous_transformation",
                           multimer_lengths=[6, 5], cartesian_pwd_start=1,
                           cartesian_pwd_step=3, use_backbone_angles=True,
                           use_sidechains=True)
    return emt.AngleDihedralCartesianEncoderMap(dimer_cvs(128, (6, 5), seed=2, device="cpu"),
                                                ap, device="cpu")


MODELS = {"general": _emap, "fused": _fused, "adc": _adc, "sidechains": _sidechains,
          "multimer": _multimer}


def _side_count() -> dict:
    return dict(P.counter("sidechain_backmap"))


def _multimer_count() -> dict:
    return dict(P.counter("multimer_backmap"))


def _window(fn):
    """Span counts and totals that ``fn()`` added, with spans on. Each
    difference of seconds is rounded to whole nanoseconds, the totals' own
    unit: the difference of two float snapshots of integer nanoseconds can
    be an ULP off, so a span whose earlier totals hold a child could read
    its self time above its total."""
    with P.record_spans():
        before = P.span_totals()
        fn()
        after = P.span_totals()
    zero = P.SpanTotal(0, 0.0, 0.0)

    def ns(a, b):
        return round((a - b) * 1e9) * 1e-9

    return {k: P.SpanTotal(v.count - b.count, ns(v.total_s, b.total_s), ns(v.self_s, b.self_s))
            for k, v in after.items()
            for b in [before.get(k, zero)] if v.count != b.count}


# ------------------------------------------------------------------- off
@pytest.mark.parametrize("profiler", [False, True], ids=["plain", "under_profiler"])
@pytest.mark.parametrize("model", ["general", "adc", "sidechains", "multimer"])
def test_spans_off_record_nothing_and_enter_no_record_function(tmp_path, monkeypatch,
                                                               model, profiler):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    emap = MODELS[model](tmp_path)
    assert not P.spans_enabled()
    before, count, multimer = P.span_totals(), _side_count(), _multimer_count()
    if profiler:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            emap.train()
        names = {e.name for e in prof.events()}
        assert not {n for n in names if n.startswith(("train.", "trainer.", "step.",
                                                      "adc."))}
    else:
        emap.train()
    assert emap.state.step == STEPS
    assert P.span_totals() == before
    assert _side_count() == count and _multimer_count() == multimer
    assert P.span("train.chunk") is P.span("step.forward")  # the shared null context


# -------------------------------------------------------------------- on
@pytest.mark.parametrize("model", ["general", "fused", "adc", "sidechains", "multimer"])
def test_spans_on_mark_every_layer_once_per_step_or_chunk(tmp_path, model):
    emap = MODELS[model](tmp_path)
    count, multimer = _side_count(), _multimer_count()
    got = _window(emap.train)
    moved = {k: v - count.get(k, 0) for k, v in _side_count().items() if v != count.get(k, 0)}
    moved_multimer = {k: v - multimer.get(k, 0) for k, v in _multimer_count().items()
                      if v != multimer.get(k, 0)}
    chunks = STEPS // CHUNK
    per_step = {"fused": {"trainer.draw", "trainer.launch"},
                "general": {"trainer.step"} | STEP,
                "adc": {"trainer.step"} | STEP | ADC,
                "sidechains": {"trainer.step"} | STEP | ADC | SIDE,
                "multimer": {"trainer.step"} | STEP | ADC | SIDE}[model]
    # the sidechain or multimer backmap's calls and rows, forward and
    # backward, a step (and the multimer's two proteins a call)
    rows = {"fwd": STEPS, "rows_fwd": STEPS * ROWS, "bwd": STEPS, "rows_bwd": STEPS * ROWS}
    assert moved == (rows if model == "sidechains" else {})
    assert moved_multimer == ({**rows, "proteins": 2 * STEPS} if model == "multimer" else {})
    assert set(got) == TRAIN | per_step
    for name, tot in got.items():
        if name in ("train.upload", "train.persist"):
            want = 1
        elif name.startswith("train.") or model == "fused":
            want = chunks
        else:
            want = STEPS
        assert tot.count == want, name
        assert 0 <= tot.self_s <= tot.total_s, name
    for child, parent in [(c, "train.chunk") for c in per_step if c.startswith("trainer.")] \
            + [(c, "trainer.step") for c in per_step & STEP] \
            + [(c, "step.forward") for c in per_step & ADC] \
            + [(c, "step.backward") for c in per_step & SIDE]:
        assert got[child].total_s <= got[parent].total_s, (child, parent)
    assert sum(got[c].total_s for c in per_step & STEP) <= got.get(
        "trainer.step", P.SpanTotal(0, 0.0, 0.0)).total_s + 1e-12
    # a parent's self time leaves out its children's
    kids = sum(got[c].total_s for c in per_step if c.startswith("trainer."))
    assert got["train.chunk"].self_s == pytest.approx(got["train.chunk"].total_s - kids,
                                                      abs=1e-6)


def test_record_spans_nests_and_a_span_without_a_name_records_nothing():
    before = P.span_totals()
    with P.record_spans():
        with P.record_spans():
            assert P.spans_enabled()
        assert P.spans_enabled()
        with P.span(None):
            pass
    assert not P.spans_enabled()
    assert P.span_totals() == before


def test_each_thread_keeps_its_own_stack():
    """Spans of two threads do not nest in each other: each one's self time
    leaves out only its own children."""
    barrier = threading.Barrier(2)

    def work(name):
        with P.span(f"test.outer.{name}"):
            barrier.wait(timeout=30)
            with P.span(f"test.inner.{name}"):
                barrier.wait(timeout=30)

    with P.record_spans():
        threads = [threading.Thread(target=work, args=(n,)) for n in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    tot = P.span_totals()
    for n in "ab":
        outer, inner = tot[f"test.outer.{n}"], tot[f"test.inner.{n}"]
        assert outer.self_s == pytest.approx(outer.total_s - inner.total_s, abs=1e-6)
        assert inner.self_s == inner.total_s


# --------------------------------------------------------------- profiler
def _trace_events(logdir: Path) -> list:
    (path,) = logdir.rglob("*.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _within(inner: dict, outers: list) -> bool:
    return any(o["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= o["ts"] + o["dur"]
               for o in outers)


def test_trace_writes_the_spans_nested_under_the_chunk(tmp_path):
    emap = _adc(tmp_path)
    with P.trace(tmp_path / "profile", device="cpu"):
        emap.train()
    assert not P.spans_enabled()
    events = _trace_events(tmp_path / "profile")
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    assert TRAIN | STEP | ADC | {"trainer.step"} <= set(by)
    assert len(by["train.chunk"]) == STEPS // CHUNK
    assert len(by["trainer.step"]) == STEPS
    for name in STEP | ADC | {"trainer.step"}:
        assert all(_within(e, by["train.chunk"]) for e in by[name]), name
    for name in ADC:
        assert all(_within(e, by["step.forward"]) for e in by[name]), name


def test_trace_nests_the_sidechain_backward_under_the_step_backward(tmp_path):
    """One ``adc.backmap_backward`` a step, inside that step's
    ``step.backward``, with the backward's operations inside it."""
    emap = _sidechains(tmp_path)
    with P.trace(tmp_path / "profile", device="cpu"):
        emap.train()
    by = {}
    for e in _trace_events(tmp_path / "profile"):
        by.setdefault(e["name"], []).append(e)
    assert len(by["adc.backmap_backward"]) == len(by["step.backward"]) == STEPS
    assert all(_within(e, by["step.backward"]) for e in by["adc.backmap_backward"])
    inside = [e for e in by.get("aten::cumsum", []) + by.get("aten::mul", [])
              if _within(e, by["adc.backmap_backward"])]
    assert inside


def test_trace_nests_the_multimer_backward_under_the_step_backward(tmp_path):
    """One ``adc.backmap_backward`` a step of multimer training, inside that
    step's ``step.backward``, with the backward of both chains' one-way
    scans and of the placement product inside it."""
    emap = _multimer(tmp_path)
    with P.trace(tmp_path / "profile", device="cpu"):
        emap.train()
    by = {}
    for e in _trace_events(tmp_path / "profile"):
        by.setdefault(e["name"], []).append(e)
    assert len(by["adc.backmap_backward"]) == len(by["step.backward"]) == STEPS
    assert all(_within(e, by["step.backward"]) for e in by["adc.backmap_backward"])
    for name in ("_OneWayBackward", "UnsafeViewBackward0", "BmmBackward0"):
        inside = [e for e in by.get(name, []) if _within(e, by["adc.backmap_backward"])]
        assert len(inside) >= (4 * STEPS if name == "_OneWayBackward" else STEPS), name


def test_multimer_training_with_spans_on_equals_training_with_them_off(tmp_path):
    """A multimer ADC trained with the spans on ends bit for bit where one
    trained with them off ends: the backmap's backward takes one route
    whatever the spans."""
    def train(name):
        emap = _multimer(tmp_path / name)
        emap.train()
        return [t.clone() for t in torch.utils._pytree.tree_leaves(emap.state.params)]

    off = train("off")
    with P.record_spans():
        on = train("on")
    assert len(on) == len(off)
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_profile_steps_traces_the_spans(tmp_path):
    emap = _emap(tmp_path)
    emap.read_only = True
    P.profile_steps(emap, n_steps=2, logdir=tmp_path / "profile")
    names = {e["name"] for e in _trace_events(tmp_path / "profile")}
    assert {"trainer.step"} | STEP <= names


# --------------------------------------------------------------- counters
def test_launch_counts_is_the_registrys_launches():
    from encodermap_tpu_torch import _tracing

    assert _build.launch_counts is P.launches is P.counter("launches")
    for name in ("span", "record_spans", "spans_enabled", "span_totals", "SpanTotal",
                 "counter", "launches", "_counters"):
        assert getattr(P, name) is getattr(_tracing, name), name
    c = P.counter("test.counter")
    c["x"] += 2
    assert P.counter("test.counter")["x"] == 2
