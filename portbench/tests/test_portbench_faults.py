"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip is skipped and the rest of a run is driven on
the CPU, with a fault planted in the program's train step."""

import pytest

from encodermap_tpu_torch.train.autoencoder import Autoencoder
from encodermap_tpu_torch.train.core import tree_leaves, tree_unflatten


def _unchanged(step):
    def broken(state, batch):
        _, metrics = step(state, batch)
        return state.replace(step=state.step + 1), metrics

    return broken


def _half_batch(step):
    def broken(state, batch):
        if isinstance(batch, tuple):
            half = tuple(b[:len(b) // 2] for b in batch)
        else:
            half = batch[:len(batch) // 2]
        return step(state, half)

    return broken


def _update_x1_3(step):
    """Every update 1.3 times too long: a wrong learning rate."""
    def broken(state, batch):
        new, metrics = step(state, batch)
        params = [a + 1.3 * (b - a) for a, b in
                  zip(tree_leaves(state.params), tree_leaves(new.params))]
        return new.replace(params=tree_unflatten(new.params, params)), metrics

    return broken


def _count_stops(step):
    """From the third step on, Adam takes the second step's count: the
    multi-step chunk's later steps take its first step's bias correction."""
    def broken(state, batch):
        count = state.opt_state["count"]
        if count < 2:
            return step(state, batch)
        new, metrics = step(state.replace(opt_state={**state.opt_state, "count": 1}), batch)
        return new.replace(opt_state={**new.opt_state, "count": count + 1}), metrics

    return broken


def _same_batch(step):
    """From the third step on, each step trains on the second step's batch:
    a gather that does not advance in the multi-step chunk."""
    seen = []

    def broken(state, batch):
        if state.step == 1:
            seen.append(batch)
        return step(state, seen[0] if state.step > 1 and seen else batch)

    return broken


#: the faults each cell's numbers catch on every seed; the ADC's later-step
#: numbers carry too much of Adam's rounding to catch the chunk's two faults
#: (PERF.md)
FAULTS = {"em-ala2-b256": [_unchanged, _half_batch, _update_x1_3, _count_stops, _same_batch],
          "adc-trpcage-b256": [_unchanged, _half_batch, _update_x1_3]}


@pytest.mark.parametrize("cell, fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_broken_train_step_is_not_correct(cpu_run, monkeypatch, cell, fault):
    make = Autoencoder._make_train_step
    monkeypatch.setattr(Autoencoder, "_make_train_step",
                        lambda self: fault(make(self)))
    r = cpu_run(cell)
    assert not r["correct"]
    failed = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert failed
    if fault is _unchanged:
        # the worst leaf reads 1; the median leaf at least a half (the
        # leaves at or above the median leaf's norm read 1)
        held = {k: c["value"] for k, c in r["checks"].items()
                if k.startswith(("grad_", "change_"))}
        assert {k[:4] for k in held} == {"grad", "chan"}
        for k, v in held.items():
            assert v >= 0.5 if "_med_" in k else v == pytest.approx(1.0), (k, v)
