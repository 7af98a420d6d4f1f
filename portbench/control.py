#!/usr/bin/env python3
"""The controls of a cell's comparison: what the numbers that decide
``correct`` read when the plain reference stands in the program's place,
computed lower than the configuration states, or with a fault planted.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--frames N]

Each seed makes the cell's data, weights and checked rows as a run does
(``harness.prepare``), follows the float64 reference, and compares with it
(``harness.compare``):

* ``tf32``: the reference in float32 with TF32 on in its matrix products,
  the precision below the configuration's float32 with TF32 off;
* ``float32``: the reference in float32, TF32 off (a sound run's scale);
* ``half_batch``: the float64 reference on the first half of each batch,
  the mean taken over it (a step that leaves half the batch out);
* ``update_x1.3``: every update 1.3 times too long (a wrong learning rate
  or bias correction);
* ``fixed_t``: the multi-step chunk's later steps take Adam's bias
  correction of its first step (a step count that does not advance);
* ``same_batch``: the multi-step chunk trains each of its steps on its
  first batch (a gather that does not advance).

A state left unchanged reads 1 in ``grad_gap`` and the change gaps by
construction (no gradient in the optimizer's state, no change) and needs
no run. Prints one JSON line per seed and control.
"""

import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import plain  # noqa: E402


@contextlib.contextmanager
def adam_count_stops_at(step: int):
    """The reference's Adam with the bias correction of ``step`` for every
    later step."""
    adam = plain.adam
    plain.adam = lambda W, g, m, v, t, lr, **kw: adam(W, g, m, v, min(t, step), lr, **kw)
    try:
        yield
    finally:
        plain.adam = adam


def readings(cell_name: str, seed: int, device, frames=None) -> dict:
    """``{control: compare(...)}`` for one seed."""
    cell = harness.load_cell(cell_name)
    p = cell["config"]["parameters"]
    data, reference, weights, rows = harness.prepare(cell, seed, device, frames)
    weights = {k: v.cpu() for k, v in weights.items()}
    same = rows.copy()
    same[2:] = rows[1]

    def follow(r, dtype, params=p):
        return reference.follow(params, weights, data, r, dtype, device)

    with plain.tf32(False):
        ref = follow(rows, torch.float64)
        out = {"float32": follow(rows, torch.float32),
               "half_batch": follow(rows[:, :p["batch_size"] // 2], torch.float64),
               "update_x1.3": follow(rows, torch.float64,
                                     dict(p, learning_rate=1.3 * p["learning_rate"])),
               "same_batch": follow(same, torch.float64)}
        with adam_count_stops_at(2):
            out["fixed_t"] = follow(rows, torch.float64)
    with plain.tf32(True):
        out["tf32"] = follow(rows, torch.float32)
    return {k: harness.compare(v, ref) for k, v in out.items()}


def main(argv: list) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls run on the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        for control, numbers in readings(args.workload, seed, "cuda", args.frames).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                              **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
