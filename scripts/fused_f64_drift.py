#!/usr/bin/env python3
# scripts/fused_f64_drift.py
"""How far the train routes' parameters drift from a float64 run.

    python3 scripts/fused_f64_drift.py [--route fused] [--batch 288,1024]
        [--steps 10,60,100] [--data cube] [--seeds 0]

``--route fused`` (the default): at [128,128,2] on chip_smoke.py's data (the
3-cube's 125,000 points, uniform 4-column dihedrals with ``--data
periodic``, or config 5's million 6-feature frames with ``--data
config5``), runs the same batches through the fused kernels' plain version
in float64 and in float32, the plain float32 version again on each batch's
rows in reverse order (the same function, its sums taken in another order),
and each fused kernel that can take the batch (``chip_smoke.fused_drift_runs``),
and reads each run after N steps for each N of ``--steps``.

``--route general``: the same four ways for the general route's step
(``chip_smoke.general_f64_runs``): float64 and float32 with the sketch-map
loss through ``sigmoid_loss_general``, float32 on reversed rows, and
``EncoderMap(fused_trainer=False)``'s own step through the sigmoid-loss
kernels.

Prints each run's largest parameter difference from the float64 run (and
the tensor that holds it), its metrics' and moments' distances
(``chip_smoke.f64_distances``) and its loss at step N, then, for each batch size and N, how many runs of each kind
left the float64 run (a difference past ``chip_smoke.F64_PART``), their
median distance from it, and how often each fails ``chip_smoke.f64_rule``
where ``chip_smoke.f64_gate`` lets the rule apply: where the
float32 versions part from it together, and where one of them alone takes
another turn. Seed 0 draws chip_smoke.py's batches (config 5: the stream
of every other seed, ``np.random.default_rng([seed, 6])``); each further
seed another batch stream from the same weights. Needs a CUDA card; prints
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _worst(params: list, ref: list) -> int:
    """Index of the tensor that holds the largest difference."""
    errs = [float((a.double() - b.double()).abs().max()) for a, b in zip(params, ref)]
    return errs.index(max(errs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", default="fused", choices=("fused", "general"))
    ap.add_argument("--batch", default="288,1024")
    ap.add_argument("--steps", default="10,60,100")
    ap.add_argument("--data", default="cube", choices=("cube", "periodic", "config5"))
    ap.add_argument("--seeds", default="0")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fused_f64_drift.py needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.ops import fused_train as ft

    steps = [int(n) for n in args.steps.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    counts: dict = {}
    for B in (int(b) for b in args.batch.split(",")):
        for seed in seeds:
            if args.route == "general":
                res = cs.general_f64_runs(em, args.data, B, seed, steps)
            else:
                res = cs.fused_drift_runs(em, ft, args.data, B, seed, steps)
            for n in steps:
                dist = cs.f64_distances(res[n])
                loss64 = dist.pop("f64")["loss"]
                p64 = res[n]["f64"][0]
                print(f"[{args.route} {args.data} B={B} seed {seed} {n} steps] from float64, "
                      f"parameters (the tensor of the largest difference), metrics, "
                      f"moments (loss at step {n}; float64 {loss64:.5f}): "
                      + ", ".join(f"{k} {d['params']:.3e} (tensor {_worst(res[n][k][0], p64)}) "
                                  f"{d['metrics']:.3e} {d['moments']:.3e} ({d['loss']:.5f})"
                                  for k, d in dist.items()), flush=True)
                gated = not cs.f64_gate(dist)
                for k, d in dist.items():
                    counts.setdefault((B, n, k), []).append(
                        (d["params"], gated, gated and not cs.f64_rule(dist, k)))
            del res
    for B, n in dict.fromkeys((B, n) for B, n, _ in counts):
        print(f"[{args.route} {args.data} B={B} {n} steps] left float64 (past "
              f"{cs.F64_PART:g}; median distance; fails the 3x rule where "
              "f64_gate applies): "
              + ", ".join(f"{k} {sum(x > cs.F64_PART for x, _, _ in c)} of {len(c)} "
                          f"({statistics.median(x for x, _, _ in c):.3e}; "
                          f"{sum(f for _, _, f in c)} of {sum(g for _, g, _ in c)})"
                          for (b, m, k), c in counts.items() if (b, m) == (B, n)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
