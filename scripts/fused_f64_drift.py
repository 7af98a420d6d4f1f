#!/usr/bin/env python3
# scripts/fused_f64_drift.py
"""How far the train routes' parameters drift from a float64 run.

    python3 scripts/fused_f64_drift.py [--route fused] [--batch 288,1024]
        [--steps 10,60,100] [--data cube] [--seeds 0]

``--route fused`` (the default): at [128,128,2] on chip_smoke.py's data (the
3-cube's 125,000 points, or uniform 4-column dihedrals with ``--data
periodic``), runs the same batches through the fused kernels' plain version
in float64 and in float32, the plain float32 version again on each batch's
rows in reverse order (the same function, its sums taken in another order),
and each fused kernel that can take the batch (``chip_smoke.fused_f64_runs``),
and reads each run after N steps for each N of ``--steps``.

``--route general``: the same four ways for the general route's step
(``chip_smoke.general_f64_runs``): float64 and float32 with the sketch-map
loss through ``sigmoid_loss_general``, float32 on reversed rows, and
``EncoderMap(fused_trainer=False)``'s own step through the sigmoid-loss
kernels; ``--data config5`` takes config 5's million 6-feature frames.

Prints each run's largest parameter difference from the float64 run and its
loss at step N, then, for each batch size and N, how many runs of each kind
left the float64 run (a difference past ``chip_smoke.F64_PART``): where the
float32 versions part from it together, and where one of them alone takes
another turn. Seed 0 draws chip_smoke.py's batches (config 5: the stream
of every other seed, ``np.random.default_rng([seed, 6])``); each further
seed another batch stream from the same weights. Needs a CUDA card; prints
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


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
    if args.route == "fused" and args.data == "config5":
        ap.error("--data config5 is a general-route shape")
    import chip_smoke as cs
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.ops import fused_train as ft

    periodic = args.data == "periodic"
    d0 = 4 if periodic else 3
    steps = [int(n) for n in args.steps.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    counts: dict = {}
    for B in (int(b) for b in args.batch.split(",")):
        if args.route == "fused":
            p, flat, n_enc, zeros, data, _ = cs._fused_setup(em, ft, d0, periodic, 1, B=B)
            kw = dict(n_enc=n_enc, hyper=ft.hyper_from(p))
            dims = [flat[0].shape[0]] + [w.shape[1] for w in flat[:len(flat) // 2]]
            kernels = [k for k in cs.FUSED_KERNELS if k == "fused_train" or
                       ft.cluster_footprint(dims, n_enc, B, d0)["total"] <= ft.MAX_SMEM_BYTES]
        for seed in seeds:
            if args.route == "general":
                res = cs.general_f64_runs(em, args.data, B, seed, steps)
            else:
                idx = torch.as_tensor(cs.drift_setup(em, args.data, B, seed, max(steps))[2],
                                      device="cuda")
                res = cs.fused_f64_runs(ft, flat, zeros, kw, data, idx, kernels, steps)
            for n in steps:
                dist = cs.f64_distances(res[n])
                loss64 = dist.pop("f64")["loss"]
                print(f"[{args.route} {args.data} B={B} seed {seed} {n} steps] parameters' "
                      f"largest difference from float64 (loss at step {n}; float64 "
                      f"{loss64:.5f}): "
                      + ", ".join(f"{k} {d['params']:.3e} ({d['loss']:.5f})"
                                  for k, d in dist.items()), flush=True)
                for k, d in dist.items():
                    c = counts.setdefault((B, n, k), [0, 0])
                    c[0] += d["params"] > cs.F64_PART
                    c[1] += 1
            del res
    for B, n in dict.fromkeys((B, n) for B, n, _ in counts):
        print(f"[{args.route} {args.data} B={B} {n} steps] left float64 (past "
              f"{cs.F64_PART:g}): " + ", ".join(f"{k} {c[0]} of {c[1]}"
                                                 for (b, m, k), c in counts.items()
                                                 if (b, m) == (B, n)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
