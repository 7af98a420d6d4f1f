#!/usr/bin/env python3
# scripts/fused_f64_drift.py
"""How far the fused train kernels' parameters drift from a float64 run.

    python3 scripts/fused_f64_drift.py [--batch 288,1024] [--steps 10,60,100]
        [--data cube] [--seeds 0]

At [128,128,2] on chip_smoke.py's data (the 3-cube's 125,000 points, or
uniform 4-column dihedrals with ``--data periodic``), runs the first N steps
of the same batches, for each N of ``--steps``, through the plain version in
float64 and in float32, the plain float32 version again on each batch's rows
in reverse order (the same function, its sums taken in another order), and
each fused kernel that can take the batch, and prints each one's largest
parameter difference from the float64 run and its loss at step N: where the
float32 versions part from it together, and where one of them alone takes
another turn. Seed 0 draws chip_smoke.py's batches; each further seed of
``--seeds`` draws another batch stream from the same weights. Needs a CUDA
card; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", default="288,1024")
    ap.add_argument("--steps", default="10,60,100")
    ap.add_argument("--data", default="cube", choices=("cube", "periodic"))
    ap.add_argument("--seeds", default="0")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_f64_drift.py needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.ops import fused_train as ft

    periodic = args.data == "periodic"
    d0 = 4 if periodic else 3
    steps = [int(n) for n in args.steps.split(",")]
    for B in (int(b) for b in args.batch.split(",")):
        p, flat, n_enc, zeros, data, idx0 = cs._fused_setup(em, ft, d0, periodic, max(steps),
                                                            B=B)
        kw = dict(n_enc=n_enc, hyper=ft.hyper_from(p))
        dims = [flat[0].shape[0]] + [w.shape[1] for w in flat[:len(flat) // 2]]
        kernels = [k for k in cs.FUSED_KERNELS if k == "fused_train"
                   or ft.cluster_footprint(dims, n_enc, B, d0)["total"] <= ft.MAX_SMEM_BYTES]
        f64 = [t.double() for t in flat]
        z64 = [t.double() for t in zeros]
        for seed in (int(s) for s in args.seeds.split(",")):
            idx = idx0 if seed == 0 else torch.as_tensor(
                np.random.default_rng([seed, d0]).integers(0, len(data), idx0.shape),
                device=idx0.device)
            for n in steps:
                q, _, _, met = ft.fused_chunk_plain(f64, z64, z64, 0.0, data.double(),
                                                    idx[:n], **kw)
                runs = {"plain f32": ft.fused_chunk_plain(flat, zeros, zeros, 0.0, data,
                                                          idx[:n], **kw),
                        "plain f32 rows reversed": ft.fused_chunk_plain(
                            flat, zeros, zeros, 0.0, data, idx[:n].flip(1), **kw)}
                for k in kernels:
                    runs[k] = ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx[:n],
                                             kernel=k, **kw)
                print(f"[{args.data} B={B} seed {seed} {n} steps] parameters' largest "
                      f"difference from float64 (loss at step {n}; float64 "
                      f"{float(met[-1, 4]):.5f}): "
                      + ", ".join(f"{k} {cs._max_err(r[0], q):.3e} ({float(r[3][-1, 4]):.5f})"
                                  for k, r in runs.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
