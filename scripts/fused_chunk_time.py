#!/usr/bin/env python3
# scripts/fused_chunk_time.py
"""Time a fused train kernel of encodermap_tpu_torch on one CUDA card.

    python3 scripts/fused_chunk_time.py [--root DIR] [--kernel NAME]
        [--batch B] [--neurons 128,128,2] [--steps N] [--data cube,periodic]

Imports ``encodermap_tpu_torch`` from ``DIR`` (default: this checkout), so
that two trees (a ``git archive`` of each under ``build/``) can be timed one
after the other on the same card, and times a chunk of ``--steps`` steps
(default 500) of ``fused_chunk`` with ``--kernel`` (``fused_train_cluster``,
the default, or ``fused_train``, the grid kernel) at batch ``--batch``
(default 256) and widths ``--neurons`` (default the main configuration
[128,128,2]), on cube (d0=3) and periodic (d0=4) data, by CUDA events: 5
chunks after a warm-up. Where the tree's kernel has a cycle trace, it also
prints the split of a step by phase. Prints the card's name and power limit
and one JSON line of the times.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kernel", default="fused_train_cluster",
                    choices=("fused_train_cluster", "fused_train"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--neurons", default="128,128,2")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--data", default="cube,periodic")
    args = ap.parse_args()
    reps = 5
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_chunk_time.py needs a CUDA device", file=sys.stderr)
        return 2
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.models import sequential as seq
    from encodermap_tpu_torch.ops import fused_train as ft

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    neurons = [int(n) for n in args.neurons.split(",")]
    B, steps = args.batch, args.steps
    out = {"root": args.root, "card": smi, "kernel": args.kernel, "batch": B,
           "neurons": neurons, "steps": steps}
    for tag in args.data.split(","):
        periodic = tag == "periodic"
        d0 = 4 if periodic else 3
        p = em.Parameters(n_neurons=neurons, batch_size=B,
                          periodicity=2 * math.pi if periodic else float("inf"))
        params = seq.init_params(torch.Generator().manual_seed(0), p, d0, device="cuda")
        flat, n_enc = ft.split_params(params)
        rng = np.random.default_rng(d0)
        if periodic:
            data = rng.uniform(-np.pi, np.pi, (125000, d0))
        else:
            data = em.create_n_cube(3, points_along_edge=500, seed=0)[0]
        data = torch.as_tensor(data, dtype=torch.float32, device="cuda")
        idx = torch.as_tensor(rng.integers(0, len(data), (steps, B)), device="cuda")
        zeros = [torch.zeros_like(t) for t in flat]
        kw = dict(n_enc=n_enc, hyper=ft.hyper_from(p), kernel=args.kernel)

        def chunk(**extra):
            return ft.fused_chunk(flat, zeros, zeros, 0.0, data, idx, **kw, **extra)

        chunk()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            chunk()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        res = {"ms": ms, "us_per_step": 1e3 * ms / steps}
        phases = None
        if args.kernel == "fused_train_cluster":
            phases, rows = ft.CLUSTER_PHASES, ft.CLUSTER
        elif hasattr(ft, "GRID_PHASES"):  # the grid kernel's trace, where it has one
            dims = [flat[0].shape[0]] + [w.shape[1] for w in flat[:len(flat) // 2]]
            phases = ft.GRID_PHASES
            rows = ft.grid_launch_plan(dims, n_enc, B, d0, periodic)["ctas"]
        if phases is not None:
            clocks = torch.zeros((rows, len(phases)), dtype=torch.int64, device="cuda")
            chunk(clocks=clocks)
            cyc = clocks.double().mean(0)
            res["cycles_per_step"] = float(cyc.sum()) / steps
            res["us_by_phase"] = {name: float(c / cyc.sum()) * res["us_per_step"]
                                  for name, c in zip(phases, cyc)}
        out[tag] = res
        print(f"[{tag}] {args.kernel} {neurons} B={B}: {ms:.3f} ms per {steps}-step chunk "
              f"({res['us_per_step']:.2f} us/step)", flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
