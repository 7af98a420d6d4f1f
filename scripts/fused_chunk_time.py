#!/usr/bin/env python3
# scripts/fused_chunk_time.py
"""Time the cluster train kernel of encodermap_tpu_torch on one CUDA card.

    python3 scripts/fused_chunk_time.py [--root DIR]

Imports ``encodermap_tpu_torch`` from ``DIR`` (default: this checkout), so
that two trees can be timed one after the other on the same card, and times one
500-step chunk of ``fused_chunk`` at the main configuration ([128,128,2],
B=256) on cube (d0=3) and periodic (d0=4) data by CUDA events, 5 chunks
after a warm-up, with the cluster kernel's split of a step by phase.
Prints the card's name and power limit and one JSON line of the times.
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
    out = {"root": args.root, "card": smi}
    for d0, periodic in ((3, False), (4, True)):
        p = em.Parameters(n_neurons=[128, 128, 2], batch_size=256,
                          periodicity=2 * math.pi if periodic else float("inf"))
        params = seq.init_params(torch.Generator().manual_seed(0), p, d0, device="cuda")
        flat, n_enc = ft.split_params(params)
        rng = np.random.default_rng(d0)
        if periodic:
            data = rng.uniform(-np.pi, np.pi, (125000, d0))
        else:
            data = em.create_n_cube(3, points_along_edge=500, seed=0)[0]
        data = torch.as_tensor(data, dtype=torch.float32, device="cuda")
        idx = torch.as_tensor(rng.integers(0, len(data), (500, 256)), device="cuda")
        zeros = [torch.zeros_like(t) for t in flat]
        kw = dict(n_enc=n_enc, hyper=ft.hyper_from(p), kernel="fused_train_cluster")

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
        tag = "periodic" if periodic else "cube"
        res = {"ms": ms, "us_per_step": 1e3 * ms / 500}
        clocks = torch.zeros((ft.CLUSTER, len(ft.CLUSTER_PHASES)), dtype=torch.int64,
                             device="cuda")
        chunk(clocks=clocks)
        cyc = clocks.double().mean(0)
        res["cycles_per_step"] = float(cyc.sum()) / 500
        res["us_by_phase"] = {name: float(c / cyc.sum()) * res["us_per_step"]
                              for name, c in zip(ft.CLUSTER_PHASES, cyc)}
        out[tag] = res
        print(f"[{tag}] fused_train_cluster: {ms:.3f} ms per 500-step chunk "
              f"({res['us_per_step']:.2f} us/step)", flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
