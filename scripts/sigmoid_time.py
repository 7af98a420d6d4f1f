#!/usr/bin/env python3
# scripts/sigmoid_time.py
"""Time the sigmoid-loss kernels of encodermap_tpu_torch on one CUDA card.

    python3 scripts/sigmoid_time.py [--root DIR]

Imports ``encodermap_tpu_torch`` from ``DIR`` (default: this checkout), so
that two trees can be timed one after the other on the same card (for
example this tree and a ``git archive`` of its parent unpacked under
``build/``, in turns: old, new, new, old), and times the forward and the
backward kernel at B = 64 to 16384, d=2, parameters (4.5, 12, 6, 1, 2, 6),
at the input widths ``chip_smoke.py``'s sigmoid phase runs (cube D=3,
periodic D=4, 30 and 128). A kernel's time is the card's own: a CUDA graph
of a number of launches, replayed once to warm up and once under CUDA
events, so that the host's time between launches (which at small B exceeds
a kernel's) does not count. Beside it, ``step`` is what ``chip_smoke.py``'s
router phase times: forward and backward through autograd, host included
(CUDA events around a loop of calls). Prints the card's name and power
limit and one JSON line of the times in ms per call.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

SHAPES = ((3, float("inf")), (4, 2 * math.pi), (30, 2 * math.pi), (128, 2 * math.pi))
#: batch size -> launches per graph
BATCHES = {64: 200, 256: 200, 1024: 100, 2048: 50, 3072: 40, 4096: 20, 16384: 10}


def device_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card, from a CUDA graph of ``reps``
    calls (the first call, outside the graph, builds and loads the
    kernels)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def loop_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn``, host included: CUDA events around
    ``reps`` calls after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("sigmoid_time.py needs a CUDA device", file=sys.stderr)
        return 2
    from encodermap_tpu_torch.ops import fused_sigmoid as fs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    d, params = 2, (4.5, 12, 6, 1, 2, 6)
    out = {"root": args.root, "card": smi}
    for B, reps in BATCHES.items():
        for D, periodicity in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(D)
            if math.isfinite(periodicity):
                h = (torch.rand((B, D), generator=g, device="cuda") * 2 - 1) * math.pi
            else:
                h = torch.rand((B, D), generator=g, device="cuda")
            l = torch.randn((B, d), generator=g, device="cuda")
            res = {key: device_ms(torch, lambda fn=fn: fn(h, l, params, periodicity), reps)
                   for key, fn in (("fwd", fs.sigmoid_loss_fwd),
                                   ("bwd", fs.sigmoid_loss_bwd))}

            def step():
                x = l.detach().requires_grad_(True)
                fs.fused_sigmoid_loss(h, x, params, periodicity).backward()

            res["step"] = loop_ms(torch, step, reps)
            tag = f"B={B} D={D} {'periodic' if math.isfinite(periodicity) else 'euclid'}"
            out[tag] = res
            print(f"[{tag}] fwd {res['fwd']:.4f} ms, bwd {res['bwd']:.4f} ms, "
                  f"step {res['step']:.4f} ms", flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
