#!/usr/bin/env python3
"""Runs of one cell in turn, one process each, and the spread of each
metric: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.

    python3 portbench/series.py --workload <cell> --seeds 1,2,3 --seconds 10 \
        [--trace 0] [--out runs.jsonl]

Each run's result line is kept in ``--out``; the summary goes to standard
output. The bounds in ``BENCHMARK.json`` were set from such series.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values: list) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    values: dict = {}
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload",
             args.workload, "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"seed {seed}: exit {proc.returncode}\n{proc.stderr[-3000:]}", flush=True)
            continue
        result = json.loads(lines[-1])
        if args.out:
            with open(args.out, "a") as f:
                log = [x for x in proc.stderr.splitlines() if x.startswith("[portbench]")]
                f.write(json.dumps({"workload": args.workload, "seed": int(seed),
                                    "wall_s": wall, **result, "log": log}) + "\n")
        for name, m in result["metrics"].items():
            values.setdefault(name, []).append(m["value"])
        checks = {k: c["value"] for k, c in result["checks"].items()}
        print(f"seed {seed}: wall {wall:.1f} s correct={result['correct']} " + " ".join(
            f"{k}={m['value']:.6g}" for k, m in result["metrics"].items())
            + f" checks={checks}", flush=True)
    for name, vals in values.items():
        line = f"{args.workload} {name}: n={len(vals)} median={statistics.median(vals):.6g}"
        if len(vals) >= 2:
            line += f" spread={spread(vals):.4%} min={min(vals):.6g} max={max(vals):.6g}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
