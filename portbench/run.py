#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch and CUDA port on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, last, ``checks``
(each number compared with the plain reference beside its limit; the same
lines end standard error). Exits with another code than 0, and prints no
result, without enough CUDA cards or when a forbidden module was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# every compiler cache at a fixed path inside the checkout; the port's own
# kernels build into build/kernels/ there, keyed by a hash of the sources
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
# one CPU thread for the host's math: the program's work is on the card, and
# idle worker threads spinning beside the dispatching thread make runs uneven
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
