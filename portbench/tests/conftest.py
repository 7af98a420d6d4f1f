"""Shared helpers of the benchmark's own tests (run them with
``python3 -m pytest portbench/tests``; on the card add ``-m cuda``)."""

import contextlib
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: frames of the tiny CPU runs: enough rows for the checked steps' four
#: batches of different rows
TINY_FRAMES = {"em-ala2-b256": 3000, "adc-trpcage-b256": 1200}
SEED = 2 ** 31 + 977


@pytest.fixture
def cpu_run():
    """``cpu_run(cell, **kw)``: one run of ``cell`` on the CPU at a tiny
    frame count, its result object (the harness's look for a chip is
    skipped: ``harness.run`` is called directly)."""
    from portbench import harness

    def go(cell, seed=SEED, seconds=0.01, trace=False, **kw):
        with contextlib.redirect_stdout(sys.stderr):
            return harness.run(cell, seed, seconds, trace, time.perf_counter(),
                               device="cpu", frames=TINY_FRAMES[cell], trace_chunks=1, **kw)

    return go
