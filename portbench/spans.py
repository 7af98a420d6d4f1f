"""The program's spans (``encodermap_tpu_torch/misc/profiling.py``) in a
``torch.profiler`` trace: the card's idle time and device time put down to
the span the host was in, and the per-layer numbers that read them.

With spans on, each span is a ``record_function`` range on the host, on the
profiler's clock, the clock of the card's operations. An idle gap of the
card is cut along the innermost span the host was in, piece by piece (one
gap between two chunks of the fused kernel covers several spans). A device
operation goes to the spans open when its launch's runtime call
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...: the host event with the
operation's correlation id) began, whatever thread launched it: the
backward's kernels come from autograd's device thread while the main thread
sits in ``step.backward``.
Time that no span covers is reported under :data:`OUTSIDE`. The profiler
mirrors each span on the device as an annotation named like it; those are
not operations and are left out.

A ``--trace 1`` run of the harness has the spans on over its traced chunks
and puts :func:`run_context` into the readers' ``ctx["spans"]``; the
metrics ``metrics/*_ms_per_*.py`` of the spans read it by :func:`readings`.

``python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>``
runs a cell as ``portbench/run.py --trace 1`` does, with the spans on from
the start, and prints the span table and the numbers of :func:`readings`
(the window's and the set-up's too) as one JSON line;
``--mode cost`` trains the cell's model in blocks of chunks with the spans
off and on in turn, and prints each block's wall time per step and what one
span costs the host, off and on.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import trace as trace_mod  # noqa: E402

#: the first word of every span name of the program
PREFIXES = ("train.", "trainer.", "step.", "adc.")
#: where time that no span covers is reported
OUTSIDE = "(outside every span)"


def is_span(name: str) -> bool:
    return name.startswith(PREFIXES)


def without_spans(events) -> list:
    """A profiler's events without the spans' host ranges and their
    annotations on the device: what the trace holds with the spans off."""
    return [e for e in events if not is_span(e.name)]


def _open_at(spans: list, times: list) -> list:
    """For each of the ascending ``times``, the spans open then, innermost
    (latest started) first; ``spans`` is ``(start, end, name)`` sorted by
    start, the longer first where two start together."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= t]
        out.append([s[2] for s in reversed(active)])
    return out


def _segments(spans: list) -> list:
    """The host's time under spans as ``(start, end, innermost span)``
    pieces, in order; ``spans`` as :func:`_open_at` takes them."""
    bounds = sorted({t for s, e, _ in spans for t in (s, e)})
    pieces = list(zip(bounds, bounds[1:]))
    names = _open_at(spans, [0.5 * (a + b) for a, b in pieces])
    return [(a, b, n[0]) for (a, b), n in zip(pieces, names) if n]


def _split(gaps: list, segments: list) -> Counter:
    """The ascending ``gaps`` cut along the ``segments``: seconds by
    innermost span, and under :data:`OUTSIDE` what no span covers."""
    out: Counter = Counter()
    j = 0
    for s, e in gaps:
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        covered, k = 0.0, j
        while k < len(segments) and segments[k][0] < e:
            a, b, name = segments[k]
            overlap = min(e, b) - max(s, a)
            if overlap > 0:
                out[name] += overlap * 1e-6
                covered += overlap
            k += 1
        if e - s > covered:
            out[OUTSIDE] += (e - s - covered) * 1e-6
    return out


def summarize(events) -> dict:
    """Reduce a profiler's ``events()`` to the spans' share of the card.

    Returns ``idle_s`` (the card's idle time by the innermost span the host
    was in meanwhile), ``device_s`` (device seconds by innermost span at
    launch), ``device_incl_s`` (device seconds under each span and the spans
    nested in it), ``busy_s``, ``idle_total_s``, ``device_total_s``,
    ``unlinked_s`` (device seconds whose launch was not found: counted under
    :data:`OUTSIDE`), ``annotations`` (the spans' mirrors on the device,
    left out) and ``span_counts`` (spans in the trace by name)."""
    from torch.autograd import DeviceType

    dev, spans, launch = [], [], {}
    annotations = 0
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if is_span(e.name):
                annotations += 1
            else:
                dev.append((tr.start, tr.end, e.id))
        elif e.device_type == DeviceType.CPU:
            if is_span(e.name):
                spans.append((tr.start, tr.end, e.name))
            elif e.name.startswith("cu"):
                launch[e.id] = tr.start
    spans.sort(key=lambda s: (s[0], -s[1]))  # an outer span first where two start together
    busy_us, gaps = trace_mod._union([(s, e) for s, e, _ in dev])
    idle = _split(gaps, _segments(spans))
    linked = sorted((launch[i], (e - s) * 1e-6) for s, e, i in dev if i in launch)
    unlinked = sum((e - s) * 1e-6 for s, e, i in dev if i not in launch)
    own: Counter = Counter({OUTSIDE: unlinked} if unlinked else {})
    incl: Counter = Counter()
    for (_, d), open_ in zip(linked, _open_at(spans, [t for t, _ in linked])):
        own[open_[0] if open_ else OUTSIDE] += d
        for name in set(open_):
            incl[name] += d
    return {"idle_s": dict(idle), "device_s": dict(own), "device_incl_s": dict(incl),
            "busy_s": busy_us * 1e-6, "idle_total_s": sum(idle.values()),
            "device_total_s": sum(own.values()), "unlinked_s": unlinked,
            "annotations": annotations,
            "span_counts": dict(Counter(name for _, _, name in spans))}


def window(before: dict, after: dict) -> dict:
    """``span_totals()`` between two snapshots, as ``name -> (count, total
    s, self s)`` of the names that ran."""
    out = {}
    for k, v in after.items():
        b = before.get(k, (0, 0.0, 0.0))
        if v[0] > b[0]:
            out[k] = tuple(x - y for x, y in zip(v, b))
    return out


def counter_deltas(before: dict, after: dict) -> dict:
    """The program's counters (``{counter: {key: count}}``) between two
    snapshots: each key that moved, by how much."""
    out = {}
    for name, c in after.items():
        b = before.get(name, {})
        moved = {k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
        if moved:
            out[name] = moved
    return out


def run_context(events, snaps: dict, traced_chunks: int, traced_steps: int) -> dict:
    """``ctx["spans"]`` of a traced run: ``trace`` (:func:`summarize` of the
    traced chunks' events), ``window`` and ``counters`` (span totals and
    counter deltas over the traced chunks, from the harness's snapshots
    ``trace_open`` and ``trace_close``), ``traced_chunks``,
    ``traced_steps``, and where the spans were on from the start
    (:func:`traced_run`) ``setup`` and ``measured``: the span totals before
    the measured window and in it."""
    sp = {"trace": summarize(events), "traced_chunks": traced_chunks,
          "traced_steps": traced_steps}
    if "trace_open" in snaps and "trace_close" in snaps:
        (s0, c0), (s1, c1) = snaps["trace_open"], snaps["trace_close"]
        sp["window"], sp["counters"] = window(s0, s1), counter_deltas(c0, c1)
    if "open" in snaps and "close" in snaps:
        sp["setup"] = window({}, snaps["open"][0])
        sp["measured"] = window(snaps["open"][0], snaps["close"][0])
    return sp


# --------------------------------------------------------------- readings
def _entry(name: str) -> bool:
    """The Entry point's share: ``train()``'s own spans but the chunk
    trainer's call, and its glue outside every span."""
    return name == OUTSIDE or (name.startswith("train.") and name != "train.chunk")


def readings(sp: dict) -> dict:
    """The per-layer numbers from ``sp`` (:func:`run_context`): the idle
    time a traced chunk and the device time a traced step by layer from
    ``trace``, and with the spans on from the start the host's time a step
    in the measured window (``measured``) and the uploads before it
    (``setup``). A number with nothing to read is left out."""
    out = {}
    tr, chunks, steps = sp.get("trace"), sp.get("traced_chunks"), sp.get("traced_steps")
    if tr and chunks and tr["idle_total_s"] > 0:
        entry = sum(v for k, v in tr["idle_s"].items() if _entry(k))
        out["entry_idle_ms_per_chunk"] = 1e3 * entry / chunks
        out["trainer_idle_ms_per_chunk"] = 1e3 * (tr["idle_total_s"] - entry) / chunks
    if tr and steps and tr["device_total_s"] > 0:
        for phase in ("forward", "backward", "optimizer", "metrics"):
            d = tr["device_incl_s"].get(f"step.{phase}")
            if d:
                out[f"{phase}_device_ms_per_step"] = 1e3 * d / steps
    step = sp.get("measured", {}).get("trainer.step")
    if step:
        out["dispatch_ms_per_step"] = 1e3 * step[1] / step[0]
    upload = sp.get("setup", {}).get("train.upload")
    if upload:
        out["upload_s"] = upload[1]
    return out


def table(sp: dict) -> list:
    """Rows ``[name, count, total ms, self ms over the traced chunks,
    traced idle ms, traced device ms (own), traced device ms (with
    nested)]``."""
    win, tr = sp.get("window", {}), sp.get("trace") or {}
    names = sorted(set(win) | set(tr.get("idle_s", {})) | set(tr.get("device_s", {})))
    return [[n, win.get(n, (0,))[0], 1e3 * win.get(n, (0, 0.0))[1],
             1e3 * win.get(n, (0, 0.0, 0.0))[2], 1e3 * tr.get("idle_s", {}).get(n, 0.0),
             1e3 * tr.get("device_s", {}).get(n, 0.0),
             1e3 * tr.get("device_incl_s", {}).get(n, 0.0)] for n in names]


# ------------------------------------------------------------------ runs
def traced_run(cell_name: str, seed: int, seconds: float, t_start: float, **kw) -> tuple:
    """``harness.run(..., trace=True)`` with the spans on from before the
    model is built: its result, and its ``ctx["spans"]`` (with ``setup``
    and ``measured``: :func:`run_context`)."""
    from encodermap_tpu_torch.misc import profiling

    from portbench import harness

    ctx: dict = {}
    with profiling.record_spans():
        result = harness.run(cell_name, seed, seconds, True, t_start, context=ctx, **kw)
    return result, ctx["spans"]


def span_cost_us(n: int = 200_000) -> dict:
    """Host microseconds of one empty span, spans off and on."""
    from encodermap_tpu_torch.misc import profiling

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with profiling.span("bench.span"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    off = loop()
    with profiling.record_spans():
        on = loop()
    return {"off": off, "on": on}


def _quartiles(xs: list) -> dict:
    return {"median": statistics.median(xs),
            "quartiles": statistics.quantiles(xs, n=4) if len(xs) > 1 else xs}


def cost_run(cell_name: str, seed: int, blocks: int, chunks: int, device="cuda",
             frames=None) -> dict:
    """Train the cell's model (the benchmark's data and weights from the
    seed) through one ``train()`` call: a warm-up chunk, then ``2 * blocks``
    blocks of ``chunks`` chunks, spans off and on in the order off, on, on,
    off, ... Returns each block's seconds per step (its mean, and its median
    chunk's), their medians and quartiles by side, the spans' totals over
    the blocks with spans on, and :func:`span_cost_us`."""
    import shutil

    from encodermap_tpu_torch.misc import profiling
    from encodermap_tpu_torch.train.callbacks import Callback

    from portbench import harness

    cell = harness.load_cell(cell_name)
    data, _, weights, _ = harness.prepare(cell, seed, device, frames)
    main_path = tempfile.mkdtemp(prefix="portbench-cost-")
    order = [i % 4 in (1, 2) for i in range(2 * blocks)]
    rows: list = []
    state = {"i": -1, "last": None, "times": [], "steps": 0,
             "stack": contextlib.ExitStack()}
    on_totals: dict = {}

    def spans(on: bool):
        state["stack"].close()
        state["stack"] = contextlib.ExitStack()
        if on:
            state["stack"].enter_context(profiling.record_spans())

    class Blocks(Callback):
        def on_chunk_end(self, first_step, metrics):
            harness._sync(device)
            now = time.perf_counter()
            i = state["i"]
            if i >= 0:
                state["times"].append(now - state["last"])
                state["steps"] += len(metrics["loss"])
            state["last"] = now
            if i >= 0 and len(state["times"]) < chunks:
                return None
            if i >= 0:
                per_chunk = state["steps"] / chunks
                rows.append({"on": order[i],
                             "s_per_step": sum(state["times"]) / state["steps"],
                             "median_s_per_step": statistics.median(state["times"])
                             / per_chunk})
                if order[i]:
                    for k, v in window(state["before"], profiling.span_totals()).items():
                        c, t, s = on_totals.get(k, (0, 0.0, 0.0))
                        on_totals[k] = (c + v[0], t + v[1], s + v[2])
            if i + 1 == len(order):
                spans(False)
                return False
            state["i"], state["times"], state["steps"] = i + 1, [], 0
            spans(order[i + 1])
            state["before"] = profiling.span_totals()
            state["last"] = time.perf_counter()
            return None

    try:
        model = harness.build_model(cell["config"], data, weights, seed, main_path, device)
        model.p.n_steps = model.state.step + 10 ** 12
        model.add_callback(Blocks())
        spans(True)  # on when train() starts: it names the callbacks' spans then
        model.train()
    finally:
        state["stack"].close()
        shutil.rmtree(main_path, ignore_errors=True)
    out: dict = {"blocks": rows}
    for side, on in (("off", False), ("on", True)):
        for unit in ("s_per_step", "median_s_per_step"):
            out[f"{side}_{unit}"] = _quartiles([r[unit] for r in rows if r["on"] == on])
    # the blocks pair up as (off, on), (on, off), ...
    out["pairs_on_slower"] = 0
    for a, b in zip(rows[::2], rows[1::2]):
        on_row, off_row = (b, a) if b["on"] else (a, b)
        out["pairs_on_slower"] += on_row["s_per_step"] > off_row["s_per_step"]
    out["on_over_off"] = (out["on_s_per_step"]["median"]
                          / out["off_s_per_step"]["median"] - 1.0)
    out["spans_on"] = {k: list(v) for k, v in sorted(on_totals.items())}
    out["span_us"] = span_cost_us()
    return out


def main(argv: list, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="A cell's run with the program's spans on.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--mode", choices=("trace", "cost"), default="trace")
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--chunks", type=int, default=100)
    args = ap.parse_args(argv)
    from portbench import harness

    with contextlib.redirect_stdout(sys.stderr):
        if args.mode == "cost":
            out = {"cost": cost_run(args.workload, args.seed, args.blocks, args.chunks)}
        else:
            result, sp = traced_run(args.workload, args.seed, args.seconds, t_start)
            out = {"correct": result["correct"], "metrics": result["metrics"],
                   "device": result["device"], "readings": readings(sp), "spans": sp}
            for row in table(sp):
                harness.log("span {:<34} n={:<7} total {:>12.3f} ms self {:>12.3f} ms "
                            "idle {:>10.3f} ms device {:>10.3f} ms (nested {:>10.3f})"
                            .format(*row))
    out["workload"], out["seed"] = args.workload, args.seed
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
