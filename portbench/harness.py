"""One run of one cell: set-up, the measured window, the traced sub-window,
the comparison with the plain reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own that this module finds by name, and
``BENCHMARK.json`` at the checkout's root says which metrics a cell
reports. A configuration of another mode of the program enters as new
files alone:

- ``makers/<generator>.py``, where the mix's ``generator`` is none of
  ``generators.GENERATORS``: ``make(traffic, seed, device, frames)``
  returns the data the model takes, one array or a dict of CV arrays (it
  may use ``generators`` and ``proteins``);
- ``configs/<config>.json``: the model and its ``parameters``;
- ``traffic/<traffic>.json``: the mix's parameters and its ``generator``;
- ``workloads/<cell>.json``: the cell's configuration, mix, chips,
  ``trace_chunks`` and the ``limits`` of its comparison;
- ``reference/<config>.py``: ``weight_shapes(parameters, data)``, whose
  names ``<group>.<i>.<kernel|bias>`` give the program's weight groups
  (``<i>`` an index, or a key where the group is keyed by name),
  ``follow(parameters, weights, data, rows, dtype, device)`` and, where
  the cost readers need other widths than :func:`shapes` counts,
  ``shapes(parameters, data)``;
- ``metrics/<metric>.py``: a reader over the run's context, with the
  spans and counters of the traced chunks in ``ctx["spans"]``.

The program under test is ``encodermap_tpu_torch`` and only it: the window
drives ``train()`` of the cell's model through the public API, and a
callback added with ``add_callback`` marks the window's start and end at
chunk ends (``train/autoencoder.py`` calls it after the chunk's metrics are
on the host, so the device has finished the chunk). In a ``--trace 1`` run
the program's spans (``misc/profiling.py``) are on over the traced chunks
only, so no measured window runs with them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench import generators
from portbench import spans as spans_mod
from portbench import trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "encodermap_tpu")
#: steps whose losses, first gradient and changes the reference follows:
#: step 1 alone, then the rest in one chunk
CHECK_STEPS = 4
#: host ops whose device time is the backmap's (``ops/backmap.py::_OneWay``)
BACKMAP_OPS = ("_OneWay", "_OneWayBackward")
#: per-run cap of the trace: CUPTI stops recording after about 300k
#: device operations in a process
MAX_TRACED_OPS = 250_000


def log(*args) -> None:
    print("[portbench]", *args, file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic mix and metrics:
    the files found by name, and the metrics ``BENCHMARK.json`` gives it."""
    here = root / "portbench"
    work = _json(here / "workloads" / f"{name}.json")
    bench = _json(root / "BENCHMARK.json")

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "workload": work,
            "config": _json(here / "configs" / f"{work['config']}.json"),
            "traffic": _json(here / "traffic" / f"{work['traffic']}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)],
            "root": root}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------------ model
def params_tree(w: dict) -> dict:
    """The program's parameter tree of the benchmark's named weights
    ``<group>.<i>.<kernel|bias>``: each group a list of layers where its
    ``<i>`` are indices (``encoder``, ``decoder``), else a dict of layers by
    key (the sparse ADC's ``densifiers``), in the order the names come."""
    groups: dict = {}
    for name in w:
        group, key, leaf = name.rsplit(".", 2)
        groups.setdefault(group, {}).setdefault(key, {})[leaf] = w[name]
    return {g: [layers[k] for k in sorted(layers, key=int)]
            if all(k.isdigit() for k in layers) else layers
            for g, layers in groups.items()}


def named(tree: dict) -> dict:
    """The inverse of :func:`params_tree`, as host float64 copies."""
    return {f"{group}.{key}.{leaf}": x.detach().to("cpu", torch.float64).clone()
            for group, layers in tree.items()
            for key, layer in (enumerate(layers) if isinstance(layers, list)
                               else layers.items())
            for leaf, x in layer.items()}


def build_model(cfg: dict, data, weights: dict, seed: int, main_path: str, device):
    """The cell's model, with the benchmark's weights, on ``device``."""
    import encodermap_tpu_torch as em

    kw = dict(cfg["parameters"], main_path=main_path, seed=int(seed))
    tree = params_tree({k: v.clone() for k, v in weights.items()})
    if cfg["model"] == "EncoderMap":
        return em.EncoderMap(em.Parameters(**kw), data, model_params=tree, device=device)
    if cfg["model"] == "AngleDihedralCartesianEncoderMap":
        return em.AngleDihedralCartesianEncoderMap(
            data, em.ADCParameters(**kw), model_params=tree, device=device)
    raise ValueError(f"no model {cfg['model']!r}")


def shapes(cfg: dict, data) -> dict:
    """The widths that the cost functions count from."""
    p = cfg["parameters"]
    B = p["batch_size"]
    if cfg["model"] == "EncoderMap":
        d0 = data.shape[1]
        periodic = math.isfinite(p["periodicity"])
        width = 2 * d0 if periodic else d0
        dims = [width] + p["n_neurons"] + p["n_neurons"][-2::-1] + [width]
        return {"family": "em", "B": B, "d0": d0, "periodic": periodic, "dims": dims,
                "n_enc": len(p["n_neurons"]), "sig": tuple(p["dist_sig_parameters"])}
    enc_d = sum(data[k].shape[1] for k in
                ("central_angles", "central_dihedrals", "side_dihedrals"))
    n_atoms = data["central_cartesians"].shape[1]
    sel = range(n_atoms)[slice(p["cartesian_pwd_start"], p["cartesian_pwd_stop"],
                               p["cartesian_pwd_step"])]
    dims = [2 * enc_d] + p["n_neurons"] + p["n_neurons"][-2::-1] + [2 * enc_d]
    return {"family": "adc", "B": B, "enc_d": enc_d, "dims": dims, "n_atoms": n_atoms,
            "n_ca": len(sel), "sig": tuple(p["dist_sig_parameters"]),
            "ca_sig": tuple(p["cartesian_dist_sig_parameters"])}


# --------------------------------------------------------------- callbacks
def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launches() -> dict:
    from encodermap_tpu_torch.ops import _build

    return dict(_build.launch_counts)


def _launched(before: dict, after: dict) -> list:
    """The kernels of the port launched between two counts."""
    return sorted(k for k in after if after[k] > before.get(k, 0))


def check_steps(model, rows: np.ndarray) -> dict:
    """Train the first steps through ``train()`` on the given rows (one
    batch a row of ``rows``), as the window trains: step 1 alone, a chunk of
    one step, then the rest as one chunk of several steps, a single launch
    on the fused route as each of the window's chunks is. Keep what the
    optimizer holds: each step's loss, the first clipped gradient (Adam's
    first moment after one step over 1 - b1), and the parameters' change
    after step 1 and after all the steps."""
    from encodermap_tpu_torch.train.callbacks import Callback

    start = named(model.state.params)
    losses: list = []

    class Capture(Callback):
        def on_chunk_end(self, first_step, metrics):
            losses.extend(float(x) for x in metrics["loss"])

    p = model.p
    sps = p.steps_per_scan
    model.add_callback(cap := Capture())
    try:
        p.steps_per_scan, p.n_steps = 1, model.state.step + 1
        model.train(index_stream=iter([rows[:1]]))
        grad1 = {k: v / (1.0 - 0.9) for k, v in named(model.state.opt_state["mu"]).items()}
        after1 = named(model.state.params)
        p.steps_per_scan, p.n_steps = len(rows) - 1, model.state.step + len(rows) - 1
        model.train(index_stream=iter([rows[1:]]))
    finally:
        model.callbacks.remove(cap)
        p.steps_per_scan = sps
    end = named(model.state.params)
    return {"losses": losses, "grad1": grad1,
            "delta1": {k: after1[k] - start[k] for k in start},
            "delta": {k: end[k] - start[k] for k in start}}


def _counters() -> dict:
    """A copy of every counter of the program's registry
    (``misc/profiling.py::counter``, ``launches`` among them), which has no
    public listing."""
    from encodermap_tpu_torch.misc import profiling

    return {k: dict(v) for k, v in profiling._counters.items()}


class _Window:
    """The measured window between chunk ends: it opens when the first
    chunk of ``train()`` (the warm-up of the window's own shapes) has
    ended and closes at the first chunk end ``seconds`` later; with
    ``trace_chunks`` the profiler then records that many more chunks, and
    with ``spans`` the program's spans are on over those chunks alone.
    ``snaps`` keeps ``(span_totals(), counters)`` where the traced chunks
    begin and end (``trace_open``, ``trace_close``), and where the window
    opens and closes if a caller had the spans on (``open``, ``close``)."""

    def __init__(self, seconds: float, trace_chunks: int, device,
                 spans: bool = False) -> None:
        from encodermap_tpu_torch.misc import profiling

        self.seconds, self.trace_chunks, self.device = seconds, trace_chunks, device
        self.spans, self.profiling = spans, profiling
        self.t0 = self.t1 = self.trace_t0 = self.trace_t1 = None
        self.steps = self.nonfinite = 0
        self.traced_chunks = self.traced_steps = 0
        self.prof = None
        self.chunk_s: list = []
        self.snaps: dict = {}
        self.spans_on = contextlib.ExitStack()
        self._last = None

    def callback(self):
        from encodermap_tpu_torch.train.callbacks import Callback

        win = self

        class Window(Callback):
            def on_chunk_end(self, first_step, metrics):
                return win.chunk_end(metrics["loss"])

        return Window()

    def _snap(self, key: str) -> None:
        self.snaps[key] = (self.profiling.span_totals(), _counters())

    def chunk_end(self, loss: np.ndarray):
        _sync(self.device)
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = self._last = now
            if self.profiling.spans_enabled():
                self._snap("open")
            return None
        if self.prof is not None:
            self.traced_chunks += 1
            self.traced_steps += len(loss)
            if self.traced_chunks < self.trace_chunks:
                return None
            self.trace_t1 = now
            if self.spans:
                self._snap("trace_close")
                self.spans_on.close()
            self.prof.stop()
            return False
        self.chunk_s.append(now - self._last)
        self._last = now
        self.steps += len(loss)
        self.nonfinite += int(np.count_nonzero(~np.isfinite(loss)))
        if now - self.t0 < self.seconds:
            return None
        self.t1 = now
        if self.profiling.spans_enabled():
            self._snap("close")
        if not self.trace_chunks:
            return False
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.spans:
            self.spans_on.enter_context(self.profiling.record_spans())
            self._snap("trace_open")
        self.trace_t0 = time.perf_counter()
        return None


# ------------------------------------------------------------ comparison
def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.norm(v.to(torch.float64).cpu())) for k, v in tree.items()}


def _change_gap(prog: dict, ref: dict, keep: list) -> dict:
    dp, dr = leaf_norms(prog), leaf_norms(ref)
    med = statistics.median(dr[k] for k in keep)
    return {k: abs(dp[k] - dr[k]) / max(dr[k], med) for k in keep}


def compare(prog: dict, ref: dict, detail: Optional[dict] = None) -> dict:
    """The numbers that decide ``correct``: the relative gap of the first
    step's loss and the largest over all steps (the last step's loss reads
    the parameters that the steps before it made, on a batch they did not
    see); the largest gap between the program's and the reference's norm of
    a leaf's first gradient, over the reference's norm of that leaf or of
    the median leaf, whichever is larger; the same for each leaf's change
    after the first step and after all steps, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's (they
    move by round-off); and the median leaf's gap of each of the three,
    steady from seed to seed where the largest swings with one small leaf's
    rounding (a gradient near Adam's eps flips its first update, or a
    decoded angle's ill-conditioned atan2: PERF.md §2). A cell's workload
    names the numbers it holds. ``detail`` receives each step's gap and the
    leaves that set the largest gaps."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        steps.append(math.inf)
    gp, gr = leaf_norms(prog["grad1"]), leaf_norms(ref["grad1"])
    med = statistics.median(gr.values())
    grad = {k: abs(gp[k] - gr[k]) / max(gr[k], med) for k in gr}
    keep = [k for k in gr if gr[k] >= 1e-3 * med]
    change1 = _change_gap(prog["delta1"], ref["delta1"], keep)
    change = _change_gap(prog["delta"], ref["delta"], keep)
    if detail is not None:
        detail.update(loss_steps=steps, grad_leaf=max(grad, key=grad.get),
                      change1_leaf=max(change1, key=change1.get),
                      change_leaf=max(change, key=change.get),
                      left_out=sorted(set(gr) - set(keep)))
    return {"loss1_gap": steps[0], "loss_gap": max(steps), "grad_gap": max(grad.values()),
            "change1_gap": max(change1.values()), "change_gap": max(change.values()),
            "grad_med_gap": statistics.median(grad.values()),
            "change1_med_gap": statistics.median(change1.values()),
            "change_med_gap": statistics.median(change.values())}


def reference_module(cell: dict):
    """The plain reference of the cell's configuration,
    ``reference/<config>.py``: ``weight_shapes(parameters, data)``,
    ``follow(parameters, weights, data, rows, dtype, device)`` and
    optionally ``shapes(parameters, data)``."""
    name = cell["config"]["name"]
    return load_module(cell["root"] / "portbench" / "reference" / f"{name}.py",
                       f"portbench_reference_{name.replace('-', '_')}")


# --------------------------------------------------------------- metrics
def read_metrics(cell: dict, ctx: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    ``setup_s`` and a rate in samples/s from the host's clock, any other
    from its reader, ``metrics/<name>.py``; a metric whose reader finds
    nothing to read is left out."""
    out = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        if not trace and m["name"] == "setup_s":
            value = ctx["setup_s"]
        elif not trace and m["unit"] == "samples/s":
            value = ctx["samples_per_s"]
        else:
            reader = load_module(cell["root"] / "portbench" / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak, "nvidia_smi": smi}


# -------------------------------------------------------------------- run
def make_data(cell: dict, seed: int, device, frames: int | None = None):
    """The traffic mix's data at its own frame count, or at ``frames``
    (tests): from one of ``generators.GENERATORS``, or else from the maker
    ``makers/<generator>.py`` that the mix names."""
    traffic = cell["traffic"]
    name = traffic["generator"]
    if name in generators.GENERATORS:
        return generators.make(traffic, seed, device, frames)
    maker = load_module(cell["root"] / "portbench" / "makers" / f"{name}.py",
                        "portbench_maker_" + name.replace("-", "_").replace(".", "_"))
    return maker.make(traffic, seed, device,
                      int(frames if frames is not None else traffic["frames"]))


def cell_shapes(cell: dict, reference, data) -> dict:
    """The widths the cost readers count from: the reference's
    ``shapes(parameters, data)`` where it has one, else :func:`shapes`."""
    if hasattr(reference, "shapes"):
        return reference.shapes(cell["config"]["parameters"], data)
    return shapes(cell["config"], data)


def prepare(cell: dict, seed: int, device, frames: int | None = None) -> tuple:
    """What a run and the controls make from the seed: the traffic mix's
    data (host arrays), the reference module, the weights (float32 on the
    device) and the checked steps' rows."""
    cfg = cell["config"]
    data = make_data(cell, seed, device, frames)
    reference = reference_module(cell)
    weights = generators.weights(reference.weight_shapes(cfg["parameters"], data),
                                 seed, device)
    rows = generators.check_rows(generators.frame_count(data), CHECK_STEPS,
                                 cfg["parameters"]["batch_size"], seed, device)
    return data, reference, weights, rows


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", frames: int | None = None, root: Path = ROOT,
        trace_chunks: int | None = None, context: dict | None = None) -> dict:
    """One run; returns the result line's object. ``frames`` and
    ``trace_chunks`` shrink the traffic mix and the traced sub-window,
    ``device="cpu"`` runs without a card, and ``context`` receives the
    readers' context: all for tests and ``spans.py`` only, the command line
    takes none of them."""
    cell = load_cell(cell_name, root)
    cfg, work = cell["config"], cell["workload"]
    if not work.get("limits"):
        raise RuntimeError(f"{cell_name} has no limits to hold its comparison to")
    B = cfg["parameters"]["batch_size"]
    log(f"{cell_name}: imports {time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    data, reference, weights, rows = prepare(cell, seed, device, frames)
    log(f"{cell_name}: data {time.perf_counter() - t:.2f} s")
    shp = cell_shapes(cell, reference, data)
    host_weights = {k: v.detach().cpu().clone() for k, v in weights.items()}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    main_path = tempfile.mkdtemp(prefix="portbench-")
    win = None
    try:
        t = time.perf_counter()
        model = build_model(cfg, data, weights, seed, main_path, device)
        del weights
        log(f"{cell_name}: model {time.perf_counter() - t:.2f} s")
        t, counts = time.perf_counter(), _launches()
        prog = check_steps(model, rows)
        checked = _launched(counts, counts := _launches())
        log(f"{cell_name}: {CHECK_STEPS} checked steps {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        # the traced chunks follow the window in a run with --trace 1, and in
        # every run of a cell with an end-to-end metric from the device trace
        from_trace = any(m["source"] == "device_trace" for m in cell["end_to_end"])
        traced = int(trace_chunks or work["trace_chunks"]) if trace or from_trace else 0
        win = _Window(seconds, traced, device, spans=trace)
        model.p.n_steps = model.state.step + 10 ** 12
        model.add_callback(win.callback())
        model.train()
        _sync(device)
        timed = _launched(counts, _launches())
        if checked != timed:
            raise RuntimeError(f"the checked steps launched {checked}, the window {timed}: "
                               f"the comparison would not hold the timed path")
        log(f"{cell_name}: kernels of the checked steps and the window {timed}")
        log(f"{cell_name}: warm-up chunk and data upload {win.t0 - t:.2f} s, window "
            f"{(win.t1 or win.t0) - win.t0:.2f} s, {win.steps} steps")
        if len(win.chunk_s) >= 4:
            q = statistics.quantiles(win.chunk_s, n=4)
            half = len(win.chunk_s) // 2
            log(f"{cell_name}: chunk ms quartiles {[round(1e3 * x, 3) for x in q]}, "
                f"min {1e3 * min(win.chunk_s):.3f}, max {1e3 * max(win.chunk_s):.3f}, "
                f"halves {1e3 * statistics.mean(win.chunk_s[:half]):.3f} / "
                f"{1e3 * statistics.mean(win.chunk_s[half:]):.3f}")
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        prof, win.prof = win.prof, None
        del model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        if win is not None:
            win.spans_on.close()
        shutil.rmtree(main_path, ignore_errors=True)

    if win.t1 is None:
        raise RuntimeError("training stopped before the window closed "
                           "(a non-finite loss, or no chunk after the warm-up)")
    ctx = {"setup_s": win.t0 - t_start, "window_s": win.t1 - win.t0,
           "window_steps": win.steps,
           "samples_per_s": win.steps * B / (win.t1 - win.t0),
           "shapes": shp, "cell": cell}
    if traced:
        if win.trace_t1 is None:
            raise RuntimeError("the traced sub-window did not close")
        events = prof.events()
        # the spans' host ranges and their mirrors on the device are no
        # operations of the program: the trace's numbers are read without them
        ctx["trace"] = trace_mod.summarize(spans_mod.without_spans(events),
                                           win.trace_t1 - win.trace_t0, BACKMAP_OPS)
        ctx["traced_steps"] = win.traced_steps
        if ctx["trace"]["device_ops"] > MAX_TRACED_OPS:
            raise RuntimeError(f"{ctx['trace']['device_ops']} device operations traced: "
                               f"more than the profiler records whole")
        if trace:
            ctx["spans"] = spans_mod.run_context(events, win.snaps, win.traced_chunks,
                                                 win.traced_steps)
        del prof, events
    if context is not None:
        context.update(ctx)
    metrics = read_metrics(cell, ctx, trace)

    t = time.perf_counter()
    ref = reference.follow(cfg["parameters"], host_weights, data, rows, torch.float64, device)
    detail: dict = {}
    numbers = compare(prog, ref, detail)
    log(f"{cell_name}: reference {time.perf_counter() - t:.2f} s; {numbers}; {detail}")
    checks = {k: {"value": numbers[k], "limit": v} for k, v in work["limits"].items()}
    correct = win.nonfinite == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": win.steps, "failed": win.nonfinite,
              "metrics": metrics, "device": device_info(device, peak)}
    if trace:
        result["device"].update(busy_s=ctx["trace"]["busy_s"],
                                window_s=ctx["trace"]["window_s"])
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = checks
    return result


def main(argv: list, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = int(load_cell(args.workload)["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    with contextlib.redirect_stdout(sys.stderr):
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"modules that a run may not load were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
