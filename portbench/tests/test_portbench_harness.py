"""The harness: what no run may load, the result line, and cells,
configurations and metrics found by name."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "encodermap_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("encodermap_tpu_torch_x", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in harness.forbidden_modules() if m.endswith(("_x", "typing", "_like"))]
    monkeypatch.setitem(sys.modules, "encodermap_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"encodermap_tpu.ops", "jax.numpy"} <= set(harness.forbidden_modules())


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "contextlib", "torch", "portbench"}, path
        assert not any(m.startswith("portbench.") and not m.startswith("portbench.reference")
                       for m in _imports(path)), path


def _python(code: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, env=env, timeout=600)


def test_a_run_and_the_reference_load_no_forbidden_module():
    code = """
import contextlib, json, sys, time
sys.path.insert(0, ".")
from portbench import harness
with contextlib.redirect_stdout(sys.stderr):
    harness.load_module(harness.ROOT / "portbench" / "reference" / "adc-128-128-2.py", "r1")
    harness.load_module(harness.ROOT / "portbench" / "reference" / "encodermap-128-128-2.py", "r2")
    ref_only = sorted(m for m in sys.modules if m.split(".")[0] == "encodermap_tpu_torch")
    harness.run("em-ala2-b256", 2 ** 31 + 3, 0.01, True, time.perf_counter(), device="cpu",
                frames=3000, trace_chunks=1)
print(json.dumps({"ref_only": ref_only, "forbidden": harness.forbidden_modules(),
                  "program": "encodermap_tpu_torch" in sys.modules}))
"""
    p = _python(code, ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"ref_only": [], "forbidden": [], "program": True}


def test_the_result_line_has_the_contract_keys_with_the_checks_last(cpu_run):
    r = cpu_run("em-ala2-b256")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {"em_samples_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    t = cpu_run("em-ala2-b256", trace=True)
    assert list(t) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert {"busy_s", "window_s"} <= set(t["device"])
    assert set(t["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_with_a_device_trace_metric_traces_every_run(cpu_run, monkeypatch):
    """Every run of the ADC cell traces a chunk for the device time a step;
    a ``--trace 0`` run never switches the program's spans on for it."""
    from encodermap_tpu_torch.misc import profiling

    from portbench import trace

    entered = []
    real_spans = profiling.record_spans
    monkeypatch.setattr(profiling, "record_spans",
                        lambda: entered.append(1) or real_spans())
    seen = []

    real = trace.summarize
    monkeypatch.setattr(trace, "summarize", lambda *a, **k: seen.append(1) or real(*a, **k))
    r = cpu_run("adc-trpcage-b256")
    assert seen
    # the CPU's trace holds no device operation, so the reader finds nothing
    assert set(r["metrics"]) == {"setup_s"}
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    seen.clear()
    cpu_run("em-ala2-b256")
    assert not seen
    assert not entered


def test_the_device_time_per_step_is_the_busy_time_over_the_traced_steps():
    from portbench import readers

    ctx = {"trace": {"busy_s": 0.163, "window_s": 3.8}, "traced_steps": 100}
    assert readers.device_ms_per_step(ctx) == pytest.approx(1.63)
    assert readers.device_ms_per_step({**ctx, "trace": {"busy_s": 0.0, "window_s": 3.8}}) \
        is None
    assert readers.device_ms_per_step({"traced_steps": 100}) is None


def test_without_a_card_the_command_prints_no_result(tmp_path):
    p = _python("import runpy, sys; sys.argv = ['run.py', '--workload', 'em-ala2-b256', "
                "'--seed', '1', '--seconds', '1', '--trace', '0']; "
                "runpy.run_path('portbench/run.py', run_name='__main__')", ROOT)
    assert p.returncode != 0 and p.stdout == ""


def _bare_copy(tmp_path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_without_the_program_a_run_fails(tmp_path):
    root = _bare_copy(tmp_path)
    p = _python("import sys, time; sys.path.insert(0, '.'); from portbench import harness; "
                "harness.run('em-ala2-b256', 1, 0.01, False, time.perf_counter(), "
                "device='cpu', frames=3000)", root)
    assert p.returncode != 0 and "encodermap_tpu_torch" in p.stderr


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_configuration_and_metric_are_added_as_new_files(tmp_path):
    root = _bare_copy(tmp_path)
    here = root / "portbench"
    before = _digest(root)
    (here / "configs" / "encodermap-copy.json").write_text(
        (here / "configs" / "encodermap-128-128-2.json").read_text()
        .replace("encodermap-128-128-2", "encodermap-copy"))
    shutil.copy(here / "reference" / "encodermap-128-128-2.py",
                here / "reference" / "encodermap-copy.py")
    traffic = json.loads((here / "traffic" / "ala2-dihedrals-125k.json").read_text())
    traffic["columns"] = 6
    (here / "traffic" / "six-dihedrals.json").write_text(json.dumps(traffic))
    work = json.loads((here / "workloads" / "em-ala2-b256.json").read_text())
    work.update(config="encodermap-copy", traffic="six-dihedrals")
    (here / "workloads" / "em-six-b256.json").write_text(json.dumps(work))
    (here / "metrics" / "window_steps.em.py").write_text(
        'LAYER = "Chunk trainer"\nUNIT = "steps"\nMOVES = "em_samples_per_s"\n\n\n'
        'def read(ctx):\n    return ctx["window_steps"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "window_steps.em", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "Chunk trainer",
                               "moves": "em_samples_per_s", "workloads": ["em-six-b256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    import contextlib
    import time
    with contextlib.redirect_stdout(sys.stderr):
        r = harness.run("em-six-b256", 2 ** 31 + 11, 0.01, True, time.perf_counter(),
                        device="cpu", frames=3000, root=root, trace_chunks=1)
    assert r["correct"], r["checks"]
    assert r["metrics"]["window_steps.em"]["value"] == r["attempted"]
    after = _digest(root)
    changed = [k for k in before if before[k] != after[k]]
    assert changed == ["BENCHMARK.json"]


#: a maker of a new kind of data: trp-cage CVs whose last side dihedrals
#: are missing (NaN) in every other frame, as a mixed-topology ensemble pads
#: them; the program then trains in its masked-dense "sparse" mode
SPARSE_MAKER = """
import numpy as np

from portbench import generators


def make(traffic, seed, device, frames):
    out = generators.protein_cvs(traffic, seed, device, frames)
    out["side_dihedrals"][1::2, -int(traffic["missing"]):] = np.nan
    return out
"""

#: the sparse mode's reference: each input zero-filled where NaN and passed
#: through its square densifier, a third weight group, then the ADC's loss
SPARSE_REFERENCE = """
import importlib.util
import pathlib

import torch

_spec = importlib.util.spec_from_file_location(
    "adc_base", pathlib.Path(__file__).with_name("adc-128-128-2.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

INPUTS = {"angles": "central_angles", "dihedrals": "central_dihedrals",
          "cartesians": "central_cartesians", "distances": "central_distances",
          "side_dihedrals": "side_dihedrals"}


def _widths(data):
    return {k: data[v][0].size for k, v in INPUTS.items()}


def shapes(p, data):
    return {"family": "adc-sparse", "densified": sorted(_widths(data))}


def weight_shapes(p, data):
    out = base.weight_shapes(p, data)
    for k, w in _widths(data).items():
        out += [(f"densifiers.{k}.kernel", (w, w)), (f"densifiers.{k}.bias", (w,))]
    return out


def loss(p, W, batch):
    dense = []
    for k, x in zip(INPUTS, batch):
        y = torch.nan_to_num(x).reshape(len(x), -1)
        y = y @ W[f"densifiers.{k}.kernel"] + W[f"densifiers.{k}.bias"]
        dense.append(y.reshape(x.shape))
    core = {k: w for k, w in W.items() if not k.startswith("densifiers.")}
    return base.loss(p, core, tuple(dense))


def follow(p, weights, data, rows, dtype, device):
    base._check(p)

    def batch(r):
        return lambda: tuple(torch.as_tensor(data[k][r], device=device).to(dtype)
                             for k in base.CVS)

    return base.plain.follow(lambda W, b: loss(p, W, b), weights,
                             [batch(r) for r in rows], p["learning_rate"], 1.0, dtype, device)
"""


def test_a_cell_of_another_mode_is_added_as_new_files(tmp_path, monkeypatch):
    """A configuration whose data come from a new maker, whose shapes come
    from its reference and whose weights have a third group (the sparse
    ADC's densifiers) runs with BENCHMARK.json the only file changed."""
    root = _bare_copy(tmp_path)
    here = root / "portbench"
    before = _digest(root)
    (here / "makers").mkdir()
    (here / "makers" / "nan-padded-cvs.py").write_text(SPARSE_MAKER)
    traffic = json.loads((here / "traffic" / "trpcage-cvs-1m.json").read_text())
    traffic.update(generator="nan-padded-cvs", missing=3)
    (here / "traffic" / "trpcage-sparse.json").write_text(json.dumps(traffic))
    cfg = json.loads((here / "configs" / "adc-128-128-2.json").read_text())
    cfg["name"] = "adc-sparse"
    cfg["parameters"]["trainable_dense_to_sparse"] = True
    (here / "configs" / "adc-sparse.json").write_text(json.dumps(cfg))
    (here / "reference" / "adc-sparse.py").write_text(SPARSE_REFERENCE)
    work = json.loads((here / "workloads" / "adc-trpcage-b256.json").read_text())
    work.update(config="adc-sparse", traffic="trpcage-sparse")
    (here / "workloads" / "adc-sparse-b256.json").write_text(json.dumps(work))
    (here / "metrics" / "densified_inputs.adc.py").write_text(
        'def read(ctx):\n    return len(ctx["shapes"]["densified"])\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "densified_inputs.adc", "unit": "inputs",
                               "better": "lower", "source": "program_counter",
                               "layer": "ADC step", "moves": "adc_device_ms_per_step",
                               "workloads": ["adc-sparse-b256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    seen = []
    real = harness.compare
    monkeypatch.setattr(harness, "compare",
                        lambda prog, ref, *a: seen.append((prog, ref)) or real(prog, ref, *a))
    import contextlib
    import time
    with contextlib.redirect_stdout(sys.stderr):
        r = harness.run("adc-sparse-b256", 2 ** 31 + 13, 0.01, True, time.perf_counter(),
                        device="cpu", frames=1200, root=root, trace_chunks=1)
    assert r["correct"], r["checks"]
    assert r["metrics"]["densified_inputs.adc"]["value"] == 5
    (prog, ref), = seen
    for side in (prog, ref):
        grads = {k: float(v.norm()) for k, v in side["grad1"].items()}
        assert len(grads) == 2 * (3 + 3 + 5)
        assert grads["densifiers.side_dihedrals.kernel"] > 0
        assert float(side["delta"]["densifiers.angles.kernel"].norm()) > 0
    after = _digest(root)
    assert [k for k in before if before[k] != after[k]] == ["BENCHMARK.json"]


def test_a_traced_run_has_the_spans_on_over_its_traced_chunks_alone(cpu_run, monkeypatch):
    """``--trace 1`` switches the spans on over its traced chunks and off
    again, and a counter's change over those chunks reaches
    ``ctx["spans"]``."""
    from encodermap_tpu_torch.misc import profiling
    from encodermap_tpu_torch.train.callbacks import Callback

    class Count(Callback):
        def on_chunk_end(self, first_step, metrics):
            if profiling.spans_enabled():
                profiling.counter("portbench.test")["chunks with spans"] += 1

    build = harness.build_model

    def build_model(*a, **k):
        model = build(*a, **k)
        model.add_callback(Count())
        return model

    monkeypatch.setattr(harness, "build_model", build_model)
    ctx: dict = {}
    r = cpu_run("em-ala2-b256", trace=True, context=ctx)
    assert r["correct"], r["checks"]
    assert not profiling.spans_enabled()
    sp = ctx["spans"]
    assert sp["traced_chunks"] == 1 and sp["window"]["trainer.step"][0] == 100
    assert sp["counters"]["portbench.test"] == {"chunks with spans": 1}
    # spans off in the measured window: nothing to read there
    assert "measured" not in sp and "setup" not in sp


def test_every_reader_declares_what_benchmark_json_says():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        mod = harness.load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py", "m")
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
    for m in bench["end_to_end"]:
        if m["name"] != "setup_s" and m["unit"] != "samples/s":
            mod = harness.load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py", "m")
            assert mod.UNIT == m["unit"]
    names = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert {k: cell["workload"][k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert cell["workload"]["limits"]
    assert names <= {p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json")}


#: the controls and faults of ``control.readings`` that each cell's limits
#: catch on every seed
CAUGHT = {"em-ala2-b256": ("tf32", "half_batch", "update_x1.3", "same_batch", "fixed_t"),
          "adc-trpcage-b256": ("tf32", "half_batch", "update_x1.3")}


@pytest.mark.cuda
def test_the_tf32_control_fails_every_cell():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control

    frames = {"em-ala2-b256": 125000, "adc-trpcage-b256": 20000}
    for cell, n in frames.items():
        limits = harness.load_cell(cell)["workload"]["limits"]
        for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
            got = control.readings(cell, seed, "cuda", n)
            for control_name in CAUGHT[cell]:
                assert any(got[control_name][k] > v for k, v in limits.items()), \
                    (cell, seed, control_name, got[control_name])
            assert all(got["float32"][k] <= v for k, v in limits.items()), (cell, seed)
