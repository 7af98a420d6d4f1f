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
    from portbench import trace

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
