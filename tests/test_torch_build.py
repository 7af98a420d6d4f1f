# tests/test_torch_build.py
"""The kernel-binding layer (``ops/_build.py``) on the CPU: the binder and
the kernel modules import in any order, since the launch counter lives in
the leaf module ``_tracing.py``; every kernel module declares its entry
points when it is imported and loads no library until a launch; and
``_build.launch`` is the one place that calls an entry point on PyTorch's
stream, counts the launch and raises the library's error."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from encodermap_tpu_torch.ops import _build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: every ``csrc/*.cu`` of the port
LIBRARIES = ["backmap_one_way", "backmap_sidechains", "clip_adam", "fused_train",
             "fused_train_cluster", "sigmoid_loss"]


@pytest.mark.parametrize("first", ["encodermap_tpu_torch.ops.backmap",
                                   "encodermap_tpu_torch.ops._build"])
def test_a_fresh_process_imports_a_kernel_module_or_the_binder_first(first):
    """After ``import encodermap_tpu_torch`` every library is declared and
    none is loaded."""
    code = textwrap.dedent(f"""
        import json
        import {first}
        import encodermap_tpu_torch
        from encodermap_tpu_torch.ops import _build
        print(json.dumps([sorted(_build._ENTRY_POINTS), sorted(_build._loaded)]))
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    declared, loaded = json.loads(run.stdout.splitlines()[-1])
    assert declared == LIBRARIES == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert loaded == []


def test_launch_passes_the_stream_last_counts_once_and_raises_the_library_error(monkeypatch):
    calls = []

    class StandIn:
        """A library whose entry point returns its first argument as the
        CUDA error code."""

        def em_stand_in(self, *args):
            calls.append(args)
            return args[0]

        def em_error_string(self, err):
            return f"stand-in error {err}".encode()

    monkeypatch.setitem(_build._loaded, "stand_in", StandIn())
    monkeypatch.setattr(_build, "stream_ptr", lambda: "the stream")
    monkeypatch.setitem(_build.launch_counts, "stand_in", 0)
    _build.launch("stand_in", "em_stand_in", 0, "x")
    assert calls == [(0, "x", "the stream")]
    assert _build.launch_counts["stand_in"] == 1
    with pytest.raises(RuntimeError, match="em_stand_in: CUDA error 7: stand-in error 7"):
        _build.launch("stand_in", "em_stand_in", 7)
    assert calls[-1] == (7, "the stream")
    assert _build.launch_counts["stand_in"] == 2


def test_launch_counts_are_written_in_the_binder_alone():
    package = ROOT / "encodermap_tpu_torch"
    writers = sorted(str(p.relative_to(package)) for p in package.rglob("*.py")
                     if "launch_counts[" in p.read_text())
    assert writers == ["ops/_build.py"]
