# tests/test_torch_structure.py
"""The PyTorch port stands alone: no JAX, no JAX package.

``encodermap_tpu_torch``, ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
run on a GPU machine without JAX, so none of them may import ``jax``,
``jaxlib``, ``flax``, ``optax`` or anything of ``encodermap_tpu`` (not even
its jax-free modules). Checked on
the source's syntax tree, so a function-level import is caught too."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).parent.parent
PKG = ROOT / "encodermap_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "test_torch_cuda.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "encodermap_tpu"}


def _imported_roots(path: Path) -> list:
    roots = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append((node.module or "").split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.append(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_module_header_and_docstring(path):
    """Each module opens with its path and has a docstring."""
    src = path.read_text()
    assert src.splitlines()[0] == f"# {path.relative_to(ROOT)}"
    assert ast.get_docstring(ast.parse(src))


def test_checker_sees_forbidden_imports(tmp_path):
    """The AST walk catches top-level, from- and function-level imports."""
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom encodermap_tpu.nn import x\n"
                 "def g():\n    import jax.numpy\n")
    assert {"encodermap_tpu", "jax"} <= set(_imported_roots(f))


def test_import_pulls_in_no_jax():
    """Importing every module of the port in a fresh interpreter loads no
    module of JAX or of the JAX package."""
    names = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                   .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_kernel_sources_ship():
    """Every kernel library the wrappers load has its CUDA source, and the
    package data lists the sources."""
    from encodermap_tpu_torch.ops import _build, fused_sigmoid, fused_train  # noqa: F401

    for name in _build._ENTRY_POINTS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert '"encodermap_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in (
        ROOT / "pyproject.toml").read_text()
