# encodermap_tpu_torch/ops/_build.py
"""Build and bind the port's CUDA kernels.

The JAX package has no counterpart: Pallas kernels compile inside
``jax.jit``. Here each ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, on first use, into
``build/kernels/`` at the repository root, and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs when the module is imported: the CPU tests import every
module of the port, and this machine may have no ``nvcc``.

Every kernel module declares its C entry points with :func:`register` when
it is imported, asks :func:`kernel_route` whether its tensors go to the
kernels (CUDA) or to its plain version (CPU), and launches through
:func:`launch`. :data:`launch_counts` counts kernel launches by kernel name,
in :func:`launch` and nowhere else, so a run can show which kernels its
path went through. It is the ``launches`` counter of the registry in
``_tracing.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

from .._tracing import launches as launch_counts

__all__ = ["CSRC", "build_all", "register", "load_library", "launch_counts",
           "check_cuda", "stream_ptr", "launch", "kernel_route"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the repository root's ``build/``, listed in ``.gitignore``
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: library name -> its C entry points: (name, argument types[, result type])
_ENTRY_POINTS: dict[str, list[tuple]] = {}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc on the GPU machine")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return log


def build_all(names: Optional[list[str]] = None) -> dict[str, str]:
    """Compile every kernel library (or ``names``) that is not built yet,
    one ``nvcc`` per source, all started together. Returns each library's
    compiler log, kept beside it for one that was built before (empty where
    none was kept)."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start_build(n) for n in names}
    out = {}
    for n, job in jobs.items():
        if job is not None:
            out[n] = _finish_build(n, job)
        else:
            kept = _library_path(n).with_suffix(".log")
            out[n] = kept.read_text() if kept.exists() else ""
    return out


def register(name: str, entry_points: list[tuple]) -> None:
    """Declare a library's C entry points: ``(name, argtypes)`` for one that
    returns a ``cudaError_t`` as an int, ``(name, argtypes, restype)``
    otherwise. Every library also exports ``em_error_string``."""
    _ENTRY_POINTS[name] = entry_points + [
        ("em_error_string", [ctypes.c_int], ctypes.c_char_p)]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    if name not in _loaded:
        build_all([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn_name, argtypes, *restype in _ENTRY_POINTS[name]:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype[0] if restype else ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def check_cuda(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.em_error_string(err).decode()}")


def stream_ptr() -> int:
    """PyTorch's current CUDA stream, as the kernels' ``cudaStream_t``."""
    return torch.cuda.current_stream().cuda_stream


def launch(library: str, entry: str, *args) -> None:
    """Call ``library``'s C entry point ``entry`` with ``args`` and PyTorch's
    current CUDA stream last, count one launch under the entry's name less
    its ``em_`` prefix (``em_sigmoid_fwd`` counts as ``sigmoid_fwd``), and
    raise if the entry returned a CUDA error."""
    lib = load_library(library)
    err = getattr(lib, entry)(*args, stream_ptr())
    launch_counts[entry.removeprefix("em_")] += 1
    check_cuda(lib, err, entry)


def kernel_route(tensors: Sequence, what: str,
                 dtypes: tuple = (torch.float32, torch.float64)) -> bool:
    """Whether ``tensors`` go to the kernels ``what`` names: True for CUDA
    tensors of one device and of one of ``dtypes``, False for CPU tensors
    (whatever their type: the plain versions take them); anything else
    raises, before any library is loaded."""
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"the inputs of {what} lie on {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    types = {x.dtype for x in tensors}
    if len(types) != 1 or not types <= set(dtypes):
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{what} take {names} tensors of one type, got "
                        f"{sorted(map(str, types))}")
    return True
