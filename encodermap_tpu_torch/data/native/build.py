# encodermap_tpu_torch/data/native/build.py
"""Build the native XTC codec with ``g++`` on first use and bind it with
``ctypes``.

Counterpart of ``encodermap_tpu/data/native/build.py``, with two changes:
the shared object goes to ``build/native/`` at the repository root (listed
in ``.gitignore``), not next to its source, and its file name carries a
hash of the source, so an edited source is rebuilt. A failed build raises
with the compiler's message; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "load_library"]

_HERE = Path(__file__).resolve().parent
#: the repository root's ``build/``, listed in ``.gitignore``
BUILD_DIR = _HERE.parents[2] / "build" / "native"
_LIB: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _compile(src: Path, so: Path) -> None:
    """g++ to a process-unique temporary name, then publish atomically, so
    that two processes building at once never load a half-written file."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(src), "-o", str(tmp)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src.name}:\n"
                               f"{proc.stderr}{proc.stdout}")
        tmp.replace(so)
    finally:
        tmp.unlink(missing_ok=True)


def load_library(name: str = "xdr_xtc") -> ctypes.CDLL:
    """Build ``lib<name>-<hash>.so`` if it is not built yet, and load it."""
    with _LOCK:
        if name in _LIB:
            return _LIB[name]
        src = _HERE / f"{name}.cpp"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if not so.exists():
            try:
                _compile(src, so)
            except FileNotFoundError as e:
                raise RuntimeError(
                    f"g++ not found: the native {name} codec is built with "
                    f"g++ on first use ({e})") from e
        _LIB[name] = ctypes.CDLL(str(so))
        return _LIB[name]
