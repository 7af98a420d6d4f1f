# encodermap_tpu_torch/misc/summaries.py
"""Training metrics as an append-only JSONL log.

Counterpart of ``encodermap_tpu/misc/summaries.py::MetricsWriter``, JSONL
only: one ``{"step": ..., "<metric>": ...}`` row per written step in
``main_path/train_metrics.jsonl``, the same rows the JAX package writes.
In a multi-process run only rank 0 writes (every rank computes the same
global metrics). TensorBoard output is not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Union

import numpy as np

__all__ = ["MetricsWriter"]


class MetricsWriter:
    """Append-only scalar metrics log."""

    def __init__(self, main_path: Union[str, Path], tensorboard: bool = False,
                 filename: str = "train_metrics.jsonl") -> None:
        if tensorboard:
            raise NotImplementedError(
                "TensorBoard output is not ported to encodermap_tpu_torch yet; "
                "set tensorboard=False (metrics still go to the JSONL log)")
        from ..parallel.distributed import is_primary

        self.main_path = Path(main_path)
        self.path = self.main_path / filename
        self._fh = None
        if is_primary():
            self.main_path.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")

    def write_scalars(self, step: int, scalars: dict[str, Any]) -> None:
        """Append one row for ``step``."""
        if self._fh is None:
            return
        row = {"step": int(step)}
        for k, v in scalars.items():
            row[k] = float(np.asarray(v))
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        """Close the log file."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
