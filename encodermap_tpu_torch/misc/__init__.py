# encodermap_tpu_torch/misc/__init__.py
"""Host-side utilities of the port: toy data, checkpoints, metrics logs
(counterpart of ``encodermap_tpu/misc``)."""

from .misc import create_n_cube
from .saving import latest_checkpoint, load_checkpoint, save_checkpoint
from .summaries import MetricsWriter

__all__ = ["create_n_cube", "latest_checkpoint", "load_checkpoint",
           "save_checkpoint", "MetricsWriter"]
