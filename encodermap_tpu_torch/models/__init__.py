# encodermap_tpu_torch/models/__init__.py
"""Model definitions of the port (counterpart of ``encodermap_tpu/models``)."""

from .sequential import SequentialModel, gen_sequential_model

__all__ = ["SequentialModel", "gen_sequential_model"]
