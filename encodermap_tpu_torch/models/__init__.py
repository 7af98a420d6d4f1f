# encodermap_tpu_torch/models/__init__.py
"""Model definitions of the port (counterpart of ``encodermap_tpu/models``,
with its re-exports, ``encodermap_tpu/models/__init__.py:8-19``)."""

from . import adc, sequential
from .adc import ADCFunctionalModel, gen_functional_model
from .sequential import SequentialModel, gen_sequential_model

__all__ = [
    "sequential",
    "adc",
    "SequentialModel",
    "gen_sequential_model",
    "ADCFunctionalModel",
    "gen_functional_model",
]
