# encodermap_tpu_torch/train/__init__.py
"""Training of the port: the chunked trainer, callbacks and the autoencoder
classes (counterpart of ``encodermap_tpu/train``)."""

from .adc_autoencoder import AngleDihedralCartesianEncoderMap
from .autoencoder import Autoencoder, DihedralEncoderMap, EncoderMap
from .callbacks import (
    Callback,
    CheckpointSaver,
    EarlyStop,
    ImageCallback,
    NaNInterrupt,
    ProgressBar,
)
from .core import TrainState, make_optimizer, make_scan_trainer

__all__ = ["Autoencoder", "EncoderMap", "DihedralEncoderMap",
           "AngleDihedralCartesianEncoderMap", "Callback",
           "CheckpointSaver", "EarlyStop", "ImageCallback", "NaNInterrupt",
           "ProgressBar",
           "TrainState", "make_optimizer", "make_scan_trainer"]
