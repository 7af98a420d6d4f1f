# encodermap_tpu_torch/ops/__init__.py
"""Numerical building blocks of the port: distances, backmapping, Kabsch,
the analytic and blocked Cartesian costs, and the two kernel modules,
``fused_sigmoid`` (sketch-map loss) and ``fused_train`` (a chunk of
EncoderMap steps). Counterpart of ``encodermap_tpu/ops``."""
