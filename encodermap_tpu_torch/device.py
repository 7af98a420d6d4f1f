# encodermap_tpu_torch/device.py
"""Where the port runs: the card unless the caller asks for the CPU.

The JAX package has no counterpart (JAX picks its backend itself). Every
entry point of the port takes ``device=None`` and resolves it here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises and
    says how to run on the CPU instead; nothing falls back silently.

    On CUDA, float32 matrix products and convolutions are kept in full
    float32 (TF32 off), the precision the parity tests hold the port to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "encodermap_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU."
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
