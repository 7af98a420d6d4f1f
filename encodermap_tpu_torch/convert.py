# encodermap_tpu_torch/convert.py
"""Carry weights and Adam state between the JAX package and the port.

The JAX package has no counterpart. Both packages store a model as
``{"encoder": [{"kernel": (din, dout), "bias": (dout,)}, ...],
"decoder": [...]}`` (an ADC model with sparse inputs adds ``"densifiers":
{name: {"kernel", "bias"}}``) and the Adam state as optax's
``count``/``mu``/``nu`` in the same layout, so conversion is a copy of any
such tree: no transpose, no reordering.
Pass numpy arrays (``jax.device_get`` of the JAX trees) in, get numpy
arrays out.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .device import resolve_device
from .train.core import tree_map

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree: Any, mu: Any = None, nu: Any = None,
                      count: Optional[int] = None, device: Any = "cpu"
                      ) -> tuple[Any, Optional[dict]]:
    """``(params, opt_state)`` as float32 tensors on ``device``.

    ``opt_state`` is the port's Adam state ``{"count", "mu", "nu"}`` when
    ``mu`` and ``nu`` are given (``count`` defaults to 0), else None.
    """
    dev = resolve_device(device)

    def to_tensor(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    params = tree_map(to_tensor, tree)
    if mu is None or nu is None:
        return params, None
    opt = {"count": int(np.asarray(count if count is not None else 0)),
           "mu": tree_map(to_tensor, mu), "nu": tree_map(to_tensor, nu)}
    return params, opt


def params_to_numpy(params: Any, opt_state: Optional[dict] = None
                    ) -> tuple[Any, Any, Any, Optional[int]]:
    """Inverse of :func:`params_from_numpy`: ``(tree, mu, nu, count)`` as
    numpy arrays (``mu``, ``nu`` and ``count`` None without an Adam
    state)."""
    def to_numpy(x):
        return x.detach().cpu().numpy()

    tree = tree_map(to_numpy, params)
    if opt_state is None:
        return tree, None, None, None
    return (tree, tree_map(to_numpy, opt_state["mu"]),
            tree_map(to_numpy, opt_state["nu"]), int(opt_state["count"]))
