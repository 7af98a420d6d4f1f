# encodermap_tpu_torch/losses.py
"""EncoderMap's loss functions on torch tensors.

Counterpart of the EncoderMap subset of ``encodermap_tpu/losses.py`` (after
the reference's ``loss_functions/loss_functions.py:200-628``):

* ``sigmoid_loss``        — sketch-map cost between high-D and latent pairwise dists
* ``distance_loss``       — sigmoid_loss * distance_cost_scale
* ``auto_loss``           — periodic distance between input and reconstruction
* ``center_loss``         — mean(latent**2) * scale
* ``regularization_loss`` — l2_reg_constant * sum of squared kernels
* ``reconstruction_loss`` / ``loss_combinator`` for custom training loops.

The ADC losses wait for the ADC slice of the port.
"""

from __future__ import annotations

import torch

from .ops.distances import periodic_distance as _periodic_distance
from .ops.fused_sigmoid import fused_or_reference
from .parameters import Parameters

__all__ = [
    "sigmoid_loss",
    "distance_loss",
    "auto_loss",
    "center_loss",
    "regularization_loss",
    "periodic_diff_cost",
    "reconstruction_loss",
    "loss_combinator",
]


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


def periodic_diff_cost(y_true: torch.Tensor, y_pred: torch.Tensor,
                       periodicity: float, variant: str) -> torch.Tensor:
    """The mean_abs/mean_square/mean_norm family over periodic differences
    (reference e.g. ``loss_functions.py:596-610``)."""
    d = _periodic_distance(y_true, y_pred, periodicity)
    if variant == "mean_square":
        return torch.mean(torch.square(d))
    if variant == "mean_abs":
        return torch.mean(torch.abs(d))
    if variant == "mean_norm":
        return torch.mean(torch.linalg.norm(d, dim=1))
    raise ValueError(f"cost variant {variant!r} not available")


def sigmoid_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                 dist_sig_parameters: tuple, periodicity: float) -> torch.Tensor:
    """Sketch-map sigmoid cost between all-pairs distances of ``y_true``
    (high-D, optionally periodic) and ``y_pred`` (latent, Euclidean);
    reference ``loss_functions.py:301-369``. Batches on the card go through
    the sigmoid-loss kernels."""
    return fused_or_reference(y_true, y_pred, tuple(dist_sig_parameters),
                              periodicity)


def distance_loss(y_true: torch.Tensor, latent: torch.Tensor,
                  p: Parameters) -> torch.Tensor:
    """``sigmoid_loss * distance_cost_scale``; 0 if the scale is None
    (reference ``loss_functions.py:200-298``)."""
    if p.distance_cost_scale is None:
        return _zero(latent)
    cost = sigmoid_loss(y_true, latent, p.dist_sig_parameters, p.periodicity)
    return cost * p.distance_cost_scale


def auto_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
              p: Parameters) -> torch.Tensor:
    """Autoencoding cost over periodic distances (reference
    ``loss_functions.py:553-628``)."""
    if p.auto_cost_scale is None:
        return _zero(y_pred)
    cost = periodic_diff_cost(y_true, y_pred, p.periodicity,
                              p.auto_cost_variant)
    return cost * p.auto_cost_scale


def center_loss(latent: torch.Tensor, p: Parameters) -> torch.Tensor:
    """``mean(latent**2) * center_cost_scale`` (reference
    ``loss_functions.py:372-451``)."""
    if p.center_cost_scale is None:
        return _zero(latent)
    return torch.mean(torch.square(latent)) * p.center_cost_scale


def regularization_loss(l2_kernel_sum: torch.Tensor,
                        p: Parameters) -> torch.Tensor:
    """Keras ``regularizers.l2``: ``const * sum(w**2)`` over all kernels
    (reference ``loss_functions.py:454-508``)."""
    return p.l2_reg_constant * l2_kernel_sum


def reconstruction_loss(model=None):
    """Loss factory for custom training loops: mean-squared reconstruction
    error (reference ``loss_functions.py:511-551``). Returns
    ``loss(y_true, y_pred=None)``; without ``y_pred`` the ``model`` (any
    callable, e.g. a :class:`SequentialModel`) is called on ``y_true``."""

    def reconstruction_loss_func(y_true, y_pred=None):
        if y_pred is None:
            if model is None:
                raise ValueError("reconstruction_loss needs either a model "
                                 "at factory time or y_pred at call time")
            y_pred = model(y_true)
        return torch.mean(torch.square(y_pred - y_true))

    return reconstruction_loss_func


def loss_combinator(*losses):
    """Sum of loss closures, each called as ``loss(y_true, y_pred)``
    (reference ``loss_functions.py:146-198``)."""

    def combined_loss_func(y_true, y_pred=None):
        return sum(loss(y_true, y_pred) for loss in losses)

    return combined_loss_func
