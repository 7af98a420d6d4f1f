# encodermap_tpu_torch/losses.py
"""EncoderMap's and the ADC trainer's loss functions on torch tensors.

Counterpart of ``encodermap_tpu/losses.py`` (after the reference's
``loss_functions/loss_functions.py:200-1067``):

* ``sigmoid_loss``            — sketch-map cost between high-D and latent pairwise dists
* ``distance_loss``           — sigmoid_loss * distance_cost_scale
* ``cartesian_distance_loss`` — sigmoid_loss (non-periodic) on CA pair dists vs latent,
  flat or from full distance matrices (``*_matrix``, sigma scaled by sqrt 2)
* ``cartesian_loss``          — mean-abs/square/norm between input and backmapped
  pair dists, times the soft-start scale; ``*_matrix``, ``*_analytic`` and
  ``*_blocked`` give the same values from full matrices, hand-written
  backwards or row blocks
* ``auto_loss``               — periodic distance between input and reconstruction
* ``dihedral/angle/side_dihedral_loss`` — periodic mean-abs family, / reference * scale
* ``center_loss``             — mean(latent**2) * scale
* ``regularization_loss``     — l2_reg_constant * sum of squared kernels
* ``reconstruction_loss`` / ``loss_combinator`` for custom training loops.
"""

from __future__ import annotations

from math import sqrt
from typing import Optional, Union

import torch

from .ops.blocked_cartesian import blocked_cartesian_terms, sigmoid_from_gram
from .ops.cartesian_analytic import cartesian_cost_analytic, input_row_gram
from .ops.distances import periodic_distance as _periodic_distance
from .ops.fused_sigmoid import fused_or_reference
from .parameters import ADCParameters, Parameters

__all__ = [
    "sigmoid_loss",
    "distance_loss",
    "cartesian_distance_loss",
    "cartesian_distance_loss_matrix",
    "cartesian_loss",
    "cartesian_loss_matrix",
    "cartesian_losses_analytic",
    "cartesian_losses_blocked",
    "auto_loss",
    "angle_loss",
    "dihedral_loss",
    "side_dihedral_loss",
    "center_loss",
    "regularization_loss",
    "periodic_diff_cost",
    "soft_start_scale",
    "reconstruction_loss",
    "loss_combinator",
]

Scale = Union[torch.Tensor, float, None]


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
                 dist_sig_parameters: tuple, periodicity: float,
                 h_precision: str = "highest") -> torch.Tensor:
    """Sketch-map sigmoid cost between all-pairs distances of ``y_true``
    (high-D, optionally periodic) and ``y_pred`` (latent, Euclidean);
    reference ``loss_functions.py:301-369``. Batches on the card go through
    the sigmoid-loss kernels; ``h_precision`` means float32 on every route
    (``fused_or_reference``)."""
    return fused_or_reference(y_true, y_pred, tuple(dist_sig_parameters),
                              periodicity, h_precision=h_precision)


def distance_loss(y_true: torch.Tensor, latent: torch.Tensor,
                  p: Parameters) -> torch.Tensor:
    """``sigmoid_loss * distance_cost_scale``; 0 if the scale is None
    (reference ``loss_functions.py:200-298``)."""
    if p.distance_cost_scale is None:
        return _zero(latent)
    cost = sigmoid_loss(y_true, latent, p.dist_sig_parameters, p.periodicity)
    return cost * p.distance_cost_scale


def cartesian_distance_loss(inp_pairwise: torch.Tensor, latent: torch.Tensor,
                            p: ADCParameters) -> torch.Tensor:
    """Sigmoid loss between flat CA pair distances (non-periodic) and the
    latent (reference ``loss_functions.py:873-944``)."""
    if p.cartesian_distance_cost_scale is None:
        return _zero(latent)
    cost = sigmoid_loss(inp_pairwise, latent, p.cartesian_dist_sig_parameters,
                        float("inf"))
    return cost * p.cartesian_distance_cost_scale


def cartesian_distance_loss_matrix(inp_mat: torch.Tensor, latent: torch.Tensor,
                                   p: ADCParameters) -> torch.Tensor:
    """:func:`cartesian_distance_loss` fed the FULL ``(B, n, n)`` CA distance
    matrices as ``(B, n^2)`` rows. The same value: each unordered pair
    appears twice in a row and the diagonal is zero, so row distances are
    ``sqrt(2)`` times the flat ones, which the sigmoid absorbs as
    ``sig(sqrt(2) r; sqrt(2) sig, a, b) == sig(r; sig, a, b)``
    (:func:`_matrix_sig_params`)."""
    if p.cartesian_distance_cost_scale is None:
        return _zero(latent)
    cost = sigmoid_loss(inp_mat.reshape(inp_mat.shape[0], -1), latent,
                        _matrix_sig_params(p), float("inf"), h_precision="high")
    return cost * p.cartesian_distance_cost_scale


def _matrix_sig_params(p: ADCParameters) -> tuple:
    """``cartesian_dist_sig_parameters`` for full-matrix rows: the high-D
    sigma times sqrt(2); the latent triplet unchanged. One definition for
    the matrix, analytic and blocked routes, which must stay equal."""
    sig_h, a_h, b_h, sig_l, a_l, b_l = p.cartesian_dist_sig_parameters
    return (sig_h * sqrt(2.0), a_h, b_h, sig_l, a_l, b_l)


def soft_start_scale(p: ADCParameters, step: int, device=None) -> torch.Tensor:
    """The soft-started Cartesian cost scale at global ``step`` (reference
    callback ``IncreaseCartesianCost``, ``callbacks/callbacks.py:532-606``):
    0 before ``a``, ``cartesian_cost_scale * (step - a) / (b - a)`` from
    ``a`` to ``b``, the full scale after ``b``; a 0-d float32 tensor.

    Example:
        >>> from encodermap_tpu_torch import ADCParameters
        >>> from encodermap_tpu_torch.losses import soft_start_scale
        >>> p = ADCParameters(cartesian_cost_scale=1.0,
        ...                   cartesian_cost_scale_soft_start=(10, 20))
        >>> [float(soft_start_scale(p, s)) for s in (5, 15, 25)]
        [0.0, 0.5, 1.0]
    """
    scale = torch.tensor(p.cartesian_cost_scale
                         if p.cartesian_cost_scale is not None else 0.0,
                         dtype=torch.float32, device=device)
    a, b = p.cartesian_cost_scale_soft_start
    if a is None or b is None:
        return scale
    step_f = torch.tensor(float(step), dtype=torch.float32, device=device)
    if a == b:
        # an instant switch-on: (step - a) / 0 would be NaN at step == a
        frac = (step_f >= a).to(torch.float32)
    else:
        frac = torch.clamp((step_f - a) / float(b - a), 0.0, 1.0)
    return scale * frac


def _cartesian_scale(p: ADCParameters, scale: Scale):
    if scale is None:
        return p.cartesian_cost_scale if p.cartesian_cost_scale is not None else 0.0
    return scale


def cartesian_loss(inp_pairwise: torch.Tensor, out_pairwise: torch.Tensor,
                   p: ADCParameters, scale: Scale = None) -> torch.Tensor:
    """Mean-abs/square/norm between input and backmapped pair distances,
    over ``cartesian_cost_reference``, times the (soft-started) scale
    (reference ``loss_functions.py:947-1067``)."""
    diff = inp_pairwise - out_pairwise
    if p.cartesian_cost_variant == "mean_square":
        cost = torch.mean(torch.square(diff))
    elif p.cartesian_cost_variant == "mean_abs":
        cost = torch.mean(torch.abs(diff))
    elif p.cartesian_cost_variant == "mean_norm":
        cost = torch.mean(torch.linalg.norm(diff, dim=1))
    else:
        raise ValueError(f"cartesian_cost_variant "
                         f"{p.cartesian_cost_variant!r} not available")
    return cost / p.cartesian_cost_reference * _cartesian_scale(p, scale)


def _normalized_cartesian(acc: torch.Tensor, n: int, B: int,
                          p: ADCParameters, scale: Scale) -> torch.Tensor:
    """The full-matrix reduction ``acc`` normalized as the flat form is:
    each pair appears twice, the diagonal adds nothing."""
    if p.cartesian_cost_variant in ("mean_square", "mean_abs"):
        cost = acc / (2 * (n * (n - 1) // 2) * B)
    else:  # mean_norm: per-sample full-matrix squared sums
        cost = torch.mean(torch.sqrt(acc / 2.0))
    return cost / p.cartesian_cost_reference * _cartesian_scale(p, scale)


def cartesian_loss_matrix(inp_mat: torch.Tensor, out_mat: torch.Tensor,
                          p: ADCParameters, scale: Scale = None) -> torch.Tensor:
    """:func:`cartesian_loss` from FULL ``(B, n, n)`` distance matrices: the
    same value, with a dense reduction for a backward."""
    diff = inp_mat - out_mat
    if p.cartesian_cost_variant == "mean_square":
        acc = torch.sum(torch.square(diff))
    elif p.cartesian_cost_variant == "mean_abs":
        acc = torch.sum(torch.abs(diff))
    elif p.cartesian_cost_variant == "mean_norm":
        acc = torch.sum(torch.square(diff), dim=(-1, -2))
    else:
        raise ValueError(f"cartesian_cost_variant "
                         f"{p.cartesian_cost_variant!r} not available")
    return _normalized_cartesian(acc, inp_mat.shape[-1], inp_mat.shape[0], p,
                                 scale)


def cartesian_losses_analytic(inp_xyz: torch.Tensor, out_xyz: torch.Tensor,
                              latent: torch.Tensor, p: ADCParameters,
                              scale: Scale = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cartesian_loss, cartesian_distance_loss)`` for large proteins
    through ``ops.cartesian_analytic``: a backward that recomputes the
    distance matrices, and the CA-pair sigmoid from one Gram of the input
    rows. The values of :func:`cartesian_loss_matrix` and
    :func:`cartesian_distance_loss_matrix` up to float32 order.

    Args:
        inp_xyz / out_xyz: ``(B, n, 3)`` selected input / backmapped
            coordinates; no gradient flows to the input side.
        latent: ``(B, d)`` latent points.
    """
    B, n, _ = inp_xyz.shape
    acc = cartesian_cost_analytic(out_xyz, inp_xyz, p.cartesian_cost_variant)
    cart = _normalized_cartesian(acc, n, B, p, scale)
    if p.cartesian_distance_cost_scale is None:
        return cart, _zero(latent)
    cdist = sigmoid_from_gram(input_row_gram(inp_xyz.detach()), latent,
                              _matrix_sig_params(p))
    return cart, cdist * p.cartesian_distance_cost_scale


def cartesian_losses_blocked(inp_xyz: torch.Tensor, out_xyz: torch.Tensor,
                             latent: torch.Tensor, p: ADCParameters,
                             scale: Scale = None, block: int = 128
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cartesian_loss, cartesian_distance_loss)`` for large proteins
    from row blocks (``ops.blocked_cartesian``), never materializing the
    ``(B, n, n)`` matrices; the values of the matrix forms up to float32
    order."""
    want_sigmoid = p.cartesian_distance_cost_scale is not None
    acc, gram = blocked_cartesian_terms(inp_xyz, out_xyz,
                                        variant=p.cartesian_cost_variant,
                                        block=block, with_gram=want_sigmoid)
    B, n, _ = inp_xyz.shape
    cart = _normalized_cartesian(acc, n, B, p, scale)
    if not want_sigmoid:
        return cart, _zero(latent)
    cdist = sigmoid_from_gram(gram, latent, _matrix_sig_params(p))
    return cart, cdist * p.cartesian_distance_cost_scale


def auto_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
              p: Parameters) -> torch.Tensor:
    """Autoencoding cost over periodic distances (reference
    ``loss_functions.py:553-628``)."""
    if p.auto_cost_scale is None:
        return _zero(y_pred)
    cost = periodic_diff_cost(y_true, y_pred, p.periodicity,
                              p.auto_cost_variant)
    return cost * p.auto_cost_scale


def _angle_family(y_true: torch.Tensor, y_pred: torch.Tensor,
                  p: ADCParameters, scale: Optional[float], variant: str,
                  reference: float) -> torch.Tensor:
    if scale is None:
        return _zero(y_pred)
    cost = periodic_diff_cost(y_true, y_pred, p.periodicity, variant)
    return cost / reference * scale


def dihedral_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                  p: ADCParameters) -> torch.Tensor:
    """Reference ``loss_functions.py:631-712``."""
    return _angle_family(y_true, y_pred, p, p.dihedral_cost_scale,
                         p.dihedral_cost_variant, p.dihedral_cost_reference)


def angle_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
               p: ADCParameters) -> torch.Tensor:
    """Reference ``loss_functions.py:790-870``."""
    return _angle_family(y_true, y_pred, p, p.angle_cost_scale,
                         p.angle_cost_variant, p.angle_cost_reference)


def side_dihedral_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                       p: ADCParameters) -> torch.Tensor:
    """Reference ``loss_functions.py:715-787``."""
    return _angle_family(y_true, y_pred, p, p.side_dihedral_cost_scale,
                         p.side_dihedral_cost_variant,
                         p.side_dihedral_cost_reference)


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
