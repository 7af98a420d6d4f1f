# encodermap_tpu_torch/ops/cartesian_analytic.py
"""The ADC Cartesian costs for large proteins, with a hand-written backward.

Counterpart of ``encodermap_tpu/ops/cartesian_analytic.py``. The dense
losses (``losses.cartesian_loss_matrix`` and
``cartesian_distance_loss_matrix``) keep ``(B, n, n)`` tensors for autograd's
backward; :func:`cartesian_cost_analytic` keeps only the ``(B, n, 3)``
coordinates and recomputes the distance matrices in its backward, which
collapses to four ``(B, n, n) -> (B, n)`` reductions: with
``w_ij = c_ij / d^out_ij`` (``c`` the cost variant's coefficient)

    d acc / d x_i = 2 (x_i sum_j w_ij - sum_j w_ij x_j).

The CA-pair sigmoid loss needs only the Gram matrix of the input
distance rows (:func:`input_row_gram`), consumed by
``ops.blocked_cartesian.sigmoid_from_gram``. The JAX package takes that Gram
at ``Precision.HIGH`` on the TPU; the port takes it in full float32.

:data:`MIN_ANALYTIC_ATOMS` is the JAX package's crossover, measured on the
TPU; the port keeps it so that both take the same route, until the H100's
own crossover is measured.
"""

from __future__ import annotations

import torch

from .distances import component_plane_dists

__all__ = ["cartesian_cost_analytic", "input_row_gram", "MIN_ANALYTIC_ATOMS"]

#: selected-atom count from which the ADC trainer takes this module's forms
MIN_ANALYTIC_ATOMS = 320


def _dmat(x: torch.Tensor) -> torch.Tensor:
    """(B, n, n) pairwise distances with the shared diagonal guard."""
    return component_plane_dists(x, x)


def _reduce(diff: torch.Tensor, variant: str) -> torch.Tensor:
    if variant == "mean_abs":
        return torch.sum(torch.abs(diff))
    if variant == "mean_square":
        return torch.sum(torch.square(diff))
    if variant == "mean_norm":
        return torch.sum(torch.square(diff), dim=(1, 2))
    raise ValueError(f"cost variant {variant!r} not available")


class _CartesianCost(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out_xyz, inp_xyz, variant):
        ctx.save_for_backward(out_xyz, inp_xyz)
        ctx.variant = variant
        return _reduce(_dmat(inp_xyz) - _dmat(out_xyz), variant)

    @staticmethod
    def backward(ctx, g):
        out_xyz, inp_xyz = ctx.saved_tensors
        d_out = _dmat(out_xyz)
        delta = d_out - _dmat(inp_xyz)
        # mean_square and mean_norm share the quadratic coefficient
        c = torch.sign(delta) if ctx.variant == "mean_abs" else 2.0 * delta
        if ctx.variant == "mean_norm":
            c = c * g[:, None, None]     # per-sample cotangents
            gscale = 1.0
        else:
            gscale = g
        w = torch.where(d_out > 0.0, c / torch.clamp(d_out, min=1e-16),
                        torch.zeros_like(c))
        row_w = torch.sum(w, dim=2)
        comps = []
        for ax in range(3):
            xc = out_xyz[..., ax]
            wx = torch.sum(w * xc[:, None, :], dim=2)
            comps.append(2.0 * gscale * (xc * row_w - wx))
        return torch.stack(comps, dim=-1), None, None


def cartesian_cost_analytic(out_xyz: torch.Tensor, inp_xyz: torch.Tensor,
                            variant: str = "mean_abs") -> torch.Tensor:
    """The UN-normalized Cartesian cost between the full distance matrices
    of ``inp_xyz`` (training data, no gradient) and ``out_xyz``
    (backmapped, the gradient path): ``sum |D_in - D_out|`` (mean_abs),
    ``sum (.)^2`` (mean_square) or the per-sample ``(B,)`` squared sums
    (mean_norm), what ``losses.cartesian_loss_matrix`` reduces before its
    normalization."""
    return _CartesianCost.apply(out_xyz, inp_xyz.detach(), variant)


def input_row_gram(inp_xyz: torch.Tensor) -> torch.Tensor:
    """``(B, B)`` Gram matrix ``G[i, j] = <D_i, D_j>_F`` of the input
    distance-matrix rows: all the CA-pair sigmoid loss needs of its high-D
    side (``||v_i - v_j||^2 = G_ii + G_jj - 2 G_ij``)."""
    v = _dmat(inp_xyz).reshape(inp_xyz.shape[0], -1)
    return v @ v.T
