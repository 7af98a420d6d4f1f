# encodermap_tpu_torch/ops/blocked_cartesian.py
"""The ADC Cartesian costs blockwise, for proteins whose ``(B, n, n)``
distance matrices should never exist.

Counterpart of ``encodermap_tpu/ops/blocked_cartesian.py``. A loop over
row blocks of the atom axis computes ``(B, R, n)`` distance slabs of the
input and the backmapped coordinates, reduces them into the Cartesian cost
and accumulates the ``(B, B)`` Gram matrix of the input distance rows (all
the CA-pair sigmoid loss needs). Each block body runs under
``torch.utils.checkpoint``: the backward recomputes its slabs instead of
storing them, so the peak memory is ``O(B R n)`` per block, as the JAX
package's ``jax.checkpoint`` scan keeps it. The last block is ragged
instead of zero-padded and masked; the sums are the same up to float32
order.

:data:`MIN_BLOCKED_ATOMS` is the JAX package's threshold, set on the TPU
for memory; the port keeps it so that both take the same route.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .distances import component_plane_dists, pairwise_dist, sigmoid, sqrt_guard

__all__ = ["blocked_cartesian_terms", "sigmoid_from_gram", "MIN_BLOCKED_ATOMS"]

#: selected-atom count from which the ADC trainer takes the blocked forms
MIN_BLOCKED_ATOMS = 1536


def _block_terms(in_blk, out_blk, inp_xyz, out_xyz, variant, with_gram):
    d_in = component_plane_dists(in_blk, inp_xyz)      # (B, R, n)
    diff = d_in - component_plane_dists(out_blk, out_xyz)
    if variant == "mean_square":
        acc = torch.sum(torch.square(diff))
    elif variant == "mean_abs":
        acc = torch.sum(torch.abs(diff))
    elif variant == "mean_norm":
        acc = torch.sum(torch.square(diff), dim=(1, 2))
    else:
        raise ValueError(f"cost variant {variant!r} not available")
    if not with_gram:
        return acc, None
    v = d_in.reshape(d_in.shape[0], -1)
    return acc, v @ v.T


def blocked_cartesian_terms(inp_xyz: torch.Tensor, out_xyz: torch.Tensor,
                            variant: str = "mean_abs", block: int = 128,
                            with_gram: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cartesian-cost reduction and input-row Gram, never materializing
    ``(B, n, n)``.

    Args:
        inp_xyz: ``(B, n, 3)`` selected input coordinates (no gradient).
        out_xyz: ``(B, n, 3)`` backmapped coordinates, the gradient path.
        variant: mean_abs / mean_square give a scalar, mean_norm ``(B,)``.
        block: rows per block.
        with_gram: also accumulate the input-row Gram (zeros otherwise).

    Returns:
        ``(acc, gram)``: the UN-normalized reduction over the full
        matrices (what ``losses.cartesian_loss_matrix`` reduces before its
        normalization) and the ``(B, B)`` Gram.
    """
    inp_xyz = inp_xyz.detach()
    B, n, _ = inp_xyz.shape
    acc = torch.zeros((B,) if variant == "mean_norm" else (),
                      dtype=inp_xyz.dtype, device=inp_xyz.device)
    gram = torch.zeros((B, B), dtype=inp_xyz.dtype, device=inp_xyz.device)
    for start in range(0, n, block):
        rows = slice(start, start + block)
        a, g = checkpoint(_block_terms, inp_xyz[:, rows], out_xyz[:, rows],
                          inp_xyz, out_xyz, variant, with_gram,
                          use_reentrant=False)
        acc = acc + a
        if with_gram:
            gram = gram + g
    return acc, gram


def sigmoid_from_gram(gram: torch.Tensor, latent: torch.Tensor,
                      params: tuple) -> torch.Tensor:
    """Sketch-map cost with the high-D distances taken from a Gram matrix of
    the high-D rows: ``||v_i - v_j||^2 = G_ii + G_jj - 2 G_ij``, clamped at
    zero with an exact-zero diagonal (``pairwise_dist``'s Gram convention),
    then ``mean((sig_h(d_h) - sig_l(d_l))^2)`` over the ``(B, B)`` grid."""
    sig_h, a_h, b_h, sig_l, a_l, b_l = params
    s = torch.diagonal(gram)
    d2 = torch.clamp(s[:, None] + s[None, :] - 2.0 * gram, min=0.0)
    d2 = d2 * (1.0 - torch.eye(d2.shape[0], dtype=d2.dtype, device=d2.device))
    return torch.mean(torch.square(sigmoid(sig_h, a_h, b_h)(sqrt_guard(d2))
                                   - sigmoid(sig_l, a_l, b_l)(pairwise_dist(latent))))
