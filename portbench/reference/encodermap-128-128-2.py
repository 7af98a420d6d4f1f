"""Plain reference of ``encodermap-128-128-2``: EncoderMap's autoencoder
with the sketch-map cost, trained by clipped Adam (reference EncoderMap:
``models/models.py`` SequentialModel, ``loss_functions.py`` auto, center,
regularization and distance costs).

Periodic inputs go onto the unit circle (sin and cos of each column), the
decoder's output comes back by atan2 of its halves. The loss is the
periodic mean absolute reconstruction error, the latent's mean square, the
kernels' L2 and the sketch-map cost of the raw inputs against the latent,
each with its scale.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import plain


def _check(p: dict) -> None:
    if p["auto_cost_variant"] != "mean_abs":
        raise ValueError("the reference computes the mean_abs auto cost only")


def in_out(p: dict, d0: int) -> int:
    return 2 * d0 if math.isfinite(p["periodicity"]) else d0


def weight_shapes(p: dict, data) -> list:
    d0 = data.shape[1]
    return plain.weight_shapes(in_out(p, d0), p["n_neurons"], in_out(p, d0))


def loss(p: dict, W: dict, x: torch.Tensor) -> torch.Tensor:
    period = float(p["periodicity"])
    enc_acts, dec_acts = plain.stack_acts(p["activation_functions"])
    h = plain.unit_circle(x, period) if math.isfinite(period) else x
    latent = plain.mlp(W, "encoder", h, enc_acts)
    y = plain.mlp(W, "decoder", latent, dec_acts)
    out = plain.from_unit_circle(y, period) if math.isfinite(period) else y
    return (p["auto_cost_scale"] * plain.periodic_abs(out, x, period).mean()
            + p["center_cost_scale"] * torch.mean(latent * latent)
            + p["l2_reg_constant"] * plain.l2(W)
            + p["distance_cost_scale"] * plain.sketchmap(
                x, latent, p["dist_sig_parameters"], period))


def follow(p: dict, weights: dict, data, rows, dtype: torch.dtype, device) -> dict:
    """The steps of ``rows`` (one batch of row indices each) from
    ``weights``, on ``data`` (the host array the program trained on)."""
    _check(p)

    def batch(r):
        return lambda: torch.as_tensor(data[r], device=device).to(dtype)

    return plain.follow(lambda W, x: loss(p, W, x), weights,
                        [batch(r) for r in rows], p["learning_rate"], 1.0, dtype, device)
