# encodermap_tpu_torch/models/adc.py
"""The AngleDihedralCartesian (ADC) model: an internal-coordinate
autoencoder with backmapping inside the step.

Counterpart of the dense and sparse non-sidechain part of
``encodermap_tpu/models/adc.py`` (after the reference's functional graph,
``models/models.py:385-1060``). Inputs are always ``(angles,
central_dihedrals, cartesians, distances[, side_dihedrals])``:

  per-group unit-circle projection (sin||cos)  [PeriodicInput]
        -> concat -> encoder MLP -> latent
        -> decoder MLP -> split by group -> atan2   [PeriodicOutput]
  out_angles = batch mean of the input angles when angles are not trained
  BackMap: mean bond lengths -> chain_in_plane -> dihedrals + pi -> 3-D
  pair distances of the ``cartesian_pwd_*`` slice of both coordinate sets

Sparse (NaN-padded) data goes through square densifier layers. Multimer
training and sidechain reconstruction raise ``NotImplementedError``: they
are a later slice of the port.
"""

from __future__ import annotations

from math import pi
from typing import Any, NamedTuple, Optional

import torch

from ..nn import ACTIVATIONS, dense_apply, dense_init, l2_sum, mlp_apply, mlp_init
from ..ops.backmap import backmap as backmap_op
from ..ops.distances import pairwise_dist
from ..parameters import ADCParameters

__all__ = ["ADCShapes", "init_params", "densify_inputs", "encode", "decode",
           "forward", "cartesian_pwd_slice", "cartesian_pwd_matrix",
           "decoder_splits", "regularization_sum", "check_supported"]

LATER_SLICE = ("is not ported to encodermap_tpu_torch yet (the sidechain and "
               "multimer slice of the port); train it with encodermap_tpu")


class ADCShapes(NamedTuple):
    """Input widths: angles, dihedrals, cartesian atoms, distances and side
    dihedrals (0 = no sidechain training)."""

    n_angles: int
    n_dihedrals: int
    n_cartesians: int
    n_distances: int
    n_side_dihedrals: int = 0

    @classmethod
    def from_data(cls, angles, dihedrals, cartesians, distances,
                  side_dihedrals=None) -> "ADCShapes":
        return cls(angles.shape[1], dihedrals.shape[1], cartesians.shape[1],
                   distances.shape[1],
                   0 if side_dihedrals is None else side_dihedrals.shape[1])


def check_supported(p: ADCParameters) -> None:
    """Raise for the ADC modes that wait for a later slice of the port."""
    if p.multimer_training is not None:
        raise NotImplementedError(f"multimer_training {LATER_SLICE}")
    if p.reconstruct_sidechains:
        raise NotImplementedError(f"reconstruct_sidechains {LATER_SLICE}")


def _encoder_in_dim(p: ADCParameters, shapes: ADCShapes) -> int:
    check_supported(p)
    dim = 2 * shapes.n_dihedrals
    if p.use_backbone_angles:
        dim += 2 * shapes.n_angles
    if p.use_sidechains:
        dim += 2 * shapes.n_side_dihedrals
    return dim


def decoder_splits(p: ADCParameters, shapes: ADCShapes) -> list[int]:
    """Widths of the decoder-output groups in unit-circle space
    (reference ``models.py:1942-2025``)."""
    check_supported(p)
    if not p.use_backbone_angles:
        if p.use_sidechains:
            # the reference rejects this combination too (models.py:2019)
            raise ValueError("use_sidechains=True requires "
                             "use_backbone_angles=True")
        return [2 * shapes.n_dihedrals]
    splits = [2 * shapes.n_angles, 2 * shapes.n_dihedrals]
    if p.use_sidechains:
        splits.append(2 * shapes.n_side_dihedrals)
    return splits


def init_params(generator: torch.Generator, p: ADCParameters,
                shapes: ADCShapes, dtype: torch.dtype = torch.float32,
                sparse: bool = False, device: Any = "cpu") -> dict:
    """``{"encoder", "decoder"}`` dense stacks, plus ``"densifiers"`` (one
    square Dense layer per input) in sparse mode: NaNs are zero-filled and
    ``x @ W`` then equals the reference's sparse-dense product
    (``models.py:2667-2950``)."""
    in_dim = _encoder_in_dim(p, shapes)
    out_dim = sum(decoder_splits(p, shapes))
    enc_dims = [in_dim] + list(p.n_neurons)
    dec_dims = [p.n_neurons[-1]] + list(p.n_neurons[-2::-1]) + [out_dim]
    params = {"encoder": mlp_init(generator, enc_dims, dtype, device=device),
              "decoder": mlp_init(generator, dec_dims, dtype, device=device)}
    if sparse:
        widths = {"dihedrals": shapes.n_dihedrals, "angles": shapes.n_angles,
                  "cartesians": shapes.n_cartesians * 3,
                  "distances": shapes.n_distances}
        if shapes.n_side_dihedrals:
            widths["side_dihedrals"] = shapes.n_side_dihedrals
        params["densifiers"] = {
            name: dense_init(generator, w, w, dtype, device=device)
            for name, w in widths.items()}
    return params


def densify_inputs(params: dict, inputs: tuple) -> tuple:
    """Zero-fill NaNs and pass each input through its densifier (identity
    without densifiers). ``(B, 0)`` placeholders stay as they are."""
    if "densifiers" not in params:
        return tuple(torch.nan_to_num(x) for x in inputs)
    dens = params["densifiers"]
    angles, dihedrals, cartesians, distances = inputs[:4]
    B = angles.shape[0]

    def one(name, x):
        return x if x.numel() == 0 else dense_apply(dens[name], torch.nan_to_num(x))

    out = [one("angles", angles), one("dihedrals", dihedrals),
           one("cartesians", cartesians.reshape(B, -1)).reshape(B, -1, 3)
           if cartesians.numel() else cartesians,
           one("distances", distances)]
    if len(inputs) >= 5:
        out.append(one("side_dihedrals", inputs[4]) if "side_dihedrals" in dens
                   else torch.nan_to_num(inputs[4]))
    return tuple(out)


def _unit_circle(x: torch.Tensor, periodicity: float) -> torch.Tensor:
    """PeriodicInput: rescale to 2*pi, emit sin||cos."""
    if periodicity != 2 * pi:
        x = x / periodicity * 2 * pi
    return torch.cat([torch.sin(x), torch.cos(x)], dim=1)


def _from_unit_circle(x: torch.Tensor, periodicity: float) -> torch.Tensor:
    """PeriodicOutput: atan2 of the halves, rescaled back."""
    s, c = torch.chunk(x, 2, dim=1)
    out = torch.atan2(s, c)
    if periodicity != 2 * pi:
        out = out / (2 * pi) * periodicity
    return out


def _compute_dtype(p: ADCParameters) -> Optional[torch.dtype]:
    return torch.bfloat16 if p.compute_dtype == "bfloat16" else None


def encode(params: dict, p: ADCParameters, inputs: tuple) -> torch.Tensor:
    """Unit-circle projections of the trained groups in (angles, dihedrals,
    side_dihedrals) order through the encoder MLP."""
    groups = []
    if p.use_backbone_angles:
        groups.append(_unit_circle(inputs[0], p.periodicity))
    groups.append(_unit_circle(inputs[1], p.periodicity))
    if p.use_sidechains:
        if len(inputs) < 5:
            raise ValueError("use_sidechains=True needs the side_dihedrals input")
        groups.append(_unit_circle(inputs[4], p.periodicity))
    x = torch.cat(groups, dim=1) if len(groups) > 1 else groups[0]
    acts = [ACTIVATIONS[a] for a in p.activation_functions[1:]]
    return mlp_apply(params["encoder"], x, acts, _compute_dtype(p))


def decode(params: dict, p: ADCParameters, latent: torch.Tensor,
           shapes: ADCShapes) -> tuple:
    """Decoder MLP and per-group PeriodicOutput: ``(angles or None,
    dihedrals, side_dihedrals or None)``."""
    acts = [ACTIVATIONS[a] for a in p.activation_functions[-2::-1]]
    out = mlp_apply(params["decoder"], latent, acts, _compute_dtype(p))
    splits = decoder_splits(p, shapes)
    if not p.use_backbone_angles:
        return None, _from_unit_circle(out, p.periodicity), None
    parts = torch.split(out, splits, dim=1)
    side = _from_unit_circle(parts[2], p.periodicity) if p.use_sidechains else None
    return (_from_unit_circle(parts[0], p.periodicity),
            _from_unit_circle(parts[1], p.periodicity), side)


def _ca_slice(p: ADCParameters, cartesians: torch.Tensor) -> torch.Tensor:
    """The ``cartesian_pwd_*`` atom slice, with the reference's raw values:
    None everywhere takes every atom, ``start=1, step=3`` the CAs of an
    N-CA-C backbone (``models/layers.py:1252-1266``)."""
    return cartesians[:, p.cartesian_pwd_start:p.cartesian_pwd_stop:
                      p.cartesian_pwd_step]


def cartesian_pwd_slice(p: ADCParameters, cartesians: torch.Tensor
                        ) -> torch.Tensor:
    """Flat upper-triangle pair distances of the atom slice."""
    return pairwise_dist(_ca_slice(p, cartesians), flat=True)


def cartesian_pwd_matrix(p: ADCParameters, cartesians: torch.Tensor
                         ) -> torch.Tensor:
    """The atom slice's full ``(B, n, n)`` distance matrix."""
    return pairwise_dist(_ca_slice(p, cartesians))


def forward(params: dict, p: ADCParameters, inputs: tuple, shapes: ADCShapes,
            with_pairs: bool = True) -> tuple:
    """The ADC forward pass.

    Args:
        inputs: (angles, dihedrals, cartesians, distances[, side_dihedrals]),
            densified already in sparse mode.
        with_pairs: also compute the flat pair distances of the input and
            backmapped slices (the reference's model outputs); the trainer's
            losses read the coordinates instead and pass False.

    Returns:
        (out_angles, out_dihedrals, out_side_dihedrals or None,
         back_cartesians, inp_pairwise or None, out_pairwise or None, latent)
    """
    angles, _, cartesians, distances = inputs[:4]
    latent = encode(params, p, inputs)
    out_angles, out_dihedrals, out_side = decode(params, p, latent, shapes)
    if not p.use_backbone_angles:
        # MeanAngles (layers.py:1152-1160)
        out_angles = torch.mean(angles, dim=0, keepdim=True).expand(angles.shape)
    back = backmap_op(distances, out_angles, out_dihedrals)
    inp_pair = out_pair = None
    if with_pairs:
        inp_pair = cartesian_pwd_slice(p, cartesians)
        out_pair = cartesian_pwd_slice(p, back)
    return out_angles, out_dihedrals, out_side, back, inp_pair, out_pair, latent


def regularization_sum(params: dict) -> torch.Tensor:
    """L2 over encoder and decoder kernels; densifiers carry no
    regularizer."""
    return l2_sum({"encoder": params["encoder"], "decoder": params["decoder"]})

