# encodermap_tpu_torch/models/adc.py
"""The AngleDihedralCartesian (ADC) model: an internal-coordinate
autoencoder with backmapping inside the step.

Counterpart of ``encodermap_tpu/models/adc.py`` (after the reference's
functional graph, ``models/models.py:385-1060``). Inputs are ``(angles,
central_dihedrals, cartesians, distances[, side_dihedrals])``:

  per-group unit-circle projection (sin||cos)  [PeriodicInput]
        -> concat -> encoder MLP -> latent
        -> decoder MLP -> split by group -> atan2   [PeriodicOutput]
  out_angles = batch mean of the input angles when angles are not trained
  BackMap: mean bond lengths -> chain_in_plane -> dihedrals + pi -> 3-D
  pair distances of the ``cartesian_pwd_*`` slice of both coordinate sets

Sparse (NaN-padded) data goes through square densifier layers. Multimer
training (``multimer_training="homogeneous_transformation"``) adds the
input coordinates' pair distances to the encoder input and a ``(B, n - 1,
4, 4)`` transform group to the decoder output, and backmaps each protein
on its own (``ops/backmap.py::backmap_multimer``). Sidechain reconstruction
(``reconstruct_sidechains=True``) is a model of its own: seven inputs
``(central_angles, central_dihedrals, all_cartesians, central_distances,
side_angles, side_dihedrals, side_distances)``, four decoder groups, and
the sidechain backmap of ``ops/backmap_sidechains.py``.
"""

from __future__ import annotations

from math import pi
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .._tracing import span
from ..device import resolve_device
from ..nn import ACTIVATIONS, dense_apply, dense_init, l2_sum, mlp_apply, mlp_init
from ..ops.backmap import backmap as backmap_op
from ..ops.backmap import backmap_multimer
from ..ops.backmap_sidechains import _side_atoms_per_res, backmap_sidechains_fast
from ..ops.distances import pairwise_dist
from ..parameters import ADCParameters

__all__ = ["ADCShapes", "init_params", "densify_inputs", "encode", "decode",
           "forward", "cartesian_pwd_slice", "cartesian_pwd_matrix",
           "decoder_splits", "regularization_sum", "multimer_lengths_list",
           "validate_multimer", "ADCSidechainShapes", "sidechain_decoder_splits",
           "init_sidechain_params", "encode_sidechains", "decode_sidechains",
           "sidechain_pwd_indices", "forward_sidechains", "ADCFunctionalModel",
           "gen_functional_model"]


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


def multimer_lengths_list(p: ADCParameters) -> list[int]:
    """``p.multimer_lengths`` as residues per protein (empty when multimer
    training is off; reference ``models/models.py:846-859``): a sequence
    as it is, a dict (topology class -> lengths) only if every class has
    the same list. ``"homogeneous_transformation"`` is the only mode."""
    if p.multimer_training is None:
        return []
    if p.multimer_training != "homogeneous_transformation":
        raise ValueError(
            f"multimer_training must be None or 'homogeneous_transformation'"
            f", got {p.multimer_training!r}")
    ml = p.multimer_lengths
    if ml is None:
        raise ValueError(
            "multimer_training='homogeneous_transformation' needs "
            "multimer_lengths (residues per protein, or a dict of "
            "topology class -> lengths)")
    if isinstance(ml, dict):
        if p.multimer_topology_classes is not None:
            missing = [t for t in p.multimer_topology_classes if t not in ml]
            if missing:
                raise ValueError(f"multimer_lengths has no entry for topology "
                                 f"classes {missing}")
        keys = list(ml)
        first = [int(x) for x in ml[keys[0]]]
        for k in keys[1:]:
            if [int(x) for x in ml[k]] != first:
                raise ValueError(
                    "multimer training with multiple topology classes "
                    "requires the same number of residues per protein in "
                    f"all classes; {keys[0]!r} has {first}, {k!r} has "
                    f"{[int(x) for x in ml[k]]}")
        return first
    return [int(x) for x in ml]


def validate_multimer(p: ADCParameters, shapes: ADCShapes,
                      sparse: bool = False) -> list[int]:
    """Check a multimer configuration against the input widths (reference
    ``models/models.py:1198-1260``); returns the lengths list."""
    lengths = multimer_lengths_list(p)
    if not lengths:
        return lengths
    if not p.use_backbone_angles:
        raise ValueError("multimer training requires use_backbone_angles=True "
                         "(reference models.py:1211-1214)")
    if not p.use_sidechains:
        raise ValueError("multimer training requires use_sidechains=True "
                         "(reference models.py:1215-1218)")
    if p.reconstruct_sidechains:
        raise ValueError("multimer training and reconstruct_sidechains are "
                         "mutually exclusive (reference models.py:1108-1111)")
    if sparse:
        raise ValueError("multimer training does not support NaN-padded "
                         "(sparse) CVs (reference models.py:1108-1111)")
    n_at = sum(3 * L for L in lengths)
    n_d = sum(3 * L - 1 for L in lengths)
    n_a = sum(3 * L - 2 for L in lengths)
    n_di = sum(3 * L - 3 for L in lengths)
    if (shapes.n_cartesians, shapes.n_distances, shapes.n_angles,
            shapes.n_dihedrals) != (n_at, n_d, n_a, n_di):
        raise ValueError(
            f"multimer_lengths {lengths} expect per-protein concatenated "
            f"internal coordinates with {n_at} atoms / {n_d} distances / "
            f"{n_a} angles / {n_di} dihedrals; the data has "
            f"{shapes.n_cartesians} / {shapes.n_distances} / "
            f"{shapes.n_angles} / {shapes.n_dihedrals}")
    return lengths


def _multimer_pairwise_dim(p: ADCParameters, shapes: ADCShapes) -> int:
    """Width of the flat pair-distance block the multimer encoder also sees
    (``models.py:836-865``): the ``cartesian_pwd_*`` slice's pairs."""
    n_sel = len(range(shapes.n_cartesians)[_ca_slice_spec(p)])
    return n_sel * (n_sel - 1) // 2


def _encoder_in_dim(p: ADCParameters, shapes: ADCShapes) -> int:
    dim = 2 * shapes.n_dihedrals
    if p.use_backbone_angles:
        dim += 2 * shapes.n_angles
    if p.use_sidechains:
        dim += 2 * shapes.n_side_dihedrals
    if p.multimer_training is not None:
        dim += _multimer_pairwise_dim(p, shapes)
    return dim


def decoder_splits(p: ADCParameters, shapes: ADCShapes) -> list[int]:
    """Widths of the decoder-output groups in unit-circle space
    (reference ``models.py:1942-2025``); in multimer mode a last group of
    ``(n_proteins - 1) * 16`` transform entries (``models.py:1487-1488``)."""
    if not p.use_backbone_angles:
        if p.use_sidechains:
            # the reference rejects this combination too (models.py:2019)
            raise ValueError("use_sidechains=True requires "
                             "use_backbone_angles=True")
        return [2 * shapes.n_dihedrals]
    splits = [2 * shapes.n_angles, 2 * shapes.n_dihedrals]
    if p.use_sidechains:
        splits.append(2 * shapes.n_side_dihedrals)
    if p.multimer_training is not None:
        splits.append((len(multimer_lengths_list(p)) - 1) * 16)
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


def _encoder_activations(p: ADCParameters) -> list:
    return [ACTIVATIONS[a] for a in p.activation_functions[1:]]


def _decoder_activations(p: ADCParameters) -> list:
    # mirrored; the final "" is the linear output
    return [ACTIVATIONS[a] for a in p.activation_functions[-2::-1]]


def encode(params: dict, p: ADCParameters, inputs: tuple) -> torch.Tensor:
    """Unit-circle projections of the trained groups in (angles, dihedrals,
    side_dihedrals) order through the encoder MLP; a multimer model also
    sees the input coordinates' pair distances, since internal coordinates
    do not place the proteins (``models.py:836-865``)."""
    groups = []
    if p.use_backbone_angles:
        groups.append(_unit_circle(inputs[0], p.periodicity))
    groups.append(_unit_circle(inputs[1], p.periodicity))
    if p.use_sidechains:
        if len(inputs) < 5:
            raise ValueError("use_sidechains=True needs the side_dihedrals input")
        groups.append(_unit_circle(inputs[4], p.periodicity))
    if p.multimer_training is not None:
        groups.append(cartesian_pwd_slice(p, inputs[2]))
    x = torch.cat(groups, dim=1) if len(groups) > 1 else groups[0]
    return mlp_apply(params["encoder"], x, _encoder_activations(p), _compute_dtype(p))


def decode(params: dict, p: ADCParameters, latent: torch.Tensor,
           shapes: ADCShapes) -> tuple:
    """Decoder MLP and per-group PeriodicOutput: ``(angles or None,
    dihedrals, side_dihedrals or None)``, and in multimer mode a fourth
    value, the ``(B, n_proteins - 1, 4, 4)`` transforms (raw linear
    outputs; reference ``models.py:1523-1532``)."""
    out = mlp_apply(params["decoder"], latent, _decoder_activations(p),
                    _compute_dtype(p))
    splits = decoder_splits(p, shapes)
    if not p.use_backbone_angles:
        return None, _from_unit_circle(out, p.periodicity), None
    parts = torch.split(out, splits, dim=1)
    side = _from_unit_circle(parts[2], p.periodicity) if p.use_sidechains else None
    decoded = (_from_unit_circle(parts[0], p.periodicity),
               _from_unit_circle(parts[1], p.periodicity), side)
    if p.multimer_training is not None:
        n_proteins = len(multimer_lengths_list(p))
        return decoded + (parts[3].reshape(latent.shape[0], n_proteins - 1, 4, 4),)
    return decoded


def _ca_slice_spec(p: ADCParameters) -> slice:
    """The ``cartesian_pwd_*`` atom slice, with the reference's raw values:
    None everywhere takes every atom, ``start=1, step=3`` the CAs of an
    N-CA-C backbone (``models/layers.py:1252-1266``)."""
    return slice(p.cartesian_pwd_start, p.cartesian_pwd_stop, p.cartesian_pwd_step)


def _ca_slice(p: ADCParameters, cartesians: torch.Tensor) -> torch.Tensor:
    return cartesians[:, _ca_slice_spec(p)]


def cartesian_pwd_slice(p: ADCParameters, cartesians: torch.Tensor
                        ) -> torch.Tensor:
    """Flat upper-triangle pair distances of the atom slice."""
    return pairwise_dist(_ca_slice(p, cartesians), flat=True)


def cartesian_pwd_matrix(p: ADCParameters, cartesians: torch.Tensor
                         ) -> torch.Tensor:
    """The atom slice's full ``(B, n, n)`` distance matrix."""
    return pairwise_dist(_ca_slice(p, cartesians))


def forward(params: dict, p: ADCParameters, inputs: tuple, shapes: ADCShapes,
            with_pairs: bool = True, gather: Optional[Callable] = None) -> tuple:
    """The ADC forward pass.

    Args:
        inputs: (angles, dihedrals, cartesians, distances[, side_dihedrals]),
            densified already in sparse mode.
        with_pairs: also compute the flat pair distances of the input and
            backmapped slices (the reference's model outputs); the trainer's
            losses read the coordinates instead and pass False.
        gather: in a data-parallel step, the function that gathers every
            rank's rows: the batch means of MeanAngles and of the backmap's
            bond lengths are the global batch's.

    Returns:
        (out_angles, out_dihedrals, out_side_dihedrals or None,
         back_cartesians, inp_pairwise or None, out_pairwise or None, latent)
    """
    angles, _, cartesians, distances = inputs[:4]
    with span("adc.encode"):
        latent = encode(params, p, inputs)
    with span("adc.decode"):
        decoded = decode(params, p, latent, shapes)
        out_angles, out_dihedrals, out_side = decoded[:3]
        if not p.use_backbone_angles:
            # MeanAngles (layers.py:1152-1160), over the global batch
            rows = gather(angles) if gather is not None else angles
            out_angles = torch.mean(rows, dim=0, keepdim=True).expand(angles.shape)
    with span("adc.backmap"):
        if p.multimer_training is not None:
            # each protein rebuilt on its own, proteins 2..N placed by the
            # decoded transforms (models.py:946-953)
            back = backmap_multimer(multimer_lengths_list(p), distances, out_angles,
                                    out_dihedrals, decoded[3], gather)
        else:
            back = backmap_op(distances, out_angles, out_dihedrals, gather)
    inp_pair = out_pair = None
    if with_pairs:
        inp_pair = cartesian_pwd_slice(p, cartesians)
        out_pair = cartesian_pwd_slice(p, back)
    return out_angles, out_dihedrals, out_side, back, inp_pair, out_pair, latent


def regularization_sum(params: dict) -> torch.Tensor:
    """L2 over encoder and decoder kernels; densifiers carry no
    regularizer."""
    return l2_sum({"encoder": params["encoder"], "decoder": params["decoder"]})


# --------------------------------------------------- sidechain reconstruction
class ADCSidechainShapes(NamedTuple):
    """Input widths of the seven-input sidechain-reconstruction model."""

    n_central_angles: int
    n_central_dihedrals: int
    n_all_cartesians: int
    n_central_distances: int
    n_side_angles: int
    n_side_dihedrals: int
    n_side_distances: int

    @classmethod
    def from_data(cls, ca, cdi, ac, cd, sa, sdi, sd) -> "ADCSidechainShapes":
        return cls(ca.shape[1], cdi.shape[1], ac.shape[1], cd.shape[1],
                   sa.shape[1], sdi.shape[1], sd.shape[1])


def sidechain_decoder_splits(shapes: ADCSidechainShapes) -> list[int]:
    """Groups: central angles, central dihedrals, side angles, side
    dihedrals (reference ``_concatenate_inputs_reconstruct_sidechains``)."""
    return [2 * shapes.n_central_angles, 2 * shapes.n_central_dihedrals,
            2 * shapes.n_side_angles, 2 * shapes.n_side_dihedrals]


def init_sidechain_params(generator: torch.Generator, p: ADCParameters,
                          shapes: ADCSidechainShapes,
                          dtype: torch.dtype = torch.float32,
                          device: Any = "cpu") -> dict:
    """``{"encoder", "decoder"}`` of the sidechain model; the decoder's
    output is as wide as the encoder's input."""
    width = sum(sidechain_decoder_splits(shapes))
    enc_dims = [width] + list(p.n_neurons)
    dec_dims = [p.n_neurons[-1]] + list(p.n_neurons[-2::-1]) + [width]
    return {"encoder": mlp_init(generator, enc_dims, dtype, device=device),
            "decoder": mlp_init(generator, dec_dims, dtype, device=device)}


def encode_sidechains(params: dict, p: ADCParameters, inputs: tuple) -> torch.Tensor:
    """The encoder over the unit-circle projections of central angles,
    central dihedrals, side angles and side dihedrals."""
    x = torch.cat([_unit_circle(inputs[i], p.periodicity) for i in (0, 1, 4, 5)],
                  dim=1)
    return mlp_apply(params["encoder"], x, _encoder_activations(p), _compute_dtype(p))


def decode_sidechains(params: dict, p: ADCParameters, latent: torch.Tensor,
                      shapes: ADCSidechainShapes) -> tuple:
    """The decoder: ``(central_angles, central_dihedrals, side_angles,
    side_dihedrals)``."""
    out = mlp_apply(params["decoder"], latent, _decoder_activations(p),
                    _compute_dtype(p))
    return tuple(_from_unit_circle(x, p.periodicity)
                 for x in torch.split(out, sidechain_decoder_splits(shapes), dim=1))


def sidechain_pwd_indices(p: ADCParameters, spec) -> np.ndarray:
    """The atoms of the pair-distance costs in reconstruct mode: the
    ``cartesian_pwd_*`` slice of the backbone (the CAs, ``1::3``, when they
    are None) and the last atom of each sidechain branch.

    The JAX package's recorded divergence from the reference walk
    (``PairwiseDistances.__init__``, ``layers.py:1183-1208``, which lands
    ``branch_rank - 2`` atoms off the branch end): each branch's last atom,
    as the reference documents it."""
    n_backbone = spec.n_residues * 3
    start = p.cartesian_pwd_start if p.cartesian_pwd_start is not None else 1
    step = p.cartesian_pwd_step if p.cartesian_pwd_step is not None else 3
    idx = list(np.arange(n_backbone)[start:p.cartesian_pwd_stop:step])
    col = n_backbone
    for n_sc in _side_atoms_per_res(spec):
        if n_sc:
            idx.append(col + int(n_sc) - 1)
            col += int(n_sc)
    return np.asarray(idx, np.int64)


def forward_sidechains(params: dict, p: ADCParameters, inputs: tuple,
                       shapes: ADCSidechainShapes, spec, with_pairs: bool = True
                       ) -> tuple:
    """The sidechain model's forward pass.

    Args:
        inputs: (central_angles, central_dihedrals, all_cartesians,
            central_distances, side_angles, side_dihedrals, side_distances).
        with_pairs: also compute the flat pair distances of the input and
            backmapped :func:`sidechain_pwd_indices` atoms.

    Returns:
        (out_central_angles, out_central_dihedrals, out_side_angles,
         out_side_dihedrals, back_cartesians, inp_pair or None,
         out_pair or None, latent)
    """
    all_cartesians, central_distances, side_distances = inputs[2], inputs[3], inputs[6]
    with span("adc.encode"):
        latent = encode_sidechains(params, p, inputs)
    with span("adc.decode"):
        out_ca, out_cdi, out_sa, out_sdi = decode_sidechains(params, p, latent, shapes)
    with span("adc.backmap"):
        back = backmap_sidechains_fast(spec, central_distances, out_ca, out_cdi,
                                       side_distances, out_sa, out_sdi)
    inp_pair = out_pair = None
    if with_pairs:
        idx = torch.as_tensor(sidechain_pwd_indices(p, spec), device=back.device)
        inp_pair = pairwise_dist(all_cartesians[:, idx], flat=True)
        out_pair = pairwise_dist(back[:, idx], flat=True)
    return out_ca, out_cdi, out_sa, out_sdi, back, inp_pair, out_pair, latent


# ------------------------------------------------------------ model bundle
class ADCFunctionalModel:
    """The ADC parameters with the functions above (reference
    ``models/models.py:2152-2523``): ``model(inputs)`` runs :func:`forward`,
    ``model.encoder(inputs)`` and ``model.decoder(latent)`` the halves.
    ``inputs`` is ``(angles, dihedrals, cartesians, distances[,
    side_dihedrals])``. The parameters come from ``seed`` (``p.seed``, else
    0) through a ``torch.Generator``: the same distributions as the JAX
    package's, not the same numbers. ``device`` None means the card (pass
    ``"cpu"`` without one)."""

    def __init__(self, input_shapes, parameters: Optional[ADCParameters] = None,
                 sparse: bool = False, seed: Optional[int] = None,
                 device: Any = None) -> None:
        self.p = parameters if parameters is not None else ADCParameters()
        a, d, c, dist = input_shapes[:4]
        side = input_shapes[4] if len(input_shapes) >= 5 else None
        self.shapes = ADCShapes(
            n_angles=int(np.atleast_1d(a)[-1]), n_dihedrals=int(np.atleast_1d(d)[-1]),
            # cartesians as (n_atoms, 3) or n_atoms
            n_cartesians=int(np.atleast_1d(c)[0]), n_distances=int(np.atleast_1d(dist)[-1]),
            n_side_dihedrals=0 if side is None else int(np.atleast_1d(side)[-1]))
        self.sparse = bool(sparse)
        # an invalid multimer configuration raises here, not in decode()
        validate_multimer(self.p, self.shapes, sparse=self.sparse)
        self.device = resolve_device(device)
        if seed is None:
            seed = self.p.seed if self.p.seed is not None else 0
        self.params = init_params(torch.Generator().manual_seed(int(seed)), self.p,
                                  self.shapes, sparse=sparse, device=self.device)

    def _prep(self, inputs: tuple) -> tuple:
        inputs = tuple(torch.as_tensor(x, dtype=torch.float32, device=self.device)
                       for x in inputs)
        return densify_inputs(self.params, inputs) if self.sparse else inputs

    def encoder(self, inputs: tuple) -> torch.Tensor:
        return encode(self.params, self.p, self._prep(inputs))

    def decoder(self, latent) -> tuple:
        z = torch.as_tensor(latent, dtype=torch.float32, device=self.device)
        return decode(self.params, self.p, z, self.shapes)

    def __call__(self, inputs: tuple) -> tuple:
        return forward(self.params, self.p, self._prep(inputs), self.shapes)


def gen_functional_model(input_shapes, parameters: Optional[ADCParameters] = None,
                         sparse: bool = False, seed: Optional[int] = None,
                         device: Any = None) -> ADCFunctionalModel:
    """The model factory with the reference's core signature
    (``models/models.py:385-1060``): ``input_shapes`` is ``((n_angles,),
    (n_dihedrals,), (n_cartesians, 3), (n_distances,)[,
    (n_side_dihedrals,)])``."""
    return ADCFunctionalModel(input_shapes, parameters, sparse=sparse, seed=seed,
                              device=device)
