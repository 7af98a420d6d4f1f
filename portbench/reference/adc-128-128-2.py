"""Plain reference of ``adc-128-128-2``: the AngleDihedralCartesian
EncoderMap's step (reference EncoderMap: ``models/models.py`` functional
model, ``models/layers.py`` BackMapLayer, ``loss_functions.py``), trained
by clipped Adam.

The encoder sees the angles, dihedrals and side dihedrals on the unit
circle; the decoder's groups come back by atan2. The backmap builds the
backbone from the batch's mean bond lengths and the decoded angles and
dihedrals. The loss is the periodic mean absolute dihedral, angle and side
dihedral costs, the mean absolute difference of the CA pair distances
(input against backmapped), the sketch-map cost of the CA pair distances
against the latent, the sketch-map cost of the raw angle groups against the
latent, the latent's mean square and the kernels' L2, each with its scale
and reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import plain

CVS = ("central_angles", "central_dihedrals", "central_cartesians",
       "central_distances", "side_dihedrals")


def _check(p: dict) -> None:
    for key, want in (("use_backbone_angles", True), ("use_sidechains", True),
                      ("cartesian_cost_variant", "mean_abs"),
                      ("dihedral_cost_variant", "mean_abs"),
                      ("angle_cost_variant", "mean_abs"),
                      ("side_dihedral_cost_variant", "mean_abs"),
                      ("multimer_training", None), ("reconstruct_sidechains", False)):
        if p.get(key) != want:
            raise ValueError(f"the reference computes {key}={want!r} only")
    if list(p["cartesian_cost_scale_soft_start"]) != [None, None]:
        raise ValueError("the reference computes no soft start")


def weight_shapes(p: dict, data: dict) -> list:
    width = 2 * sum(data[k].shape[1] for k in
                    ("central_angles", "central_dihedrals", "side_dihedrals"))
    return plain.weight_shapes(width, p["n_neurons"], width)


def loss(p: dict, W: dict, batch: tuple) -> torch.Tensor:
    angles, dihedrals, xyz, distances, side = batch
    period = float(p["periodicity"])
    enc_acts, dec_acts = plain.stack_acts(p["activation_functions"])
    groups = (angles, dihedrals, side)
    latent = plain.mlp(W, "encoder", torch.cat(
        [plain.unit_circle(g, period) for g in groups], 1), enc_acts)
    y = plain.mlp(W, "decoder", latent, dec_acts)
    out_a, out_d, out_s = (plain.from_unit_circle(part, period) for part in
                           torch.split(y, [2 * g.shape[1] for g in groups], 1))
    back = plain.backmap(distances, out_a, out_d)
    sel = slice(p["cartesian_pwd_start"], p["cartesian_pwd_stop"], p["cartesian_pwd_step"])
    inp_pairs = plain.flat_pair_dists(xyz[:, sel])
    out_pairs = plain.flat_pair_dists(back[:, sel])
    return (p["dihedral_cost_scale"] / p["dihedral_cost_reference"]
            * plain.periodic_abs(out_d, dihedrals, period).mean()
            + p["angle_cost_scale"] / p["angle_cost_reference"]
            * plain.periodic_abs(out_a, angles, period).mean()
            + p["side_dihedral_cost_scale"] / p["side_dihedral_cost_reference"]
            * plain.periodic_abs(out_s, side, period).mean()
            + p["cartesian_cost_scale"] / p["cartesian_cost_reference"]
            * torch.abs(inp_pairs - out_pairs).mean()
            + p["cartesian_distance_cost_scale"] * plain.sketchmap(
                inp_pairs, latent, p["cartesian_dist_sig_parameters"], math.inf)
            + p["distance_cost_scale"] * plain.sketchmap(
                torch.cat(groups, 1), latent, p["dist_sig_parameters"], period)
            + p["center_cost_scale"] * torch.mean(latent * latent)
            + p["l2_reg_constant"] * plain.l2(W))


def follow(p: dict, weights: dict, data: dict, rows, dtype: torch.dtype, device) -> dict:
    """The steps of ``rows`` from ``weights`` on the CV arrays ``data``."""
    _check(p)

    def batch(r):
        return lambda: tuple(torch.as_tensor(data[k][r], device=device).to(dtype)
                             for k in CVS)

    return plain.follow(lambda W, b: loss(p, W, b), weights,
                        [batch(r) for r in rows], p["learning_rate"], 1.0, dtype, device)
