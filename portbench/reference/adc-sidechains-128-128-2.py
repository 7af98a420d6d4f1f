"""Plain reference of ``adc-sidechains-128-128-2``: the
AngleDihedralCartesianEncoderMap with ``reconstruct_sidechains=True``
(reference EncoderMap: ``models/models.py`` functional model,
``models/layers.py`` BackMapLayerWithSidechains, ``loss_functions.py``),
trained by clipped Adam.

The encoder sees the central angles, central dihedrals, side angles and
side dihedrals on the unit circle; the decoder's four groups come back by
atan2. The backmap (``sidechains.sweep``) places every atom and then sets
each angle and each dihedral in turn, one rotation each, from the value it
measures:

- placement: the backbone (N, CA, C per residue) along +x at the
  cumulative bond lengths, each residue's sidechain atoms in a column
  above its CA (+y) at the cumulative sidechain bond lengths;
- the central angles, vertex by vertex along the chain: the atoms past the
  vertex (the backbone atoms after it and the branches of the CAs after
  it) turn about +z through the vertex by ``|target - current|``;
- the side angles, branch by branch, atom by atom: the branch's atoms from
  the angle's far atom on turn about -z through the vertex by ``|target -
  current|`` (the first side angle is N-CA-CB, the second CA-CB-CG);
- the central dihedrals in turn: the atoms past the bond (b, c) (the
  backbone atoms after c and the branches of c and of the CAs after it)
  turn about the unit vector from b to c by ``target - current``;
- the side dihedrals, branch by branch: N-CA-CB-CG first, then CA-CB-CG-CD
  and so on, each turning the branch's atoms past its bond.

Departures from upstream, each of which the program has too:

- a current angle is measured exactly, ``atan2(|ba x bc|, ba . bc)``,
  where upstream's sweep clips the cosine to +-(1 - 1e-7) before arccos;
- the bond lengths are the batch's own, frame by frame, where the
  backbone-only BackMapLayer takes the batch mean;
- the sketch-map cost of the inputs sees all four angle groups, where
  upstream truncates the reconstruct mode's inputs to three
  (``loss_functions.py:279-281``);
- the Cartesian costs read the CAs (``cartesian_pwd_*``) and each branch's
  last atom, where upstream's walk (``PairwiseDistances.__init__``) lands
  ``branch_rank - 2`` atoms off the branch end.

The loss is the periodic mean absolute dihedral, angle (central and side)
and side dihedral costs, the mean absolute difference of the pair
distances of those atoms (input against backmapped), their sketch-map cost
against the latent, the sketch-map cost of the four raw angle groups
against the latent, the latent's mean square and the kernels' L2, each with
its scale and reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import plain, sidechains

CVS = ("central_angles", "central_dihedrals", "all_cartesians", "central_distances",
       "side_angles", "side_dihedrals", "side_distances")
#: the groups the encoder sees, as indices into CVS
GROUPS = (0, 1, 4, 5)


def _check(p: dict) -> None:
    for key, want in (("reconstruct_sidechains", True),
                      ("cartesian_cost_variant", "mean_abs"),
                      ("dihedral_cost_variant", "mean_abs"),
                      ("angle_cost_variant", "mean_abs"),
                      ("side_dihedral_cost_variant", "mean_abs"),
                      ("multimer_training", None)):
        if p.get(key) != want:
            raise ValueError(f"the reference computes {key}={want!r} only")
    if list(p["cartesian_cost_scale_soft_start"]) != [None, None]:
        raise ValueError("the reference computes no soft start")


def pair_atoms(p: dict) -> list:
    """The atoms of the Cartesian costs: the ``cartesian_pwd_*`` slice of
    the backbone, then each branch's last atom."""
    brs = sidechains.branches(p["sidechain_info"])
    nb = 3 * len({int(k) for k in p["sidechain_info"]})
    sel = list(range(nb))[slice(p["cartesian_pwd_start"], p["cartesian_pwd_stop"],
                                p["cartesian_pwd_step"])]
    end = nb
    for _, m in brs:
        end += m
        sel.append(end - 1)
    return sel


def _widths(data: dict) -> list:
    return [data[CVS[i]].shape[1] for i in GROUPS]


def weight_shapes(p: dict, data: dict) -> list:
    width = 2 * sum(_widths(data))
    return plain.weight_shapes(width, p["n_neurons"], width)


def shapes(p: dict, data: dict) -> dict:
    """The widths the cost readers count from: the encoder sees the four
    angle groups (206 raw columns on trp-cage), the backmap places every
    atom (114), and the Cartesian costs read the CAs and branch ends (37)."""
    enc_d = sum(_widths(data))
    dims = [2 * enc_d] + p["n_neurons"] + p["n_neurons"][-2::-1] + [2 * enc_d]
    return {"family": "adc", "B": p["batch_size"], "enc_d": enc_d, "dims": dims,
            "n_atoms": data["all_cartesians"].shape[1], "n_ca": len(pair_atoms(p)),
            "sig": tuple(p["dist_sig_parameters"]),
            "ca_sig": tuple(p["cartesian_dist_sig_parameters"])}


def loss(p: dict, W: dict, batch: tuple) -> torch.Tensor:
    ca, cdi, xyz, cd, sa, sdi, sd = batch
    period = float(p["periodicity"])
    enc_acts, dec_acts = plain.stack_acts(p["activation_functions"])
    groups = [batch[i] for i in GROUPS]
    latent = plain.mlp(W, "encoder", torch.cat(
        [plain.unit_circle(g, period) for g in groups], 1), enc_acts)
    y = plain.mlp(W, "decoder", latent, dec_acts)
    out_ca, out_cdi, out_sa, out_sdi = (
        plain.from_unit_circle(part, period)
        for part in torch.split(y, [2 * g.shape[1] for g in groups], 1))
    back = sidechains.sweep(p["sidechain_info"], cd, out_ca, out_cdi, sd, out_sa, out_sdi)
    sel = pair_atoms(p)
    inp_pairs = plain.flat_pair_dists(xyz[:, sel])
    out_pairs = plain.flat_pair_dists(back[:, sel])
    angle_scale = p["angle_cost_scale"] / p["angle_cost_reference"]
    return (p["dihedral_cost_scale"] / p["dihedral_cost_reference"]
            * plain.periodic_abs(out_cdi, cdi, period).mean()
            + angle_scale * plain.periodic_abs(out_ca, ca, period).mean()
            + angle_scale * plain.periodic_abs(out_sa, sa, period).mean()
            + p["side_dihedral_cost_scale"] / p["side_dihedral_cost_reference"]
            * plain.periodic_abs(out_sdi, sdi, period).mean()
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
