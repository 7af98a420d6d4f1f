"""Plain reference of ``adc-multimer-128-128-2``: the AngleDihedralCartesian
EncoderMap's multimer training (reference EncoderMap:
``ADCParameters.multimer_training="homogeneous_transformation"``,
``models/models.py`` functional model, ``models/layers.py``
BackMapLayerTransformations, ``loss_functions.py``), trained by clipped
Adam.

The encoder sees the angles, dihedrals and side dihedrals on the unit
circle and the flat pair distances of the input's CA atoms (internal
coordinates do not place the proteins). The decoder's groups come back by
atan2, and its last ``(n_proteins - 1) x 16`` outputs are the 4x4
transforms. The backmap builds each chain on its own from its batch-mean
bond lengths and its decoded angles and dihedrals (``plain.backmap``), and
places chain ``i > 1`` by ``[xyz, 1] @ M_i``. The loss is the backbone
ADC's (``adc-128-128-2.py``) over the whole complex: the CA pairs span both
chains.

The Cartesian sketch-map cost is taken over the flat CA pairs. The program
feeds its sigmoid the full distance matrices from 64 selected atoms on,
whose row distances are sqrt(2) times the flat ones, and scales sigma by
sqrt(2) (``losses.py::cartesian_distance_loss_matrix``): the same value,
which this form checks independently. The pair distances between rows of
the flat CA block are taken by direct differences in row blocks, never by
the Gram identity, so that they fit and do not cancel.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import plain

CVS = ("central_angles", "central_dihedrals", "central_cartesians",
       "central_distances", "side_dihedrals")
GROUPS = ("central_angles", "central_dihedrals", "side_dihedrals")
#: rows of one block of the flat CA block's row-pair distances
ROW_BLOCK = 16


def _check(p: dict) -> None:
    for key, want in (("use_backbone_angles", True), ("use_sidechains", True),
                      ("cartesian_cost_variant", "mean_abs"),
                      ("dihedral_cost_variant", "mean_abs"),
                      ("angle_cost_variant", "mean_abs"),
                      ("side_dihedral_cost_variant", "mean_abs"),
                      ("multimer_training", "homogeneous_transformation"),
                      ("reconstruct_sidechains", False)):
        if p.get(key) != want:
            raise ValueError(f"the reference computes {key}={want!r} only")
    if not isinstance(p.get("multimer_lengths"), list):
        raise ValueError("the reference takes multimer_lengths as a list")
    if list(p["cartesian_cost_scale_soft_start"]) != [None, None]:
        raise ValueError("the reference computes no soft start")


def _sel(p: dict) -> slice:
    return slice(p["cartesian_pwd_start"], p["cartesian_pwd_stop"], p["cartesian_pwd_step"])


def _widths(p: dict, data: dict) -> tuple[int, int, int, int]:
    """The angle groups' columns, the selected atoms, the encoder's input
    and the decoder's output widths."""
    enc_d = sum(data[k].shape[1] for k in GROUPS)
    n_atoms = data["central_cartesians"].shape[1]
    n_ca = len(range(n_atoms)[_sel(p)])
    in_dim = 2 * enc_d + n_ca * (n_ca - 1) // 2
    return enc_d, n_ca, in_dim, 2 * enc_d + 16 * (len(p["multimer_lengths"]) - 1)


def weight_shapes(p: dict, data: dict) -> list:
    _, _, in_dim, out_dim = _widths(p, data)
    return plain.weight_shapes(in_dim, p["n_neurons"], out_dim)


def shapes(p: dict, data: dict) -> dict:
    """The widths the cost readers count from: the dense stack with the
    encoder's pair block and the decoder's transform head, the angle groups'
    columns of the input's sketch-map cost, every atom backmapped and the
    CAs of the Cartesian costs."""
    enc_d, n_ca, in_dim, out_dim = _widths(p, data)
    dims = [in_dim] + p["n_neurons"] + p["n_neurons"][-2::-1] + [out_dim]
    return {"family": "adc", "B": p["batch_size"], "enc_d": enc_d, "dims": dims,
            "n_atoms": data["central_cartesians"].shape[1], "n_ca": n_ca,
            "sig": tuple(p["dist_sig_parameters"]),
            "ca_sig": tuple(p["cartesian_dist_sig_parameters"])}


def backmap(lengths: list, distances: torch.Tensor, angles: torch.Tensor,
            dihedrals: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Each chain by ``plain.backmap`` from its own columns, chain ``i > 0``
    placed by ``[xyz, 1] @ mats[:, i - 1]``."""
    out, d0, a0, t0 = [], 0, 0, 0
    for i, L in enumerate(lengths):
        nd, na, nt = 3 * L - 1, 3 * L - 2, 3 * L - 3
        xyz = plain.backmap(distances[:, d0:d0 + nd], angles[:, a0:a0 + na],
                            dihedrals[:, t0:t0 + nt])
        if i:
            ones = torch.ones_like(xyz[..., :1])
            xyz = (torch.cat([xyz, ones], -1) @ mats[:, i - 1])[..., :3]
        out.append(xyz)
        d0, a0, t0 = d0 + nd, a0 + na, t0 + nt
    return torch.cat(out, 1)


def row_d2(h: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances of all row pairs of the data ``h`` (no
    gradient), ``ROW_BLOCK`` rows at a time by direct differences."""
    with torch.no_grad():
        return torch.cat([torch.square(h[s:s + ROW_BLOCK, None, :] - h[None, :, :]).sum(-1)
                          for s in range(0, h.shape[0], ROW_BLOCK)])


def ca_sketchmap(pairs: torch.Tensor, latent: torch.Tensor, params) -> torch.Tensor:
    """``plain.sketchmap`` of the flat CA pairs on the line, from
    :func:`row_d2`."""
    sh, ah, bh, sl, al, bl = (float(x) for x in params)
    s_h = plain.sigmoid_of_d2(row_d2(pairs), sh, ah, bh)
    diff = latent[:, None, :] - latent[None, :, :]
    s_l = plain.sigmoid_of_d2((diff * diff).sum(-1), sl, al, bl)
    return torch.mean(torch.square(s_h - s_l))


def loss(p: dict, W: dict, batch: tuple) -> torch.Tensor:
    angles, dihedrals, xyz, distances, side = batch
    lengths = [int(L) for L in p["multimer_lengths"]]
    period = float(p["periodicity"])
    enc_acts, dec_acts = plain.stack_acts(p["activation_functions"])
    groups = (angles, dihedrals, side)
    sel = _sel(p)
    inp_pairs = plain.flat_pair_dists(xyz[:, sel])
    latent = plain.mlp(W, "encoder", torch.cat(
        [plain.unit_circle(g, period) for g in groups] + [inp_pairs], 1), enc_acts)
    y = plain.mlp(W, "decoder", latent, dec_acts)
    *parts, head = torch.split(y, [2 * g.shape[1] for g in groups]
                               + [16 * (len(lengths) - 1)], 1)
    out_a, out_d, out_s = (plain.from_unit_circle(part, period) for part in parts)
    mats = head.reshape(head.shape[0], len(lengths) - 1, 4, 4)
    back = backmap(lengths, distances, out_a, out_d, mats)
    out_pairs = plain.flat_pair_dists(back[:, sel])
    return (p["dihedral_cost_scale"] / p["dihedral_cost_reference"]
            * plain.periodic_abs(out_d, dihedrals, period).mean()
            + p["angle_cost_scale"] / p["angle_cost_reference"]
            * plain.periodic_abs(out_a, angles, period).mean()
            + p["side_dihedral_cost_scale"] / p["side_dihedral_cost_reference"]
            * plain.periodic_abs(out_s, side, period).mean()
            + p["cartesian_cost_scale"] / p["cartesian_cost_reference"]
            * torch.abs(inp_pairs - out_pairs).mean()
            + p["cartesian_distance_cost_scale"] * ca_sketchmap(
                inp_pairs, latent, p["cartesian_dist_sig_parameters"])
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
