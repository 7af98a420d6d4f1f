"""The plain backmap of the ADC's sidechain-reconstruction mode, after the
reference EncoderMap's ``BackMapLayerWithSidechains`` (``models/layers.py``):
place every atom, then set each angle and each dihedral in turn by one
rotation of the atoms past it, from the value it measures. Shared by the
mode's reference (``adc-sidechains-128-128-2.py``, whose docstring gives
the steps and the departures from upstream) and the maker of its data
(``makers/sidechain-cvs.py``). Nothing of the program: no scans, no
closed-form headings, no step tables.
"""

from __future__ import annotations

import torch

from portbench.reference import plain


def branches(info: dict) -> list[tuple[int, int]]:
    """``(CA index, side atoms)`` of each residue with sidechain dihedrals,
    in chain order: a residue with ``v`` of them has ``v + 1`` side atoms
    (CB, CG, ...). ``info`` maps residue (from 1) to ``v``."""
    counts = {int(k): int(v) for k, v in info.items()}
    return [(3 * (r - 1) + 1, v + 1) for r, v in sorted(counts.items()) if v]


def _free(n_atoms: int, idx: list, device) -> torch.Tensor:
    mask = torch.zeros(n_atoms, dtype=torch.bool, device=device)
    mask[idx] = True
    return mask


def _turn(pos, free, pivot, axis, angle):
    """The atoms where ``free`` turned by ``angle`` about ``axis`` through
    ``pivot`` (all ``(B, ...)``)."""
    moved = plain.rotate(pos - pivot[:, None], axis, angle) + pivot[:, None]
    return torch.where(free[None, :, None], moved, pos)


def _angle(pos, a: int, b: int, c: int) -> torch.Tensor:
    ba, bc = pos[:, a] - pos[:, b], pos[:, c] - pos[:, b]
    return torch.atan2(torch.linalg.norm(torch.linalg.cross(ba, bc, dim=-1), dim=-1),
                       (ba * bc).sum(-1))


def _dihedral(pos, a: int, b: int, c: int, d: int) -> torch.Tensor:
    """IUPAC torsion of a-b-c-d."""
    b1, b2, b3 = pos[:, b] - pos[:, a], pos[:, c] - pos[:, b], pos[:, d] - pos[:, c]
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    y = (b1 * n2).sum(-1) * torch.linalg.norm(b2, dim=-1)
    x = (torch.linalg.cross(b1, b2, dim=-1) * n2).sum(-1)
    return torch.atan2(y, x)


def sweep(info: dict, central_distances, central_angles, central_dihedrals,
          side_distances, side_angles, side_dihedrals) -> torch.Tensor:
    """``(B, n_atoms, 3)``: the backbone atoms, then each branch's atoms in
    chain order, from the internal coordinates (``(B, 3R - 1)``, ``(B, 3R -
    2)``, ``(B, 3R - 3)`` central, one bond and one angle per side atom,
    one dihedral per residue's sidechain dihedral)."""
    brs = branches(info)
    B, nb = central_distances.shape[0], central_distances.shape[1] + 1
    dtype, device = central_distances.dtype, central_distances.device
    n_atoms = nb + sum(m for _, m in brs)
    zero = torch.zeros((B, 1), dtype=dtype, device=device)
    x_bb = torch.cat([zero, torch.cumsum(central_distances, 1)], 1)
    xs, ys, first = [x_bb], [torch.zeros_like(x_bb)], []
    s = nb
    for ca, m in brs:
        first.append(s)
        bonds = side_distances[:, s - nb:s - nb + m]
        xs.append(x_bb[:, ca:ca + 1].expand(B, m))
        ys.append(torch.cumsum(bonds, 1))
        s += m
    x, y = torch.cat(xs, 1), torch.cat(ys, 1)
    pos = torch.stack([x, y, torch.zeros_like(x)], -1)

    def branch_atoms_after(cut: int) -> list:
        """The side atoms of the branches whose CA index is ``cut`` or more."""
        return [first[k] + j for k, (ca, m) in enumerate(brs) if ca >= cut for j in range(m)]

    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device).expand(B, 3)
    for v in range(1, nb - 1):
        free = _free(n_atoms, list(range(v + 1, nb)) + branch_atoms_after(v + 1), device)
        delta = torch.abs(central_angles[:, v - 1] - _angle(pos, v - 1, v, v + 1))
        pos = _turn(pos, free, pos[:, v], up, delta)
    for k, (ca, m) in enumerate(brs):
        chain = [ca - 1, ca] + [first[k] + j for j in range(m)]
        for j in range(m):
            a, b, c = chain[j], chain[j + 1], chain[j + 2]
            free = _free(n_atoms, chain[j + 2:], device)
            delta = torch.abs(side_angles[:, first[k] - nb + j] - _angle(pos, a, b, c))
            pos = _turn(pos, free, pos[:, b], -up, delta)

    def dihedral_step(pos, quad, free_idx, target):
        a, b, c, d = quad
        axis = pos[:, c] - pos[:, b]
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        delta = target - _dihedral(pos, a, b, c, d)
        return _turn(pos, _free(n_atoms, free_idx, device), pos[:, b], axis, delta)

    for i in range(nb - 3):
        pos = dihedral_step(pos, (i, i + 1, i + 2, i + 3),
                            list(range(i + 3, nb)) + branch_atoms_after(i + 2),
                            central_dihedrals[:, i])
    t = 0
    for k, (ca, m) in enumerate(brs):
        chain = [ca - 1, ca] + [first[k] + j for j in range(m)]
        for j in range(m - 1):
            pos = dihedral_step(pos, chain[j:j + 4], chain[j + 3:], side_dihedrals[:, t])
            t += 1
    return pos
