# encodermap_tpu_torch/ops/geometry.py
"""Geometry from coordinates: displacements, distances, angles, dihedrals,
centres of mass and contacts, with the periodic minimum image.

Counterpart of ``encodermap_tpu/ops/geometry.py``: the same float32
formulas as batched PyTorch over coordinates on the featurizer's device.
Index tables come from the host (numpy), computed once per topology.

Conventions (as mdtraj's):

* dihedral: the IUPAC signed angle by ``atan2``, from elementwise sums
  (no matrix product), in (-pi, pi];
* angle: ``arccos`` of the normalised dot product;
* minimum image: cell row vectors in GROMACS reduced form. An orthorhombic
  cell takes the cheap fractional round; a triclinic cell also searches the
  27 neighbouring images, as mdtraj's triclinic kernel does.

Which of the two the wrap takes is decided once per call on the host from
the whole box stack (:func:`boxes_are_triclinic`), or pinned by the
:class:`mic_mode` context, as the featurizer does per trajectory. There is
no trace cache to key: the flag is read at call time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "compute_displacements",
    "compute_distances",
    "compute_angles",
    "compute_dihedrals",
    "compute_center_of_mass",
    "compute_contacts",
    "boxes_are_triclinic",
    "mic_mode",
]

#: the 27 lattice shifts searched for a skewed (triclinic) cell
_NEIGHBOR_SHIFTS = np.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    np.float32,
)

#: set by :class:`mic_mode`; None decides from the box
_MIC_TRICLINIC_OVERRIDE: Optional[bool] = None


def boxes_are_triclinic(box) -> bool:
    """Do any cells of ``box`` (``(..., 3, 3)`` row vectors) have an
    off-diagonal component above 1e-5 of the cell's size? Orthorhombic
    cells read from float32 files carry ~1e-7 of skew noise, which must not
    force the 27-image search."""
    if isinstance(box, torch.Tensor):
        box = box.detach().cpu().numpy()
    b = np.asarray(box, np.float64)
    if b.size == 0:
        return False
    off = b * (1.0 - np.eye(3))
    scale = np.max(np.abs(b)) or 1.0
    return bool(np.any(np.abs(off) > 1e-5 * scale))


class mic_mode:
    """``with mic_mode(triclinic=False):`` pins the minimum-image wrap to
    the orthorhombic round (``True``: the 27-image search) for every call
    inside the block, so a caller that knows its cells needs no host check
    per call."""

    def __init__(self, triclinic: bool) -> None:
        self.triclinic = bool(triclinic)

    def __enter__(self):
        global _MIC_TRICLINIC_OVERRIDE
        self._prev = _MIC_TRICLINIC_OVERRIDE
        _MIC_TRICLINIC_OVERRIDE = self.triclinic
        return self

    def __exit__(self, *exc):
        global _MIC_TRICLINIC_OVERRIDE
        _MIC_TRICLINIC_OVERRIDE = self._prev
        return False


def _is_triclinic(box) -> bool:
    if _MIC_TRICLINIC_OVERRIDE is not None:
        return _MIC_TRICLINIC_OVERRIDE
    return boxes_are_triclinic(box)


def _mic_wrap(vecs: torch.Tensor, box: torch.Tensor, triclinic: bool
              ) -> torch.Tensor:
    """Minimum image of ``(F, P, 3)`` displacements in ``(F, 3, 3)``
    cells: round to the nearest lattice vector in fractional coordinates,
    then, for a triclinic cell, take the shortest of the 27 neighbouring
    images (the first of equals, as ``argmin`` gives it)."""
    inv = torch.linalg.inv(box)
    frac = torch.einsum("fpi,fij->fpj", vecs, inv)
    frac = frac - torch.round(frac)
    base = torch.einsum("fpi,fij->fpj", frac, box)
    if not triclinic:
        return base
    shifts = torch.as_tensor(_NEIGHBOR_SHIFTS, dtype=base.dtype,
                             device=base.device)
    shift_vecs = torch.einsum("si,fij->fsj", shifts, box)       # (F, 27, 3)
    cands = base[:, :, None, :] - shift_vecs[:, None]           # (F, P, 27, 3)
    d2 = torch.sum(torch.square(cands), dim=-1)
    best = torch.argmin(d2, dim=-1)
    return torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]


def _as_index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _wrap_all(box, *vecs):
    if box is None:
        return vecs
    box = torch.as_tensor(box, dtype=vecs[0].dtype, device=vecs[0].device)
    tri = _is_triclinic(box)
    return tuple(_mic_wrap(v, box, tri) for v in vecs)


def compute_displacements(xyz: torch.Tensor, pairs, box=None) -> torch.Tensor:
    """``(F, P, 3)`` vectors from atom ``pairs[:, 0]`` to ``pairs[:, 1]``,
    minimum-imaged in ``box`` (``(F, 3, 3)``) when one is given."""
    pairs = _as_index(pairs, xyz.device)
    d = xyz[:, pairs[:, 1]] - xyz[:, pairs[:, 0]]
    return _wrap_all(box, d)[0]


def compute_distances(xyz: torch.Tensor, pairs, box=None) -> torch.Tensor:
    """Pair distances ``(F, P)``, minimum-imaged when ``box`` is given."""
    d = compute_displacements(xyz, pairs, box)
    return torch.sqrt(torch.sum(torch.square(d), dim=-1))


def compute_angles(xyz: torch.Tensor, triplets, box=None) -> torch.Tensor:
    """Angles at the middle atom of each triplet, ``(F, T)``."""
    t = _as_index(triplets, xyz.device)
    p1 = xyz[:, t[:, 1]]
    u, v = _wrap_all(box, xyz[:, t[:, 0]] - p1, xyz[:, t[:, 2]] - p1)
    cos = torch.sum(u * v, -1) / (
        torch.linalg.norm(u, dim=-1) * torch.linalg.norm(v, dim=-1))
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def compute_dihedrals(xyz: torch.Tensor, quadruplets, box=None
                      ) -> torch.Tensor:
    """Signed dihedrals (IUPAC, as mdtraj), ``(F, Q)`` in (-pi, pi]."""
    q = _as_index(quadruplets, xyz.device)
    p1, p2 = xyz[:, q[:, 1]], xyz[:, q[:, 2]]
    b0, b1, b2 = _wrap_all(box, xyz[:, q[:, 0]] - p1, p2 - p1,
                           xyz[:, q[:, 3]] - p2)
    b1n = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    v = b0 - torch.sum(b0 * b1n, -1, keepdim=True) * b1n
    w = b2 - torch.sum(b2 * b1n, -1, keepdim=True) * b1n
    x = torch.sum(v * w, -1)
    y = torch.sum(torch.linalg.cross(b1n, v, dim=-1) * w, -1)
    return torch.atan2(y, x)


def compute_center_of_mass(xyz: torch.Tensor, group_indices, masses
                           ) -> torch.Tensor:
    """Mass-weighted centre ``(F, 3)`` of one atom group per frame."""
    sel = xyz[:, _as_index(group_indices, xyz.device)]
    m = torch.as_tensor(np.asarray(masses), dtype=xyz.dtype, device=xyz.device)
    w = m / torch.sum(m)
    return torch.einsum("fng,n->fg", sel, w)


def compute_contacts(xyz: torch.Tensor, pairs, threshold: float = 0.45,
                     box=None) -> torch.Tensor:
    """Binary contacts over the given pairs (distance < threshold)."""
    return (compute_distances(xyz, pairs, box) < threshold).to(torch.float32)
