# encodermap_tpu_torch/ops/backmap_sidechains.py
"""Backmapping with sidechains: internal coordinates -> xyz of the backbone
and the sidechain atoms.

Counterpart of ``encodermap_tpu/ops/backmap_sidechains.py`` (after the
reference's ``BackMapLayerWithSidechains``, ``models/layers.py:219-902``):

* :func:`make_spec` builds the static step tables from ``sidechain_info``
  (residue -> number of sidechain dihedrals) on the host, in numpy; a copy
  of the JAX package's, not an import of it.
* :func:`backmap_sidechains` is the sequential sweep: placement along +x
  with each branch in a vertical column above its CA, then every angle and
  every dihedral set in turn by a masked Rodrigues rotation of the atoms
  that are still free. The JAX package's two ``lax.scan``\\ s are Python
  loops over the static tables here. It is the oracle and the plain
  version.
* :func:`backmap_sidechains_fast` is the log-depth form that training
  uses: every "current" value the sweep measures is set by the plane tree
  (pi, pi/2; a dihedral 0 where the chain turns the same way at both ends
  of its bond, else pi: a decoded angle below 0 turns it the other way), so
  the angle phase is closed-form headings (cumsums) and the dihedral phase
  telescopes into cumulative quaternion products of rotations about fixed
  in-plane axes: one scan over the backbone, one over every branch at once.
  The JAX package's form takes every dihedral as angles in (0, pi) give it
  (a recorded divergence). CUDA tensors go through a hand-written kernel
  each way (``csrc/backmap_sidechains.cu``, launch counters
  ``sidechain_fwd`` and ``sidechain_bwd``), CPU tensors through the plain
  version ``_backmap_sidechains_fast_plain``; wherever a gradient is taken
  the backward runs under the span ``adc.backmap_backward``
  (``_SidechainBackmap`` on the card, ``_tracing.backward_in_span`` on the
  CPU).

PyTorch has no ``associative_scan``: in the plain version both scans run
through ``ops/backmap.py``'s doubling scan (``_cumulative_quats``,
``ceil(log2 n)`` rounds, the earlier product on the left as in the JAX
scan). Its layout is component-first, so quaternions here are ``(4, B,
...)`` and vectors ``(3, B, ...)`` with the scanned axis last: the branch
scan runs on ``(4, B, n_branches, max_len)`` as it stands. Its gradients
come from autograd through the scans (the JAX package differentiates its
scans too; there is no custom VJP); the kernels' backward is the adjoint
derived by hand (``_SidechainBackmap``).
"""

from __future__ import annotations

import ctypes
import functools
from math import pi
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._tracing import backward_in_span, count_rows, span
from . import _build
from .backmap import _cumulative_quats, _quat_compose, _quat_rotate

__all__ = ["SidechainBackmapSpec", "backmap_sidechains", "backmap_sidechains_fast",
           "make_spec"]

_LIB = "backmap_sidechains"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_build.register(_LIB, [
    ("em_sidechain_fwd", [_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    ("em_sidechain_bwd", [_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _L, _L, _L, _P, _P,
                          _P]),
])


class SidechainBackmapSpec(NamedTuple):
    """Static tables driving the placement, angle and dihedral phases."""

    n_residues: int
    n_sidechain_atoms: int
    n_atoms: int
    #: (n_side_atoms,) which backbone CA x-position seeds each side atom
    side_seed_ca: np.ndarray
    #: (n_side_atoms,) first side-bond index of the atom's branch
    side_branch_start: np.ndarray
    #: (n_side_atoms,) the atom's bond index within side_distances
    side_bond_index: np.ndarray
    # angle phase: central then side
    angle_triplets: np.ndarray  # (n_angles, 3)
    angle_static_masks: np.ndarray  # (n_angles, n_atoms) bool
    angle_z_dir: np.ndarray  # (n_angles,) +1 (central, +z) or -1 (side, -z)
    n_central_angles: int
    # dihedral phase: central then side
    dihedral_quadruplets: np.ndarray  # (n_dihedrals, 4)
    dihedral_static_masks: np.ndarray  # (n_dihedrals, n_atoms) bool
    n_central_dihedrals: int
    #: (n_residues,) side atoms per residue (n_dihedrals + 1, or 0)
    side_atoms_per_res: np.ndarray = None


def _side_atoms_per_res(spec: SidechainBackmapSpec) -> np.ndarray:
    """(n_residues,) side atoms per residue, from the spec's table
    (re-derived from side_seed_ca for a spec without it)."""
    if spec.side_atoms_per_res is not None:
        return np.asarray(spec.side_atoms_per_res)
    return np.asarray([int((spec.side_seed_ca == (r - 1) * 3 + 1).sum())
                       for r in range(1, spec.n_residues + 1)])


def make_spec(sidechain_info: dict[int, int]) -> SidechainBackmapSpec:
    """The step tables from residue -> n_sidechain_dihedrals (reference
    ``layers.py:234-497``): a residue with v > 0 dihedrals has v + 1
    sidechain atoms and v + 1 sidechain bonds (CA->CB first)."""
    residues = sorted(sidechain_info.keys())
    n_res = max(residues)
    if residues != list(range(1, n_res + 1)):
        raise ValueError("sidechain_info keys must be 1..n_residues")
    v = np.array([sidechain_info[r] for r in range(1, n_res + 1)], np.int64)
    n_backbone = 3 * n_res
    side_atoms_per_res = np.where(v > 0, v + 1, 0)
    n_side = int(side_atoms_per_res.sum())
    n_atoms = n_backbone + n_side

    # placement: atom j of a branch sits at
    # y = sum(side_distances[branch_start : branch_start + j + 1])
    side_seed_ca, side_branch_start, side_bond_index = [], [], []
    bond = 0
    for r in range(1, n_res + 1):
        if v[r - 1] == 0:
            continue
        start = bond
        for _ in range(int(v[r - 1]) + 1):
            side_seed_ca.append((r - 1) * 3 + 1)
            side_branch_start.append(start)
            side_bond_index.append(bond)
            bond += 1
    side_seed_ca = np.asarray(side_seed_ca, np.int64)
    side_branch_start = np.asarray(side_branch_start, np.int64)
    side_bond_index = np.asarray(side_bond_index, np.int64)

    # central rows: row i has backbone atoms 0..i static, and the branches
    # whose CA (index 3r - 2) is among them, i.e. residues 1..(i+2)//3
    central_rows = np.tri(n_backbone - 1, n_backbone, k=0).astype(bool)
    right = np.zeros((n_backbone - 1, n_side), bool)
    col = 0
    side_cols_of_res = {}
    for r in range(1, n_res + 1):
        if v[r - 1] == 0:
            continue
        side_cols_of_res[r] = np.arange(col, col + v[r - 1] + 1)
        col += v[r - 1] + 1
    for i in range(n_backbone - 1):
        for r in range(1, (i + 2) // 3 + 1):
            if r in side_cols_of_res:
                right[i, side_cols_of_res[r]] = True
    central_dist_masks = np.hstack([central_rows, right])

    # side rows: all backbone static, the branch prefix static, and the
    # other branches static (the reference's `(block_diag(...) % 2) == 0`)
    side_rows = []
    for r in range(1, n_res + 1):
        if v[r - 1] == 0:
            continue
        m = int(v[r - 1]) + 1
        side_rows.append((np.tri(m, m + 1, k=0) + 1)[:, 1:])
    if side_rows:
        from scipy.linalg import block_diag

        side_block = (block_diag(*side_rows) % 2) == 0
        side_dist_masks = np.hstack([np.ones((len(side_block), n_backbone), bool),
                                     side_block])
    else:
        side_dist_masks = np.zeros((0, n_atoms), bool)

    bb = np.arange(n_backbone)
    central_angle_triplets = np.stack([bb[:-2], bb[1:-1], bb[2:]], axis=1)
    central_angle_masks = central_dist_masks[1:]

    side_angle_triplets, side_dihedral_quadruplets = [], []
    count2 = n_backbone + 1  # one past the first sidechain atom (reference counting)
    for r in range(1, n_res + 1):
        n_sc = int(v[r - 1])
        if n_sc == 0:
            continue
        n, ca = (r - 1) * 3, (r - 1) * 3 + 1
        for k in range(n_sc + 1):
            if k == 0:  # N - CA - CB, N - CA - CB - CG
                side_angle_triplets.append([n, ca, count2 - 1])
                side_dihedral_quadruplets.append([n, ca, count2 - 1, count2])
            elif k == 1:  # CA - CB - CG
                side_angle_triplets.append([ca, count2 - 1, count2])
                if k < n_sc:
                    side_dihedral_quadruplets.append([ca, count2 - 1, count2, count2 + 1])
            else:
                side_angle_triplets.append([count2 + k - 3, count2 + k - 2, count2 + k - 1])
                if k < n_sc:
                    side_dihedral_quadruplets.append(
                        [count2 + k - 3, count2 + k - 2, count2 + k - 1, count2 + k])
        count2 += n_sc + 1
    side_angle_triplets = np.asarray(side_angle_triplets, np.int64).reshape(-1, 3)
    side_dihedral_quadruplets = np.asarray(side_dihedral_quadruplets,
                                           np.int64).reshape(-1, 4)

    angle_triplets = np.vstack([central_angle_triplets, side_angle_triplets])
    angle_masks = np.vstack([central_angle_masks, side_dist_masks])
    angle_z_dir = np.concatenate([np.ones(len(central_angle_triplets)),
                                  -np.ones(len(side_angle_triplets))]).astype(np.float32)

    central_dihedral_quadruplets = np.stack([bb[:-3], bb[1:-2], bb[2:-1], bb[3:]], axis=1)
    central_dihedral_masks = central_dist_masks[1:-1]
    # side dihedral rows: the side_dist_masks rows of atoms that carry one
    side_cart_ind = []
    count = 0
    for r in range(1, n_res + 1):
        n_sc = int(v[r - 1])
        if n_sc == 0:
            continue
        side_cart_ind.append(np.arange(count, count + n_sc))
        count += n_sc + 1
    if side_cart_ind:
        side_dih_masks = side_dist_masks[np.concatenate(side_cart_ind)]
    else:
        side_dih_masks = np.zeros((0, n_atoms), bool)

    dihedral_quadruplets = np.vstack([central_dihedral_quadruplets,
                                      side_dihedral_quadruplets])
    dihedral_masks = np.vstack([central_dihedral_masks, side_dih_masks])
    return SidechainBackmapSpec(
        n_residues=n_res, n_sidechain_atoms=n_side, n_atoms=n_atoms,
        side_seed_ca=side_seed_ca, side_branch_start=side_branch_start,
        side_bond_index=side_bond_index, angle_triplets=angle_triplets,
        angle_static_masks=angle_masks, angle_z_dir=angle_z_dir,
        n_central_angles=len(central_angle_triplets),
        dihedral_quadruplets=dihedral_quadruplets,
        dihedral_static_masks=dihedral_masks,
        n_central_dihedrals=len(central_dihedral_quadruplets),
        side_atoms_per_res=side_atoms_per_res)


# ------------------------------------------------------------ sequential sweep
def _rot_about_axis_point(pos, axis_unit, point, angle, dyn_mask):
    """Rotate the atoms where ``dyn_mask`` about the axis through ``point``
    by ``angle`` (right-handed Rodrigues, reference ``layers.py:860-902``):
    ``p' = R (p - point) + point``."""
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    u = axis_unit[:, None, :]  # (B, 1, 3)
    rel = pos - point[:, None, :]
    cross = torch.linalg.cross(u.expand_as(rel), rel, dim=-1)
    dot = torch.sum(u * rel, dim=-1, keepdim=True)
    new = rel * c + cross * s + u * dot * (1.0 - c) + point[:, None, :]
    return torch.where(dyn_mask[None, :, None], new, pos)


def _norm(x):
    # sqrt of the sum of squares, as the JAX package's jnp.linalg.norm
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _current_angle(pos, triplet, angle_clip: Optional[float]):
    """The angle at ``triplet[1]``. With ``angle_clip`` (the JAX package's
    1e-7) the cosine is clipped into ``(-1 + clip, 1 - clip)``, which keeps
    arccos differentiable at the colinear start and biases each measured pi
    by ``arccos(1 - clip)`` (4.5e-4 rad); None measures ``atan2(|ba x bc|,
    ba . bc)``, exact at 0 and pi."""
    ba = pos[:, triplet[0]] - pos[:, triplet[1]]
    bc = pos[:, triplet[2]] - pos[:, triplet[1]]
    dot = torch.sum(ba * bc, dim=-1)
    if angle_clip is None:
        return torch.atan2(torch.linalg.norm(torch.linalg.cross(ba, bc, dim=-1), dim=-1),
                           dot)
    prod = _norm(ba) * _norm(bc)
    return torch.arccos(torch.clamp(dot / prod, -1.0 + angle_clip, 1.0 - angle_clip))


def _current_dihedral(pos, quad):
    b1 = pos[:, quad[1]] - pos[:, quad[0]]
    b2 = pos[:, quad[2]] - pos[:, quad[1]]
    b3 = pos[:, quad[3]] - pos[:, quad[2]]
    c1 = torch.linalg.cross(b2, b3, dim=-1)
    c2 = torch.linalg.cross(b1, b2, dim=-1)
    p1 = torch.sum(b1 * c1, dim=-1) * _norm(b2)
    p2 = torch.sum(c1 * c2, dim=-1)
    return torch.atan2(p1, p2)


def backmap_sidechains(spec: SidechainBackmapSpec, central_distances: torch.Tensor,
                       central_angles: torch.Tensor, central_dihedrals: torch.Tensor,
                       side_distances: torch.Tensor, side_angles: torch.Tensor,
                       side_dihedrals: torch.Tensor,
                       angle_clip: Optional[float] = 1e-7) -> torch.Tensor:
    """The sequential sidechain backmapping, one rotation per angle and per
    dihedral.

    Args:
        spec: the tables of :func:`make_spec`.
        central_distances: ``(B, 3R - 1)``.
        central_angles: ``(B, 3R - 2)``.
        central_dihedrals: ``(B, 3R - 3)``.
        side_distances: ``(B, n_side_atoms)`` (one bond per side atom).
        side_angles: ``(B, n_side_atoms)``.
        side_dihedrals: ``(B, sum of sidechain dihedrals)``.
        angle_clip: how the current angle is measured (see
            ``_current_angle``); the default is the JAX package's clip,
            None the exact form, which the fast version equals.

    Returns:
        ``(B, n_atoms, 3)``: backbone atoms first, then the sidechain atoms
        residue by residue, the reference's atom order.
    """
    B = central_distances.shape[0]
    dtype, device = central_distances.dtype, central_distances.device
    zeros = torch.zeros((B, 1), dtype=dtype, device=device)

    # placement: backbone along +x, each branch's atoms above its CA
    def idx(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    xs_bb = torch.cat([zeros, torch.cumsum(central_distances, dim=1)], dim=1)
    side_cum = torch.cumsum(side_distances, dim=1)
    start = np.asarray(spec.side_branch_start, np.int64)
    prev = torch.where(torch.as_tensor(start - 1 >= 0, device=device)[None, :],
                       side_cum[:, idx(np.maximum(start - 1, 0))], 0.0)
    ys_side = side_cum[:, idx(spec.side_bond_index)] - prev
    xs = torch.cat([xs_bb, xs_bb[:, idx(spec.side_seed_ca)]], dim=1)
    ys = torch.cat([torch.zeros_like(xs_bb), ys_side], dim=1)
    pos = torch.stack([xs, ys, torch.zeros_like(xs)], dim=-1)

    # angles, central then side: rotations about +z / -z through the vertex
    targets = torch.cat([central_angles, side_angles], dim=1)
    free = torch.as_tensor(~spec.angle_static_masks, device=device)
    for i, triplet in enumerate(spec.angle_triplets.tolist()):
        delta = torch.abs(targets[:, i] - _current_angle(pos, triplet, angle_clip))
        axis = torch.zeros((B, 3), dtype=dtype, device=device)
        axis[:, 2] = float(spec.angle_z_dir[i])
        pos = _rot_about_axis_point(pos, axis, pos[:, triplet[1]], delta, free[i])

    # dihedrals, central then side: rotations about the b -> c bond
    targets = torch.cat([central_dihedrals, side_dihedrals], dim=1)
    free = torch.as_tensor(~spec.dihedral_static_masks, device=device)
    for i, quad in enumerate(spec.dihedral_quadruplets.tolist()):
        delta = targets[:, i] - _current_dihedral(pos, quad)
        axis = pos[:, quad[2]] - pos[:, quad[1]]
        axis = axis / _norm(axis)[:, None]
        pos = _rot_about_axis_point(pos, axis, pos[:, quad[1]], delta, free[i])
    return pos


# ------------------------------------------------------------ log-depth form
def _axis_angle_quat(heading: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``(4, ...)`` quaternions of rotations by ``angle`` about the in-plane
    unit axes of polar angle ``heading``."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.stack([torch.cos(half), s * torch.cos(heading), s * torch.sin(heading),
                        torch.zeros_like(half)])


def _identity(shape: tuple, like: torch.Tensor) -> torch.Tensor:
    q = torch.zeros((4,) + shape, dtype=like.dtype, device=like.device)
    q[0] = 1.0
    return q


_TABLES: dict = {}


def _bond_csr(keys: np.ndarray, n_bonds: int) -> tuple[np.ndarray, np.ndarray]:
    """Offsets (``n_bonds + 1``) and branch indices, in ascending order
    within a bond, of the branches keyed to each backbone bond."""
    order = np.argsort(keys, kind="stable")
    return np.searchsorted(keys[order], np.arange(n_bonds + 1)), order


def _kernel_table(nb: int, branches: np.ndarray, lens: np.ndarray,
                  thresholds: np.ndarray) -> np.ndarray:
    """The kernels' int32 table (``csrc/backmap_sidechains.cu``'s
    ``Args::tab``): a row a branch (its CA atom, the index of the central
    rotation it rides on or -1, its length, its first side atom, its first
    side dihedral), then the branches of each backbone bond as two CSR
    tables: by the bond into their CA (``ca - 1``) and by the bond whose
    rotation they ride on (``threshold``), each offsets (``nb``) then
    indices (padded to one a branch)."""
    n_br = len(branches)
    ca = branches * 3 + 1
    thr = np.where(thresholds > 0, thresholds - 1, -1)
    rows = np.stack([ca, thr, lens, np.cumsum(lens) - lens,
                     np.cumsum(lens - 1) - (lens - 1)], axis=1).reshape(-1)
    ca_ptr, ca_ids = _bond_csr(ca - 1, nb - 1)
    on = np.where(thr >= 0)[0]
    thr_ptr, thr_ids = _bond_csr(thr[on] + 1, nb - 1)
    thr_ids = np.pad(on[thr_ids], (0, n_br - len(on)))
    return np.concatenate([rows, ca_ptr, ca_ids, thr_ptr, thr_ids]).astype(np.int32)


def _fast_tables(spec: SidechainBackmapSpec, device: torch.device) -> dict:
    """The fast version's index tables on ``device``, built once per spec
    (keyed by its branch lengths and central dihedral masks) and device:
    the plain version's, and the kernels' (``kernel``, :func:`_kernel_table`)."""
    v = _side_atoms_per_res(spec)
    cmasks = np.asarray(spec.dihedral_static_masks[:spec.n_central_dihedrals])
    key = (v.tobytes(), cmasks.tobytes(), cmasks.shape, str(device))
    if key in _TABLES:
        return _TABLES[key]
    nb = 3 * spec.n_residues
    n_cdi = nb - 3
    branches = np.where(v > 0)[0]  # residues (0-based) with a branch
    lens = v[branches]
    if not len(branches):
        none = np.zeros(0, np.int64)
        _TABLES[key] = tables = dict(n_br=0, bond_quat_idx=torch.as_tensor(
            np.minimum(np.arange(2, nb) - 2, max(n_cdi - 1, 0)), device=device),
            kernel=torch.as_tensor(_kernel_table(nb, none, none, none), device=device))
        return tables
    n_br, max_len = len(branches), int(lens.max())
    # ragged branch atoms -> (n_br, max_len), padded; and their dihedrals
    gath = np.zeros((n_br, max_len), np.int64)
    mask = np.zeros((n_br, max_len), bool)
    sdi_cols = np.zeros((n_br, max_len), np.int64)
    sdi_mask = np.zeros((n_br, max_len), bool)
    col = dcol = 0
    for bi, L in enumerate(lens):
        gath[bi, :L] = np.arange(col, col + L)
        mask[bi, :L] = True
        sdi_cols[bi, :L - 1] = np.arange(dcol, dcol + L - 1)
        sdi_mask[bi, :L - 1] = True
        col += L
        dcol += L - 1
    # central dihedral steps that move each branch: the spec's masks say it
    br_col_start = nb + np.cumsum(lens) - lens
    thresholds = np.asarray([int((~cmasks[:, c]).sum()) for c in br_col_start],
                            np.int64)
    first_step = np.zeros((n_br, max_len - 1), bool)
    first_step[:, 0] = True
    bidx = np.concatenate([np.full(L, bi) for bi, L in enumerate(lens)])
    jidx = np.concatenate([np.arange(L) for L in lens])

    def t(x):
        return torch.as_tensor(x, device=device)

    tables = dict(
        n_br=n_br, max_len=max_len, gath=t(gath), mask=t(mask), ca_idx=t(branches * 3 + 1),
        bond_quat_idx=t(np.minimum(np.arange(2, nb) - 2, max(n_cdi - 1, 0))),
        thr_idx=t(np.maximum(thresholds - 1, 0)), thr_on=t(thresholds > 0),
        sdi_cols=t(sdi_cols), sdi_mask=t(sdi_mask), first_step=t(first_step), bidx=t(bidx),
        jidx=t(jidx), kernel=t(_kernel_table(nb, branches, lens, thresholds)))
    _TABLES[key] = tables
    return tables


def _backmap_sidechains_fast_plain(spec: SidechainBackmapSpec,
                                   central_distances: torch.Tensor,
                                   central_angles: torch.Tensor,
                                   central_dihedrals: torch.Tensor,
                                   side_distances: torch.Tensor, side_angles: torch.Tensor,
                                   side_dihedrals: torch.Tensor) -> torch.Tensor:
    """Log-depth sidechain backmapping: the semantics of
    :func:`backmap_sidechains` (with ``angle_clip=None``) from cumsums and
    two cumulative quaternion products. Same arguments and result. The
    plain version of the kernels, which :func:`backmap_sidechains_fast`
    takes for CPU tensors."""
    B = central_distances.shape[0]
    dtype, device = central_distances.dtype, central_distances.device
    nb = 3 * spec.n_residues
    n_cdi = nb - 3
    tb = _fast_tables(spec, device)
    n_br = tb["n_br"]

    # phase A: the planar tree in closed form; heading of backbone bond i
    zeros = torch.zeros((B, 1), dtype=dtype, device=device)
    h = torch.cat([zeros, torch.cumsum(pi - central_angles, dim=1)], dim=1)
    dx = central_distances * torch.cos(h)
    dy = central_distances * torch.sin(h)

    # phase B: backbone dihedral quaternions about the planar bond axes,
    # C_i = q_0 (x) ... (x) q_i; bond k (atoms k-1 -> k) is rotated by
    # C_min(k-2, n_cdi-1), the first bond by nothing
    if n_cdi:
        # the sweep's current dihedral: 0 where the plane chain turns the
        # same way at both ends of the bond, pi where the turns differ (a
        # decoded angle below 0 turns the other way)
        turn = torch.sin(central_angles.detach())
        trans = turn[:, :-1] * turn[:, 1:] < 0
        C_c = _cumulative_quats(_axis_angle_quat(
            h[:, 1:n_cdi + 1], torch.add(central_dihedrals, trans, alpha=-pi)))
        bb_quats = torch.cat([_identity((B, 1), h), C_c[:, :, tb["bond_quat_idx"]]],
                             dim=-1)
    else:  # one residue: no central dihedral, no rotated bond
        C_c = None
        bb_quats = _identity((B, nb - 1), h)
    planar = torch.stack([dx, dy, torch.zeros_like(dx)])  # (3, B, nb - 1)
    bb_pos = torch.cat([torch.zeros((3, B, 1), dtype=dtype, device=device),
                        torch.cumsum(_quat_rotate(bb_quats, planar), dim=-1)], dim=-1)
    if not n_br:
        return bb_pos.permute(1, 2, 0).contiguous()
    max_len = tb["max_len"]

    # branch bond headings: phi_0 = theta + pi/2 - |sa_0 - pi/2|,
    # phi_k = phi_{k-1} - (pi - sa_k); theta the heading into the CA
    sd_p = side_distances[:, tb["gath"]] * tb["mask"].to(dtype)  # (B, n_br, max_len)
    sa_p = side_angles[:, tb["gath"]]
    phi0 = (h[:, tb["ca_idx"] - 1] + pi / 2 - torch.abs(sa_p[..., 0] - pi / 2))[..., None]
    phi = torch.cat([phi0, phi0 + torch.cumsum(-(pi - sa_p[..., 1:]), dim=-1)], dim=-1)
    br_planar = torch.stack([sd_p * torch.cos(phi), sd_p * torch.sin(phi),
                             torch.zeros_like(phi)])  # (3, B, n_br, max_len)

    # the central rotation each branch rides on: the product of the central
    # steps that move it
    if C_c is not None:
        C_thr = torch.where(tb["thr_on"][None, None, :], C_c[:, :, tb["thr_idx"]],
                            _identity((1, 1), h))
    else:
        C_thr = _identity((B, n_br), h)
    # side dihedral quaternions: step k of a branch turns about phi_k by its
    # target less the sweep's current dihedral, pi where the plane branch
    # turns different ways at the bond's two ends, else 0; padded steps are
    # the identity. The turns' sines are sin(sa_0) into the first bond and
    # -sin(sa_k) after, so the first step (pi for angles in (0, pi)) reads
    # the product's sign the other way round
    turn = torch.sin(sa_p.detach())
    trans = (turn[..., :-1] * turn[..., 1:] < 0) ^ tb["first_step"]
    ang = torch.add(side_dihedrals[:, tb["sdi_cols"]],
                    F.pad(trans, (0, 1)), alpha=-pi) * tb["sdi_mask"].to(dtype)
    q_s = torch.where(tb["sdi_mask"], _axis_angle_quat(phi, ang),
                      _identity((1, 1, 1), h))
    C_s = _cumulative_quats(q_s)  # along each branch: (4, B, n_br, max_len)
    # bond j of a branch (0 = CA -> CB) is rotated by C_thr (x) prefix(j - 1)
    prev = torch.cat([_identity((B, n_br, 1), h), C_s[..., :max_len - 1]], dim=-1)
    bond_quats = _quat_compose(C_thr[..., None].expand_as(prev), prev)
    ca_pos = bb_pos[:, :, tb["ca_idx"]]  # (3, B, n_br)
    br_pos = ca_pos[..., None] + torch.cumsum(_quat_rotate(bond_quats, br_planar), dim=-1)
    side_pos = br_pos[:, :, tb["bidx"], tb["jidx"]]  # (3, B, n_side_atoms)
    return torch.cat([bb_pos, side_pos], dim=-1).permute(1, 2, 0).contiguous()


# ------------------------------------------------------------ the kernels
def _pointers(tensors) -> tuple:
    """ctypes arrays of the tensors' data pointers and of their (row,
    column) strides."""
    ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
    strides = (ctypes.c_longlong * (2 * len(tensors)))(
        *(s for x in tensors for s in x.stride()))
    return ptrs, strides


def _sidechain_fwd(spec: SidechainBackmapSpec, inputs) -> tuple:
    """The forward kernel: the coordinates ``(B, nb + n_side, 3)`` and each
    bond's rotation ``(B, nb - 1 + n_side, 4)`` and heading ``(B, nb - 1 +
    n_side)``, which :func:`_sidechain_bwd` takes."""
    x = inputs[0]
    B, nb, n_side = x.shape[0], 3 * spec.n_residues, spec.n_sidechain_atoms
    tb = _fast_tables(spec, x.device)
    widths = (nb - 1, nb - 2, nb - 3, n_side, n_side, n_side - tb["n_br"])
    if any(t.shape != (B, w) for t, w in zip(inputs, widths)):
        raise ValueError(f"the sidechain backmap takes (B, n) inputs of widths {widths}, "
                         f"got {[tuple(t.shape) for t in inputs]}")
    out = torch.empty((B, nb + n_side, 3), dtype=x.dtype, device=x.device)
    quat = torch.empty((B, nb - 1 + n_side, 4), dtype=x.dtype, device=x.device)
    head = torch.empty((B, nb - 1 + n_side), dtype=x.dtype, device=x.device)
    ptrs, strides = _pointers(inputs)
    _build.launch(_LIB, "em_sidechain_fwd", int(x.dtype == torch.float64), ptrs, strides,
                  tb["kernel"].data_ptr(), B, nb, tb["n_br"], n_side, out.data_ptr(),
                  quat.data_ptr(), head.data_ptr())
    return out, quat, head


def _sidechain_bwd(spec: SidechainBackmapSpec, inputs, quat: torch.Tensor,
                   head: torch.Tensor, grad: torch.Tensor) -> list:
    """The backward kernel: the gradients of the six inputs (contiguous)
    from the coordinates' cotangent ``grad`` (any strides) and what
    :func:`_sidechain_fwd` returned."""
    x = inputs[0]
    B, nb, n_side = x.shape[0], 3 * spec.n_residues, spec.n_sidechain_atoms
    if grad.dtype != x.dtype or grad.device != x.device or grad.shape != (B, nb + n_side, 3):
        raise TypeError(f"a ({B}, {nb + n_side}, 3) {x.dtype} cotangent on {x.device} "
                        f"expected, got {tuple(grad.shape)} {grad.dtype} on {grad.device}")
    tb = _fast_tables(spec, x.device)
    grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in inputs]
    part = torch.empty((B, tb["n_br"], 7), dtype=x.dtype, device=x.device)
    ptrs, strides = _pointers(inputs)
    outs = (ctypes.c_void_p * len(grads))(*(t.data_ptr() for t in grads))
    _build.launch(_LIB, "em_sidechain_bwd", int(x.dtype == torch.float64), ptrs, strides,
                  tb["kernel"].data_ptr(), B, nb, tb["n_br"], n_side, quat.data_ptr(),
                  head.data_ptr(), grad.data_ptr(), *grad.stride(), part.data_ptr(), outs)
    return grads


class _SidechainBackmap(torch.autograd.Function):
    """:func:`backmap_sidechains_fast` on the card: one kernel each way
    (``csrc/backmap_sidechains.cu``; launch counters ``sidechain_fwd`` and
    ``sidechain_bwd``). The forward saves each bond's rotation and heading
    (5 values a bond: 2.3 kB a frame in float32 on trp-cage); the backward
    is the hand-derived adjoint of the fast form (the kernels' source
    derives it), takes the gradients of all six inputs, runs under the span
    ``adc.backmap_backward`` and is not differentiated again (a second
    derivative raises). While the spans are on it counts its calls and rows
    forward (``fwd``, ``rows_fwd``) and backward (``bwd``, ``rows_bwd``) in
    the counter ``sidechain_backmap``, as ``_tracing.backward_in_span``
    counts the CPU's."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        count_rows("sidechain_backmap", "fwd", inputs[0].shape[0])
        ctx.spec = spec
        out, quat, head = _sidechain_fwd(spec, inputs)
        ctx.save_for_backward(*inputs, quat, head)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[1:]
        with span("adc.backmap_backward"):
            *inputs, quat, head = ctx.saved_tensors
            grads = _sidechain_bwd(ctx.spec, inputs, quat, head, grad)
        count_rows("sidechain_backmap", "bwd", grad.shape[0])
        return (None,) + tuple(g if need else None for g, need in zip(grads, needs))


def backmap_sidechains_fast(spec: SidechainBackmapSpec, central_distances: torch.Tensor,
                            central_angles: torch.Tensor,
                            central_dihedrals: torch.Tensor,
                            side_distances: torch.Tensor, side_angles: torch.Tensor,
                            side_dihedrals: torch.Tensor) -> torch.Tensor:
    """Log-depth sidechain backmapping: the semantics of
    :func:`backmap_sidechains` (with ``angle_clip=None``) from cumsums and
    two cumulative quaternion products. Same arguments and result.

    CUDA tensors (float32 or float64, of one device) go through one
    hand-written kernel each way; CPU tensors through the plain version
    ``_backmap_sidechains_fast_plain``, and the kernels' library is never
    loaded; any other device or type raises. The card takes
    ``_SidechainBackmap`` always; the CPU takes the plain version through
    ``_tracing.backward_in_span`` wherever a gradient is taken (autograd
    over its saved graph), and directly without one. Either backward runs
    under the span ``adc.backmap_backward`` and counts in the counter
    ``sidechain_backmap``."""
    inputs = (central_distances, central_angles, central_dihedrals, side_distances,
              side_angles, side_dihedrals)
    if _build.kernel_route(inputs, "the sidechain kernels"):
        return _SidechainBackmap.apply(spec, *inputs)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return backward_in_span("adc.backmap_backward", "sidechain_backmap",
                                functools.partial(_backmap_sidechains_fast_plain, spec),
                                *inputs)
    return _backmap_sidechains_fast_plain(spec, *inputs)
