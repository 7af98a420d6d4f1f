# encodermap_tpu_torch/misc/backmapping_offline.py
"""Topology-aware dihedral backmapping: rotate a real structure's bonds so
its dihedrals match decoder output.

Equivalent of the reference's ``mdtraj_backmapping``
(``encodermap/misc/backmapping.py:1027-1790``) and ``mdtraj_rotate``
(``misc/rotate.py:117``): a seed conformation of the full topology
(sidechains, hydrogens and all) is deformed by rotating, for every
requested dihedral, all atoms on the "far" side of its central bond about
that bond until the dihedral matches the target.

Counterpart of ``encodermap_tpu/misc/backmapping_offline.py``. The
near/far split is host numpy: a breadth-first search over an adjacency
list of the distance-guessed bonds (the JAX package asks networkx for the
same connected component), one boolean mask per dihedral. The rotation
sweep, a ``lax.scan`` over dihedrals vmapped over frames in JAX, is a
Python loop over dihedrals here: each step measures the current dihedral
of every frame and rotates the masked atoms of all frames at once, with
the port's ``rotation_matrices``, on the caller's device.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from ..data.topology import Topology
from ..device import resolve_device
from ..ops.backmap import rotation_matrices

__all__ = ["guess_bonds", "near_and_far_masks", "dihedral_rotate",
           "backmap_topology", "traj_rotate", "mdtraj_backmapping",
           "mdtraj_rotate", "dihedral_backmapping"]

# covalent radii (nm) for bond guessing
_COV_RADII = {
    "H": 0.031, "C": 0.076, "N": 0.071, "O": 0.066, "S": 0.105, "P": 0.107,
    "SE": 0.120, "F": 0.057, "CL": 0.102, "BR": 0.120,
}


def guess_bonds(top: Topology, xyz: np.ndarray, tolerance: float = 1.3
                ) -> list[tuple[int, int]]:
    """Distance-based bond guessing on one frame (standard covalent-radii
    criterion, like mdtraj's topology bond guesser).

    Same/adjacent-residue pairs cover every covalent bond in a linear
    protein chain; a second pass over sulfur atoms picks up disulfide
    bridges (CYS SG-SG), the one bond that spans arbitrarily distant
    residues — the reference handles these explicitly in
    ``mdtraj_backmapping`` (``misc/backmapping.py:1027-1790``)."""
    xyz = np.asarray(xyz)
    if xyz.ndim == 3:
        xyz = xyz[0]
    radii = np.array(
        [_COV_RADII.get(a.element.upper(), 0.08) for a in top.atoms]
    )
    bonds = set()
    # only test pairs within the same or adjacent residues (covalent bonds
    # along the chain never span further) to stay O(n) on host
    for res_i, res in enumerate(top.residues):
        atoms_here = np.array([a.index for a in res.atoms], np.int64)
        atoms_next = (
            np.array([a.index for a in top.residues[res_i + 1].atoms],
                     np.int64)
            if res_i + 1 < len(top.residues)
            else np.zeros(0, np.int64)
        )
        cand = np.concatenate([atoms_here, atoms_next])
        if not len(atoms_here) or not len(cand):
            continue
        # one broadcasted block per residue instead of a Python pair loop
        # (~160k scalar norm calls on an 8000-atom protein otherwise)
        d = np.linalg.norm(
            xyz[atoms_here][:, None, :] - xyz[cand][None, :, :], axis=-1
        )
        cutoff = (radii[atoms_here][:, None] + radii[cand][None, :]) \
            * tolerance
        ai, bi = np.nonzero(d < cutoff)
        for a, b in zip(atoms_here[ai], cand[bi]):
            # normalize (min, max): the old `b > a` filter permanently
            # dropped inter-residue bonds whose next-residue partner has
            # a LOWER global index (interleaved/patched topologies) — the
            # reverse direction is never re-tested (wave 33)
            if a != b:
                bonds.add((int(min(a, b)), int(max(a, b))))
    # disulfide-bridge pass: S-S pairs across any residue distance
    sulfurs = [a.index for a in top.atoms if a.element.upper() == "S"]
    for i, a in enumerate(sulfurs):
        for b in sulfurs[i + 1:]:
            lo, hi = (a, b) if a < b else (b, a)
            cutoff = (radii[lo] + radii[hi]) * tolerance
            if np.linalg.norm(xyz[lo] - xyz[hi]) < cutoff:
                bonds.add((lo, hi))
    # user-declared bonds from a CustomTopology (unnatural residues whose
    # connectivity the distance criterion may miss) join the graph here —
    # this is where the patched topology's _extra_bonds become observable
    for a, b in getattr(top, "_extra_bonds", []):
        bonds.add((min(a, b), max(a, b)))
    # user-declared bond DELETIONS (reference 'delete_bonds' /
    # 'optional_delete_bonds', trajinfo_utils.py:980-991): the distance
    # criterion can fabricate bonds in modified residues (e.g. the OXT-C
    # pair in a phosphothreonine); strict deletions of a never-guessed
    # bond raise, like the reference
    for lo, hi, strict in getattr(top, "_deleted_bonds", []):
        if (lo, hi) in bonds:
            bonds.discard((lo, hi))
        elif strict:
            raise ValueError(
                f"Bond between atoms {lo} and {hi} was not present in "
                f"topology. Consider using the key 'optional_delete_bonds' "
                f"to not raise on bonds that don't exist in the first "
                f"place."
            )
    return sorted(bonds)


def _far_side(adj: list[list[int]], b: int, c: int) -> set[int]:
    """The atoms reachable from ``c`` without crossing the b-c bond (every
    b-c edge, should the bond list repeat it)."""
    seen = {c}
    todo = deque([c])
    while todo:
        u = todo.popleft()
        for v in adj[u]:
            if v in seen or (u == c and v == b) or (u == b and v == c):
                continue
            seen.add(v)
            todo.append(v)
    return seen


def near_and_far_masks(
    top: Topology,
    dihedral_indices: np.ndarray,
    bonds: Optional[list[tuple[int, int]]] = None,
    xyz: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """For each dihedral (a,b,c,d): boolean mask of atoms on the far side of
    the b-c bond (the atoms that rotate) plus a rotatable flag — dihedrals
    whose central bond lies on a ring (proline phi, disulfide-bridged
    backbone) are marked unrotatable and skipped, mirroring the reference's
    proline handling. Host-side graph split (the reference's
    ``_get_near_and_far_networkx``, ``rotate.py:392``), by a breadth-first
    search over an adjacency list."""
    if bonds is None:
        assert xyz is not None, "need xyz to guess bonds"
        bonds = guess_bonds(top, xyz)
    adj: list[list[int]] = [[] for _ in range(top.n_atoms)]
    edges = set()
    for u, v in bonds:
        u, v = int(u), int(v)
        if u == v:
            continue
        edges.add((min(u, v), max(u, v)))
        adj[u].append(v)
        adj[v].append(u)

    masks = np.zeros((len(dihedral_indices), top.n_atoms), bool)
    rotatable = np.ones(len(dihedral_indices), bool)
    for i, (a, b, c, d) in enumerate(np.asarray(dihedral_indices)):
        a, b, c, d = int(a), int(b), int(c), int(d)
        if (min(b, c), max(b, c)) not in edges:
            rotatable[i] = False
            continue
        far = _far_side(adj, b, c)
        if a in far or d not in far:
            # a in far: ring bond (proline phi, disulfide-bridged
            # backbone, ...) — unrotatable; the reference likewise
            # special-cases prolines. d NOT in far: the c-d bond was
            # missed by the bond guesser, so rotating the far set would
            # never move the measured dihedral — mark unrotatable instead
            # of silently spinning the wrong atoms.
            rotatable[i] = False
            continue
        masks[i, list(far)] = True
        masks[i, b] = False
        masks[i, c] = False  # both axis atoms stay fixed
    return masks, rotatable


def _current_dihedral(pos: torch.Tensor, quad) -> torch.Tensor:
    """``(F,)`` dihedral of atoms ``quad`` in every frame of ``pos``, from
    elementwise sums and ``atan2`` like ``ops/geometry.py``."""
    p0, p1, p2, p3 = (pos[:, quad[0]], pos[:, quad[1]], pos[:, quad[2]],
                      pos[:, quad[3]])
    b0 = p0 - p1
    b1 = p2 - p1
    b2 = p3 - p2
    b1n = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    v = b0 - torch.sum(b0 * b1n, -1, keepdim=True) * b1n
    w = b2 - torch.sum(b2 * b1n, -1, keepdim=True) * b1n
    x = torch.sum(v * w, -1)
    y = torch.sum(torch.linalg.cross(b1n, v, dim=-1) * w, -1)
    return torch.atan2(y, x)


def dihedral_rotate(
    xyz: torch.Tensor,
    quads: np.ndarray,
    masks: np.ndarray,
    targets: torch.Tensor,
) -> torch.Tensor:
    """Rotate the far-side atoms of each dihedral, in turn, so that the
    dihedral takes its target value.

    A loop over dihedrals; each step rotates the masked atoms of every
    frame at once.

    Args:
        xyz: ``(F, n_atoms, 3)`` conformations (or one ``(n_atoms, 3)``).
        quads: ``(n_dih, 4)`` dihedral atom quadruplets (host).
        masks: ``(n_dih, n_atoms)`` far-side rotation masks (host).
        targets: ``(F, n_dih)`` target dihedrals in radians (or
            ``(n_dih,)`` with one conformation).

    Returns:
        The rotated conformations, shaped like ``xyz``.
    """
    single = xyz.dim() == 2
    pos = xyz[None] if single else xyz
    targets = torch.as_tensor(targets, dtype=pos.dtype, device=pos.device)
    if single:
        targets = targets[None]
    quads = np.asarray(quads, np.int64)
    masks_t = torch.as_tensor(np.asarray(masks), dtype=pos.dtype,
                              device=pos.device)[..., None]
    for k, quad in enumerate(quads.tolist()):
        delta = targets[:, k] - _current_dihedral(pos, quad)
        axis = pos[:, quad[2]] - pos[:, quad[1]]
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        # rotation_matrices is the row-vector (x @ R) convention rotating by
        # -angle; measured dihedral increases with +delta rotation of the far
        # side about b->c, so negate to match.
        R = rotation_matrices(axis, -delta)
        pivot = pos[:, quad[2]][:, None, :]
        rotated = (pos - pivot) @ R + pivot
        pos = pos + masks_t[k] * (rotated - pos)
    return pos[0] if single else pos


def backmap_topology(
    top: Topology,
    base_xyz: np.ndarray,
    dihedrals: np.ndarray,
    dihedral_indices: Optional[np.ndarray] = None,
    side_dihedrals: Optional[np.ndarray] = None,
    side_indices: Optional[np.ndarray] = None,
    bonds: Optional[list[tuple[int, int]]] = None,
    device=None,
) -> np.ndarray:
    """Full offline backmapping: one seed conformation -> many frames with
    the requested backbone (and optional sidechain) dihedrals.

    Default dihedral set matches the reference's ``mdtraj_backmapping``:
    phi+psi backbone torsions in featurization order. The sweep runs on
    ``device`` (the card unless ``device="cpu"``).

    Returns:
        ``(n_frames, n_atoms, 3)`` coordinates (numpy).
    """
    dev = resolve_device(device)
    base_xyz = np.asarray(base_xyz, np.float32)
    if base_xyz.ndim == 3:
        base_xyz = base_xyz[0]
    dihedrals = np.atleast_2d(np.asarray(dihedrals, np.float32))

    if dihedral_indices is None:
        phi = top.indices_phi
        psi = top.indices_psi
        dihedral_indices = np.vstack([phi, psi])
    quads = np.asarray(dihedral_indices, np.int64)
    targets = dihedrals

    if side_dihedrals is not None:
        if side_indices is None:
            # residue-major (residue, chi1..chi5) — the EXACT column order
            # of the side_dihedrals CV (SideChainDihedrals), this
            # argument's documented drop-in source. A chi-major
            # vstack(indices_chi(1..5)) has the same row COUNT but pairs
            # values with the wrong quadruplets for any multi-chi protein.
            from ..loading.features import SideChainDihedrals

            side_indices = SideChainDihedrals(top)._indices
        side_dihedrals = np.atleast_2d(np.asarray(side_dihedrals, np.float32))
        quads = np.vstack([quads, np.asarray(side_indices, np.int64)])
        targets = np.concatenate([targets, side_dihedrals], axis=1)

    assert targets.shape[1] == len(quads), (
        f"got {targets.shape[1]} dihedral values for {len(quads)} quadruplets"
    )
    masks, rotatable = near_and_far_masks(top, quads, bonds=bonds,
                                          xyz=base_xyz)
    if not rotatable.all():
        skipped = int((~rotatable).sum())
        print(
            f"backmap_topology: skipping {skipped} unrotatable (ring) "
            f"dihedral(s) — e.g. proline phi / disulfide bridges"
        )
        quads = quads[rotatable]
        masks = masks[rotatable]
        targets = targets[:, rotatable]

    base = torch.as_tensor(base_xyz, device=dev)
    with torch.no_grad():
        out = dihedral_rotate(
            base.expand(len(targets), *base.shape), quads, masks,
            torch.as_tensor(targets, device=dev))
    return out.cpu().numpy()


def traj_rotate(
    traj,
    angles: np.ndarray,
    indices: np.ndarray,
    deg: bool = False,
    delete_sulfide_bridges: bool = True,
    device=None,
) -> np.ndarray:
    """Set specific dihedrals of a single-frame trajectory to given values —
    the drop-in analog of the reference's ``mdtraj_rotate``
    (``misc/rotate.py:117``), shaped ``angles (n_frames, n_dih)`` /
    ``indices (n_dih, 4)``.

    Returns the rotated coordinates ``(n_frames, n_atoms, 3)``.
    """
    angles = np.atleast_2d(np.asarray(angles, np.float32))
    indices = np.asarray(indices, np.int64).reshape(-1, 4)
    if deg:
        angles = np.radians(angles)
    assert angles.shape[1] == len(indices), (
        f"angles.shape[1]={angles.shape[1]} must equal len(indices)="
        f"{len(indices)}"
    )
    xyz = np.asarray(traj.xyz, np.float32)
    if xyz.ndim == 3:
        xyz = xyz[0]
    bonds = guess_bonds(traj.top, xyz)
    if delete_sulfide_bridges:
        bonds = [
            (a, b) for a, b in bonds
            if not (traj.top.atom(a).element.upper() == "S"
                    and traj.top.atom(b).element.upper() == "S")
        ]
    return backmap_topology(
        traj.top, xyz, angles, dihedral_indices=indices, bonds=bonds,
        device=device,
    )


def mdtraj_rotate(
    traj,
    angles: np.ndarray,
    indices: np.ndarray,
    deg: bool = False,
    check_cyclic_backbone: bool = True,
    verify_every_rotation: bool = False,
    drop_proline_angles: bool = False,
    delete_sulfide_bridges: bool = True,
    device=None,
) -> np.ndarray:
    """Reference-named entry point (``misc/rotate.py:117``) for
    :func:`traj_rotate`.

    Signature-compatible with the reference; three of its flags are
    no-ops here by construction: ``check_cyclic_backbone`` and
    ``drop_proline_angles`` are subsumed by the ring detection in
    :func:`near_and_far_masks` (unrotatable ring dihedrals are always
    detected and skipped, cyclic or proline alike), and
    ``verify_every_rotation`` is a numba-debugging aid in the reference
    whereas the device sweep here sets each dihedral exactly by a single
    closed-form rotation. Returns ``(n_frames, n_atoms, 3)`` coordinates
    (this framework has no mdtraj to wrap them in).
    """
    del check_cyclic_backbone, verify_every_rotation, drop_proline_angles
    return traj_rotate(
        traj, angles, indices, deg=deg,
        delete_sulfide_bridges=delete_sulfide_bridges, device=device,
    )


def mdtraj_backmapping(
    top=None,
    dihedrals: Optional[np.ndarray] = None,
    sidechain_dihedrals: Optional[np.ndarray] = None,
    trajs=None,
    remove_component_size: int = 0,
    verify_every_rotation: bool = False,
    angle_type: str = "radian",
    omega: bool = True,
    guess_sp2_atoms: bool = True,
    return_indices: bool = False,
    parallel: bool = False,
    progbar=None,
    device=None,
):
    """Reference-named entry point (``misc/backmapping.py:1027-1790``) for
    :func:`backmap_topology`.

    Resolves the seed structure the reference way: ``top`` may be a
    topology file path (frame 0 of that file seeds the rotation), or an
    int indexing into ``trajs``; with ``top=None`` the first trajectory
    of ``trajs`` is used. ``dihedrals`` columns follow the
    ``central_dihedrals`` CV order (PSI/OMEGA/PHI interleave, honoring
    ``omega``) when their width matches it, else the phi+psi
    ``BackboneTorsionFeature`` order. ``angle_type="degree"`` converts.
    ``sidechain_dihedrals`` follow the ``side_dihedrals`` CV order.

    Returns ``(n_frames, n_atoms, 3)`` coordinates — this framework's
    offline-backmapping currency (no mdtraj in the image); pass
    ``return_indices=True`` to also get the ``{"dihedrals": quads,
    "side_dihedrals": quads}`` index tables actually rotated.
    ``remove_component_size``/``parallel``/``progbar`` are accepted for
    signature compatibility (disconnected-component pruning does not
    apply to the covalent-radius bond guesser, and the rotation sweep is
    already batched over frames on the device). The sweep runs on
    ``device`` (the card unless ``device="cpu"``), as in every entry
    point of this module.
    """
    del remove_component_size, verify_every_rotation, guess_sp2_atoms
    del parallel, progbar
    if dihedrals is None:
        raise ValueError("mdtraj_backmapping needs a `dihedrals` array")

    # --- resolve the seed trajectory/topology --------------------------
    seed = None
    if isinstance(top, (int, np.integer)):
        if trajs is None:
            raise ValueError("top=<int> indexes into `trajs`; pass trajs")
        if hasattr(trajs, "top") and not hasattr(trajs, "trajs"):
            # a bare SingleTraj has nothing to index into
            if int(top) != 0:
                raise ValueError(
                    f"top={int(top)} indexes into an ensemble/list of "
                    "trajectories, but `trajs` is a single trajectory"
                )
            seed = trajs
        else:
            # TrajEnsemble and plain lists both index positionally
            seed = trajs[int(top)]
    elif top is not None and not isinstance(top, Topology):
        from ..data.trajectory import SingleTraj

        seed = SingleTraj(top)
    elif trajs is not None:
        if hasattr(trajs, "trajs"):  # TrajEnsemble
            seed = trajs.trajs[0]
        elif isinstance(trajs, (list, tuple)):  # plain sequence of trajs
            if not trajs:
                raise ValueError("`trajs` is an empty sequence")
            seed = trajs[0]
        else:
            seed = trajs
    if seed is not None:
        # an explicitly passed Topology object wins over the seed's own
        # (e.g. a chi-patched CustomTopology product) — silently using
        # seed.top would build quadruplet tables without the user's
        # patches. Coordinates still come from the seed.
        if isinstance(top, Topology):
            if top.n_atoms != seed.top.n_atoms:
                raise ValueError(
                    f"the explicit Topology has {top.n_atoms} atoms but "
                    f"the seed trajectory has {seed.top.n_atoms}; they "
                    f"must describe the same structure"
                )
            topology = top
        else:
            topology = seed.top
        base_xyz = np.asarray(seed.xyz, np.float32)[0]
    elif isinstance(top, Topology):
        raise ValueError(
            "a bare Topology carries no coordinates; pass a file path or "
            "trajs so a seed conformation exists"
        )
    else:
        raise ValueError("pass `top` (path/int) and/or `trajs`")

    dihedrals = np.atleast_2d(np.asarray(dihedrals, np.float32))
    if sidechain_dihedrals is not None:
        sidechain_dihedrals = np.atleast_2d(
            np.asarray(sidechain_dihedrals, np.float32)
        )
    # unit sanity checks mirror the reference (backmapping.py:1232-1274):
    # radians must stay within pi; degrees must have SOME value above pi
    # (an all-<=pi "degree" array is almost certainly radians mislabeled)
    if angle_type == "radian":
        # magnitude checks: signed comparisons (the reference's
        # backmapping.py:1251 form) misclassify all-negative degree data
        if np.any(np.abs(dihedrals) > np.pi):
            raise ValueError(
                "angle_type='radian', but some dihedrals exceed pi in "
                "magnitude — they look like degrees"
            )
        if sidechain_dihedrals is not None and np.any(
                np.abs(sidechain_dihedrals) > np.pi):
            raise ValueError(
                "angle_type='radian', but some sidechain dihedrals exceed "
                "pi in magnitude — they look like degrees"
            )
    elif angle_type == "degree":
        if np.all(np.abs(dihedrals) <= np.pi):
            raise ValueError(
                "angle_type='degree', but none of the dihedrals exceed pi "
                "in magnitude — they look like radians"
            )
        dihedrals = np.radians(dihedrals)
        if sidechain_dihedrals is not None:
            if np.all(np.abs(sidechain_dihedrals) <= np.pi):
                raise ValueError(
                    "angle_type='degree', but none of the sidechain "
                    "dihedrals exceed pi in magnitude — they look like "
                    "radians"
                )
            sidechain_dihedrals = np.radians(sidechain_dihedrals)
    else:
        raise ValueError(f"angle_type must be 'radian'/'degree', "
                         f"got {angle_type!r}")
    if (sidechain_dihedrals is not None
            and len(dihedrals) != len(sidechain_dihedrals)):
        raise ValueError(
            f"The number of provided dihedrals ({len(dihedrals)}) and "
            f"sidechain dihedrals ({len(sidechain_dihedrals)}) must be "
            f"the same."
        )

    # --- map columns onto quadruplets ----------------------------------
    from ..loading.features import CentralDihedrals

    cd = CentralDihedrals(topology, omega=omega)
    n_central = len(cd._indices)
    phi = np.asarray(topology.indices_phi, np.int64).reshape(-1, 4)
    psi = np.asarray(topology.indices_psi, np.int64).reshape(-1, 4)
    if dihedrals.shape[1] == n_central:
        # NOTE: with omega=False this width EQUALS len(phi)+len(psi), so
        # the dispatch cannot distinguish interleaved central-CV order
        # from phi-block+psi-block data; interleaved (the featurizer's
        # own order) wins. Blocked phi+psi data for an omega-less model
        # must go through backmap_topology with explicit indices (or the
        # legacy dihedral_backmapping, which is block-ordered).
        quads = np.asarray(cd._indices, np.int64)
    elif dihedrals.shape[1] == len(phi) + len(psi):
        quads = np.vstack([phi, psi])
    else:
        raise ValueError(
            f"dihedrals has {dihedrals.shape[1]} columns; topology "
            f"expects {n_central} (central_dihedrals order) or "
            f"{len(phi) + len(psi)} (phi+psi order)"
        )

    side_indices = None
    if sidechain_dihedrals is not None:
        from ..loading.features import SideChainDihedrals

        side_indices = np.asarray(
            SideChainDihedrals(topology)._indices, np.int64
        )

    out = backmap_topology(
        topology, base_xyz, dihedrals,
        dihedral_indices=quads,
        side_dihedrals=sidechain_dihedrals,
        side_indices=side_indices,
        device=device,
    )
    if return_indices:
        # the docstring promises the tables ACTUALLY rotated:
        # backmap_topology drops unrotatable rows (proline phi, ring /
        # missing-bond dihedrals), so filter with the same mask instead
        # of returning the pre-filter tables (wave 33)
        seed = np.asarray(base_xyz, np.float32)
        if seed.ndim == 3:
            seed = seed[0]
        all_quads = (
            quads if side_indices is None
            else np.vstack([quads, side_indices])
        )
        _, rotatable = near_and_far_masks(topology, all_quads, xyz=seed)
        n_c = len(quads)
        tables = {"dihedrals": quads[rotatable[:n_c]]}
        if side_indices is not None:
            tables["side_dihedrals"] = side_indices[rotatable[n_c:]]
        return out, tables
    return out


def dihedral_backmapping(
    pdb_path, dihedral_trajectory, rough_n_points: int = -1, sidechains=None,
    device=None,
):
    """Legacy reference-named entry (``misc/backmapping.py:1993-2044``):
    rotate the structure in ``pdb_path`` to match the given phi/psi
    ``dihedral_trajectory``, optionally subsampled to roughly
    ``rough_n_points`` frames (the reference's step-size rule, where
    ``-1`` keeps every frame).

    The reference returns an MDAnalysis ``Universe``; this framework's
    offline-backmapping currency is ``(n_frames, n_atoms, 3)``
    coordinates (see :func:`mdtraj_backmapping`).

    Column order is the LEGACY block layout the reference builds from
    MDAnalysis selections (``backmapping.py:2016-2051``): all psi, then
    all omega, then all phi; sidechains chi-major (all chi1, all chi2,
    ...). This differs from :func:`mdtraj_backmapping`'s residue-
    interleaved ``central_dihedrals`` order — the quadruplet tables are
    built here in block order so every column rotates the dihedral the
    legacy API promised.
    """
    dihedral_trajectory = np.atleast_2d(
        np.asarray(dihedral_trajectory, np.float32)
    )
    step_size = max(1, int(len(dihedral_trajectory) / rough_n_points))
    dihedral_trajectory = dihedral_trajectory[::step_size]
    if sidechains is not None:
        sidechains = np.atleast_2d(
            np.asarray(sidechains, np.float32))[::step_size]

    from ..data.trajectory import SingleTraj

    seed = SingleTraj(pdb_path)
    top = seed.top
    psi = np.asarray(top.indices_psi, np.int64).reshape(-1, 4)
    omega = np.asarray(top.indices_omega, np.int64).reshape(-1, 4)
    phi = np.asarray(top.indices_phi, np.int64).reshape(-1, 4)
    if dihedral_trajectory.shape[1] == len(psi) + len(omega) + len(phi):
        quads = np.vstack([psi, omega, phi])
    elif dihedral_trajectory.shape[1] == len(psi) + len(phi):
        quads = np.vstack([psi, phi])
    else:
        raise ValueError(
            f"dihedral_trajectory has {dihedral_trajectory.shape[1]} "
            f"columns; the legacy block layout expects "
            f"{len(psi) + len(omega) + len(phi)} (psi+omega+phi) or "
            f"{len(psi) + len(phi)} (psi+phi) for this topology"
        )
    side_indices = None
    if sidechains is not None:
        chi_blocks = [
            np.asarray(top.indices_chi(n), np.int64).reshape(-1, 4)
            for n in range(1, 6)
        ]
        side_indices = np.vstack([b for b in chi_blocks if len(b)]) \
            if any(len(b) for b in chi_blocks) else np.zeros((0, 4), np.int64)
        if sidechains.shape[1] != len(side_indices):
            raise ValueError(
                f"sidechains has {sidechains.shape[1]} columns; the "
                f"chi-major legacy layout expects {len(side_indices)}"
            )
    return backmap_topology(
        top, np.asarray(seed.xyz, np.float32)[0], dihedral_trajectory,
        dihedral_indices=quads,
        side_dihedrals=sidechains,
        side_indices=side_indices,
        device=device,
    )
