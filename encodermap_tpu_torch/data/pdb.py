# encodermap_tpu_torch/data/pdb.py
"""PDB file reading/writing (self-contained; mdtraj is unavailable here).

Coordinates follow the mdtraj convention used throughout the reference:
nanometers internally (PDB files store Angstrom; factor 10).

Counterpart of ``encodermap_tpu/data/pdb.py``; host numpy, copied near verbatim.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from .topology import Topology

__all__ = ["load_pdb", "write_pdb"]


_ION_RESIDUES = {"NA", "NA+", "SOD", "CL", "CL-", "CLA", "K", "K+", "POT",
                 "MG", "MG2", "ZN", "ZN2", "FE", "FE2", "MN", "BR", "CAL"}


def _guess_element(
    atom_name: str, element_field: str,
    res_name: str = "", col13: bool = False,
) -> str:
    """Element from the atom name when columns 77-78 are blank.

    The "NA" ambiguity (sodium ion vs a heme pyrrole nitrogen, both named
    NA): the PDB convention puts two-letter element names at column 13
    (``col13``) while single-letter elements indent to column 14 — a
    two-letter metal/halogen guess is only taken when the name starts at
    column 13 or the residue itself is a known ion residue."""
    if element_field:
        return element_field.strip().upper()
    name = atom_name.strip()
    # strip leading digits (e.g. 1HB2)
    stripped = name.lstrip("0123456789")
    if not stripped:
        return ""
    two = stripped[:2].upper()
    if two == "NA":
        # the one genuinely ambiguous pair: heme/porphyrin pyrrole
        # nitrogens are named NA (element N)
        if col13 or res_name.strip().upper() in _ION_RESIDUES:
            return "NA"
        return "N"
    if two in ("CL", "BR", "FE", "ZN", "MG", "SE", "MN"):
        return two
    return stripped[0].upper()


def _cell_from_lengths_angles(
    lengths: tuple, angles: tuple
) -> np.ndarray:
    """Crystallographic (a, b, c, alpha, beta, gamma) -> lower-triangular
    ``(3, 3)`` cell-vector rows (the mdtraj/GROMACS convention)."""
    a, b, c = lengths
    al, be, ga = np.radians(angles)
    v2x, v2y = b * np.cos(ga), b * np.sin(ga)
    v3x = c * np.cos(be)
    v3y = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    v3z = np.sqrt(max(c * c - v3x * v3x - v3y * v3y, 0.0))
    return np.asarray(
        [[a, 0.0, 0.0], [v2x, v2y, 0.0], [v3x, v3y, v3z]], np.float64
    )


def load_pdb(
    path: Union[str, Path], frame_stack: bool = True
) -> tuple[Topology, np.ndarray, Optional[np.ndarray]]:
    """Parse a PDB file.

    Returns:
        (topology, xyz, unitcell) where xyz is ``(n_frames, n_atoms, 3)`` in
        nm (MODEL records give multiple frames) and unitcell is
        ``(n_frames, 3)`` box lengths in nm (orthorhombic cells),
        ``(n_frames, 3, 3)`` cell-vector rows (triclinic CRYST1 angles),
        or None.
    """
    top = Topology()
    frames: list[list[tuple[float, float, float]]] = []
    coords: list[tuple[float, float, float]] = []
    # per-model atom signatures (name+resSeq), kept so ragged multi-model
    # files can be verified before trimming — a positional trim of a model
    # whose EXTRA atom sits mid-chain would silently shift every later
    # coordinate onto the wrong atom
    sigs: list[list[str]] = []
    cur_sigs: list[str] = []
    box = None

    chain_index = -1
    last_chain_id = None
    cur_res = None
    first_model_done = False

    with open(path) as fh:
        for line in fh:
            rec = line[:6]
            if rec == "CRYST1":
                try:
                    box = (
                        float(line[6:15]) / 10.0,
                        float(line[15:24]) / 10.0,
                        float(line[24:33]) / 10.0,
                    )
                    # "CRYST1 1.000 1.000 1.000" is the PDB convention
                    # for "no crystal" (NMR/modeled structures) — a real
                    # 0.1 nm box would wreck minimum-image distances
                    if max(box) <= 0.11:
                        box = None
                    else:
                        # alpha/beta/gamma columns: a skewed cell treated
                        # as orthorhombic silently breaks every
                        # minimum-image distance near the boundary
                        try:
                            angles = (
                                float(line[33:40]),
                                float(line[40:47]),
                                float(line[47:54]),
                            )
                        except (ValueError, IndexError):
                            angles = (90.0, 90.0, 90.0)
                        if any(abs(x - 90.0) > 1e-4 for x in angles):
                            box = _cell_from_lengths_angles(box, angles)
                except ValueError:
                    box = None
            elif rec in ("ATOM  ", "HETATM"):
                altloc = line[16] if len(line) > 16 else " "
                if altloc not in (" ", "A", "1"):
                    continue  # keep only the primary alternate location
                x = float(line[30:38]) / 10.0
                y = float(line[38:46]) / 10.0
                z = float(line[46:54]) / 10.0
                coords.append((x, y, z))
                cur_sigs.append(line[12:16] + line[22:26])
                if first_model_done:
                    continue
                name = line[12:16].strip()
                res_name = line[17:21].strip()
                chain_id = line[21]
                res_seq = int(line[22:26])
                element_field = line[76:78] if len(line) >= 78 else ""
                if chain_id != last_chain_id:
                    chain_index += 1
                    last_chain_id = chain_id
                    cur_res = None
                if (
                    cur_res is None
                    or cur_res.resSeq != res_seq
                    or cur_res.name != res_name
                ):
                    cur_res = top.add_residue(res_name, res_seq, chain_index)
                col13 = line[12] not in " 0123456789"
                top.add_atom(
                    name,
                    _guess_element(name, element_field, res_name, col13),
                    cur_res,
                )
            elif rec == "TER   " or line.startswith("TER"):
                # chain break within the same chain id
                last_chain_id = None
            elif line.startswith("ENDMDL"):
                if coords:
                    frames.append(coords)
                    sigs.append(cur_sigs)
                    coords = []
                    cur_sigs = []
                first_model_done = True

    if coords:
        frames.append(coords)
        sigs.append(cur_sigs)

    n_atoms = top.n_atoms
    # some deposited ensembles have per-model extra atoms (waters/altlocs),
    # making `frames` ragged — trim every model to model 1's atoms BEFORE
    # stacking (np.asarray raises on ragged input under numpy 2.x), but
    # only when the kept prefix is the SAME atoms: a mid-chain extra atom
    # would shift every later coordinate onto the wrong atom
    if any(len(f) != n_atoms for f in frames):
        for m, (f, s) in enumerate(zip(frames, sigs)):
            if len(f) < n_atoms:
                raise ValueError(
                    f"{path}: MODEL {m + 1} has fewer atoms ({len(f)}) "
                    f"than model 1 ({n_atoms})"
                )
            if s[:n_atoms] != sigs[0]:
                raise ValueError(
                    f"{path}: MODEL {m + 1} has extra atoms mid-chain — "
                    f"trimming would misalign coordinates with the "
                    f"topology (first mismatch at atom "
                    f"{next(i for i in range(n_atoms) if s[i] != sigs[0][i])})"
                )
        frames = [f[:n_atoms] for f in frames]
    xyz = np.asarray(frames, dtype=np.float32)
    unitcell = None
    if box is not None:
        box = np.asarray(box, np.float32)
        reps = (len(xyz), 1, 1) if box.ndim == 2 else (len(xyz), 1)
        unitcell = np.tile(box, reps)
    if not frame_stack and len(xyz) == 1:
        xyz = xyz[0]
    return top, xyz, unitcell


def write_pdb(
    path: Union[str, Path],
    top: Topology,
    xyz: np.ndarray,
    unitcell: Optional[np.ndarray] = None,
) -> None:
    """Write (multi-frame) coordinates as a PDB file (nm -> Angstrom).

    ``unitcell`` may be box LENGTHS (``(3,)``/``(n_frames, 3)``) or
    cell-vector rows (``(3, 3)``/``(n_frames, 3, 3)``, the framework's
    internal ``_unitcell`` layout) — the CRYST1 record carries the true
    lengths AND angles either way."""
    xyz = np.asarray(xyz)
    if xyz.ndim == 2:
        xyz = xyz[None]
    chain_ids = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    with open(path, "w") as fh:
        if unitcell is not None:
            cell = np.asarray(unitcell, np.float64)
            # (F, 3, 3) = cell-vector rows; (3, 3) alone stays the legacy
            # "frames of lengths" reading (disambiguated by ndim only)
            if cell.ndim == 3 and cell.shape[-2:] == (3, 3):
                vecs = cell[0]
                a, b, c = (np.linalg.norm(vecs, axis=-1) * 10.0).tolist()

                def _angle(u, v):
                    cos = float(np.dot(u, v)) / max(
                        np.linalg.norm(u) * np.linalg.norm(v), 1e-12
                    )
                    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))

                al = _angle(vecs[1], vecs[2])
                be = _angle(vecs[0], vecs[2])
                ga = _angle(vecs[0], vecs[1])
            else:
                a, b, c = (cell.reshape(-1, 3)[0] * 10.0).tolist()
                al = be = ga = 90.0
            fh.write(
                f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}{al:7.2f}{be:7.2f}"
                f"{ga:7.2f} P 1           1\n"
            )
        for f, frame in enumerate(xyz):
            fh.write(f"MODEL     {f + 1:4d}\n")
            serial = 1
            for atom in top.atoms:
                r = atom.residue
                x, y, z = (frame[atom.index] * 10.0).tolist()
                # clamp to the 4-char column like the residue name below —
                # a 5-char name (legal in GRO input) would shift every
                # later column and silently corrupt parsed coordinates
                name = atom.name[:4]
                name_fmt = f" {name:<3s}" if len(name) < 4 else f"{name:<4s}"
                chain = chain_ids[r.chain_index % len(chain_ids)]
                # fixed-column format: wrap overflowing serial/resSeq like
                # mdtraj (serial % 100000, resSeq % 10000) and clamp the
                # residue name — an overflow would shift every later
                # column and silently corrupt parsed coordinates
                fh.write(
                    f"ATOM  {serial % 100000:5d} {name_fmt} "
                    f"{r.name[:4]:<4s}{chain}{r.resSeq % 10000:4d}"
                    f"    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
                    f"          {atom.element:>2s}\n"
                )
                serial += 1
            fh.write("ENDMDL\n")
        fh.write("END\n")
