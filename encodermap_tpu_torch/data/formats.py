# encodermap_tpu_torch/data/formats.py
"""Additional trajectory/structure formats: GRO (text) and DCD (binary).

The reference reaches these through mdtraj; here they are small direct
readers. GRO files carry topology+coordinates (nm); DCD carries coordinates
in Angstrom (converted to nm on read, CHARMM/NAMD convention); TRR (GROMACS,
XDR) carries nm and may hold frames without coordinates.

Counterpart of ``encodermap_tpu/data/formats.py``; host numpy, copied near
verbatim, so both packages read and write the same bytes.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np

from .pdb import _guess_element
from .topology import Topology

__all__ = ["load_gro", "DCDReader", "write_dcd", "TRRReader", "write_trr"]


def load_gro(path: Union[str, Path]) -> tuple[Topology, np.ndarray, Optional[np.ndarray]]:
    """Parse a GROMACS .gro file (possibly multi-frame).

    Returns (topology, xyz (n_frames, n_atoms, 3) nm, box (n_frames, 3) nm).
    """
    top = Topology()
    frames = []
    boxes = []
    built = False
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip() and frames:
            # A blank line after the first frame is EITHER trailing/EOF
            # padding (nothing but blanks follow -> done) OR a legal empty
            # title line of the next frame (content follows -> parse it;
            # skipping would misread the atom-count line as the title).
            if all(not l.strip() for l in lines[i + 1:]):
                break
        # title line, then atom count
        n_atoms = int(lines[i + 1])
        coords = np.empty((n_atoms, 3), np.float32)
        cur_res = None
        for k in range(n_atoms):
            ln = lines[i + 2 + k]
            res_num = int(ln[0:5])
            res_name = ln[5:10].strip()
            atom_name = ln[10:15].strip()
            coords[k, 0] = float(ln[20:28])
            coords[k, 1] = float(ln[28:36])
            coords[k, 2] = float(ln[36:44])
            if not built:
                if cur_res is None or cur_res.resSeq != res_num or \
                        cur_res.name != res_name:
                    cur_res = top.add_residue(res_name, res_num, 0)
                element = _guess_element(atom_name, "", res_name)
                top.add_atom(atom_name, element, cur_res)
        built = True
        box_line = lines[i + 2 + n_atoms].split()
        v = [float(x) for x in box_line]
        if len(v) >= 9:
            # triclinic box: v1x v2y v3z v1y v1z v2x v2z v3x v3y
            # (GROMACS manual order) -> (3, 3) cell-vector rows
            boxes.append([[v[0], v[3], v[4]],
                          [v[5], v[1], v[6]],
                          [v[7], v[8], v[2]]])
        else:
            boxes.append([v[0], v[1], v[2]])
        frames.append(coords)
        i += 3 + n_atoms
    boxes_arr = (
        np.asarray(boxes, np.float32)
        if all(np.ndim(b) == np.ndim(boxes[0]) for b in boxes)
        # mixed ortho/triclinic frame boxes: promote lengths to diagonals
        else np.stack([
            np.diag(b).astype(np.float32) if np.ndim(b) == 1
            else np.asarray(b, np.float32)
            for b in boxes
        ])
    )
    return top, np.stack(frames), boxes_arr


class DCDReader:
    """CHARMM/NAMD DCD trajectory reader (coordinates converted A -> nm)."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = str(path)
        with open(self.path, "rb") as fh:
            raw = fh.read(4)
            # fortran record marker; detect endianness
            (marker,) = struct.unpack("<i", raw)
            self._end = "<" if marker == 84 else ">"
            if marker != 84:
                (marker,) = struct.unpack(">i", raw)
                if marker != 84:
                    raise IOError(f"{path} is not a DCD file")
            hdr = fh.read(84)
            if hdr[:4] != b"CORD":
                raise IOError(f"{path}: missing CORD magic")
            icntrl = struct.unpack(f"{self._end}20i", hdr[4:])
            self.n_frames_header = icntrl[0]
            self._has_cell = icntrl[10] != 0
            if icntrl[8] != 0:
                # NAMNF > 0: a FREEAT index record follows and frames 2..N
                # store only free atoms — the fixed layout below would
                # silently decode garbage
                raise IOError(
                    f"{path}: DCD files with fixed atoms "
                    f"(NAMNF={icntrl[8]}) are not supported"
                )
            fh.read(4)  # trailing marker
            # title record
            (tlen,) = struct.unpack(f"{self._end}i", fh.read(4))
            fh.read(tlen + 4)
            # natoms record
            fh.read(4)
            (self.n_atoms,) = struct.unpack(f"{self._end}i", fh.read(4))
            fh.read(4)
            self._data_start = fh.tell()
        # frame size: optional cell record + 3 coordinate records
        cell = (4 + 48 + 4) if self._has_cell else 0
        coord = 3 * (4 + 4 * self.n_atoms + 4)
        self._frame_size = cell + coord
        size = Path(self.path).stat().st_size
        self.n_frames = (size - self._data_start) // self._frame_size

    def read(self, indices=None) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Decode frames: (xyz (n, n_atoms, 3) nm, cell (n, 3) nm or None)."""
        if indices is None:
            idx = np.arange(self.n_frames)
        else:
            idx = np.atleast_1d(np.asarray(indices, np.int64))
            if len(idx) and (
                idx.min() < -self.n_frames or idx.max() >= self.n_frames
            ):
                raise IndexError(
                    f"frame index out of range for {self.n_frames}-frame "
                    f"trajectory: {indices}"
                )
            idx = np.where(idx < 0, idx + self.n_frames, idx)
        xyz = np.empty((len(idx), self.n_atoms, 3), np.float32)
        cells = np.empty((len(idx), 3), np.float32) if self._has_cell else None
        with open(self.path, "rb") as fh:
            for out_i, f in enumerate(idx):
                fh.seek(self._data_start + int(f) * self._frame_size)
                if self._has_cell:
                    fh.read(4)
                    cell = struct.unpack(f"{self._end}6d", fh.read(48))
                    fh.read(4)
                    # CHARMM order: A, gamma, B, beta, alpha, C
                    cells[out_i] = (cell[0] / 10, cell[2] / 10, cell[5] / 10)
                for d in range(3):
                    fh.read(4)
                    xyz[out_i, :, d] = np.frombuffer(
                        fh.read(4 * self.n_atoms),
                        dtype=f"{self._end}f4",
                    )
                    fh.read(4)
        return xyz / 10.0, cells

    def __len__(self) -> int:
        return self.n_frames


def write_dcd(
    path: Union[str, Path],
    xyz: np.ndarray,
    cell_lengths: Optional[np.ndarray] = None,
) -> None:
    """Write a minimal CHARMM-style DCD file (nm -> Angstrom)."""
    xyz = np.asarray(xyz, np.float32) * 10.0
    n_frames, n_atoms, _ = xyz.shape
    has_cell = cell_lengths is not None
    with open(path, "wb") as fh:
        def rec(payload: bytes) -> None:
            fh.write(struct.pack("<i", len(payload)))
            fh.write(payload)
            fh.write(struct.pack("<i", len(payload)))

        icntrl = [0] * 20
        icntrl[0] = n_frames
        icntrl[10] = 1 if has_cell else 0
        # CHARMM version field: VMD/mdtraj only parse the unit-cell extra
        # block when this is non-zero (0 would mean X-PLOR format and the
        # cell record would be misread as coordinates)
        icntrl[19] = 24
        rec(b"CORD" + struct.pack("<20i", *icntrl))
        title = b"REMARKS written by encodermap_tpu".ljust(80)
        rec(struct.pack("<i", 1) + title)
        rec(struct.pack("<i", n_atoms))
        for f in range(n_frames):
            if has_cell:
                a, b, c = (np.asarray(cell_lengths[f]) * 10.0).tolist()
                rec(struct.pack("<6d", a, 90.0, b, 90.0, 90.0, c))
            for d in range(3):
                rec(xyz[f, :, d].astype("<f4").tobytes())


class TRRReader:
    """GROMACS TRR trajectory reader (XDR big-endian, uncompressed).

    Handles single- and double-precision files; returns nm coordinates.
    """

    _MAGIC = 1993

    def __init__(self, path: Union[str, Path]) -> None:
        self.path = str(path)
        self._offsets: list[int] = []
        self._meta: list[tuple] = []
        file_size = Path(self.path).stat().st_size
        with open(self.path, "rb") as fh:
            while True:
                pos = fh.tell()
                hdr = fh.read(4)
                if len(hdr) < 4:
                    break
                (magic,) = struct.unpack(">i", hdr)
                if magic != self._MAGIC:
                    raise IOError(f"{path}: bad TRR magic {magic} at {pos}")
                # GROMACS writes the version tag as (len+1, len, padded
                # bytes) — read both lengths then the padded text
                (_slen_plus1,) = struct.unpack(">i", fh.read(4))
                (slen,) = struct.unpack(">i", fh.read(4))
                fh.read((slen + 3) // 4 * 4)
                ints = struct.unpack(">10i", fh.read(40))
                (ir, e, box_sz, vir, pres, top, sym, x_sz, v_sz, f_sz) = ints
                natoms, step, nre = struct.unpack(">3i", fh.read(12))
                double = box_sz == 72 or x_sz == natoms * 24
                fsize = 8 if double else 4
                t_lambda = fh.read(2 * fsize)  # t, lambda
                body = box_sz + vir + pres + x_sz + v_sz + f_sz
                body_start = fh.tell()
                if body_start + body > file_size:
                    # final frame cut off mid-write (crashed simulation):
                    # drop it, like the XTC path's truncated-frame
                    # tolerance — seek past EOF would "succeed" and read()
                    # would later die on a short buffer
                    break
                self._meta.append(
                    (pos, natoms, step, double, box_sz, vir, pres,
                     x_sz, v_sz, f_sz, body_start)
                )
                fh.seek(body_start + body)
        self.n_frames = len(self._meta)
        self.n_atoms = self._meta[0][1] if self._meta else 0

    def read(self, indices=None):
        """Returns (xyz (n, n_atoms, 3) nm, box (n, 3, 3) nm, step (n,))."""
        if indices is None:
            idx = np.arange(self.n_frames)
        else:
            idx = np.atleast_1d(np.asarray(indices, np.int64))
            if len(idx) and (
                idx.min() < -self.n_frames or idx.max() >= self.n_frames
            ):
                raise IndexError(
                    f"frame index out of range for {self.n_frames}-frame "
                    f"trajectory: {indices}"
                )
            idx = np.where(idx < 0, idx + self.n_frames, idx)
        xyz = np.zeros((len(idx), self.n_atoms, 3), np.float32)
        box = np.zeros((len(idx), 3, 3), np.float32)
        steps = np.zeros(len(idx), np.int32)
        with open(self.path, "rb") as fh:
            for k, f in enumerate(idx):
                (pos, natoms, step, double, box_sz, vir, pres,
                 x_sz, v_sz, f_sz, body_start) = self._meta[int(f)]
                fh.seek(body_start)
                dt = ">f8" if double else ">f4"
                if box_sz:
                    box[k] = np.frombuffer(
                        fh.read(box_sz), dtype=dt
                    ).reshape(3, 3)
                fh.seek(fh.tell() + vir + pres)
                if x_sz:
                    xyz[k] = np.frombuffer(
                        fh.read(x_sz), dtype=dt
                    ).reshape(natoms, 3)
                steps[k] = step
        return xyz, box, steps

    def __len__(self) -> int:
        return self.n_frames


def write_trr(
    path: Union[str, Path],
    xyz: np.ndarray,
    box: Optional[np.ndarray] = None,
    steps: Optional[np.ndarray] = None,
) -> None:
    """Write a single-precision TRR file (coordinates in nm). ``box`` may
    be (n, 3, 3) Bravais vectors or (n, 3) orthorhombic lengths (the shape
    this library's own GRO/DCD readers produce) — lengths are promoted to
    diagonal vectors, since the header always declares 36 box bytes."""
    xyz = np.asarray(xyz, np.float32)
    n_frames, n_atoms, _ = xyz.shape
    if box is not None:
        box = np.asarray(box, np.float32)
        if box.ndim == 2 and box.shape[1] == 3:
            box = np.stack([np.diag(b) for b in box])
        if box.shape != (n_frames, 3, 3):
            raise ValueError(
                f"box must be (n_frames, 3, 3) vectors or (n_frames, 3) "
                f"lengths, got {box.shape}"
            )
    tag = b"GMX_trn_file"
    with open(path, "wb") as fh:
        for f in range(n_frames):
            fh.write(struct.pack(">i", TRRReader._MAGIC))
            # XDR string: outer length, inner length, padded bytes
            padded = tag + b"\x00" * ((-len(tag)) % 4)
            fh.write(struct.pack(">i", len(tag) + 1))
            fh.write(struct.pack(">i", len(tag)))
            fh.write(padded)
            box_sz = 36 if box is not None else 0
            fh.write(struct.pack(
                ">10i", 0, 0, box_sz, 0, 0, 0, 0, n_atoms * 12, 0, 0
            ))
            step = int(steps[f]) if steps is not None else f
            fh.write(struct.pack(">3i", n_atoms, step, 0))
            fh.write(struct.pack(">2f", float(f), 0.0))  # t, lambda
            if box is not None:
                fh.write(np.asarray(box[f], ">f4").tobytes())
            fh.write(xyz[f].astype(">f4").tobytes())
