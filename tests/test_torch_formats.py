# tests/test_torch_formats.py
"""GRO, DCD and TRR files in the port against the JAX package.

Proteins come from ``chip_smoke.py::synthetic_protein``: the 20-residue
peptide of every standard amino acid and a second, shorter sequence. Both
packages' readers and writers are host numpy, so everything here is held
exactly:

* the DCD and TRR writers give the same bytes in both packages, with and
  without a cell (TRR with Bravais vectors and with box lengths);
* each package reads the other's files to the same arrays: DCD stores
  float32 Angstrom and comes back in nm within float32 rounding (1e-6 nm
  of the array written), TRR bit for bit, GRO at its fixed ``%8.3f``
  precision (5e-4 nm);
* a TRR frame without coordinates reads as zeros in both, and a truncated
  last frame is dropped in both;
* ``SingleTraj`` from a GRO (its own topology), a DCD and a TRR (each with
  the PDB's topology) gives the same ``xyz``, time, unit cell and
  topology in both packages, and its CVs (``load_CV("all")``, the port on
  the CPU) agree to 1e-6 nm for distances and Cartesians and 1e-5 rad for
  angles and dihedrals (modulo 2 pi), the tolerances of
  ``test_torch_featurize.py``;
* ``atom_slice``, frame slices, ``stack`` and ``traj_joined`` over DCD,
  TRR and GRO trajectories give the JAX package's coordinates bit for bit;
* a TRR written without a box is vacuum in the port (no unit cell, finite
  CVs, equal to the JAX package's CVs of the same frames without a cell),
  where the JAX package keeps the all-zero cell and its minimum image
  gives NaN CVs: a recorded divergence.
"""

import struct

import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu.data.formats as FJ
import encodermap_tpu_torch as emt
import encodermap_tpu_torch.data.formats as FT
from chip_smoke import ALL_AMINO_ACIDS, synthetic_protein, write_gro
from encodermap_tpu_torch.data.pdb import write_pdb

torch.set_num_threads(1)

OTHER = "GSHMKEVLQAL"


@pytest.fixture(scope="module", params=[ALL_AMINO_ACIDS, OTHER], ids=["all20", "other"])
def protein(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("fmt")
    top, xyz = synthetic_protein(request.param, 6, seed=len(request.param))
    write_pdb(d / "p.pdb", top, xyz[:1])
    return top, xyz, d


def _cells(n):
    rng = np.random.default_rng(n)
    lengths = rng.uniform(4.0, 6.0, (n, 3)).astype(np.float32)
    vectors = np.stack([np.diag(v) for v in lengths]) + np.triu(
        rng.uniform(0.0, 0.5, (n, 3, 3)), 1).astype(np.float32)
    return lengths, vectors


@pytest.mark.parametrize("cell", [False, True])
def test_dcd_writers_byte_equal_and_read_alike(protein, cell):
    top, xyz, d = protein
    lengths = _cells(len(xyz))[0] if cell else None
    FT.write_dcd(d / "t.dcd", xyz, lengths)
    FJ.write_dcd(d / "j.dcd", xyz, lengths)
    assert (d / "t.dcd").read_bytes() == (d / "j.dcd").read_bytes()
    for f in ("t.dcd", "j.dcd"):
        got, ref = FT.DCDReader(d / f), FJ.DCDReader(d / f)
        assert (got.n_frames, got.n_atoms) == (ref.n_frames, ref.n_atoms) == xyz.shape[:2]
        (x_t, c_t), (x_j, c_j) = got.read(), ref.read()
        np.testing.assert_array_equal(x_t, x_j)
        assert float(np.abs(x_t - xyz).max()) <= 1e-6
        if cell:
            np.testing.assert_array_equal(c_t, c_j)
            np.testing.assert_allclose(c_t, lengths, atol=1e-6)
        else:
            assert c_t is None and c_j is None
        sel = [4, 0, -1]
        np.testing.assert_array_equal(got.read(sel)[0], ref.read(sel)[0])


@pytest.mark.parametrize("box", ["none", "lengths", "vectors"])
def test_trr_writers_byte_equal_and_read_alike(protein, box):
    top, xyz, d = protein
    lengths, vectors = _cells(len(xyz))
    b = {"none": None, "lengths": lengths, "vectors": vectors}[box]
    steps = np.arange(len(xyz)) * 100
    FT.write_trr(d / "t.trr", xyz, b, steps)
    FJ.write_trr(d / "j.trr", xyz, b, steps)
    assert (d / "t.trr").read_bytes() == (d / "j.trr").read_bytes()
    for f in ("t.trr", "j.trr"):
        got, ref = FT.TRRReader(d / f).read(), FJ.TRRReader(d / f).read()
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(a, r)
        np.testing.assert_array_equal(got[0], xyz)  # bit for bit
        np.testing.assert_array_equal(got[2], steps)


def test_trr_frames_without_coordinates_and_a_cut_last_frame(tmp_path):
    """A frame that holds only a box reads as zeros; a frame cut off
    mid-write is dropped: alike in both packages."""
    xyz = np.random.default_rng(0).normal(size=(3, 5, 3)).astype(np.float32)
    FJ.write_trr(tmp_path / "a.trr", xyz)
    raw = (tmp_path / "a.trr").read_bytes()
    frame = len(raw) // 3
    # frame 2 (index 1) keeps its header but declares no coordinates: the
    # x_size field goes to 0 and the body is dropped
    hdr = bytearray(raw[frame:2 * frame - 5 * 3 * 4])
    x_size_at = 4 + 4 + 4 + 12 + 7 * 4
    hdr[x_size_at:x_size_at + 4] = struct.pack(">i", 0)
    (tmp_path / "b.trr").write_bytes(raw[:frame] + bytes(hdr) + raw[2 * frame:-7])
    got, ref = FT.TRRReader(tmp_path / "b.trr"), FJ.TRRReader(tmp_path / "b.trr")
    assert got.n_frames == ref.n_frames == 2
    for a, r in zip(got.read(), ref.read()):
        np.testing.assert_array_equal(a, r)
    np.testing.assert_array_equal(got.read()[0][0], xyz[0])
    assert not got.read()[0][1].any()


def test_gro_reads_alike(protein):
    top, xyz, d = protein
    write_gro(d / "p.gro", top, xyz[0])
    (t_top, t_xyz, t_box), (j_top, j_xyz, j_box) = (FT.load_gro(d / "p.gro"),
                                                   FJ.load_gro(d / "p.gro"))
    np.testing.assert_array_equal(t_xyz, j_xyz)
    np.testing.assert_array_equal(t_box, j_box)
    assert float(np.abs(t_xyz[0] - xyz[0]).max()) <= 5e-4
    assert [(a.name, a.element, a.residue.name, a.residue.resSeq) for a in t_top.atoms] == \
        [(a.name, a.element, a.residue.name, a.residue.resSeq) for a in j_top.atoms] == \
        [(a.name, a.element, a.residue.name, a.residue.resSeq) for a in top.atoms]


def _cv_err(a, b, name):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    if "dihedral" in name:
        d = (d + np.pi) % (2 * np.pi) - np.pi
    return float(np.nanmax(np.abs(d))) if d.size else 0.0


@pytest.mark.parametrize("fmt", ["gro", "dcd", "trr"])
def test_single_traj_from_each_format_matches_jax(protein, fmt):
    top, xyz, d = protein
    pdb = str(d / "p.pdb")
    if fmt == "gro":
        write_gro(d / "s.gro", top, xyz[0])
        args = (str(d / "s.gro"),)
    elif fmt == "dcd":
        FT.write_dcd(d / "s.dcd", xyz, _cells(len(xyz))[0])
        args = (str(d / "s.dcd"), pdb)
    else:
        FT.write_trr(d / "s.trr", xyz, _cells(len(xyz))[1])
        args = (str(d / "s.trr"), pdb)
    tt, tj = emt.SingleTraj(*args), emj.SingleTraj(*args)
    assert tt.n_frames == tj.n_frames == (1 if fmt == "gro" else len(xyz))
    np.testing.assert_array_equal(tt.xyz, tj.xyz)
    np.testing.assert_array_equal(tt.time, tj.time)
    if tj.unitcell_vectors is None:
        assert tt.unitcell_vectors is None
    else:
        np.testing.assert_array_equal(tt.unitcell_vectors, tj.unitcell_vectors)
    assert [(a.name, a.element, a.residue.name) for a in tt.top.atoms] == \
        [(a.name, a.element, a.residue.name) for a in tj.top.atoms]
    np.testing.assert_array_equal(tt[1:3 if fmt != "gro" else 1].xyz,
                                  tj[1:3 if fmt != "gro" else 1].xyz)
    tt.load_CV("all", device="cpu")
    tj.load_CV("all")
    assert sorted(tt.CVs) == sorted(tj.CVs)
    for name in tj.CVs:
        tol = 1e-5 if any(k in name for k in ("angle", "dihedral")) else 1e-6
        assert _cv_err(tt.CVs[name], tj.CVs[name], name) <= tol, name


def test_trr_without_a_box_is_vacuum(protein):
    top, xyz, d = protein
    FT.write_trr(d / "v.trr", xyz)
    args = (str(d / "v.trr"), str(d / "p.pdb"))
    tt, tj = emt.SingleTraj(*args), emj.SingleTraj(*args)
    np.testing.assert_array_equal(tt.xyz, tj.xyz)
    assert tt.unitcell_vectors is None
    assert not np.asarray(tj.unitcell_vectors).any()  # the JAX package keeps zeros
    tj._unitcell = None  # the same frames as vacuum in the JAX package
    tt.load_CV("all", device="cpu")
    tj.load_CV("all")
    for name in tj.CVs:
        assert np.isfinite(tt.CVs[name]).all(), name
        tol = 1e-5 if any(k in name for k in ("angle", "dihedral")) else 1e-6
        assert _cv_err(tt.CVs[name], tj.CVs[name], name) <= tol, name


@pytest.mark.parametrize("fmt", ["dcd", "trr"])
def test_slices_stacks_and_joins_match_jax(protein, fmt):
    """``atom_slice``, frame slices, ``stack`` of GRO-topology trajectories
    and an ensemble's ``traj_joined`` over the new formats give the JAX
    package's coordinates bit for bit."""
    top, xyz, d = protein
    path = str(d / f"j.{fmt}")
    (FT.write_dcd if fmt == "dcd" else FT.write_trr)(path, xyz)
    write_gro(d / "j.gro", top, xyz[0])
    out = []
    for pkg in (emt, emj):
        t = pkg.SingleTraj(path, str(d / "p.pdb"))
        g = pkg.SingleTraj(str(d / "j.gro"))
        stacked = g.stack(pkg.SingleTraj(str(d / "j.gro")))
        joined = pkg.TrajEnsemble([t, pkg.SingleTraj(path, str(d / "p.pdb"))]).traj_joined
        out.append((t.atom_slice(np.arange(10)).xyz, t[2:4].xyz, stacked.xyz, joined.xyz,
                    stacked.top.n_atoms, joined.n_frames))
    for got, ref in zip(*out):
        np.testing.assert_array_equal(got, ref)
    assert out[0][4] == 2 * top.n_atoms and out[0][5] == 2 * len(xyz)
