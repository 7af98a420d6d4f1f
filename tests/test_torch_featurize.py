# tests/test_torch_featurize.py
"""The port's featurization against the JAX package's, on the CPU.

The same XTC + PDB files (``chip_smoke.py::synthetic_protein``) go through
both packages' loaders and featurizers; XTC quantizes to 1e-3 nm, so both
read the same coordinates. Both compute the same float32 formulas and may
round them in another order, so:

* distances, Cartesians and centres of mass agree to 1e-6 nm;
* angles, dihedrals, RMSDs and their cos/sin to 1e-5 (rad), dihedrals
  compared modulo 2 pi, since +-pi can flip;
* labels, CV names and NaN patterns (the mixed-topology alignment) exactly.

The minimum image is held on random points in an orthorhombic and in a
triclinic cell, with no ties between images.
"""

import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu_torch as emt
from chip_smoke import ALL_AMINO_ACIDS, synthetic_protein
from encodermap_tpu.ops import geometry as geom_j
from encodermap_tpu_torch.data.pdb import write_pdb
from encodermap_tpu_torch.data.xtc import write_xtc
from encodermap_tpu_torch.ops import geometry as geom_t

torch.set_num_threads(1)

OTHER = "GSHMKEVLQAL"


def _err(a, b, dihedral=False):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    if dihedral:
        d = (d + np.pi) % (2 * np.pi) - np.pi
    return float(np.nanmax(np.abs(d))) if d.size else 0.0


def _tol(name):
    return 1e-5 if any(k in name for k in ("angle", "dihedral", "torsion", "rmsd")) else 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("f")
    out = {}
    for name, seq, n in (("all20", ALL_AMINO_ACIDS, 12), ("other", OTHER, 9)):
        top, xyz = synthetic_protein(seq, n, seed=n)
        write_pdb(d / f"{name}.pdb", top, xyz[:1])
        write_xtc(d / f"{name}.xtc", xyz)
        out[name] = (str(d / f"{name}.xtc"), str(d / f"{name}.pdb"))
    return out


def _ensembles(files, names):
    trajs = [f[0] for f in (files[n] for n in names)]
    tops = [f[1] for f in (files[n] for n in names)]
    return emt.load(trajs, tops), emj.load(trajs, tops)


@pytest.mark.parametrize("which", ["all", "full"])
def test_load_cvs_match_jax(files, which):
    et, ej = _ensembles(files, ["all20", "all20"])
    et.load_CVs(which, device="cpu")
    ej.load_CVs(which)
    assert sorted(et.CVs) == sorted(ej.CVs)
    for k in ej.CVs:
        assert et.CVs[k].shape == ej.CVs[k].shape, k
        assert _err(et.CVs[k], ej.CVs[k], "dihedral" in k) <= _tol(k), k
        for a, b in zip(et.trajs, ej.trajs):
            assert a._CVs.entry(k).labels == b._CVs.entry(k).labels, k


def test_mixed_topology_nan_alignment_matches_jax(files):
    """Two proteins of different sequence: ``ensemble=True`` aligns every
    CV onto the union of generic labels, NaN where a protein has no such
    column, as the JAX package does."""
    et, ej = _ensembles(files, ["all20", "other"])
    et.load_CVs("all", ensemble=True, device="cpu")
    ej.load_CVs("all", ensemble=True)
    for k in ej.CVs:
        a, b = et.CVs[k], ej.CVs[k]
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        assert _err(a, b, "dihedral" in k) <= _tol(k), k
    assert np.isnan(et.CVs["side_dihedrals"]).any()
    assert et.trajs[1]._CVs.entry("side_dihedrals").labels == \
        ej.trajs[1]._CVs.entry("side_dihedrals").labels


ADDERS = {
    "distances_ca": lambda f, t: f.add_distances_ca(),
    "inverse_distances": lambda f, t: f.add_inverse_distances(t.top.select("name CA")[:6]),
    "contacts": lambda f, t: f.add_contacts(t.top.select("name CA")[:8], threshold=0.6),
    "angles_cossin": lambda f, t: f.add_angles(t.top.central_atom_indices()[:12].reshape(4, 3),
                                               cossin=True),
    "dihedrals_deg": lambda f, t: f.add_dihedrals(t.top.indices_phi, deg=True),
    "backbone_torsions": lambda f, t: f.add_backbone_torsions(cossin=True),
    "sidechain_torsions": lambda f, t: f.add_sidechain_torsions(),
    "selection": lambda f, t: f.add_selection(t.top.select("name CA")),
    "residue_mindist": lambda f, t: f.add_residue_mindist(),
    "residue_mindist_ca": lambda f, t: f.add_residue_mindist(scheme="ca", threshold=0.8),
    "group_com": lambda f, t: f.add_group_COM([[0, 1, 2], [4, 5, 6, 7]]),
    "residue_com": lambda f, t: f.add_residue_COM([0, 3, 7], scheme="sidechain"),
    "minrmsd": lambda f, t: f.add_minrmsd_to_ref(t.xyz, ref_frame=2),
}


@pytest.mark.parametrize("adder", sorted(ADDERS))
def test_generic_features_match_jax(files, adder):
    tt, tj = emt.SingleTraj(*files["all20"]), emj.SingleTraj(*files["all20"])
    ft = emt.Featurizer(tt, device="cpu")
    fj = emj.Featurizer(tj)
    ADDERS[adder](ft, tt)
    ADDERS[adder](fj, tj)
    assert ft.describe() == fj.describe()
    out_t, out_j = ft.get_output(), fj.get_output()
    for k in out_j:
        a, b = out_t[k], out_j[k]
        assert a.shape == b.shape, k
        if adder.endswith("_deg"):  # held in radians, to the radian tolerance
            a, b = np.radians(a), np.radians(b)
        dih = "torsion" in adder or "dihedral" in adder
        assert _err(a, b, dih and "cossin" not in adder) <= _tol(adder), k


def _boxes(triclinic):
    box = np.diag([2.0, 2.3, 2.6])
    if triclinic:  # GROMACS reduced form: lower-triangular rows
        box[1, 0], box[2, 0], box[2, 1] = 0.7, -0.5, 0.9
    return np.broadcast_to(box, (6, 3, 3)).astype(np.float32)


def _images(xyz, box, pairs):
    """Lengths of the 125 nearest lattice images of every pair's
    displacement, sorted, in float64."""
    d = (xyz[:, pairs[:, 1]] - xyz[:, pairs[:, 0]]).astype(np.float64)
    shifts = np.array([[i, j, k] for i in range(-2, 3) for j in range(-2, 3)
                       for k in range(-2, 3)], np.float64) @ box[0].astype(np.float64)
    return np.sort(np.linalg.norm(d[..., None, :] - shifts, axis=-1), axis=-1)


@pytest.mark.parametrize("triclinic", [False, True], ids=["orthorhombic", "triclinic"])
def test_minimum_image_matches_jax(triclinic):
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1.0, 3.5, (6, 30, 3)).astype(np.float32)
    box = _boxes(triclinic)
    # distinct atoms in every row, and both bond angles of each quadruplet
    # within 0.5-2.6 rad: a near-straight triple leaves the dihedral (and
    # arccos near +-1 the angle) ill-conditioned in float32
    idx = np.stack([rng.choice(30, 4, replace=False) for _ in range(400)])
    bends = [np.asarray(geom_j.compute_angles(xyz, idx[:, k:k + 3], box)) for k in (0, 1)]
    good = np.all([(b > 0.5) & (b < 2.6) for b in bends], axis=(0, 1))
    idx = idx[good][:50]
    assert len(idx) == 50
    assert geom_t.boxes_are_triclinic(box) == triclinic
    lens = _images(xyz, box, idx[:, :2])
    assert float((lens[..., 1] - lens[..., 0]).min()) > 1e-4  # no ties
    x = torch.tensor(xyz)
    b = torch.tensor(box)
    d_t = geom_t.compute_displacements(x, idx[:, :2], b).numpy()
    d_j = np.asarray(geom_j.compute_displacements(xyz, idx[:, :2], box))
    assert _err(d_t, d_j) <= 1e-6
    for name, k, dih in (("compute_distances", 2, False), ("compute_angles", 3, False),
                         ("compute_dihedrals", 4, True)):
        a = getattr(geom_t, name)(x, idx[:, :k], b).numpy()
        c = np.asarray(getattr(geom_j, name)(xyz, idx[:, :k], box))
        assert _err(a, c, dih) <= (1e-5 if k > 2 else 1e-6), name
    # the wrapped displacements are the shortest images
    assert _err(np.linalg.norm(d_t, axis=-1), lens[..., 0]) <= 1e-6


@pytest.mark.parametrize("triclinic", [False, True], ids=["orthorhombic", "triclinic"])
def test_mic_mode_pins_the_wrap(triclinic):
    """``mic_mode`` forces one wrap for the whole block; on an orthorhombic
    cell both give the same image."""
    rng = np.random.default_rng(4)
    xyz = torch.tensor(rng.uniform(0, 2.6, (4, 12, 3)).astype(np.float32))
    b = torch.tensor(_boxes(False)[:4])
    pairs = rng.integers(0, 12, (20, 2))
    ref = geom_t.compute_distances(xyz, pairs, b)
    with geom_t.mic_mode(triclinic):
        np.testing.assert_allclose(geom_t.compute_distances(xyz, pairs, b).numpy(),
                                   ref.numpy(), atol=1e-6)


def test_featurizer_block_runner_matches_whole(files):
    """Blocks smaller than the trajectory, the atom-union slice and the
    deferred copy to the host give the same CVs as one block (to float32
    rounding: the CPU's vector loops round by the block's shape)."""
    tt = emt.SingleTraj(*files["all20"])
    whole = emt.Featurizer(tt, device="cpu")
    whole.add_list_of_feats("all")
    small = emt.Featurizer(tt, device="cpu", block_size=5)
    small.add_list_of_feats("all")
    a, b = whole.get_output(), small.get_output()
    for k in a:
        assert a[k].shape == b[k].shape
        assert _err(a[k], b[k], "dihedral" in k) <= _tol(k), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            emt.Featurizer(tt).get_output()
