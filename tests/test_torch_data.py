# tests/test_torch_data.py
"""The port's data layer against the JAX package's: topologies, PDB and
XTC files, trajectories and ensembles, custom topologies.

The proteins are made from a sequence and a seed by
``chip_smoke.py::synthetic_protein``: a 20-residue peptide holding every
standard amino acid once, and a second sequence of another length and
make-up. Both packages' data layers are host numpy, so everything here is
held exactly:

* the topology tables (phi, psi, omega, chi1-chi5, the central chain, the
  per-residue sidechain dihedral counts) of a PDB read by either package;
* PDB and XTC files written by either package are the same bytes, and each
  package reads the other's files to the same arrays (XTC quantizes to
  1e-3 nm, so both read the same quantized coordinates);
* ``SingleTraj``/``TrajEnsemble`` frame indexing and ``load``;
* ``CustomTopology`` on the acetyl-lysine (KAC) tripeptide of
  ``tests/test_known_answers.py``.

A guard test imports the port with ``networkx``, ``h5py``, ``pandas``,
``mdtraj`` and ``MDAnalysis`` hidden, as on the GPU machine, which lacks
them, and drives write -> load -> featurize -> ``backmap_topology``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu.data.pdb as pdb_j
import encodermap_tpu.data.xtc as xtc_j
import encodermap_tpu_torch as emt
import encodermap_tpu_torch.data.pdb as pdb_t
import encodermap_tpu_torch.data.xtc as xtc_t
from chip_smoke import ALL_AMINO_ACIDS, synthetic_protein
from tests.test_known_answers import _KAC_CUSTOM_AAS, _TRIPEPTIDE

torch.set_num_threads(1)

ROOT = Path(__file__).parent.parent
#: the second sequence: other length, other make-up (no TRP/ARG/CYS)
OTHER = "GSHMKEVLQAL"


@pytest.fixture(scope="module", params=[ALL_AMINO_ACIDS, OTHER], ids=["all20", "other"])
def protein(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("p")
    top, xyz = synthetic_protein(request.param, 16, seed=len(request.param))
    pdb_t.write_pdb(d / "p.pdb", top, xyz[:1])
    xtc_t.write_xtc(d / "p.xtc", xyz)
    return top, xyz, d


TABLES = ["indices_phi", "indices_psi", "indices_omega", "indices_chi1", "indices_chi2",
          "indices_chi3", "indices_chi4", "indices_chi5"]


def test_chi_tables_are_jax_s():
    from encodermap_tpu.data.topology import CHI_ATOMS as cj
    from encodermap_tpu_torch.data.topology import CHI_ATOMS as ct

    assert ct == cj


@pytest.mark.parametrize("table", TABLES)
def test_topology_tables_equal_jax(protein, table):
    _, _, d = protein
    tt = pdb_t.load_pdb(d / "p.pdb")[0]
    tj = pdb_j.load_pdb(d / "p.pdb")[0]
    np.testing.assert_array_equal(getattr(tt, table), getattr(tj, table))
    assert len(np.atleast_2d(getattr(tt, table))) or table != "indices_phi"


def test_topology_summary_equals_jax(protein):
    top, _, d = protein
    tt = pdb_t.load_pdb(d / "p.pdb")[0]
    tj = pdb_j.load_pdb(d / "p.pdb")[0]
    np.testing.assert_array_equal(tt.central_atom_indices(), tj.central_atom_indices())
    assert tt.sidechain_info() == tj.sidechain_info() == top.sidechain_info()
    assert [str(a) for a in tt.atoms] == [str(a) for a in tj.atoms]
    assert tt.to_fasta() == tj.to_fasta()


def test_pdb_files_are_the_same_bytes_both_ways(protein, tmp_path):
    top, xyz, d = protein
    tj = pdb_j.load_pdb(d / "p.pdb")[0]
    pdb_t.write_pdb(tmp_path / "t.pdb", top, xyz[:3])
    pdb_j.write_pdb(tmp_path / "j.pdb", tj, xyz[:3])
    assert (tmp_path / "t.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()
    for path in ("t.pdb", "j.pdb"):
        _, xt, _ = pdb_t.load_pdb(tmp_path / path)
        _, xj, _ = pdb_j.load_pdb(tmp_path / path)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_allclose(xt, xyz[:3], atol=5e-5)  # 3 decimals in Angstrom


def test_xtc_files_are_the_same_bytes_both_ways(protein, tmp_path):
    _, xyz, d = protein
    box = np.broadcast_to(np.diag([3.0, 3.1, 3.2]), (len(xyz), 3, 3)).astype(np.float32)
    xtc_t.write_xtc(tmp_path / "t.xtc", xyz, box=box)
    xtc_j.write_xtc(tmp_path / "j.xtc", xyz, box=box)
    assert (tmp_path / "t.xtc").read_bytes() == (tmp_path / "j.xtc").read_bytes()
    for path in ("t.xtc", "j.xtc"):
        rt = xtc_t.read_xtc(tmp_path / path)
        rj = xtc_j.read_xtc(tmp_path / path)
        for a, b in zip(rt, rj):
            np.testing.assert_array_equal(a, b)
        assert float(np.abs(rt[0] - xyz).max()) <= 5.01e-4
        np.testing.assert_array_equal(rt[1], box)
    reader = xtc_t.XTCReader(tmp_path / "t.xtc")
    np.testing.assert_array_equal(reader[[3, 1]], rt[0][[3, 1]])
    np.testing.assert_array_equal(reader[-1], rt[0][-1])


def test_native_codec_builds_into_build_dir():
    from encodermap_tpu_torch.data.native import build

    lib = build.load_library("xdr_xtc")
    assert Path(lib._name).parent == build.BUILD_DIR
    assert build.BUILD_DIR == ROOT / "build" / "native"


def test_native_build_failure_raises_with_compiler_message(tmp_path):
    from encodermap_tpu_torch.data.native import build

    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken.cpp"):
        build._compile(src, tmp_path / "libbroken.so")


def test_single_traj_indexing_and_load_match_jax(protein):
    _, xyz, d = protein
    tt = emt.SingleTraj(d / "p.xtc", d / "p.pdb")
    tj = emj.SingleTraj(d / "p.xtc", d / "p.pdb")
    assert tt.n_frames == tj.n_frames == 16 and tt.n_atoms == tj.n_atoms
    np.testing.assert_array_equal(tt.xyz, tj.xyz)
    for item in (slice(None, None, 3), [5, 1, 1], np.arange(16) % 2 == 0, 7):
        st, sj = tt[item], tj[item]
        np.testing.assert_array_equal(st.xyz, sj.xyz)
        np.testing.assert_array_equal(st.id, sj.id)
    np.testing.assert_array_equal(tt[::2][1:4].xyz, tj[::2][1:4].xyz)
    np.testing.assert_array_equal(tt.fsel[[4, 6]].xyz, tj.fsel[[4, 6]].xyz)
    assert tt.basename == tj.basename and tt.extension == tj.extension == ".xtc"


def test_ensemble_load_and_indexing_match_jax(protein, tmp_path):
    top, xyz, d = protein
    xtc_t.write_xtc(tmp_path / "b.xtc", xyz[::-1][:10])
    files = [str(d / "p.xtc"), str(tmp_path / "b.xtc")]
    et = emt.load(files, str(d / "p.pdb"))
    ej = emj.load(files, str(d / "p.pdb"))
    assert type(et).__name__ == "TrajEnsemble" and et.n_trajs == ej.n_trajs == 2
    assert et.n_frames == ej.n_frames == 26
    np.testing.assert_array_equal(et.index_arr, ej.index_arr)
    np.testing.assert_array_equal(et[1].xyz, ej[1].xyz)
    np.testing.assert_array_equal(et.id, ej.id)
    sub_t, sub_j = et.subsample(stride=3), ej.subsample(stride=3)
    np.testing.assert_array_equal(sub_t.id, sub_j.id)
    for i in (0, 13, 25):
        np.testing.assert_array_equal(et.get_single_frame(i).xyz,
                                      ej.get_single_frame(i).xyz)
    single = emt.load(files[0], str(d / "p.pdb"))
    assert type(single).__name__ == "SingleTraj" and single.n_frames == 16


@pytest.fixture()
def kac_pdb(tmp_path):
    lines = []
    for i, (name, resname, resseq, x, y, z) in enumerate(_TRIPEPTIDE, 1):
        field = name if len(name) == 4 else f" {name:<3}"
        lines.append(f"ATOM  {i:>5} {field} {resname:<3} A{resseq:>4}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {name[0]:>2}")
    p = tmp_path / "ala_kac_ala.pdb"
    p.write_text("\n".join(lines + ["TER", "END"]) + "\n")
    return p


def test_custom_topology_kac_matches_jax(kac_pdb):
    tt = emt.SingleTraj(kac_pdb, custom_top=_KAC_CUSTOM_AAS)
    tj = emj.SingleTraj(kac_pdb, custom_top=_KAC_CUSTOM_AAS)
    for table in TABLES:
        np.testing.assert_array_equal(getattr(tt.top, table), getattr(tj.top, table))
    assert tt.top.to_fasta() == tj.top.to_fasta() == ["AKA"]
    assert tt.top.sidechain_info() == tj.top.sidechain_info()
    top_t = emt.SingleTraj(kac_pdb).top
    top_j = emj.SingleTraj(kac_pdb).top
    ct = emt.CustomTopology.from_dict(_KAC_CUSTOM_AAS, top_t)
    cj = emj.CustomTopology.from_dict(_KAC_CUSTOM_AAS, top_j)
    assert ct.to_json() == cj.to_json() and ct.to_dict() == cj.to_dict()
    for table in TABLES:
        np.testing.assert_array_equal(getattr(ct, table), getattr(cj, table))
    tt.load_CV("side_dihedrals", device="cpu")
    tj.load_CV("side_dihedrals")
    np.testing.assert_allclose(tt.CVs["side_dihedrals"], tj.CVs["side_dihedrals"],
                               atol=1e-5)
    assert any("CHI5" in lbl and "KAC" in lbl
               for lbl in tt._CVs.entry("side_dihedrals").labels)


GUARD = """
import sys
for name in ("networkx", "h5py", "pandas", "mdtraj", "MDAnalysis"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
import encodermap_tpu_torch as em
from chip_smoke import ALL_AMINO_ACIDS, synthetic_protein
from encodermap_tpu_torch.data.pdb import write_pdb
from encodermap_tpu_torch.data.xtc import write_xtc
from encodermap_tpu_torch.misc.backmapping_offline import backmap_topology
d = sys.argv[1]
top, xyz = synthetic_protein(ALL_AMINO_ACIDS, 8, seed=0)
write_pdb(d + "/g.pdb", top, xyz[:1])
write_xtc(d + "/g.xtc", xyz)
trajs = em.load([d + "/g.xtc", d + "/g.xtc"], d + "/g.pdb")
trajs.load_CVs("all", ensemble=True, device="cpu")
dih = trajs.CVs["central_dihedrals"]
traj = trajs[0]
out = backmap_topology(traj.top, traj.xyz[0], dih[:4], device="cpu",
                       dihedral_indices=np.stack([traj.top.central_atom_indices()[k:k + 57]
                                                  for k in range(4)], 1))
assert out.shape == (4, top.n_atoms, 3) and np.isfinite(out).all()
print("guarded", sorted(m for m in ("networkx", "h5py", "pandas", "mdtraj", "MDAnalysis")
                        if sys.modules.get(m) is not None))
"""


def test_card_path_needs_no_networkx_h5py_pandas_mdtraj(tmp_path):
    """The GPU machine has none of these packages: with each import made
    to fail, the port writes, loads and featurizes a synthetic peptide and
    rotates its topology into the featurized dihedrals."""
    out = subprocess.run([sys.executable, "-c", GUARD, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("guarded []")


@pytest.mark.parametrize("ext", [".gro", ".dcd", ".trr"])
def test_formats_of_a_later_slice_raise(tmp_path, ext):
    """GRO, DCD and TRR files, once refused as a later slice, are read now
    (``data/formats.py``): an empty file of each fares in the port as in
    the JAX package, the same exception type or the same frame count, and
    none raises ``NotImplementedError`` any more."""
    path = tmp_path / f"x{ext}"
    path.write_bytes(b"")

    def outcome(pkg):
        try:
            return pkg.SingleTraj(path, tmp_path / "top.pdb").n_frames
        except NotImplementedError:
            raise
        except Exception as e:  # the refusal itself is compared
            return type(e)

    assert outcome(emt) == outcome(emj)
