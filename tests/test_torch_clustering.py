# tests/test_torch_clustering.py
"""The port's RMSD clustering (``misc/clustering.py``) and ``align_one``
against the JAX package's, on the CPU.

Frames come from ``chip_smoke.py::synthetic_protein`` (trp-cage, 20
residues), float32 in both packages:

* ``pairwise_rmsd_matrix`` agrees with the JAX package's to 1e-5 nm, with
  and without subsampling (``max_frames``), and its row blocks change
  nothing beyond 1e-6 nm; the matrix is symmetric and its diagonal zero
  to 1e-5 nm (float32 Kabsch fits of a frame onto itself);
* ``rmsd_centroid_of_cluster`` picks the same frame as the JAX package's;
* ``cluster_to_dict`` gives the same membership dict from an integer
  array, and from a ``TrajEnsemble`` cluster the same keys, series, frame
  counts and superposed coordinates (1e-5 nm) as the JAX package's;
* ``ops/kabsch.py::align_one`` agrees with one frame of ``align_frames``
  to 1e-6 nm (batched products round alike but for the order) and with
  the JAX package's alignment to 1e-5 nm.

Without a card, ``pairwise_rmsd_matrix`` raises unless ``device="cpu"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu.misc.clustering as CJ
import encodermap_tpu_torch as emt
import encodermap_tpu_torch.misc.clustering as CT
from chip_smoke import TRP_CAGE, synthetic_protein
from encodermap_tpu.ops.kabsch import align_frames as align_frames_j
from encodermap_tpu_torch.data.pdb import write_pdb
from encodermap_tpu_torch.data.xtc import write_xtc
from encodermap_tpu_torch.ops.kabsch import align_frames, align_one

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    return synthetic_protein(TRP_CAGE, 48, seed=3)


@pytest.mark.parametrize("max_frames", [500, 20])
def test_rmsd_matrix_matches_jax(frames, max_frames):
    _, xyz = frames
    got = CT.pairwise_rmsd_matrix(xyz, max_frames=max_frames, device="cpu")
    ref = CJ.pairwise_rmsd_matrix(xyz, max_frames=max_frames)
    assert got.shape == ref.shape == (min(48, max_frames),) * 2
    assert float(np.abs(got - ref).max()) <= 1e-5
    assert float(np.abs(got - got.T).max()) <= 1e-5
    assert float(np.abs(np.diag(got)).max()) <= 1e-5
    assert got.min() >= 0 and got.max() > 0.1
    with pytest.MonkeyPatch.context() as mp:  # three rows a block
        mp.setattr(CT, "RMSD_BLOCK_BYTES", 3 * 4 * len(got) * xyz.shape[1] * 3 * 4)
        blocks = CT.pairwise_rmsd_matrix(xyz, max_frames=max_frames, device="cpu")
    assert float(np.abs(blocks - got).max()) <= 1e-6


def test_centroid_matches_jax(frames):
    _, xyz = frames
    for max_frames in (500, 16):
        i_t, d_t = CT.rmsd_centroid_of_cluster(xyz, max_frames=max_frames, device="cpu")
        i_j, d_j = CJ.rmsd_centroid_of_cluster(xyz, max_frames=max_frames)
        assert i_t == i_j
        assert float(np.abs(d_t - d_j).max()) <= 1e-5
    empty = np.zeros((0, xyz.shape[1], 3), np.float32)
    assert CT.pairwise_rmsd_matrix(empty, device="cpu").shape == \
        CJ.pairwise_rmsd_matrix(empty).shape == (0, 0)
    same = np.repeat(xyz[:1], 4, axis=0)
    assert CT.rmsd_centroid_of_cluster(same, device="cpu")[0] == \
        CJ.rmsd_centroid_of_cluster(same)[0]


def test_cluster_dict_from_membership_array():
    ids = np.array([0, 2, -1, 2, 0, 0, 5])
    got, ref = CT.cluster_to_dict(ids), CJ.cluster_to_dict(ids)
    assert got.keys() == ref.keys() == {0, 2, 5}
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    with pytest.raises(TypeError):
        CT.cluster_to_dict(np.array([0.5, 1.0]))


def test_cluster_dict_from_ensemble_matches_jax(frames, tmp_path):
    top, xyz = frames
    write_pdb(tmp_path / "p.pdb", top, xyz[:1])
    write_xtc(tmp_path / "a.xtc", xyz[:24])
    write_xtc(tmp_path / "b.xtc", xyz[24:])
    files = [str(tmp_path / "a.xtc"), str(tmp_path / "b.xtc")]
    member = np.full(48, -1)
    member[[1, 5, 9, 30, 31, 40]] = 3
    out = []
    for pkg in (emt, emj):
        trajs = pkg.load(files, str(tmp_path / "p.pdb"))
        trajs.load_CVs(member, attr_name="cluster_membership")
        out.append((CT if pkg is emt else CJ).cluster_to_dict(trajs.cluster(3)))
    got, ref = out
    assert got.keys() == ref.keys() == {"ensemble", "series", "joined_per_top",
                                        "joined", "stacked"}
    np.testing.assert_array_equal(got["series"], ref["series"])
    assert (got["series"] == 3).all() and len(got["series"]) == 6
    assert got["joined"].n_frames == ref["joined"].n_frames == 6
    assert float(np.abs(got["joined"].xyz - ref["joined"].xyz).max()) <= 1e-5
    assert got["stacked"].n_atoms == ref["stacked"].n_atoms == 6 * top.n_atoms
    assert float(np.abs(got["stacked"].xyz - ref["stacked"].xyz).max()) <= 1e-5
    assert len(got["joined_per_top"]) == len(ref["joined_per_top"]) == 1


def test_align_one_matches_jax(frames):
    _, xyz = frames
    ref_frame = xyz[0]
    sel = np.arange(1, xyz.shape[1], 3)
    got = align_one(torch.tensor(xyz[7]), torch.tensor(ref_frame[sel]),
                    torch.tensor(sel)).numpy()
    batched = align_frames(torch.tensor(xyz[7:8]), torch.tensor(ref_frame),
                           torch.tensor(sel), torch.tensor(sel))[0].numpy()
    assert float(np.abs(got - batched).max()) <= 1e-6
    want = np.asarray(align_frames_j(jnp.asarray(xyz[7:8]), jnp.asarray(ref_frame),
                                     jnp.asarray(sel), jnp.asarray(sel)))[0]
    assert float(np.abs(got - want).max()) <= 1e-5
    assert jax.default_backend() == "cpu"


def test_no_card_means_cpu_only_when_asked(frames):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CT.pairwise_rmsd_matrix(frames[1][:4])
