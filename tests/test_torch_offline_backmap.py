# tests/test_torch_offline_backmap.py
"""Generation onto a topology: the port's offline backmapping against the
JAX package's, and the ADC trained from a ``TrajEnsemble``.

Proteins come from ``chip_smoke.py::synthetic_protein`` (20 residues, every
standard amino acid once), written as PDB + XTC and read by both packages.

* The near/far masks and the ``rotatable`` flags equal the JAX package's
  (networkx there, a breadth-first search here) exactly, also with a ring
  bond and with a missed c-d bond.
* ``dihedral_rotate`` measures, then rotates, dihedral after dihedral, so
  float32 rounding compounds: one frame is held to JAX to 1e-4 nm, and so
  is ``backmap_topology`` (central and side dihedrals, several frames);
  every rotatable dihedral lands on its target (1e-3 rad) and every bond
  keeps its seed length (1e-4 nm).
* The ADC built from a ``TrajEnsemble`` follows JAX step for step at
  [16,16,2], B=16, 3 steps, both ensembles carrying the same CVs (the JAX
  package's featurization, which ``tests/test_torch_featurize.py`` holds
  the port's to), so that the trainers are compared. Parameters agree to
  1e-4. Losses agree to 1e-5 relative to the largest value of their curve
  in the sidechain mode; a term far below the others (the CA sketch-map
  cost, ~1e-5, a mean of squared differences of sigmoids near 1) carries
  float32 rounding of its summands, 6e-8 each, so it is held to 1e-8
  absolute where that is larger. In reconstruct mode (the sidechain table
  read off the ensemble's first topology in both packages) the losses are
  held to 1e-4: its sketch-map cost reads all four angle groups (D=233,
  periodic), whose pair distances both packages take from the Gram
  identity (the JAX package's ``pairwise_dist_periodic`` from D=16 on). On
  a trajectory near one state a pair's distance is ~1/10 of the vectors'
  norms, so float32 cancellation puts ~1e-5 on it: the distance loss
  differs by 1.9e-5 at the same weights, and the updates carry that into
  every term. From the fourth step on, Adam lifts the two packages'
  rounding further (1.5e-4 in the angle loss at the fifth), so three steps
  are compared. ``generate`` onto the topology (``"topology"`` and
  ``"mdtraj"``) agrees at the same weights to 1e-4 nm, for the sidechain
  model and for the reconstruct-sidechain model.
* A multimer model's decoder gives each protein's central dihedrals, one
  block per protein, while a multimer topology's central chain runs
  through every protein, three dihedrals more per joint: both packages
  refuse that generation alike (the same exception and message), at the
  same weights and latent points on a homodimer topology.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu.misc.backmapping_offline as J
import encodermap_tpu_torch as emt
import encodermap_tpu_torch.misc.backmapping_offline as T
from chip_smoke import ALL_AMINO_ACIDS, synthetic_protein
from encodermap_tpu_torch.convert import params_to_numpy
from encodermap_tpu_torch.data.pdb import write_pdb
from encodermap_tpu_torch.data.xtc import write_xtc
from encodermap_tpu_torch.loading.features import SideChainDihedrals
from encodermap_tpu_torch.ops import geometry as geom

torch.set_num_threads(1)

B, STEPS = 16, 3


@pytest.fixture(scope="module")
def peptide(tmp_path_factory):
    d = tmp_path_factory.mktemp("pep")
    top, xyz = synthetic_protein(ALL_AMINO_ACIDS, 24, seed=7)
    write_pdb(d / "p.pdb", top, xyz[:1])
    write_xtc(d / "p.xtc", xyz)
    traj = emt.SingleTraj(d / "p.xtc", d / "p.pdb")
    seed = np.asarray(traj.xyz[0])
    chain = traj.top.central_atom_indices()
    quads = np.vstack([np.stack([chain[:-3], chain[1:-2], chain[2:-1], chain[3:]], axis=1),
                       SideChainDihedrals(traj.top)._indices])
    return traj, seed, quads, d


def test_guess_bonds_equal_jax(peptide):
    traj, seed, _, _ = peptide
    bonds = T.guess_bonds(traj.top, seed)
    assert bonds == J.guess_bonds(traj.top, seed)
    assert len(bonds) == traj.top.n_atoms - 1  # the chain, a tree


def _ring_and_gap(traj, seed, quads):
    """The bond list with a ring closed over the first psi's b-c bond and
    the last side dihedral's c-d bond missing."""
    bonds = T.guess_bonds(traj.top, seed)
    a, b = int(quads[0][0]), int(quads[1][3])  # N(1) to CA(2): a ring of 5
    c, d = int(quads[-1][2]), int(quads[-1][3])
    return sorted(set(bonds) - {(min(c, d), max(c, d))} | {(min(a, b), max(a, b))})


@pytest.mark.parametrize("bonds", ["guessed", "ring_and_gap"])
def test_masks_and_rotatable_equal_jax(peptide, bonds):
    traj, seed, quads, _ = peptide
    bl = T.guess_bonds(traj.top, seed) if bonds == "guessed" else \
        _ring_and_gap(traj, seed, quads)
    mt, rt = T.near_and_far_masks(traj.top, quads, bonds=bl)
    mj, rj = J.near_and_far_masks(traj.top, quads, bonds=bl)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(rt, rj)
    if bonds == "guessed":
        assert rt.all()
    else:
        # psi(1), omega(1), phi(2) turn about ring bonds; the last side
        # dihedral lost its c-d bond
        assert not rt[[0, 1, 2, -1]].any() and rt[3:-1].all()


def test_dihedral_rotate_one_frame_matches_jax(peptide):
    traj, seed, quads, _ = peptide
    masks, rot = T.near_and_far_masks(traj.top, quads, xyz=seed)
    targets = np.random.default_rng(0).uniform(-np.pi, np.pi, len(quads)).astype(np.float32)
    got = T.dihedral_rotate(torch.tensor(seed), quads, masks, torch.tensor(targets)).numpy()
    ref = np.asarray(J.dihedral_rotate(jnp.asarray(seed), quads, masks, jnp.asarray(targets)))
    assert float(np.abs(got - ref).max()) <= 1e-4
    meas = geom.compute_dihedrals(torch.tensor(got[None], dtype=torch.float64), quads)[0]
    err = (meas.numpy() - targets + np.pi) % (2 * np.pi) - np.pi
    assert float(np.abs(err).max()) <= 1e-3


def test_backmap_topology_matches_jax(peptide):
    traj, seed, quads, _ = peptide
    n_c = len(traj.top.central_atom_indices()) - 3
    rng = np.random.default_rng(1)
    cen = rng.uniform(-np.pi, np.pi, (6, n_c)).astype(np.float32)
    side = rng.uniform(-np.pi, np.pi, (6, len(quads) - n_c)).astype(np.float32)
    got = T.backmap_topology(traj.top, seed, cen, dihedral_indices=quads[:n_c],
                             side_dihedrals=side, device="cpu")
    ref = J.backmap_topology(traj.top, seed, cen, dihedral_indices=quads[:n_c],
                             side_dihedrals=side)
    assert got.shape == (6, traj.top.n_atoms, 3)
    assert float(np.abs(got - ref).max()) <= 1e-4
    meas = geom.compute_dihedrals(torch.tensor(got, dtype=torch.float64), quads).numpy()
    err = (meas - np.concatenate([cen, side], 1) + np.pi) % (2 * np.pi) - np.pi
    assert float(np.abs(err).max()) <= 1e-3
    bonds = np.asarray(T.guess_bonds(traj.top, seed))
    lens = np.linalg.norm(got[:, bonds[:, 0]] - got[:, bonds[:, 1]], axis=-1)
    seed_lens = np.linalg.norm(seed[bonds[:, 0]] - seed[bonds[:, 1]], axis=-1)
    assert float(np.abs(lens - seed_lens).max()) <= 1e-4


def test_reference_named_entry_points_match_jax(peptide):
    """``mdtraj_backmapping`` (central_dihedrals order, side dihedrals),
    ``traj_rotate`` and the legacy block-ordered ``dihedral_backmapping``."""
    traj, seed, quads, d = peptide
    trajs_t = emt.load([str(d / "p.xtc")], str(d / "p.pdb"))
    trajs_j = emj.load([str(d / "p.xtc")], str(d / "p.pdb"))
    rng = np.random.default_rng(2)
    n_c = len(traj.top.central_atom_indices()) - 3
    cen = rng.uniform(-3, 3, (3, n_c)).astype(np.float32)
    side = rng.uniform(-3, 3, (3, len(quads) - n_c)).astype(np.float32)
    got, tables = T.mdtraj_backmapping(dihedrals=cen, sidechain_dihedrals=side,
                                       trajs=trajs_t, return_indices=True, device="cpu")
    ref = J.mdtraj_backmapping(dihedrals=cen, sidechain_dihedrals=side, trajs=trajs_j)
    assert float(np.abs(got - ref).max()) <= 1e-4
    np.testing.assert_array_equal(tables["dihedrals"], quads[:n_c])
    phi = traj.top.indices_phi
    ang = rng.uniform(-3, 3, (2, len(phi))).astype(np.float32)
    assert float(np.abs(T.traj_rotate(traj[0], ang, phi, device="cpu")
                        - J.traj_rotate(emj.SingleTraj(d / "p.xtc", d / "p.pdb")[0],
                                        ang, phi)).max()) <= 1e-4
    n_pp = len(phi) + len(traj.top.indices_psi)
    legacy = rng.uniform(-3, 3, (4, n_pp)).astype(np.float32)
    assert float(np.abs(T.dihedral_backmapping(str(d / "p.pdb"), legacy, device="cpu")
                        - J.dihedral_backmapping(str(d / "p.pdb"), legacy)).max()) <= 1e-4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.backmap_topology(traj.top, seed, cen, dihedral_indices=quads[:n_c])


def _jax_indices(rng, n, chunks, batch):
    out = []
    for c in chunks:
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.randint(sub, (c, batch), 0, n)))
    return out


#: the two test files' settings (tests/test_torch_adc.py,
#: tests/test_torch_sidechains.py), which give every decoder output a
#: gradient: a zero one is rounding noise that Adam turns into a step of
#: either sign
MODES = {
    "sidechains": ("all", dict(use_backbone_angles=True, use_sidechains=True,
                               angle_cost_scale=1.0, cartesian_pwd_start=1,
                               cartesian_pwd_step=3, cartesian_cost_scale_soft_start=(1, 4))),
    # sidechain_info left unset: both trainers read it off the ensemble
    "reconstruct": ("full", dict(reconstruct_sidechains=True, use_backbone_angles=True,
                                 use_sidechains=True, angle_cost_scale=1.0,
                                 distance_cost_scale=1.0,
                                 cartesian_cost_scale_soft_start=(1, 4))),
}
#: loss tolerance (relative to each curve's largest value) per mode
LOSS_RTOL = {"sidechains": 1e-5, "reconstruct": 1e-4}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_adc_from_traj_ensemble_matches_jax_step_for_step(peptide, tmp_path, monkeypatch,
                                                          mode):
    from tests.jax_sidechains import J, measured_fast

    # the JAX package's reconstruct mode with the sweep's current dihedrals,
    # as the port takes them (tests/jax_sidechains.py)
    monkeypatch.setattr(J, "backmap_sidechains_fast", measured_fast)
    _, _, _, d = peptide
    which, extra = MODES[mode]
    files = [str(d / "p.xtc"), str(d / "p.xtc")]
    trajs_t = emt.load(files, str(d / "p.pdb"))
    trajs_j = emj.load(files, str(d / "p.pdb"))
    trajs_j.load_CVs(which, ensemble=True)
    for name in trajs_j.CVs:
        trajs_t.load_CVs([t.CVs[name] for t in trajs_j.trajs], attr_name=name)
    kw = dict(n_neurons=[16, 16, 2], batch_size=B, steps_per_scan=STEPS, n_steps=STEPS,
              seed=1, summary_step=1, **extra)
    ej = emj.AngleDihedralCartesianEncoderMap(
        trajs_j, emj.ADCParameters(main_path=str(tmp_path / "jax"), **kw))
    et = emt.AngleDihedralCartesianEncoderMap(
        trajs_t, emt.ADCParameters(main_path=str(tmp_path / "torch"), **kw),
        model_params=jax.device_get(ej.state.params), device="cpu")
    if mode == "reconstruct":
        assert et.p.sidechain_info == ej.p.sidechain_info == trajs_t[0].top.sidechain_info()
    idx = _jax_indices(ej.state.rng, trajs_t.n_frames, [STEPS], B)
    hj = ej.train()
    ht = et.train(index_stream=iter(idx))
    assert hj.keys() == ht.keys()
    for k, ref in hj.items():
        ref = np.asarray(ref)
        rtol = LOSS_RTOL[mode]
        np.testing.assert_allclose(ht[k], ref, rtol=rtol,
                                   atol=max(rtol * np.abs(ref).max(), 1e-8), err_msg=k)
    tree_t = params_to_numpy(et.state.params)[0]
    for a, b in zip(jax.tree_util.tree_leaves(tree_t),
                    jax.tree_util.tree_leaves(jax.device_get(ej.state.params))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    if mode in ("sidechains", "reconstruct"):
        # generation onto the topology at the same (JAX's) weights; in
        # reconstruct mode the topology backend rotates the decoded central
        # dihedrals and the mdtraj backend the side dihedrals too (decode's
        # fourth output)
        same = emt.AngleDihedralCartesianEncoderMap.from_checkpoint(
            trajs_t, tmp_path / "jax", device="cpu", read_only=True)
        z = ej.encode()[:4]
        got = same.generate(z, backend="topology", top=trajs_t[0])
        ref = ej.generate(z, backend="topology", top=trajs_j[0])
        assert got.shape == (4, trajs_t[0].n_atoms, 3)
        assert float(np.abs(got - ref).max()) <= 1e-4
        got = same.generate(z, backend="mdtraj")
        ref = ej.generate(z, backend="mdtraj")
        assert float(np.abs(got - ref).max()) <= 1e-4


def test_multimer_onto_a_topology_is_refused_as_in_jax(tmp_path):
    from chip_smoke import TRP_CAGE, dimer_cvs
    from encodermap_tpu_torch.data.topology import Topology

    cvs = dimer_cvs(64, device="cpu")
    kw = dict(n_neurons=[16, 16, 2], batch_size=16, steps_per_scan=2, n_steps=2, seed=1,
              multimer_training="homogeneous_transformation", multimer_lengths=[20, 20],
              use_backbone_angles=True, use_sidechains=True, cartesian_pwd_start=1,
              cartesian_pwd_step=3)
    ej = emj.AngleDihedralCartesianEncoderMap(
        cvs, emj.ADCParameters(main_path=str(tmp_path / "jax"), **kw))
    ej.train()
    et = emt.AngleDihedralCartesianEncoderMap.from_checkpoint(cvs, tmp_path / "jax",
                                                              device="cpu", read_only=True)
    z = ej.encode()[:4]
    np.testing.assert_allclose(et.encode()[:4], z, atol=1e-5)
    # a trp-cage homodimer: two chains of the synthetic trp-cage
    mono, xyz = synthetic_protein(TRP_CAGE, 1, seed=2)
    top = Topology()
    for chain in range(2):
        for r in mono.residues:
            res = top.add_residue(r.name, r.resSeq, chain)
            for a in r.atoms:
                top.add_atom(a.name, a.element, res)
    write_pdb(tmp_path / "dimer.pdb", top, np.concatenate([xyz, xyz + 3.0], axis=1))
    pdb = str(tmp_path / "dimer.pdb")
    for backend, tops in (("topology", (emt.SingleTraj(pdb), emj.SingleTraj(pdb))),
                          ("mdtraj", (pdb, pdb))):
        with pytest.raises(Exception) as ref:
            ej.generate(z, backend=backend, top=tops[1])
        with pytest.raises(type(ref.value)) as got:
            et.generate(z, backend=backend, top=tops[0])
        assert str(got.value) == str(ref.value) and "114" in str(got.value)
