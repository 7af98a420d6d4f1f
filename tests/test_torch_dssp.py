# tests/test_torch_dssp.py
"""The port's DSSP (``ops/dssp.py``, float64 PyTorch) against the JAX
package's (float64 numpy), on the CPU.

Proteins: ``chip_smoke.py::synthetic_protein`` at 20 residues (every
standard amino acid) and 152 (M1-linked diubiquitin, the protein of
BASELINE config 4), and ideal chains backmapped from fixed backbone
dihedrals (an alpha helix at phi/psi -57/-47 deg, an extended strand at
-120/130 and a fully extended chain at 180/180). Both packages compute the
same float64 formulas in the same order, so:

* the H-bond matrices are equal, and the port's energies equal the
  Kabsch–Sander formula evaluated in numpy float64 with the JAX package's
  constants to 1e-12 kcal/mol; the matrices also agree at other cutoffs
  (-3, -1 and -0.2 kcal/mol), set in both modules alike;
* the 3-state and 8-state strings are equal, frame by frame, also when the
  frames go through the device in small blocks;
* an ideal helix is H everywhere but its two end residues, and extended
  chains are all C;
* explicit amide H atoms: placed where DSSP rebuilds them, the bonds are
  the rebuilt ones; placed where the backmapping puts them (1.10 Angstrom
  at 123 deg), the port still equals the JAX package.

Without a card, ``compute_dssp`` raises unless ``device="cpu"`` is given.
"""

import numpy as np
import pytest
import torch

import encodermap_tpu.ops.dssp as J
import encodermap_tpu_torch.ops.dssp as T
from chip_smoke import ALL_AMINO_ACIDS, DIUBI, synthetic_protein
from encodermap_tpu_torch.data.topology import Topology
from encodermap_tpu_torch.ops.backmap import guess_amide_H, guess_amide_O
from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast, make_spec

torch.set_num_threads(1)


class Traj:
    def __init__(self, top, xyz):
        self.top, self.xyz = top, xyz


def ideal_chain(n_res, phi, psi, h=None):
    """An ALA chain of N, CA, C, O (and amide H on residues 2.. when ``h``
    is "rebuilt" or "backmapped") at fixed phi/psi (deg), omega 180."""
    nb = 3 * n_res
    bond = np.tile([1.458, 1.525, 1.329], n_res)[:nb - 1]
    angle = np.tile(np.radians([111.2, 116.2, 121.7]), n_res)[:nb - 2]
    dih = np.radians(np.tile([psi, 180.0, phi], n_res)[:nb - 3])
    zero = torch.zeros((1, 0), dtype=torch.float64)
    bb = backmap_sidechains_fast(make_spec({i + 1: 0 for i in range(n_res)}),
                                 *(torch.tensor(x[None]) for x in (bond, angle, dih)),
                                 zero, zero, zero)
    o = guess_amide_O(bb, np.arange(2, nb, 3))
    if h == "backmapped":
        hs = guess_amide_H(bb, np.arange(0, nb, 3))
    elif h == "rebuilt":
        co = bb[:, 2:nb - 3:3] - o[:, :-1]
        hs = bb[:, 3::3] + 1.01 * co / torch.linalg.norm(co, dim=-1, keepdim=True)
    top, cols = Topology(), []
    for i in range(n_res):
        r = top.add_residue("ALA", i + 1, 0)
        for j, name in enumerate(("N", "CA", "C")):
            top.add_atom(name, name[0], r)
            cols.append(bb[:, 3 * i + j])
        top.add_atom("O", "O", r)
        cols.append(o[:, i])
        if h is not None and i > 0:
            top.add_atom("H", "H", r)
            cols.append(hs[:, i - 1])
    return Traj(top, (torch.stack(cols, 1) / 10).to(torch.float32).numpy())


@pytest.fixture(scope="module", params=[(ALL_AMINO_ACIDS, 24), (DIUBI, 12)],
                ids=["20res", "152res"])
def protein(request):
    seq, frames = request.param
    top, xyz = synthetic_protein(seq, frames, seed=5)
    return Traj(top, xyz)


def _backbone(traj):
    x = np.asarray(traj.xyz, np.float64) * 10.0
    table, _, is_pro, h_idx = J._backbone_table(traj.top)
    n, ca, c, o = (x[:, table[:, k]] for k in range(4))
    h = np.full_like(n, np.nan)
    h[:, h_idx >= 0] = x[:, h_idx[h_idx >= 0]]
    return n, ca, c, o, h, is_pro


def _energy_numpy(n, c, o, h_eff):
    """The Kabsch–Sander energy in numpy float64 with the JAX package's
    constants."""
    def rdist(a, b):
        return np.maximum(np.linalg.norm(a[:, :, None] - b[:, None], axis=-1), J._MINDIST)

    return J._Q1Q2_F * (1.0 / rdist(o, n) + 1.0 / rdist(c, h_eff)
                        - 1.0 / rdist(o, h_eff) - 1.0 / rdist(c, n))


def test_hbond_matrices_and_energies_match_jax(protein):
    n, ca, c, o, h, is_pro = _backbone(protein)
    ref = J.kabsch_sander_hbonds(n, ca, c, o, is_proline=is_pro, h=h)
    args = [torch.tensor(v) for v in (n, ca, c, o)]
    got = T.kabsch_sander_hbonds(*args, is_proline=is_pro, h=torch.tensor(h)).numpy()
    assert ref.any() and np.array_equal(got, ref)
    e, allowed = T.kabsch_sander_energy(*args, is_proline=is_pro, h=torch.tensor(h))
    e, allowed = e.numpy(), allowed.numpy()
    # the rebuilt H of JAX's formula, where the pair may bond
    co = c[:, :-1] - o[:, :-1]
    co /= np.linalg.norm(co, axis=-1, keepdims=True)
    h_eff = np.full_like(n, 1e6)
    h_eff[:, 1:] = n[:, 1:] + 1.01 * co
    want = _energy_numpy(n, c, o, h_eff)
    assert float(np.abs(e - want)[allowed].max()) <= 1e-12
    np.testing.assert_array_equal((e < -0.5) & allowed, ref)


@pytest.mark.parametrize("cutoff", [-3.0, -1.0, -0.2])
def test_hbond_matrices_match_jax_at_other_cutoffs(protein, monkeypatch, cutoff):
    monkeypatch.setattr(J, "_HBOND_CUTOFF", cutoff)
    monkeypatch.setattr(T, "_HBOND_CUTOFF", cutoff)
    n, ca, c, o, h, is_pro = _backbone(protein)
    ref = J.kabsch_sander_hbonds(n, ca, c, o, is_proline=is_pro, h=h)
    got = T.kabsch_sander_hbonds(*(torch.tensor(v) for v in (n, ca, c, o)),
                                 is_proline=is_pro, h=torch.tensor(h)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("simplified", [True, False], ids=["3-state", "8-state"])
def test_strings_match_jax(protein, simplified):
    ref = J.compute_dssp(protein, simplified=simplified)
    got = T.compute_dssp(protein, simplified=simplified, device="cpu")
    assert got.shape == (len(protein.xyz), protein.top.n_residues)
    np.testing.assert_array_equal(got, ref)
    # a few frames a block: the same strings
    R = protein.top.n_residues
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "DSSP_BLOCK_BYTES", 5 * 12 * R * R * 8)
        np.testing.assert_array_equal(
            T.compute_dssp(protein, simplified=simplified, device="cpu"), ref)
    if not simplified:
        assert len(set("".join(ref.ravel())) - {" "}) >= 3  # patterns are exercised


@pytest.mark.parametrize("shape", ["helix", "extended", "flat"])
def test_ideal_chains(shape):
    phi, psi = {"helix": (-57, -47), "extended": (-120, 130), "flat": (180, 180)}[shape]
    traj = ideal_chain(20, phi, psi)
    got = T.compute_dssp(traj, device="cpu")[0]
    np.testing.assert_array_equal(got, J.compute_dssp(traj)[0])
    want = "C" + "H" * 18 + "C" if shape == "helix" else "C" * 20
    assert "".join(got) == want
    if shape != "helix":
        assert "".join(T.compute_dssp(traj, simplified=False, device="cpu")[0]) == " " * 20


def test_explicit_h_against_rebuilt():
    bare = ideal_chain(20, -57, -47)
    placed = ideal_chain(20, -57, -47, h="rebuilt")
    hb = []
    for traj in (bare, placed):
        n, ca, c, o, h, is_pro = _backbone(traj)
        hb.append(T.kabsch_sander_hbonds(*(torch.tensor(v) for v in (n, ca, c, o)),
                                         is_proline=is_pro, h=torch.tensor(h)).numpy())
    # the explicit H where the rebuild puts it: the same bonds (the
    # chain-initial residue has no H in either, and so donates nothing)
    np.testing.assert_array_equal(hb[0], hb[1])
    assert hb[0].any() and not hb[0][:, :, 0].any()
    for h in ("rebuilt", "backmapped"):
        traj = ideal_chain(20, -57, -47, h=h)
        for simplified in (True, False):
            np.testing.assert_array_equal(
                T.compute_dssp(traj, simplified=simplified, device="cpu"),
                J.compute_dssp(traj, simplified=simplified))
        assert "".join(T.compute_dssp(traj, device="cpu")[0]) == "C" + "H" * 18 + "C"


def test_no_card_means_cpu_only_when_asked(protein):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.compute_dssp(protein)
