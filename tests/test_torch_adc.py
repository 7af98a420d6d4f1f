# tests/test_torch_adc.py
"""The port's AngleDihedralCartesianEncoderMap against the JAX package's.

Both start from the JAX initialization (numpy arrays carried over) and the
port takes the batch indices the JAX trainer draws (reproduced from
``state.rng`` as ``train/core.py:119-120`` draws them). Synthetic CVs: 5
residues (15 backbone atoms) backmapped from random internals by the numpy
oracle, CA selection, [16,16,2], B=16. On the CPU both take the general
sketch-map path.

Tolerances: each loss term agrees step for step to 1e-5 relative to the
largest value of its curve, the parameters after five steps to 1e-4
absolute (float32 sums in another order, through Adam). Every mode gives
each output a gradient: with angle_cost_scale=0 and only CA pairs costed,
the first bond angle (and the end bond lengths) move no CA, so their exact-
zero gradient is float32 rounding noise (1e-8) that Adam normalizes into
steps of ~1e-4 in either package. Loss terms of one batch, encode, decode and generate, taken at
the same parameters (the JAX checkpoint loaded into the port), agree to
1e-5; checkpoints load both ways and encode the same to 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu_torch as emt
from encodermap_tpu.train.metrics import ADCClashMetric as ClashJ
from encodermap_tpu_torch.convert import params_to_numpy
from encodermap_tpu_torch.train.core import tree_leaves, tree_unflatten
from encodermap_tpu_torch.train.metrics import ADCClashMetric as ClashT
from tests.reference_impl import backmap_np

torch.set_num_threads(1)

N_RES, N_FRAMES, B, STEPS = 5, 64, 16, 5


def _cvs(nan=False):
    rng = np.random.default_rng(0)
    n_atoms = 3 * N_RES
    ang = rng.uniform(1.6, 2.4, (N_FRAMES, n_atoms - 2)).astype(np.float32)
    dih = rng.uniform(-np.pi, np.pi, (N_FRAMES, n_atoms - 3)).astype(np.float32)
    dist = rng.uniform(0.13, 0.155, (N_FRAMES, n_atoms - 1)).astype(np.float32)
    side = rng.uniform(-np.pi, np.pi, (N_FRAMES, 2 * N_RES)).astype(np.float32)
    if nan:  # values missing after a mixed-topology alignment
        side[::3, -2:] = np.nan
        dih[::5, 0] = np.nan
    return {"central_angles": ang, "central_dihedrals": dih,
            "central_cartesians": backmap_np(dist, ang, np.nan_to_num(dih)).astype(np.float32),
            "central_distances": dist, "side_dihedrals": side}


def _kw(**extra):
    kw = dict(n_neurons=[16, 16, 2], batch_size=B, steps_per_scan=STEPS, n_steps=STEPS,
              seed=1, cartesian_pwd_start=1, cartesian_pwd_step=3,
              cartesian_cost_scale_soft_start=(1, 4), summary_step=1)
    kw.update(extra)
    return kw


def _jax_indices(rng, n, chunks, batch):
    out = []
    for c in chunks:
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.randint(sub, (c, batch), 0, n)))
    return out


MODES = {
    "dihedrals_only": dict(),
    "backbone_angles": dict(use_backbone_angles=True, angle_cost_scale=1.0),
    # also the tracked clash / RMSD metrics and a metric object
    "sidechains": dict(use_backbone_angles=True, use_sidechains=True, angle_cost_scale=1.0,
                       track_clashes=True, track_RMSD=True),
    # NaN-padded CVs; trainable densifiers, so the sigmoid losses' high-D
    # sides need a gradient; every atom costed (the slice's default), so
    # that each bond length's densifier output has a gradient
    "sparse": dict(use_backbone_angles=True, use_sidechains=True, angle_cost_scale=1.0,
                   trainable_dense_to_sparse=True, cartesian_pwd_start=None,
                   cartesian_pwd_step=None),
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Per mode: both trainers after five steps on the same indices."""
    cache = {}

    def get(mode):
        if mode not in cache:
            root = tmp_path_factory.mktemp(mode)
            data = _cvs(nan=mode == "sparse")
            kw = _kw(**MODES[mode])
            ej = emj.AngleDihedralCartesianEncoderMap(
                data, emj.ADCParameters(main_path=str(root / "jax"), **kw))
            et = emt.AngleDihedralCartesianEncoderMap(
                data, emt.ADCParameters(main_path=str(root / "torch"), **kw),
                model_params=jax.device_get(ej.state.params), device="cpu")
            if mode == "sidechains":
                ej.add_metric(ClashJ)
                et.add_metric(ClashT)
            idx = _jax_indices(ej.state.rng, N_FRAMES, [STEPS], B)
            cache[mode] = (data, root, ej, et, ej.train(), et.train(index_stream=iter(idx)))
        return cache[mode]

    return get


@pytest.fixture(scope="module")
def same(trained):
    """Per mode: the JAX model and the port with the JAX model's trained
    parameters (its checkpoint, loaded)."""
    def get(mode):
        data, root, ej, _, _, _ = trained(mode)
        return data, ej, emt.AngleDihedralCartesianEncoderMap.from_checkpoint(
            data, root / "jax", device="cpu", read_only=True)

    return get


@pytest.mark.parametrize("mode", MODES)
def test_five_steps_match_jax_step_for_step(trained, mode):
    _, _, ej, et, hj, ht = trained(mode)
    assert et.sparse == (mode == "sparse")
    assert hj.keys() == ht.keys()
    if mode == "sidechains":
        assert {"clashes", "rmsd", "ADCClashMetric"} <= ht.keys()
    for k, ref in hj.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(ht[k], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=k)
    # the soft start (1, 4): 0 at step 0, the full scale from step 4
    np.testing.assert_allclose(ht["cartesian_cost_scale"], [0, 0, 1 / 3, 2 / 3, 1], rtol=1e-6)
    tree_t = params_to_numpy(et.state.params)[0]
    assert tree_t.keys() == ej.state.params.keys()
    for a, b in zip(jax.tree_util.tree_leaves(tree_t),
                    jax.tree_util.tree_leaves(jax.device_get(ej.state.params))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert et.state.step == int(ej.state.step) == STEPS


@pytest.mark.parametrize("step", [0, 2])
def test_loss_terms_match_jax(same, step):
    """One batch's terms at step 0 and mid-soft-start (scale 1/3)."""
    data, ej, et = same("sidechains")
    batch = tuple(np.asarray(data[k][:B]) for k in
                  ("central_angles", "central_dihedrals", "central_cartesians",
                   "central_distances", "side_dihedrals"))
    ref = jax.jit(ej._loss_terms)(ej.state.params, tuple(map(jnp.asarray, batch)),
                                  jnp.asarray(step))
    got = et._loss_terms(et.state.params, tuple(map(torch.tensor, batch)), step)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("route", ["analytic", "blocked"])
def test_cartesian_routes_give_the_dense_terms(trained, monkeypatch, route):
    """With the thresholds lowered, the analytic and the blocked route give
    the dense route's terms and gradients (5 selected atoms)."""
    from encodermap_tpu_torch.train import adc_autoencoder as mod

    data, _, _, et, _, _ = trained("sidechains")
    batch = tuple(torch.tensor(data[k][:B]) for k in
                  ("central_angles", "central_dihedrals", "central_cartesians",
                   "central_distances", "side_dihedrals"))

    def terms_and_grads():
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(et.state.params)]
        params = tree_unflatten(et.state.params, leaves)
        terms = et._loss_terms(params, batch, 3)
        grads = torch.autograd.grad(terms["cartesian_loss"] + terms["cartesian_distance_loss"],
                                    leaves)
        return {k: float(v.detach()) for k, v in terms.items()}, grads

    dense = terms_and_grads()
    monkeypatch.setattr(mod, "MIN_ANALYTIC_ATOMS", 4)
    if route == "blocked":
        monkeypatch.setattr(mod, "MIN_BLOCKED_ATOMS", 4)
    other = terms_and_grads()
    for k in dense[0]:
        np.testing.assert_allclose(other[0][k], dense[0][k], rtol=2e-5, err_msg=k)
    for a, b in zip(other[1], dense[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5 * float(b.abs().max()))


def test_encode_decode_generate_match_jax(same):
    data, ej, et = same("sidechains")
    np.testing.assert_allclose(et.encode(), ej.encode(), atol=1e-5)
    short = (data["central_angles"], data["central_dihedrals"], data["side_dihedrals"])
    np.testing.assert_allclose(et.encode(short), ej.encode(short), atol=1e-5)
    stacked = np.concatenate(short, axis=1)
    np.testing.assert_allclose(et.encode(stacked), ej.encode(stacked), atol=1e-5)
    z = ej.encode()[:7]
    for a, b in zip(et.decode(z), ej.decode(z)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    xyz = et.generate(z)
    assert xyz.shape == (7, 3 * N_RES, 3) and np.isfinite(xyz).all()
    np.testing.assert_allclose(xyz, ej.generate(z), atol=1e-5)
    bonds = np.linalg.norm(np.diff(xyz, axis=1), axis=-1)
    np.testing.assert_allclose(bonds, np.broadcast_to(data["central_distances"].mean(0),
                                                      bonds.shape), atol=1e-5)
    # the topology backends need a topology: a CV-dict model has none
    with pytest.raises(AssertionError, match="needs a `top`"):
        et.generate(z, backend="topology")
    with pytest.raises(ValueError, match="no TrajEnsemble"):
        et.generate(z, backend="mdtraj")
    with pytest.raises(TypeError):
        et.generate(z, backend="nope")


def test_dihedrals_only_decode_substitutes_mean_angles(same):
    data, ej, et = same("dihedrals_only")
    z = ej.encode()[:4]
    for a, b in zip(et.decode(z), ej.decode(z)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(et.generate(z), ej.generate(z), atol=1e-5)


def test_train_for_references_matches_jax(trained):
    _, root, ej, et, _, _ = trained("sidechains")
    got = et.train_for_references()
    ref = ej.train_for_references()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    saved = json.loads((root / "torch" / "parameters.json").read_text())
    assert saved["cartesian_cost_reference"] == got["cartesian_cost"]


def test_checkpoints_load_both_ways(trained):
    data, root, ej, et, _, _ = trained("sparse")
    into_port = emt.AngleDihedralCartesianEncoderMap.from_checkpoint(
        data, root / "jax", device="cpu")
    np.testing.assert_allclose(into_port.encode(), ej.encode(), atol=1e-6)
    assert into_port.state.step == STEPS and into_port.state.opt_state["count"] == STEPS
    adam = ej.state.opt_state[1][0]
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(into_port.state.opt_state["nu"])[0]),
                    jax.tree_util.tree_leaves(jax.device_get(adam.nu))):
        np.testing.assert_array_equal(a, np.asarray(b))

    into_jax = emj.AngleDihedralCartesianEncoderMap.from_checkpoint(data, root / "torch")
    np.testing.assert_allclose(into_jax.encode(), et.encode(), atol=1e-6)
    assert int(into_jax.state.step) == STEPS
    again = emt.AngleDihedralCartesianEncoderMap.from_checkpoint(data, root / "torch",
                                                                 device="cpu")
    assert np.array_equal(again.encode(), et.encode())
    assert "densifiers" in again.state.params


def test_frozen_densifiers_stay_put(tmp_path):
    """trainable_dense_to_sparse=False: the densifiers get no gradient and
    keep their initial values; the rest trains."""
    data = _cvs(nan=True)
    et = emt.AngleDihedralCartesianEncoderMap(
        data, emt.ADCParameters(main_path=str(tmp_path), **_kw(use_backbone_angles=True)),
        device="cpu")
    before = params_to_numpy(et.state.params)[0]
    hist = et.train()
    after = params_to_numpy(et.state.params)[0]
    assert np.isfinite(hist["loss"]).all()
    for a, b in zip(jax.tree_util.tree_leaves(before["densifiers"]),
                    jax.tree_util.tree_leaves(after["densifiers"])):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(before["encoder"][0]["kernel"], after["encoder"][0]["kernel"])


def test_entry_points_refuse_what_waits_for_later_slices(tmp_path):
    """Without a card the default device raises; streaming from a file
    that is not there raises h5py's error (nothing falls back to memory);
    sidechain reconstruction and multimer
    training construct, and combine with sparse CVs or with each other
    only to raise the JAX package's ``ValueError``."""
    from encodermap_tpu_torch.ops.backmap import backmap_multimer
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast, make_spec

    data = _cvs()
    p = emt.ADCParameters(main_path=str(tmp_path), **_kw())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            emt.AngleDihedralCartesianEncoderMap(data, p)
    et = emt.AngleDihedralCartesianEncoderMap(data, p, device="cpu", read_only=True)
    with pytest.raises(OSError):
        et.train_streaming(str(tmp_path / "ens.h5"))
    with pytest.raises(OSError):
        emt.AngleDihedralCartesianEncoderMap.from_ensemble_h5(str(tmp_path / "ens.h5"), p)

    # sidechain reconstruction: seven CVs of a 5-residue chain
    info = {1: 1, 2: 0, 3: 2, 4: 0, 5: 1}
    spec = make_spec(info)
    rng = np.random.default_rng(3)
    x = [torch.tensor(rng.uniform(lo, hi, (N_FRAMES, n)), dtype=torch.float32)
         for lo, hi, n in ((0.13, 0.155, 14), (1.7, 2.2, 13), (-np.pi, np.pi, 12),
                           (0.13, 0.16, spec.n_sidechain_atoms),
                           (1.7, 2.2, spec.n_sidechain_atoms), (-np.pi, np.pi, 4))]
    side = {"central_distances": x[0], "central_angles": x[1], "central_dihedrals": x[2],
            "side_distances": x[3], "side_angles": x[4], "side_dihedrals": x[5],
            "all_cartesians": backmap_sidechains_fast(spec, *x)}
    side = {k: v.numpy() for k, v in side.items()}
    rec = dict(reconstruct_sidechains=True, sidechain_info=info, use_backbone_angles=True)
    et = emt.AngleDihedralCartesianEncoderMap(
        side, emt.ADCParameters(main_path=str(tmp_path), **_kw(**rec)), device="cpu",
        read_only=True)
    assert et.sidechain_spec.n_atoms == 15 + spec.n_sidechain_atoms
    # multimer: a dimer of 2 and 3 residues
    dimer = {k: v.copy() for k, v in data.items()}
    dimer["central_cartesians"] = backmap_multimer(
        [2, 3], *(torch.tensor(dimer[k][:, :n]) for k, n in (
            ("central_distances", 13), ("central_angles", 11), ("central_dihedrals", 9))),
        torch.eye(4).expand(N_FRAMES, 1, 4, 4)).numpy()
    for k, n in (("central_distances", 13), ("central_angles", 11), ("central_dihedrals", 9)):
        dimer[k] = dimer[k][:, :n]
    multi = dict(multimer_training="homogeneous_transformation", multimer_lengths=[2, 3],
                 use_backbone_angles=True, use_sidechains=True)
    et = emt.AngleDihedralCartesianEncoderMap(
        dimer, emt.ADCParameters(main_path=str(tmp_path), **_kw(**multi)), device="cpu",
        read_only=True)
    assert et.state.params["decoder"][-1]["kernel"].shape[1] == 2 * (11 + 9 + 10) + 16

    sparse_side = dict(side, side_angles=side["side_angles"].copy())
    sparse_side["side_angles"][0, 0] = np.nan
    for cvs, kw in ((sparse_side, rec), (dimer, dict(multi, **rec))):
        errors = []
        for package, extra in ((emj, {}), (emt, dict(device="cpu"))):
            with pytest.raises(ValueError) as err:
                package.AngleDihedralCartesianEncoderMap(
                    cvs, package.ADCParameters(main_path=str(tmp_path), **_kw(**kw)),
                    read_only=True, **extra)
            errors.append(str(err.value))
        assert errors[0] == errors[1]

    class Ensemble:  # any object with .CVs works
        CVs = data

    et = emt.AngleDihedralCartesianEncoderMap(Ensemble(), p, device="cpu", read_only=True)
    assert et.shapes.n_cartesians == 3 * N_RES
    with pytest.raises(ValueError):
        et.set_train_data({k: v[:, :-1] for k, v in data.items()})
