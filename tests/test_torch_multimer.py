# tests/test_torch_multimer.py
"""The port's multimer training against the JAX package's.

``backmap_multimer`` and the helpers of ``encodermap_tpu_torch/ops/
backmap.py``, the multimer model of ``models/adc.py`` and the
``multimer_training="homogeneous_transformation"`` ADC trainer, on the same
numpy inputs from a seed, ``LENGTHS = [4, 5]`` residues.

Tolerances: ``backmap_multimer`` agrees with JAX's to 2e-5 nm (random
rigid transforms moving the second protein by up to 2 nm; float32), and
equals the port's monomer backmap per protein under identity transforms to
1e-6; the helpers agree with JAX's to 1e-6. Each validation error is
JAX's, type and message. The trainer follows JAX step for step over 5
steps at [16,16,2], B=16, from JAX's weights and indices (each loss term
to 1e-5 relative to the largest of its curve, parameters to 1e-4); encode,
decode, generate and the cost references at the same weights to 1e-5, and
checkpoints load both ways (encode to 1e-5: the pair block widens the
first encoder product to 451 columns, summed in another order).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu_torch as emt
from encodermap_tpu.models import adc as JA
from encodermap_tpu_torch.convert import params_from_numpy, params_to_numpy
from encodermap_tpu_torch.models import adc as TA

torch.set_num_threads(1)

JB = importlib.import_module("encodermap_tpu.ops.backmap")
TB = importlib.import_module("encodermap_tpu_torch.ops.backmap")
LENGTHS = [4, 5]
N_FRAMES, B, STEPS = 64, 16, 5
CV_KEYS = ("central_angles", "central_dihedrals", "central_cartesians", "central_distances",
           "side_dihedrals")


def _internals(rng, n, lengths=LENGTHS):
    """Per-protein internal coordinates, concatenated protein by protein."""
    parts = [(rng.uniform(0.12, 0.16, (n, 3 * L - 1)), rng.uniform(1.7, 2.4, (n, 3 * L - 2)),
              rng.uniform(-np.pi, np.pi, (n, 3 * L - 3))) for L in lengths]
    return tuple(np.concatenate(x, 1).astype(np.float32) for x in zip(*parts))


def _rigid(rng, n, k):
    """(n, k, 4, 4) rigid transforms for row vectors, ``[xyz, 1] @ M``."""
    mats = np.zeros((n, k, 4, 4))
    for b in range(n):
        for i in range(k):
            q, r = np.linalg.qr(rng.normal(size=(3, 3)))
            q *= np.sign(np.diag(r))
            if np.linalg.det(q) < 0:
                q[:, 0] *= -1
            mats[b, i, :3, :3] = q.T
            mats[b, i, 3, :3] = rng.uniform(-2, 2, 3)
            mats[b, i, 3, 3] = 1.0
    return mats.astype(np.float32)


def test_backmap_multimer_matches_jax():
    rng = np.random.default_rng(0)
    d, a, t = _internals(rng, 6)
    mats = _rigid(rng, 6, len(LENGTHS) - 1)
    got = TB.backmap_multimer(LENGTHS, *map(torch.tensor, (d, a, t, mats))).numpy()
    assert got.shape == (6, 27, 3)
    ref = np.asarray(jax.jit(lambda *x: JB.backmap_multimer(LENGTHS, *x))(d, a, t, mats))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_identity_transforms_give_the_monomer_backmaps():
    rng = np.random.default_rng(1)
    d, a, t = map(torch.tensor, _internals(rng, 4))
    eye = torch.eye(4).expand(4, len(LENGTHS) - 1, 4, 4)
    got = TB.backmap_multimer(LENGTHS, d, a, t, eye)
    at = d0 = a0 = t0 = 0
    for L in LENGTHS:
        ref = TB.backmap(d[:, d0:d0 + 3 * L - 1], a[:, a0:a0 + 3 * L - 2],
                         t[:, t0:t0 + 3 * L - 3])
        np.testing.assert_allclose(got[:, at:at + 3 * L].numpy(), ref.numpy(), atol=1e-6)
        at, d0, a0, t0 = at + 3 * L, d0 + 3 * L - 1, a0 + 3 * L - 2, t0 + 3 * L - 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("spans", [False, True], ids=["spans_off", "spans_on"])
def test_backmap_multimer_gradients_are_plain_autograds_with_spans_on_or_off(dtype, spans):
    """``backmap_multimer`` wherever a gradient is taken (its backward in
    the span ``adc.backmap_backward``, one route whatever the spans): the
    coordinates and every gradient bit for bit those of autograd through
    its plain operations, with the decoded angles, dihedrals and
    transforms used again outside it, as the losses use them; the span
    opens once a backward with the spans on, and the counter
    ``multimer_backmap`` counts one call, its rows and its proteins each
    way, and nothing with the spans off."""
    from encodermap_tpu_torch.misc import profiling as P

    rng = np.random.default_rng(5)
    d, a, t = (torch.tensor(x, dtype=dtype) for x in _internals(rng, 6))
    mats = torch.tensor(_rigid(rng, 6, len(LENGTHS) - 1), dtype=dtype)
    w = torch.tensor(rng.normal(size=(6, 27, 3)), dtype=dtype)

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in (a, t, mats)]
        out = fn(LENGTHS, d, *leaves)
        loss = (out * w).sum() + sum(torch.sin(x).sum() for x in leaves)
        return [out.detach()] + list(torch.autograd.grad(loss, leaves))

    plain = run(TB._backmap_multimer_plain)
    totals, count = P.span_totals(), dict(P.counter("multimer_backmap"))
    with P.record_spans() if spans else contextlib.nullcontext():
        got = run(TB.backmap_multimer)
    for x, y in zip(got, plain):
        assert x.dtype == dtype and torch.equal(x, y)
    opened = P.span_totals().get("adc.backmap_backward", P.SpanTotal(0, 0.0, 0.0)).count \
        - totals.get("adc.backmap_backward", P.SpanTotal(0, 0.0, 0.0)).count
    moved = {k: v - count.get(k, 0) for k, v in P.counter("multimer_backmap").items()
             if v != count.get(k, 0)}
    assert opened == int(spans)
    assert moved == ({"fwd": 1, "rows_fwd": 6, "proteins": 2, "bwd": 1, "rows_bwd": 6}
                     if spans else {})


def test_backmap_multimer_without_a_gradient_is_the_plain_call():
    """No gradient taken: the plain operations themselves, no autograd
    node, nothing counted even with the spans on."""
    from encodermap_tpu_torch.misc import profiling as P

    rng = np.random.default_rng(6)
    d, a, t = map(torch.tensor, _internals(rng, 3))
    mats = torch.tensor(_rigid(rng, 3, len(LENGTHS) - 1), requires_grad=True)
    count = dict(P.counter("multimer_backmap"))
    with P.record_spans(), torch.no_grad():
        out = TB.backmap_multimer(LENGTHS, d, a, t, mats)
    assert out.grad_fn is None
    assert torch.equal(out, TB._backmap_multimer_plain(LENGTHS, d, a, t, mats.detach()))
    assert dict(P.counter("multimer_backmap")) == count


def test_helpers_match_jax():
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(5, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(-3, 3, 5).astype(np.float32)
    np.testing.assert_allclose(TB.rotation_matrices(torch.tensor(axis), torch.tensor(ang)).numpy(),
                               np.asarray(JB.rotation_matrices(axis, ang)), atol=1e-6)
    for kw in (dict(n_atoms=9), dict(bond_lengths=np.full(8, 0.15))):
        np.testing.assert_array_equal(TB.straight_tetrahedral_chain(**kw),
                                      JB.straight_tetrahedral_chain(**kw))
    d, a, t = _internals(rng, 3, [4])
    cart = np.asarray(JB.backmap(d, a, t))
    n_idx, c_idx = list(range(0, 12, 3)), list(range(2, 12, 3))
    ct = torch.tensor(cart)
    pairs = [(TB.guess_amide_H(ct, n_idx), JB.guess_amide_H(cart, n_idx)),
             (TB.guess_amide_O(ct, c_idx), JB.guess_amide_O(cart, c_idx)),
             (TB.guess_sp2_atom(ct, [4, 11], 2.0, 0.1), JB.guess_sp2_atom(cart, [4, 11], 2.0, 0.1))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    h, o = pairs[0], pairs[1]
    merged = TB.merge_cartesians(ct, n_idx, c_idx, h[0], o[0]).numpy()
    assert merged.shape == (3, 12 + 3 + 4, 3)
    np.testing.assert_allclose(merged, np.asarray(JB.merge_cartesians(
        cart, n_idx, c_idx, np.asarray(h[1]), np.asarray(o[1]))), atol=1e-6)


def _cvs(n=N_FRAMES, seed=3):
    """A dimer whose second protein sits at one fixed rigid transform."""
    rng = np.random.default_rng(seed)
    d, a, t = _internals(rng, n)
    mats = np.broadcast_to(_rigid(np.random.default_rng(0), 1, 1), (n, 1, 4, 4))
    cart = np.array(jax.jit(lambda *x: JB.backmap_multimer(LENGTHS, *x))(d, a, t, mats))
    return {"central_angles": a, "central_dihedrals": t, "central_cartesians": cart,
            "central_distances": d,
            "side_dihedrals": rng.uniform(-np.pi, np.pi, (n, 6)).astype(np.float32)}


def _params(package, **kw):
    base = dict(multimer_training="homogeneous_transformation", multimer_lengths=LENGTHS,
                use_backbone_angles=True, use_sidechains=True, n_neurons=[16, 16, 2], seed=1)
    base.update(kw)
    return package.ADCParameters(**base)


def _invalid(cvs, case):
    """(parameter overrides, CVs) of each raising case."""
    cvs = dict(cvs)
    if case == "sparse":
        cvs["side_dihedrals"] = cvs["side_dihedrals"].copy()
        cvs["side_dihedrals"][0, 0] = np.nan
    if case == "no sidechains":
        del cvs["side_dihedrals"]
    return {"unknown mode": dict(multimer_training="something_else"),
            "no lengths": dict(multimer_lengths=None),
            "dict lengths disagree": dict(multimer_lengths={"topA": [4, 5], "topB": [4, 6]}),
            "missing class": dict(multimer_lengths={"topA": LENGTHS},
                                  multimer_topology_classes=["topA", "topB"]),
            "no sidechains": dict(use_sidechains=False),
            "no backbone angles": dict(use_backbone_angles=False),
            "shape mismatch": dict(multimer_lengths=[4, 6]),
            "sparse": dict(),
            "reconstruct": dict(reconstruct_sidechains=True)}[case], cvs


CASES = ["unknown mode", "no lengths", "dict lengths disagree", "missing class",
         "no sidechains", "no backbone angles", "shape mismatch", "sparse", "reconstruct"]


@pytest.mark.parametrize("case", CASES)
def test_invalid_configurations_raise_what_jax_raises(case, tmp_path):
    kw, cvs = _invalid(_cvs(8), case)
    errors = []
    for package, extra in ((emj, {}), (emt, dict(device="cpu"))):
        p = _params(package, main_path=str(tmp_path), **kw)
        with pytest.raises(ValueError) as err:
            package.AngleDihedralCartesianEncoderMap(cvs, p, read_only=True, **extra)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    if case in CASES[:4]:
        msgs = []
        for mod, package in ((JA, emj), (TA, emt)):
            with pytest.raises(ValueError) as err:
                mod.multimer_lengths_list(_params(package, **kw))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_dict_lengths_and_model_factory():
    p = _params(emt, multimer_lengths={"topA": LENGTHS, "topB": list(LENGTHS)},
                multimer_topology_classes=["topA", "topB"])
    assert TA.multimer_lengths_list(p) == LENGTHS
    shapes = ((52,), (51,), (27, 3), (25,))
    with pytest.raises(ValueError) as ej:
        JA.gen_functional_model(shapes, _params(emj, use_sidechains=False))
    with pytest.raises(ValueError) as et:
        TA.gen_functional_model(shapes, _params(emt, use_sidechains=False))
    assert str(et.value) == str(ej.value)


def test_model_widths_and_decode_match_jax():
    """The encoder's pair block, the transform group, and the model's
    forward from JAX's weights."""
    cvs = _cvs(8)
    batch = tuple(cvs[k] for k in CV_KEYS)
    pj, pt = _params(emj), _params(emt)
    sj = JA.ADCShapes.from_data(*batch)
    st = TA.ADCShapes.from_data(*batch)
    assert TA._encoder_in_dim(pt, st) == JA._encoder_in_dim(pj, sj) == 2 * (23 + 21 + 6) + 351
    assert TA.decoder_splits(pt, st) == JA.decoder_splits(pj, sj)
    params = JA.init_params(jax.random.PRNGKey(0), pj, sj)
    tparams = params_from_numpy(jax.device_get(params))[0]
    ref = jax.jit(lambda p_, b_: JA.forward(p_, pj, b_, sj))(params, tuple(map(jnp.asarray, batch)))
    got = TA.forward(tparams, pt, tuple(map(torch.tensor, batch)), st)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
    decoded = TA.decode(tparams, pt, got[-1], st)
    assert len(decoded) == 4 and decoded[3].shape == (8, 1, 4, 4)


def _kw():
    return dict(n_neurons=[16, 16, 2], batch_size=B, steps_per_scan=STEPS, n_steps=STEPS,
                seed=1, multimer_training="homogeneous_transformation",
                multimer_lengths=LENGTHS, use_backbone_angles=True, use_sidechains=True,
                angle_cost_scale=1.0, distance_cost_scale=1.0,
                cartesian_cost_scale_soft_start=(1, 4), summary_step=1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("multimer")
    data = _cvs()
    ej = emj.AngleDihedralCartesianEncoderMap(
        data, emj.ADCParameters(main_path=str(root / "jax"), **_kw()))
    et = emt.AngleDihedralCartesianEncoderMap(
        data, emt.ADCParameters(main_path=str(root / "torch"), **_kw()),
        model_params=jax.device_get(ej.state.params), device="cpu")
    _, sub = jax.random.split(ej.state.rng)
    idx = [np.asarray(jax.random.randint(sub, (STEPS, B), 0, N_FRAMES))]
    return data, root, ej, et, ej.train(), et.train(index_stream=iter(idx))


def test_five_steps_match_jax_step_for_step(trained):
    _, _, ej, et, hj, ht = trained
    assert hj.keys() == ht.keys()
    for k, ref in hj.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(ht[k], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(et.state.params)[0]),
                    jax.tree_util.tree_leaves(jax.device_get(ej.state.params))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert et.state.step == int(ej.state.step) == STEPS


def test_encode_decode_generate_match_jax(trained):
    data, root, ej, _, _, _ = trained
    et = emt.AngleDihedralCartesianEncoderMap.from_checkpoint(data, root / "jax", device="cpu",
                                                              read_only=True)
    np.testing.assert_allclose(et.encode(), ej.encode(), atol=1e-5)
    z = ej.encode()[:7]
    decoded = et.decode(z)
    assert len(decoded) == 4 and decoded[3].shape == (7, 1, 4, 4)
    for a, b in zip(decoded, ej.decode(z)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    xyz = et.generate(z)
    assert xyz.shape == (7, 27, 3) and np.isfinite(xyz).all()
    np.testing.assert_allclose(xyz, ej.generate(z), atol=1e-5)
    with pytest.raises(ValueError, match="cartesians"):
        et.encode((data["central_angles"], data["central_dihedrals"], data["side_dihedrals"]))


def test_train_for_references_matches_jax(trained):
    _, _, ej, et, _, _ = trained
    got, ref = et.train_for_references(), ej.train_for_references()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


def test_checkpoints_load_both_ways(trained):
    data, root, ej, et, _, _ = trained
    into_jax = emj.AngleDihedralCartesianEncoderMap.from_checkpoint(data, root / "torch")
    np.testing.assert_allclose(into_jax.encode(), et.encode(), atol=1e-5)
    assert int(into_jax.state.step) == STEPS
    into_port = emt.AngleDihedralCartesianEncoderMap.from_checkpoint(data, root / "jax",
                                                                     device="cpu")
    np.testing.assert_allclose(into_port.encode(), ej.encode(), atol=1e-5)
    assert into_port.state.step == STEPS and into_port.state.opt_state["count"] == STEPS


def test_functional_model_matches_jax_forward():
    """``gen_functional_model`` with JAX's weights gives JAX's forward."""
    cvs = _cvs(8)
    batch = tuple(cvs[k] for k in CV_KEYS)
    shapes = ((23,), (21,), (27, 3), (25,), (6,))
    mj = JA.gen_functional_model(shapes, _params(emj))
    mt = TA.gen_functional_model(shapes, _params(emt), device="cpu")
    mt.params = params_from_numpy(jax.device_get(mj.params))[0]
    for a, b in zip(mt(batch), mj(batch)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mt.encoder(batch).detach().numpy(), np.asarray(mj.encoder(batch)),
                               atol=1e-5)
    assert len(mt.decoder(np.zeros((2, 2)))) == 4
