# tests/test_torch_sidechains.py
"""The port's sidechain reconstruction against the JAX package's.

``encodermap_tpu_torch/ops/backmap_sidechains.py`` and the
``reconstruct_sidechains=True`` ADC trainer, on the same numpy inputs
drawn from a seed (the ranges of ``tests/test_sidechain_reconstruction.py``).

Tolerances and why:

* The step tables equal JAX's exactly.
* The fast backmap agrees with JAX's in float32 to 1e-5 nm (B=3). The
  sequential one is held to JAX's in float64, to 1e-5: its arccos clip sits
  where arccos's slope is ~2236, so one float32 rounding of a cosine moves
  a measured angle by ~1e-4 rad, and the two float32 sweeps part by up to
  3e-5 nm on their own.
* The fast version equals the sequential one measured exactly
  (``angle_clip=None``) in float64 to 1e-9 nm; the clipped sweep is off by
  the clip's bias, 4.5e-4 rad per angle, as in the JAX package (up to
  2.7e-3 nm at 20 residues: held to 5e-3).
* The fast version also equals the sequential one on decoded angles of
  either sign, (-pi, pi], to 1e-9 nm in float64: a negative angle turns
  the plane chain the other way, and the current dihedral the sweep
  measures across such a turn is pi, not the 0 (pi on a branch's first
  step) that angles in (0, pi) give.
* The fast version's autograd passes ``gradcheck`` in float64, and its
  float32 gradient meets err(port f32, f64) <= 3 err(JAX f32, f64).
* With the spans on, training calls the fast version through an autograd
  function whose backward runs under its own span: the same operations,
  so gradients and trained parameters bit for bit those of spans off.
* The trainer follows JAX step for step over 5 steps at [16,16,2], B=16,
  from JAX's weights and indices: each loss term to 1e-5 relative to the
  largest value of its curve, the parameters to 1e-4; encode, decode,
  generate and the cost references at the same weights to 1e-5. The JAX
  package's fast backmap takes each current dihedral as angles in (0, pi)
  give it, which decoded angles need not be (a recorded divergence): in
  this file it runs with the sweep's current dihedrals, given to it as
  shifted targets (``tests/jax_sidechains.py``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu.ops.backmap_sidechains as J
import encodermap_tpu_torch as emt
import encodermap_tpu_torch.ops.backmap_sidechains as T
from chip_smoke import TRP_CAGE, TRP_CAGE_SIDECHAIN_INFO, sidechain_cvs
from encodermap_tpu.train.metrics import ADCRMSDMetric as RmsdJ
from encodermap_tpu_torch.convert import params_to_numpy
from encodermap_tpu_torch.misc import profiling as P
from encodermap_tpu_torch.train.metrics import ADCRMSDMetric as RmsdT
from tests.jax_sidechains import measured, measured_fast

torch.set_num_threads(1)

INFO = {1: 2, 2: 0, 3: 3, 4: 1}
INFOS = {"mixed": INFO, "none": {1: 0, 2: 0, 3: 0}, "single": {1: 3},
         "single-branch": {1: 0, 2: 5, 3: 0}, "small": {1: 1, 2: 2},
         "trp-cage": TRP_CAGE_SIDECHAIN_INFO}
N_FRAMES, B, STEPS = 64, 16, 5


@pytest.fixture(scope="module", autouse=True)
def jax_fast_measured():
    with measured():
        yield


def _inputs(info, B=3, seed=0):
    """(central distances, angles, dihedrals, side distances, angles,
    dihedrals) in float64."""
    spec = J.make_spec(info)
    rng = np.random.default_rng(seed)
    nb, ns = 3 * spec.n_residues, spec.n_sidechain_atoms
    return (rng.uniform(0.13, 0.155, (B, nb - 1)), rng.uniform(1.7, 2.2, (B, nb - 2)),
            rng.uniform(-np.pi, np.pi, (B, nb - 3)), rng.uniform(0.13, 0.16, (B, ns)),
            rng.uniform(1.7, 2.2, (B, ns)),
            rng.uniform(-np.pi, np.pi, (B, sum(info.values()))))


@pytest.mark.parametrize("name", INFOS)
def test_make_spec_equals_jax(name):
    sj, st = J.make_spec(INFOS[name]), T.make_spec(INFOS[name])
    assert sj._fields == st._fields
    for field, a, b in zip(sj._fields, sj, st):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        else:
            assert a == b, field


def test_trp_cage_info_follows_the_chi_tables():
    """One dihedral per chi table (chi1-chi5) that lists the residue."""
    from encodermap_tpu.data.topology import _AA_ONE_LETTER, CHI_ATOMS

    three = {v: k for k, v in _AA_ONE_LETTER.items()}
    want = {i: sum(three[c] in CHI_ATOMS[f"chi{n}"] for n in range(1, 6))
            for i, c in enumerate(TRP_CAGE, start=1)}
    assert TRP_CAGE_SIDECHAIN_INFO == want
    spec = T.make_spec(TRP_CAGE_SIDECHAIN_INFO)
    assert (sum(want.values()), spec.n_sidechain_atoms, spec.n_atoms) == (37, 54, 114)


@pytest.mark.parametrize("name", ["mixed", "single", "single-branch", "small", "none"])
def test_backmaps_match_jax(name):
    info = INFOS[name]
    spec = T.make_spec(info)
    x64 = _inputs(info)
    x32 = [x.astype(np.float32) for x in x64]
    fast = T.backmap_sidechains_fast(spec, *map(torch.tensor, x32)).numpy()
    assert fast.shape == (3, spec.n_atoms, 3)
    sj = J.make_spec(info)
    np.testing.assert_allclose(
        fast, np.asarray(jax.jit(lambda *a: J.backmap_sidechains_fast(sj, *a))(*x32)),
        atol=1e-5)
    seq = T.backmap_sidechains(spec, *map(torch.tensor, x64)).numpy()
    with jax.enable_x64():
        ref = np.asarray(jax.jit(lambda *a: J.backmap_sidechains(sj, *a))(
            *map(jnp.asarray, x64)))
    assert ref.dtype == np.float64
    np.testing.assert_allclose(seq, ref, atol=1e-5)


@pytest.mark.parametrize("name", ["mixed", "single", "single-branch", "trp-cage"])
def test_fast_equals_sequential_in_float64(name):
    info = INFOS[name]
    spec = T.make_spec(info)
    x = [torch.tensor(v) for v in _inputs(info, seed=1)]
    fast = T.backmap_sidechains_fast(spec, *x)
    np.testing.assert_allclose(fast.numpy(), T.backmap_sidechains(spec, *x, angle_clip=None).numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(fast.numpy(), T.backmap_sidechains(spec, *x).numpy(), atol=5e-3)


@pytest.mark.parametrize("name", ["mixed", "single", "single-branch", "trp-cage"])
def test_fast_equals_sequential_on_angles_of_either_sign(name):
    """Decoded angles lie on (-pi, pi]: where one is negative the plane
    chain turns the other way, and the fast version takes the current
    dihedral the sweep measures there."""
    info = INFOS[name]
    spec = T.make_spec(info)
    rng = np.random.default_rng(6)
    x = [torch.tensor(v) for v in _inputs(info, B=8, seed=6)]
    for i in (1, 4):
        x[i] = torch.tensor(rng.uniform(-np.pi, np.pi, tuple(x[i].shape)))
    assert (x[1] < 0).any() and (x[4] < 0).any()
    np.testing.assert_allclose(T.backmap_sidechains_fast(spec, *x).numpy(),
                               T.backmap_sidechains(spec, *x, angle_clip=None).numpy(),
                               atol=1e-9)


@pytest.mark.parametrize("name", ["mixed", "small"])
def test_fast_gradcheck_float64(name):
    info = INFOS[name]
    spec = T.make_spec(info)
    x = tuple(torch.tensor(v, requires_grad=True) for v in _inputs(info, B=2, seed=2))
    assert torch.autograd.gradcheck(lambda *a: T.backmap_sidechains_fast(spec, *a), x)


#: the inputs that take a gradient in training: the decoded angles and
#: dihedrals; the bond lengths are data
DECODED = (1, 2, 4, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spanned_backmap_gradients_equal_autograd_bit_for_bit(dtype):
    """With the spans on, ``backmap_sidechains_fast`` gives the plain
    version's coordinates and, under a loss that also reads the decoded
    inputs directly (as training's angle costs do), the gradients of
    autograd through the plain version bit for bit; it counts its rows and
    runs its backward under its own span."""
    spec = T.make_spec(TRP_CAGE_SIDECHAIN_INFO)
    x = _inputs(TRP_CAGE_SIDECHAIN_INFO, B=8, seed=7)
    w = torch.randn((8, spec.n_atoms, 3), generator=torch.Generator().manual_seed(8),
                    dtype=dtype)

    def run(spanned):
        xs = [torch.tensor(v, dtype=dtype).requires_grad_(i in DECODED)
              for i, v in enumerate(x)]
        fn = T.backmap_sidechains_fast if spanned else T._backmap_sidechains_fast_plain
        out = fn(spec, *xs)
        loss = (out * w).sum() + sum(torch.sin(xs[i]).sum() for i in DECODED)
        return out, torch.autograd.grad(loss, [xs[i] for i in DECODED])

    plain_out, plain_grads = run(False)
    before, count = P.span_totals(), dict(P.counter("sidechain_backmap"))
    with P.record_spans():
        out, grads = run(True)
    assert torch.equal(out, plain_out)
    for a, b in zip(grads, plain_grads):
        assert torch.equal(a, b)
    got = P.span_totals()["adc.backmap_backward"].count
    assert got - before.get("adc.backmap_backward", P.SpanTotal(0, 0.0, 0.0)).count == 1
    moved = {k: v - count.get(k, 0) for k, v in P.counter("sidechain_backmap").items()}
    assert moved == {"fwd": 1, "rows_fwd": 8, "bwd": 1, "rows_bwd": 8}


def test_spanned_backmap_gradcheck_float64():
    spec = T.make_spec(INFO)
    x = tuple(torch.tensor(v, requires_grad=True) for v in _inputs(INFO, B=2, seed=9))
    with P.record_spans():
        assert torch.autograd.gradcheck(lambda *a: T.backmap_sidechains_fast(spec, *a), x)


def test_training_with_spans_on_equals_training_with_them_off(tmp_path):
    """A reconstruct-mode ADC trained with the spans on (the sidechain
    backmap's backward under its span) ends bit for bit where one trained
    with them off ends; spans off record nothing."""
    cvs = sidechain_cvs(256, seed=3, device="cpu")

    def train(name):
        p = emt.ADCParameters(main_path=str(tmp_path / name), n_steps=6, steps_per_scan=3,
                              batch_size=32, n_neurons=[16, 16, 2], seed=2,
                              reconstruct_sidechains=True,
                              sidechain_info=TRP_CAGE_SIDECHAIN_INFO,
                              use_backbone_angles=True, distance_cost_scale=1.0)
        model = emt.AngleDihedralCartesianEncoderMap(cvs, p, device="cpu", read_only=True)
        model.train()
        return params_to_numpy(model.state.params)[0]

    totals, count = P.span_totals(), dict(P.counter("sidechain_backmap"))
    off = train("off")
    assert P.span_totals() == totals and dict(P.counter("sidechain_backmap")) == count
    with P.record_spans():
        on = train("on")
    assert P.span_totals()["adc.backmap_backward"].count \
        - totals.get("adc.backmap_backward", P.SpanTotal(0, 0.0, 0.0)).count == 6
    for a, b in zip(jax.tree_util.tree_leaves(off), jax.tree_util.tree_leaves(on)):
        assert np.array_equal(a, b)


def test_fast_float32_gradient_rule():
    """err(port f32, f64) <= 3 err(JAX f32, f64) for the gradient of a
    random projection of the positions with respect to every input; the
    float64 oracle is the port's autograd in float64 (held by gradcheck)."""
    spec = T.make_spec(INFO)
    x64 = _inputs(INFO, B=3, seed=3)
    g = np.random.default_rng(4).normal(size=(3, spec.n_atoms, 3))
    xs = [torch.tensor(v, requires_grad=True) for v in x64]
    (T.backmap_sidechains_fast(spec, *xs) * torch.tensor(g)).sum().backward()
    oracle = [x.grad.numpy() for x in xs]
    x32 = [torch.tensor(v.astype(np.float32), requires_grad=True) for v in x64]
    (T.backmap_sidechains_fast(spec, *x32) * torch.tensor(g.astype(np.float32))).sum().backward()
    sj, g32 = J.make_spec(INFO), jnp.asarray(g.astype(np.float32))
    gj = jax.jit(jax.grad(lambda *a: jnp.sum(J.backmap_sidechains_fast(sj, *a) * g32),
                          tuple(range(6))))(*(jnp.asarray(v.astype(np.float32)) for v in x64))
    for port, jx, ref in zip(x32, gj, oracle):
        err_port = np.abs(port.grad.numpy() - ref).max()
        err_jax = np.abs(np.asarray(jx) - ref).max()
        assert err_port <= 3 * err_jax, (err_port, err_jax)


SIDECHAIN_JAX_FILE = Path(__file__).parent / "data" / "sidechain_jax.npz"
#: trp-cage; 40 residues with 36 branches (more than a warp's lanes);
#: branches of 6 and 8 atoms
SIDECHAIN_JAX_SPECS = {
    "trp-cage": TRP_CAGE_SIDECHAIN_INFO,
    "forty": {r: (0 if r % 10 == 5 else 1 + r % 4) for r in range(1, 41)},
    "long": {1: 5, 2: 0, 3: 7, 4: 2},
}
SIDECHAIN_INPUTS = ("cd", "ca", "cdi", "sd", "sa", "sdi")


def _jax_fast_vjp(sj, x, g):
    """``measured_fast``'s output and VJP, jitted (eager dispatch of its
    scans takes minutes)."""
    @jax.jit
    def fn(x, g):
        out, vjp = jax.vjp(lambda *a: measured_fast(sj, *a), *x)
        return out, vjp(g)

    return fn([jnp.asarray(v) for v in x], jnp.asarray(g))


def sidechain_jax_reference(name, B=32):
    """Float32 inputs with decoded angles of either sign, a cotangent ``g``
    of the coordinates, and the JAX package's fast form with the sweep's
    current dihedrals (``measured_fast``) and its VJP on them, in float32
    (``out32``, ``d_<input>32``) and in float64 (``out64``, ``d_<input>64``),
    as numpy."""
    info = SIDECHAIN_JAX_SPECS[name]
    x = _inputs(info, B=B, seed=11)
    rng = np.random.default_rng(12)
    x = [x[0], rng.uniform(-np.pi, np.pi, x[1].shape), x[2], x[3],
         rng.uniform(-np.pi, np.pi, x[4].shape), x[5]]
    sj = J.make_spec(info)
    g = rng.normal(size=(B, sj.n_atoms, 3))
    x, g = [v.astype(np.float32) for v in x], g.astype(np.float32)
    stored = dict(zip(SIDECHAIN_INPUTS, x), g=g)
    for bits, cast in ((32, np.float32), (64, np.float64)):
        with jax.enable_x64(bits == 64):
            out, grads = _jax_fast_vjp(sj, [v.astype(cast) for v in x], g.astype(cast))
            assert out.dtype == cast
            stored[f"out{bits}"] = np.asarray(out)
            stored.update({f"d_{k}{bits}": np.asarray(d) for k, d in zip(SIDECHAIN_INPUTS, grads)})
    return stored


def write_sidechain_jax_file(path=SIDECHAIN_JAX_FILE):
    np.savez_compressed(path, **{f"{name}_{k}": v for name in SIDECHAIN_JAX_SPECS
                                 for k, v in sidechain_jax_reference(name).items()})


@pytest.mark.parametrize("name", SIDECHAIN_JAX_SPECS)
def test_sidechain_jax_file_holds_the_jax_packages_output(name):
    """The stored inputs are the seed's, and the stored outputs are what
    the JAX package gives on them: float64 to 1e-12 of each tensor's
    largest entry, float32 to 1e-5 (XLA's CPU code may round otherwise on
    another CPU)."""
    stored = np.load(SIDECHAIN_JAX_FILE)
    for k, v in sidechain_jax_reference(name).items():
        got = stored[f"{name}_{k}"]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        if k in SIDECHAIN_INPUTS + ("g",):
            np.testing.assert_array_equal(got, v)
        else:
            tol = 1e-12 if v.dtype == np.float64 else 1e-5
            np.testing.assert_allclose(got, v, rtol=0, atol=tol * max(np.abs(v).max(), 1.0))


@pytest.mark.parametrize("name", SIDECHAIN_JAX_SPECS)
def test_plain_version_against_the_sidechain_jax_file(name):
    """The port's plain version on the stored inputs: in float64 the JAX
    package's coordinates to 1e-12 nm and its VJP to 1e-12 of each
    gradient's largest entry; in float32 err(plain f32, JAX f64) <= 3
    err(JAX f32, JAX f64), the rule the card holds the kernels to against
    this file (``tests/test_torch_cuda.py``)."""
    stored = np.load(SIDECHAIN_JAX_FILE)
    spec = T.make_spec(SIDECHAIN_JAX_SPECS[name])
    keys = ["out"] + [f"d_{k}" for k in SIDECHAIN_INPUTS]
    for dtype in (torch.float64, torch.float32):
        xs = [torch.tensor(stored[f"{name}_{k}"], dtype=dtype, requires_grad=True)
              for k in SIDECHAIN_INPUTS]
        y = T._backmap_sidechains_fast_plain(spec, *xs)
        (y * torch.tensor(stored[f"{name}_g"], dtype=dtype)).sum().backward()
        for t, k in zip([y] + [v.grad for v in xs], keys):
            ref = stored[f"{name}_{k}64"]
            err = np.abs(t.detach().double().numpy() - ref).max()
            if dtype == torch.float64:
                assert err <= 1e-12 * max(np.abs(ref).max(), 1.0), (k, err)
            else:
                err_jax = np.abs(stored[f"{name}_{k}32"].astype(np.float64) - ref).max()
                assert err <= 3 * err_jax, (k, err, err_jax)


# ------------------------------------------------------------------ trainer
def _cvs():
    x = [v.astype(np.float32) for v in _inputs(INFO, B=N_FRAMES, seed=5)]
    cd, ca, cdi, sd, sa, sdi = x
    xyz = np.array(J.backmap_sidechains_fast(J.make_spec(INFO), *map(jnp.asarray, x)))
    return {"central_angles": ca, "central_dihedrals": cdi, "all_cartesians": xyz,
            "central_distances": cd, "side_angles": sa, "side_dihedrals": sdi,
            "side_distances": sd, "central_cartesians": xyz[:, :12]}


def _kw():
    return dict(n_neurons=[16, 16, 2], batch_size=B, steps_per_scan=STEPS, n_steps=STEPS,
                seed=1, reconstruct_sidechains=True, sidechain_info=INFO,
                use_backbone_angles=True, use_sidechains=True, angle_cost_scale=1.0,
                distance_cost_scale=1.0, cartesian_cost_scale_soft_start=(1, 4),
                track_clashes=True, track_RMSD=True, summary_step=1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("sidechains")
    data = _cvs()
    ej = emj.AngleDihedralCartesianEncoderMap(
        data, emj.ADCParameters(main_path=str(root / "jax"), **_kw()))
    et = emt.AngleDihedralCartesianEncoderMap(
        data, emt.ADCParameters(main_path=str(root / "torch"), **_kw()),
        model_params=jax.device_get(ej.state.params), device="cpu")
    ej.add_metric(RmsdJ)
    et.add_metric(RmsdT)
    rng, sub = jax.random.split(ej.state.rng)
    idx = [np.asarray(jax.random.randint(sub, (STEPS, B), 0, N_FRAMES))]
    return data, root, ej, et, ej.train(), et.train(index_stream=iter(idx))


def test_five_steps_match_jax_step_for_step(trained):
    _, _, ej, et, hj, ht = trained
    assert hj.keys() == ht.keys()
    assert {"angle_loss", "side_dihedral_loss", "clashes", "rmsd", "ADCRMSDMetric"} <= ht.keys()
    for k, ref in hj.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(ht[k], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(et.state.params)[0]),
                    jax.tree_util.tree_leaves(jax.device_get(ej.state.params))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert et.state.step == int(ej.state.step) == STEPS


@pytest.fixture(scope="module")
def same(trained):
    data, root, ej, _, _, _ = trained
    return data, ej, emt.AngleDihedralCartesianEncoderMap.from_checkpoint(
        data, root / "jax", device="cpu", read_only=True)


def test_encode_decode_generate_match_jax(same):
    data, ej, et = same
    np.testing.assert_allclose(et.encode(), ej.encode(), atol=1e-5)
    short = tuple(data[k] for k in ("central_angles", "central_dihedrals", "side_angles",
                                    "side_dihedrals"))
    np.testing.assert_allclose(et.encode(short), ej.encode(short), atol=1e-5)
    z = ej.encode()[:7]
    decoded = et.decode(z)
    assert len(decoded) == 4
    for a, b in zip(decoded, ej.decode(z)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    xyz = et.generate(z)
    spec = et.sidechain_spec
    assert xyz.shape == (7, spec.n_atoms, 3) and np.isfinite(xyz).all()
    np.testing.assert_allclose(xyz, ej.generate(z), atol=1e-5)
    # bond lengths: the training set's mean central and side bonds
    bb = np.linalg.norm(np.diff(xyz[:, :12], axis=1), axis=-1)
    np.testing.assert_allclose(bb, np.broadcast_to(data["central_distances"].mean(0), bb.shape),
                               atol=1e-5)
    chain_bonds, col = [], 12
    for r, v in INFO.items():
        if v:
            chain = [(r - 1) * 3 + 1] + list(range(col, col + v + 1))
            chain_bonds += list(zip(chain[:-1], chain[1:]))
            col += v + 1
    side = np.stack([np.linalg.norm(xyz[:, b] - xyz[:, a], axis=-1) for a, b in chain_bonds], 1)
    np.testing.assert_allclose(side, np.broadcast_to(data["side_distances"].mean(0), side.shape),
                               atol=1e-5)
    with pytest.raises(ValueError):
        et.encode(np.concatenate(short, axis=1))


def test_train_for_references_matches_jax(trained):
    _, _, ej, et, _, _ = trained
    got, ref = et.train_for_references(), ej.train_for_references()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


def test_checkpoints_load_both_ways(trained):
    data, root, ej, et, _, _ = trained
    into_jax = emj.AngleDihedralCartesianEncoderMap.from_checkpoint(data, root / "torch")
    np.testing.assert_allclose(into_jax.encode(), et.encode(), atol=1e-6)
    assert int(into_jax.state.step) == STEPS
    again = emt.AngleDihedralCartesianEncoderMap.from_checkpoint(data, root / "torch",
                                                                 device="cpu")
    assert np.array_equal(again.encode(), et.encode())
    assert again.sidechain_spec.n_atoms == et.sidechain_spec.n_atoms


def test_refusals_match_jax(tmp_path):
    """Sparse CVs and a missing sidechain_info raise as in the JAX package."""
    data = _cvs()
    sparse = dict(data, side_dihedrals=data["side_dihedrals"].copy())
    sparse["side_dihedrals"][0, 0] = np.nan
    no_info = dict(_kw(), sidechain_info=None)
    for cvs, kw in ((sparse, _kw()), (data, no_info)):
        with pytest.raises(ValueError) as ej:
            emj.AngleDihedralCartesianEncoderMap(
                cvs, emj.ADCParameters(main_path=str(tmp_path), **kw), read_only=True)
        with pytest.raises(ValueError) as et:
            emt.AngleDihedralCartesianEncoderMap(
                cvs, emt.ADCParameters(main_path=str(tmp_path), **kw), read_only=True,
                device="cpu")
        assert str(et.value).split(" or ")[0] == str(ej.value).split(" or ")[0]


def test_set_train_data_takes_seven_cvs(trained):
    """New data of the same widths replaces the seven CVs; other widths
    raise, as in the JAX package."""
    data, _, _, et, _, _ = trained
    half = {k: v[: N_FRAMES // 2] for k, v in data.items()}
    et.set_train_data(half)
    assert [len(a) for a in et.train_data] == [N_FRAMES // 2] * 7
    with pytest.raises(ValueError, match="side_angles"):
        et.set_train_data(dict(half, side_angles=half["side_angles"][:, :-1]))
    et.set_train_data(data)
