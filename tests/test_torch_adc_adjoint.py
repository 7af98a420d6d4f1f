# tests/test_torch_adc_adjoint.py
"""The port's float64 ADC gradient oracle (``ops/adc_adjoint.py``) against
the JAX package's and against autograd.

The same numpy inputs, made from a seed, go through both packages'
``hand_adc_step`` in float64: every gradient and metric to 1e-10 relative
where the Cartesian cost is soft-started over steps (JAX's oracle takes a
constant scale in float32: a recorded divergence, its own test). The port's
hand gradients equal torch float64 autograd of the step's own loss to 1e-9
relative and 1e-11 absolute in every case, as ``tests/test_adc_adjoint.py``
holds the JAX package's; and its metrics equal the port's production ADC
loss assembly (``_loss_terms``) to 1e-4 relative, 1e-7 absolute. The cases
cover an odd and an even dihedral count (the two ways the chain splits),
side dihedrals on and off, the three forms of the Cartesian scale, the
encoder input's sketch-map cost on and off, and a latent sigmoid with
``a != 2`` (the guarded form of ``s'(r) / r``).
"""

import numpy as np
import pytest
import torch

from encodermap_tpu_torch.ops import adc_adjoint as PT

torch.set_num_threads(1)

#: name -> (residues, side dihedrals, soft start, distance_cost_scale,
#: cartesian_dist_sig_parameters)
CASES = {
    "odd_side_softstart": (8, True, (2, 10), None, (4.5, 12, 6, 1, 2, 6)),
    "even_no_side": (7, False, (0, 16), 1.0, (4.5, 12, 6, 1, 2, 6)),
    "odd_sketchmap_a3": (6, True, (0, 4), 0.5, (3.0, 8, 4, 1.5, 3, 4)),
    # the two cases where the JAX package's oracle takes the Cartesian
    # scale in float32 (test_constant_scale_divergence)
    "constant_scale": (7, False, None, 1.0, (4.5, 12, 6, 1, 2, 6)),
    "instant_switch_on": (8, True, (4, 4), None, (4.5, 12, 6, 1, 2, 6)),
}
#: the cases where both oracles are exact
JAX_EXACT = ["odd_side_softstart", "even_no_side", "odd_sketchmap_a3"]


def _problem(case: str, B: int = 8, hidden: int = 32):
    """float64 numpy weights, CVs and the hyperparameters of a case."""
    n_res, side, soft, dist_scale, cd_sig = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    n_atoms = 3 * n_res
    nA, nD, nS, nDist = n_atoms - 2, n_atoms - 3, 2 * n_res, n_atoms - 1
    hyper = dict(
        periodicity=2 * np.pi,
        dihedral_cost_scale=1.0, dihedral_cost_reference=1.0,
        angle_cost_scale=0.3, angle_cost_reference=1.0,
        side_dihedral_cost_scale=0.5, side_dihedral_cost_reference=1.0,
        cartesian_cost_scale=1.0, cartesian_cost_reference=1.0,
        soft_start=soft, cartesian_distance_cost_scale=1.0,
        cartesian_dist_sig_parameters=cd_sig,
        distance_cost_scale=dist_scale, dist_sig_parameters=(4.5, 12, 6, 1, 2, 6),
        center_cost_scale=1e-4, l2_reg_constant=1e-3,
        ca_start=1, ca_step=3, pair_iu=np.triu_indices(n_res, k=1), learning_rate=1e-3,
    )
    in_dim = 2 * (nA + nD + (nS if side else 0))
    dims = [in_dim, hidden, hidden, 2]
    dd = dims[::-1]
    net = dict(
        enc_w=[rng.standard_normal((a, b)) * 0.2 for a, b in zip(dims[:-1], dims[1:])],
        enc_b=[rng.standard_normal(b) * 0.05 for b in dims[1:]],
        dec_w=[rng.standard_normal((a, b)) * 0.2 for a, b in zip(dd[:-1], dd[1:])],
        dec_b=[rng.standard_normal(b) * 0.05 for b in dd[1:]],
    )
    data = dict(
        angles=rng.uniform(1.6, 2.4, (B, nA)),
        dihedrals=rng.uniform(-np.pi, np.pi, (B, nD)),
        ca=rng.uniform(0, 3, (B, n_res, 3)),
        distances=rng.uniform(1.3, 1.55, (B, nDist)),
        side=rng.uniform(-np.pi, np.pi, (B, nS)) if side else None,
    )
    return net, data, hyper


def _torch_args(net: dict, data: dict, requires_grad: bool = False):
    def t(x):
        return None if x is None else torch.tensor(x, dtype=torch.float64,
                                                   requires_grad=requires_grad)

    ws = {k: [t(x) for x in v] for k, v in net.items()}
    d = {k: None if v is None else torch.tensor(v, dtype=torch.float64)
         for k, v in data.items()}
    return ws, d


def _port_step(net, data, hyper, step=5.0, requires_grad=False):
    ws, d = _torch_args(net, data, requires_grad)
    out = PT.hand_adc_step(ws["enc_w"], ws["enc_b"], ws["dec_w"], ws["dec_b"],
                           d["angles"], d["dihedrals"], d["ca"], d["distances"], d["side"],
                           torch.tensor(step, dtype=torch.float64), hyper=hyper)
    return ws, out


def _numpy(x) -> np.ndarray:
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _jax_step(net, data, hyper) -> tuple:
    """The JAX package's oracle in float64: ``(gradients, metrics)`` as
    numpy, the gradients in (enc_w, enc_b, dec_w, dec_b) order."""
    import jax
    import jax.numpy as jnp

    from encodermap_tpu.ops import adc_adjoint as JA

    with jax.enable_x64(True):
        j = {k: [jnp.asarray(x, jnp.float64) for x in v] for k, v in net.items()}
        jd = {k: None if v is None else jnp.asarray(v, jnp.float64) for k, v in data.items()}
        jgew, jgeb, jgdw, jgdb, jmetrics = JA.hand_adc_step(
            j["enc_w"], j["enc_b"], j["dec_w"], j["dec_b"], jd["angles"], jd["dihedrals"],
            jd["ca"], jd["distances"], jd["side"], jnp.asarray(5.0, jnp.float64),
            hyper=hyper)
        want = [np.asarray(x) for x in list(jgew) + list(jgeb) + list(jgdw) + list(jgdb)]
        return want, {k: np.asarray(v) for k, v in jmetrics.items()}


@pytest.mark.parametrize("case", JAX_EXACT)
def test_hand_step_equals_jax_float64(case):
    """Every gradient and metric of the port's oracle against the JAX
    package's, both in float64 on the same numpy inputs: 1e-10 relative."""
    net, data, hyper = _problem(case)
    _, (gew, geb, gdw, gdb, metrics) = _port_step(net, data, hyper)
    want, jm = _jax_step(net, data, hyper)
    got = [_numpy(x) for x in list(gew) + list(geb) + list(gdw) + list(gdb)]
    assert len(got) == len(want) == 12
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14, err_msg=f"gradient {i}")
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(_numpy(metrics[k]), v, rtol=1e-10, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_hand_grads_equal_autograd_float64(case):
    """The closed-form backward against torch float64 autograd of the
    oracle's own loss (``tests/test_adc_adjoint.py:52-74``'s tolerances)."""
    net, data, hyper = _problem(case)
    ws, (gew, geb, gdw, gdb, metrics) = _port_step(net, data, hyper, requires_grad=True)
    leaves = ws["enc_w"] + ws["dec_w"] + ws["enc_b"] + ws["dec_b"]
    auto = torch.autograd.grad(metrics["loss"], leaves)
    hand = list(gew) + list(gdw) + list(geb) + list(gdb)
    for i, (a, b) in enumerate(zip(auto, hand)):
        np.testing.assert_allclose(_numpy(b), _numpy(a), rtol=1e-9, atol=1e-11,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("case", ["constant_scale", "instant_switch_on"])
def test_constant_scale_divergence(case):
    """A recorded divergence: without a soft start, or with an instant
    switch-on (``a == b``), the JAX package's oracle rounds the Cartesian
    scale to float32, so its Cartesian gradient parts from the exact one by
    float32 rounding (more than 1e-10, at most 1e-6 relative); the port
    keeps the scale in the inputs' dtype and stays exact (the autograd
    test above). Every metric still agrees to 1e-10."""
    net, data, hyper = _problem(case)
    _, (gew, geb, gdw, gdb, metrics) = _port_step(net, data, hyper)
    want, jm = _jax_step(net, data, hyper)
    got = [_numpy(x) for x in list(gew) + list(geb) + list(gdw) + list(gdb)]
    worst = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, want))
    assert 1e-10 < worst <= 1e-6, worst
    for k, v in jm.items():
        np.testing.assert_allclose(_numpy(metrics[k]), v, rtol=1e-10, atol=1e-14, err_msg=k)


def _adc_model(distance_cost_scale):
    """The port's ADC at 8 residues from the JAX test's CVs, and its first
    batch (as test_adc_adjoint.py:79-128 builds them)."""
    import encodermap_tpu_torch as emt
    from tests.reference_impl import backmap_np

    rng = np.random.default_rng(0)
    n_res, B = 8, 16
    n_atoms = 3 * n_res
    angles = rng.uniform(1.6, 2.4, (64, n_atoms - 2)).astype(np.float32)
    dihedrals = rng.uniform(-np.pi, np.pi, (64, n_atoms - 3)).astype(np.float32)
    distances = rng.uniform(0.13, 0.155, (64, n_atoms - 1)).astype(np.float32)
    cart = backmap_np(distances, angles, dihedrals).astype(np.float32)
    sided = rng.uniform(-np.pi, np.pi, (64, 2 * n_res)).astype(np.float32)
    cvs = dict(central_angles=angles, central_dihedrals=dihedrals,
               central_cartesians=cart, central_distances=distances,
               side_dihedrals=sided)
    p = emt.ADCParameters(batch_size=B, use_backbone_angles=True, use_sidechains=True,
                          seed=0, n_neurons=[16, 16, 2], cartesian_pwd_start=1,
                          cartesian_pwd_step=3, distance_cost_scale=distance_cost_scale,
                          cartesian_cost_scale_soft_start=(2, 10))
    emap = emt.AngleDihedralCartesianEncoderMap(cvs, p, read_only=True, device="cpu")
    batch = tuple(torch.tensor(a[:B]) for a in emap.train_data)
    return emap, batch, n_res


@pytest.mark.parametrize("distance_cost_scale", [1.0, None])
def test_metrics_equal_production_losses(distance_cost_scale):
    """Every metric of the oracle (fed the float32 weights and batch in
    float64) equals the port's ADC ``_loss_terms`` at the same step."""
    emap, batch, n_res = _adc_model(distance_cost_scale)
    p = emap.p
    with torch.no_grad():
        terms = emap._loss_terms(emap.state.params, batch, 5)
    hyper = dict(
        periodicity=p.periodicity,
        dihedral_cost_scale=p.dihedral_cost_scale,
        dihedral_cost_reference=p.dihedral_cost_reference,
        angle_cost_scale=p.angle_cost_scale or 0.0,
        angle_cost_reference=p.angle_cost_reference,
        side_dihedral_cost_scale=p.side_dihedral_cost_scale,
        side_dihedral_cost_reference=p.side_dihedral_cost_reference,
        cartesian_cost_scale=p.cartesian_cost_scale,
        cartesian_cost_reference=p.cartesian_cost_reference,
        soft_start=p.cartesian_cost_scale_soft_start,
        cartesian_distance_cost_scale=p.cartesian_distance_cost_scale,
        cartesian_dist_sig_parameters=p.cartesian_dist_sig_parameters,
        distance_cost_scale=p.distance_cost_scale,
        dist_sig_parameters=p.dist_sig_parameters,
        center_cost_scale=p.center_cost_scale,
        l2_reg_constant=p.l2_reg_constant,
        ca_start=1, ca_step=3, pair_iu=np.triu_indices(n_res, k=1),
    )
    params = emap.state.params

    def f64(layers, name):
        return [layer[name].double() for layer in layers]

    b = [x.double() for x in batch]
    *_, metrics = PT.hand_adc_step(
        f64(params["encoder"], "kernel"), f64(params["encoder"], "bias"),
        f64(params["decoder"], "kernel"), f64(params["decoder"], "bias"),
        b[0], b[1], b[2][:, 1::3, :], b[3], b[4], 5.0, hyper=hyper)
    compared = 0
    for k, v in terms.items():
        if k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-7,
                                       err_msg=k)
            compared += 1
    assert compared == len(terms) == 9


def test_oracle_shares_no_code_with_what_it_checks():
    """The oracle imports neither the backmap, the sigmoid-loss kernels'
    module nor the losses, nor anything of JAX."""
    import ast
    from pathlib import Path

    tree = ast.parse(Path(PT.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(("." * node.level) + (node.module or ""))
    assert names == {"__future__", "math", "typing", "torch"}, names
