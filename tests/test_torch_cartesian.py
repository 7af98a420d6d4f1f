# tests/test_torch_cartesian.py
"""The port's ADC Cartesian costs, distances and Kabsch RMSD against the
JAX package's.

* The dense (matrix), analytic and blocked forms of the Cartesian cost and
  of the CA-pair sigmoid loss equal each other and JAX's, in value and in
  the gradients to the backmapped coordinates and the latent, for the three
  cost variants, to 2e-5 relative (float32 sums in other orders).
* ``cartesian_cost_analytic``'s hand-written backward passes
  ``torch.autograd.gradcheck`` in float64, and its float32 gradient meets
  err(port, f64) <= 3 err(JAX, f64) against float64 autograd of the dense
  form.
* The flat and matrix CA-pair sigmoid losses are one value (the sqrt(2)
  sigma of ``_matrix_sig_params``).
* ``component_plane_dists`` to 1e-6, Kabsch RMSD and alignment to 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu_torch as emt
from encodermap_tpu import losses as LJ
from encodermap_tpu_torch import losses as LT

torch.set_num_threads(1)

VARIANTS = ["mean_abs", "mean_square", "mean_norm"]
RTOL = 2e-5


def _coords(B=6, n=20, seed=0):
    rng = np.random.default_rng(seed)
    inp = rng.uniform(0.0, 3.0, (B, n, 3)).astype(np.float32)
    out = (inp + rng.normal(0, 0.15, (B, n, 3))).astype(np.float32)
    latent = rng.normal(0, 1.0, (B, 2)).astype(np.float32)
    return inp, out, latent


def _params(variant, **kw):
    kw = dict(cartesian_cost_variant=variant, cartesian_cost_reference=0.7,
              cartesian_cost_scale=2.0, cartesian_distance_cost_scale=3.0, **kw)
    return emj.ADCParameters(**kw), emt.ADCParameters(**kw)


def _port_routes(inp, out, latent, pt):
    """(cartesian, cartesian_distance) losses of the three port routes,
    with their gradients to out and latent."""
    from encodermap_tpu_torch.ops.distances import pairwise_dist

    res = {}
    for route in ("dense", "analytic", "blocked"):
        o = torch.tensor(out, requires_grad=True)
        lat = torch.tensor(latent, requires_grad=True)
        i = torch.tensor(inp)
        if route == "dense":
            mat = pairwise_dist(i)
            cart = LT.cartesian_loss_matrix(mat, pairwise_dist(o), pt)
            cdist = LT.cartesian_distance_loss_matrix(mat, lat, pt)
        elif route == "analytic":
            cart, cdist = LT.cartesian_losses_analytic(i, o, lat, pt)
        else:  # ragged last block: 20 rows in blocks of 8
            cart, cdist = LT.cartesian_losses_blocked(i, o, lat, pt, block=8)
        (cart + cdist).backward()
        res[route] = (float(cart.detach()), float(cdist.detach()), o.grad.numpy(),
                      lat.grad.numpy())
    return res


@pytest.mark.parametrize("variant", VARIANTS)
def test_dense_analytic_blocked_agree_with_each_other_and_jax(variant):
    inp, out, latent = _coords()
    pj, pt = _params(variant)

    def jax_dense(o, lat):
        from encodermap_tpu.ops.distances import pairwise_dist

        mat = pairwise_dist(jnp.asarray(inp))
        cart = LJ.cartesian_loss_matrix(mat, pairwise_dist(o), pj)
        cdist = LJ.cartesian_distance_loss_matrix(mat, lat, pj)
        return cart + cdist, (cart, cdist)

    (_, (cj, dj)), (goj, glj) = jax.jit(jax.value_and_grad(jax_dense, (0, 1), has_aux=True))(
        jnp.asarray(out), jnp.asarray(latent))
    ref = (float(cj), float(dj), np.asarray(goj), np.asarray(glj))
    for route, got in _port_routes(inp, out, latent, pt).items():
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(),
                                       err_msg=route)


@pytest.mark.parametrize("variant", VARIANTS)
def test_analytic_backward_gradcheck_f64(variant):
    from encodermap_tpu_torch.ops.cartesian_analytic import cartesian_cost_analytic

    inp, out, _ = _coords(B=2, n=5, seed=1)
    o = torch.tensor(out, dtype=torch.float64, requires_grad=True)
    i = torch.tensor(inp, dtype=torch.float64)
    assert torch.autograd.gradcheck(lambda x: cartesian_cost_analytic(x, i, variant), (o,))


@pytest.mark.parametrize("variant", VARIANTS)
def test_analytic_f32_gradient_rule(variant):
    """err(port f32, f64) <= 3 err(JAX f32, f64); the f64 oracle is torch
    autograd through the dense distance matrices."""
    from encodermap_tpu.ops.cartesian_analytic import cartesian_cost_analytic as cj
    from encodermap_tpu_torch.ops.cartesian_analytic import cartesian_cost_analytic as ct
    from encodermap_tpu_torch.ops.distances import component_plane_dists

    inp, out, _ = _coords(B=4, n=40, seed=2)
    w = np.random.default_rng(3).uniform(0.5, 1.5, 4)

    def weight(acc, lib):
        return (acc * lib.asarray(w, dtype=acc.dtype)).sum() if variant == "mean_norm" \
            else acc
    o64 = torch.tensor(out, dtype=torch.float64, requires_grad=True)
    i64 = torch.tensor(inp, dtype=torch.float64)
    diff = component_plane_dists(i64, i64) - component_plane_dists(o64, o64)
    acc = {"mean_abs": lambda: diff.abs().sum(), "mean_square": lambda: diff.square().sum(),
           "mean_norm": lambda: diff.square().sum((1, 2))}[variant]()
    weight(acc, torch).backward()
    oracle = o64.grad.numpy()

    o32 = torch.tensor(out, requires_grad=True)
    weight(ct(o32, torch.tensor(inp), variant), torch).backward()
    gj = jax.jit(jax.grad(lambda o: weight(cj(o, jnp.asarray(inp), variant), jnp)))(
        jnp.asarray(out))
    err_port = np.abs(o32.grad.numpy() - oracle).max()
    err_jax = np.abs(np.asarray(gj) - oracle).max()
    assert err_port <= 3 * err_jax, (err_port, err_jax)


def test_flat_and_matrix_sigmoid_are_one_value_and_match_jax():
    from encodermap_tpu.ops.distances import pairwise_dist as pdj
    from encodermap_tpu_torch.ops.distances import pairwise_dist as pdt

    inp, out, latent = _coords(n=9)
    pj, pt = _params("mean_abs")
    flat = float(LT.cartesian_distance_loss(pdt(torch.tensor(inp), flat=True),
                                            torch.tensor(latent), pt))
    mat = float(LT.cartesian_distance_loss_matrix(pdt(torch.tensor(inp)),
                                                  torch.tensor(latent), pt))
    ref = float(LJ.cartesian_distance_loss(pdj(jnp.asarray(inp), flat=True),
                                           jnp.asarray(latent), pj))
    np.testing.assert_allclose([flat, mat], [ref, ref], rtol=RTOL)
    for variant in VARIANTS:
        pj, pt = _params(variant)
        a = LT.cartesian_loss(pdt(torch.tensor(inp), flat=True),
                              pdt(torch.tensor(out), flat=True), pt, scale=0.25)
        b = LJ.cartesian_loss(pdj(jnp.asarray(inp), flat=True),
                              pdj(jnp.asarray(out), flat=True), pj, scale=0.25)
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL)


def test_soft_start_scale_and_angle_family_match_jax():
    for soft in ((None, None), (3, 3), (2, 12)):
        pj, pt = _params("mean_abs", cartesian_cost_scale_soft_start=soft)
        for step in (0, 2, 3, 7, 12, 20):
            assert float(LT.soft_start_scale(pt, step)) == float(
                LJ.soft_start_scale(pj, jnp.asarray(step)))
    rng = np.random.default_rng(4)
    a, b = rng.uniform(-np.pi, np.pi, (2, 8, 5)).astype(np.float32)
    pj, pt = _params("mean_abs", angle_cost_scale=2.0, angle_cost_reference=0.5,
                     dihedral_cost_variant="mean_square", side_dihedral_cost_variant="mean_norm")
    for name in ("angle_loss", "dihedral_loss", "side_dihedral_loss"):
        np.testing.assert_allclose(
            float(getattr(LT, name)(torch.tensor(a), torch.tensor(b), pt)),
            float(getattr(LJ, name)(jnp.asarray(a), jnp.asarray(b), pj)), rtol=1e-6)


def test_component_plane_dists_match_jax():
    from encodermap_tpu.ops.distances import component_plane_dists as cj
    from encodermap_tpu_torch.ops.distances import component_plane_dists as ct

    inp, out, _ = _coords(B=3, n=7)
    inp[:, 3] = inp[:, 2]  # a coincident pair: guarded to an exact zero
    got = ct(torch.tensor(inp[:, :4]), torch.tensor(inp)).numpy()
    np.testing.assert_allclose(got, np.asarray(cj(jnp.asarray(inp[:, :4]), jnp.asarray(inp))),
                               atol=1e-6)
    assert (got[:, 2, 3] == 0).all() and (got[:, 3, 3] == 0).all()


def test_kabsch_rmsd_and_align_match_jax():
    kj = importlib.import_module("encodermap_tpu.ops.kabsch")
    kt = importlib.import_module("encodermap_tpu_torch.ops.kabsch")
    from encodermap_tpu.train.metrics import rmsd_numpy as rn_j
    from encodermap_tpu_torch.train.metrics import rmsd_numpy as rn_t

    inp, out, _ = _coords(B=5, n=12, seed=6)
    # a rotated, shifted, noisy copy, and a mirror image (the reflection fix)
    out[3] = inp[3] @ np.diag([1.0, 1.0, -1.0]).astype(np.float32)
    w = np.random.default_rng(7).uniform(1, 3, 12).astype(np.float32)
    for W in (None, w):
        got = kt.rmsd(torch.tensor(inp), torch.tensor(out),
                      None if W is None else torch.tensor(W)).numpy()
        ref = np.asarray(jax.jit(kj.rmsd)(jnp.asarray(inp), jnp.asarray(out),
                                          None if W is None else jnp.asarray(W)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rn_t(inp, out), rn_j(inp, out), rtol=1e-5, atol=1e-6)
    got = kt.align_frames(torch.tensor(out), torch.tensor(inp[0]), atom_indices=[0, 2, 4, 6],
                          ref_atom_indices=[1, 3, 5, 7]).numpy()
    ref = np.asarray(kj.align_frames(out, inp[0], atom_indices=np.array([0, 2, 4, 6]),
                                     ref_atom_indices=np.array([1, 3, 5, 7])))
    np.testing.assert_allclose(got, ref, atol=1e-5)
