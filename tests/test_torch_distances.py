# tests/test_torch_distances.py
"""The port's distance functions against encodermap_tpu.ops.distances:
values and gradients on the same numpy inputs, including the zero-distance
guards and both branches of dsig_over_r.

Tolerances: float32 results agree to 1e-6 absolute/relative (the two
packages take the same formulas with float32 roundings in another order);
the Gram-identity paths (d >= 16) to 2e-5, since their cancellation error
scales with the squared norms (values of ~10 here)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodermap_tpu.ops import distances as jd
from encodermap_tpu_torch.ops import distances as td

torch.set_num_threads(1)

SIGS = [(4.5, 12, 6), (1, 2, 6), (1, 3, 4), (1.5, 1, 2), (2.0, 2.5, 3.0)]


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b), rtol=tol, atol=tol)


def test_sqrt_guard_value_and_zero_gradient():
    d2 = np.array([0.0, 1e-8, 0.25, 4.0], np.float32)
    x = _t(d2, grad=True)
    y = td.sqrt_guard(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    _close(y, jd.sqrt_guard(jnp.asarray(d2)))
    _close(g, jax.grad(lambda v: jd.sqrt_guard(v).sum())(jnp.asarray(d2)), 1e-5)
    assert float(y[0].detach()) == 0.0 and float(g[0]) == 0.0


@pytest.mark.parametrize("sig", SIGS, ids=str)
def test_sigmoid_and_sig_value(sig):
    r = np.random.default_rng(0).uniform(0.0, 8.0, 64).astype(np.float32)
    r[0] = 0.0
    _close(td.sigmoid(*sig)(_t(r)), jd.sigmoid(*sig)(jnp.asarray(r)))
    _close(td.sig_value(_t(r), *sig), jd.sig_value(jnp.asarray(r), *sig))


@pytest.mark.parametrize("sig", SIGS, ids=str)
def test_dsig_over_r_both_branches(sig):
    """a == 2 takes the smooth form, other a the guarded one; both are zero
    or finite at r = 0 and match the JAX package elsewhere."""
    r = np.random.default_rng(1).uniform(0.05, 6.0, 64).astype(np.float32)
    r[:2] = 0.0
    r2 = r * r
    out = td.dsig_over_r(_t(r2), _t(r), *sig)
    ref = jd.dsig_over_r(jnp.asarray(r2), jnp.asarray(r), *sig)
    _close(out, ref, 2e-6)
    assert torch.isfinite(out).all()
    if sig[1] != 2:
        assert float(out[0]) == 0.0


@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi, 7.0])
def test_periodic_distance(periodicity):
    rng = np.random.default_rng(2)
    a, b = rng.uniform(-4, 4, (2, 50)).astype(np.float32)
    _close(td.periodic_distance(_t(a), _t(b), periodicity),
           jd.periodic_distance(jnp.asarray(a), jnp.asarray(b), periodicity))


def _value_and_grad_pair(tfn, jfn, x):
    xt = _t(x, grad=True)
    yt = tfn(xt)
    w = np.random.default_rng(3).standard_normal(tuple(yt.shape)).astype(np.float32)
    (gt,) = torch.autograd.grad((yt * _t(w)).sum(), xt)
    yj, vjp = jax.vjp(jfn, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(w))
    return yt, gt, yj, gj


@pytest.mark.parametrize("d,method,flat,squared", [
    (2, "auto", False, False), (3, "auto", False, True), (3, "auto", True, False),
    (20, "auto", False, False), (3, "gram", False, False), (20, "direct", False, False),
])
def test_pairwise_dist(d, method, flat, squared):
    x = np.random.default_rng(4).standard_normal((24, d)).astype(np.float32)
    gram = (d >= 16 and method == "auto") or method == "gram"
    if not gram:
        # a duplicate point: zero distance off the diagonal, where the
        # guard gives value 0 and gradient 0 (a Gram product does not
        # cancel to an exact zero there in either package)
        x[5] = x[4]
    tol = 2e-5 if gram else 1e-6
    yt, gt, yj, gj = _value_and_grad_pair(
        lambda v: td.pairwise_dist(v, squared=squared, flat=flat, method=method),
        lambda v: jd.pairwise_dist(v, squared=squared, flat=flat, method=method), x)
    assert tuple(yt.shape) == yj.shape
    _close(yt, yj, tol)
    _close(gt, gj, 50 * tol)
    assert torch.isfinite(gt).all()


@pytest.mark.parametrize("d", [3, 20])
@pytest.mark.parametrize("periodicity", [2 * math.pi, float("inf")])
def test_pairwise_dist_periodic(d, periodicity):
    """Elementwise below 16 dims, the min-image Gram split from 16 on."""
    x = np.random.default_rng(5).uniform(-3, 3, (24, d)).astype(np.float32)
    tol = 2e-5 if d >= 16 and math.isfinite(periodicity) else 1e-6
    yt, gt, yj, gj = _value_and_grad_pair(
        lambda v: td.pairwise_dist_periodic(v, periodicity),
        lambda v: jd.pairwise_dist_periodic(v, periodicity), x)
    _close(yt, yj, tol)
    _close(gt, gj, 50 * tol)


def test_pairwise_dist_periodic_zero_guard():
    """Coincident points get the 1e-12 guard per zero component and after
    the sqrt, as in the JAX package. (Their gradients differ: JAX takes
    |x|' = 1 at 0, torch 0; the high-D side this serves is never
    differentiated in training.)"""
    x = np.random.default_rng(6).uniform(-3, 3, (8, 3)).astype(np.float32)
    x[3] = x[2]
    y = td.pairwise_dist_periodic(_t(x), 2 * math.pi)
    _close(y, jd.pairwise_dist_periodic(jnp.asarray(x), 2 * math.pi))
    assert 0.0 < float(y[2, 3]) < 1e-11
