# tests/test_torch_fused_sigmoid.py
"""The sigmoid-loss kernels' module (ops/fused_sigmoid.py) against the JAX
package.

On the CPU the port's wrappers run the kernels' plain versions; they are
held against the JAX Pallas kernel run in interpret mode (as
tests/test_pallas_sigmoid.py runs it) and against ``losses.sigmoid_loss``'s
XLA path, for values and latent gradients, a != 2 sigmoids and duplicate
points. The CUDA kernels themselves are compared with the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the JAX kernel takes distances by the Gram identity, the port by
direct differences; over B = 512 pairs of 30-wide rows that costs up to
~1e-5 relative on the value and 1e-4 relative (to the largest entry) on the
latent gradient, the bounds tests/test_pallas_sigmoid.py itself holds the
JAX kernel to against the XLA path. Against the XLA path at small B (same
formulas) values agree to 1e-6 and gradients to 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodermap_tpu import losses as JL
from encodermap_tpu.ops import pallas_sigmoid as ps
from encodermap_tpu_torch import losses as TL
from encodermap_tpu_torch.ops import _build
from encodermap_tpu_torch.ops import fused_sigmoid as fs

torch.set_num_threads(1)

PARAMS = [(5.9, 12.0, 4.0, 1.0, 2.0, 4.0), (4.5, 6.0, 10.0, 1.0, 3.0, 7.0)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _data(B, D, periodic, seed=0, duplicate=False):
    rng = np.random.default_rng(seed)
    h = (rng.uniform(-np.pi, np.pi, (B, D)) if periodic
         else rng.normal(size=(B, D))).astype(np.float32)
    l = rng.normal(size=(B, 2)).astype(np.float32)
    if duplicate:
        h[1], l[1] = h[0], l[0]
        l[3] = l[2]  # same latent point, different inputs
    return h, l


def _port(h, l, params, periodicity):
    lt = torch.tensor(l, requires_grad=True)
    val = fs.fused_sigmoid_loss(torch.tensor(h), lt, params, periodicity)
    (g,) = torch.autograd.grad(val, lt)
    return float(val.detach()), g.numpy()


@pytest.mark.parametrize("params", PARAMS, ids=["a_l=2", "a_l=3"])
@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
@pytest.mark.parametrize("duplicate", [False, True], ids=["distinct", "duplicates"])
def test_plain_matches_jax_pallas_interpret(interpret, params, periodicity, duplicate):
    h, l = _data(512, 30, math.isfinite(periodicity), duplicate=duplicate)
    val_j, g_j = jax.value_and_grad(
        lambda x: ps.fused_sigmoid_loss(jnp.asarray(h), x, params, periodicity))(
        jnp.asarray(l))
    val_t, g_t = _port(h, l, params, periodicity)
    assert abs(val_t - float(val_j)) <= 1e-5 * abs(float(val_j))
    g_j = np.asarray(g_j)
    assert np.isfinite(g_t).all()
    assert np.abs(g_t - g_j).max() <= 1e-4 * np.abs(g_j).max()


@pytest.mark.parametrize("params", PARAMS, ids=["a_l=2", "a_l=3"])
@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
def test_plain_matches_jax_xla_path(params, periodicity):
    """Same formulas as ``losses.sigmoid_loss`` below its kernel threshold,
    with the zero mask on coincident latent points."""
    h, l = _data(48, 6, math.isfinite(periodicity), seed=1, duplicate=True)
    val_j, g_j = jax.value_and_grad(
        lambda x: JL.sigmoid_loss(jnp.asarray(h), x, params, periodicity))(
        jnp.asarray(l))
    val_t, g_t = _port(h, l, params, periodicity)
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-6)
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-5, atol=1e-7)


def test_h_gradient_is_exactly_zero():
    """The kernels' route gives ``h`` no gradient; materialised, it is the
    JAX kernel's exact zeros."""
    h, l = _data(32, 4, False)
    ht = torch.tensor(h, requires_grad=True)
    val = fs.fused_sigmoid_loss(ht, torch.tensor(l, requires_grad=True),
                                PARAMS[0], float("inf"))
    (g,) = torch.autograd.grad(val, ht, allow_unused=True, materialize_grads=True)
    assert torch.count_nonzero(g) == 0


@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
def test_router_below_threshold_is_the_general_path(periodicity):
    """``fused_or_reference`` (and so ``losses.sigmoid_loss``) takes the
    general path on the CPU, as the JAX router does below its threshold."""
    h, l = _data(64, 5, math.isfinite(periodicity), seed=2)
    out = float(TL.sigmoid_loss(torch.tensor(h), torch.tensor(l), PARAMS[0],
                                periodicity))
    ref = float(ps.fused_or_reference(jnp.asarray(h), jnp.asarray(l),
                                      PARAMS[0], periodicity))
    assert out == pytest.approx(ref, rel=1e-6)
    general = float(fs.sigmoid_loss_general(torch.tensor(h), torch.tensor(l),
                                            PARAMS[0], periodicity))
    assert out == general


def test_wrapper_routes_cpu_tensors_to_plain_version():
    h, l = _data(40, 3, False, seed=3)
    ht, lt = torch.tensor(h), torch.tensor(l)
    before = dict(_build.launch_counts)
    v = fs.sigmoid_loss_fwd(ht, lt, PARAMS[1], float("inf"))
    g = fs.sigmoid_loss_bwd(ht, lt, PARAMS[1], float("inf"))
    assert float(v) == float(fs.sigmoid_loss_fwd_plain(ht, lt, PARAMS[1], float("inf")))
    assert torch.equal(g, fs.sigmoid_loss_bwd_plain(ht, lt, PARAMS[1], float("inf")))
    assert dict(_build.launch_counts) == before  # no kernel launched
    with pytest.raises(ValueError):
        fs.sigmoid_loss_fwd(ht[:5], lt, PARAMS[1], float("inf"))
