# tests/test_torch_sequential.py
"""The port's MLP autoencoder against encodermap_tpu.models.sequential.

The initializers draw other numbers than JAX's (torch.Generator vs
threefry), so they are compared by distribution. Forward and backward are
compared on the same weights, copied across with ``convert.py``, for
periodic and non-periodic data. Tolerance: 2e-5 relative/absolute for
float32 values and gradients of a few 16-wide layers (the products sum in
another order than XLA's)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
from encodermap_tpu import nn as jnn
from encodermap_tpu.models import sequential as jseq
import encodermap_tpu_torch as emt
from encodermap_tpu_torch import nn as tnn
from encodermap_tpu_torch.convert import params_from_numpy, params_to_numpy
from encodermap_tpu_torch.models import sequential as tseq

torch.set_num_threads(1)

TOL = 2e-5


def test_dense_init_distribution():
    """VarianceScaling fan_in truncated normal kernels (std sqrt(1/fan_in),
    cut at two std), RandomNormal(0.1, 0.05) biases."""
    gen = torch.Generator().manual_seed(0)
    fan_in = 64
    layer = tnn.dense_init(gen, fan_in, 4096)
    k, b = layer["kernel"], layer["bias"]
    ref = jnn.dense_init(jax.random.PRNGKey(0), fan_in, 4096)
    assert k.shape == ref["kernel"].shape and b.shape == ref["bias"].shape
    std = math.sqrt(1.0 / fan_in)
    assert abs(float(k.std()) - std) < 0.02 * std
    assert abs(float(np.asarray(ref["kernel"]).std()) - std) < 0.02 * std
    assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(k.mean())) < 0.01 * std
    assert abs(float(b.mean()) - 0.1) < 0.005 and abs(float(b.std()) - 0.05) < 0.005


@pytest.mark.parametrize("periodic", [False, True])
def test_init_params_shapes_match(periodic):
    p_kw = dict(n_neurons=[16, 16, 2],
                periodicity=2 * math.pi if periodic else float("inf"))
    tp = tseq.init_params(torch.Generator().manual_seed(1), emt.Parameters(**p_kw), 5)
    jp = jseq.init_params(jax.random.PRNGKey(1), emj.Parameters(**p_kw), 5)
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert params_to_numpy(tp)[0].keys() == shapes.keys()
    for part in ("encoder", "decoder"):
        for lt, lj in zip(tp[part], shapes[part]):
            assert tuple(lt["kernel"].shape) == lj["kernel"]
            assert tuple(lt["bias"].shape) == lj["bias"]


def _setup(periodic, compute_dtype="float32"):
    rng = np.random.default_rng(7)
    kw = dict(n_neurons=[16, 16, 2], compute_dtype=compute_dtype,
              periodicity=2 * math.pi if periodic else float("inf"))
    pj, pt = emj.Parameters(**kw), emt.Parameters(**kw)
    params_j = jseq.init_params(jax.random.PRNGKey(3), pj, 5)
    tree = jax.tree_util.tree_map(np.asarray, params_j)
    x = (rng.uniform(-np.pi, np.pi, (32, 5)) if periodic
         else rng.standard_normal((32, 5))).astype(np.float32)
    return pj, pt, params_j, tree, x


@pytest.mark.parametrize("periodic", [False, True])
def test_encode_decode_forward(periodic):
    pj, pt, params_j, tree, x = _setup(periodic)
    params_t, _ = params_from_numpy(tree)
    zt = tseq.encode(params_t, pt, torch.from_numpy(x))
    zj = jseq.encode(params_j, pj, jnp.asarray(x))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tseq.decode(params_t, pt, zt).numpy(),
                               np.asarray(jseq.decode(params_j, pj, zj)),
                               rtol=TOL, atol=TOL)


def test_bf16_compute_dtype_matches():
    """bf16 operands with float32 accumulation, as XLA's
    preferred_element_type=float32 computes them."""
    pj, pt, params_j, tree, x = _setup(False, "bfloat16")
    params_t, _ = params_from_numpy(tree)
    zt = tseq.encode(params_t, pt, torch.from_numpy(x))
    zj = jseq.encode(params_j, pj, jnp.asarray(x))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-3, atol=1e-3)
    z32 = tseq.encode(params_t, emt.Parameters(n_neurons=[16, 16, 2],
                                               periodicity=float("inf")),
                      torch.from_numpy(x))
    assert float((zt - z32).abs().max()) > 0  # the bf16 path really rounds


@pytest.mark.parametrize("periodic", [False, True])
def test_forward_backward_gradients(periodic):
    """Gradients of a reconstruction + center + L2 objective in the weights,
    through the sin/cos fold-in and the atan2 fold-out."""
    pj, pt, params_j, tree, x = _setup(periodic)

    def loss_j(params):
        z = jseq.encode(params, pj, jnp.asarray(x))
        out = jseq.decode(params, pj, z)
        return (jnp.mean(jnp.square(out - x)) + jnp.mean(z * z)
                + 1e-3 * jseq.regularization_sum(params))

    gj = jax.grad(loss_j)(params_j)
    params_t, _ = params_from_numpy(tree)
    for leaf in jax.tree_util.tree_leaves(params_t):
        leaf.requires_grad_(True)
    z = tseq.encode(params_t, pt, torch.from_numpy(x))
    out = tseq.decode(params_t, pt, z)
    loss = (torch.mean(torch.square(out - torch.from_numpy(x))) + torch.mean(z * z)
            + 1e-3 * tseq.regularization_sum(params_t))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j(params_j)), rtol=TOL)
    for part in ("encoder", "decoder"):
        for lt, lj in zip(params_t[part], gj[part]):
            for name in ("kernel", "bias"):
                np.testing.assert_allclose(lt[name].grad.numpy(), np.asarray(lj[name]),
                                           rtol=1e-4, atol=TOL)


def test_densify_and_sparse_params():
    pt = emt.Parameters(n_neurons=[8, 2], activation_functions=["", "tanh", ""],
                        periodicity=float("inf"))
    params = tseq.init_params(torch.Generator().manual_seed(0), pt, 4, sparse=True)
    assert tuple(params["densifier"]["kernel"].shape) == (4, 4)
    x = torch.tensor([[1.0, float("nan"), 2.0, 0.5]])
    y = tseq.densify(params, x)
    assert torch.isfinite(y).all()
    assert tseq.densify({"encoder": []}, x) is x


def test_sequential_model_module():
    p = emt.Parameters(n_neurons=[16, 16, 2], periodicity=float("inf"), seed=4)
    model = emt.gen_sequential_model(5, p, device="cpu")
    assert isinstance(model, torch.nn.Module)
    n = sum(t.numel() for t in model.parameters())
    assert n == sum(v.numel() for v in jax.tree_util.tree_leaves(model.params))
    x = np.random.default_rng(0).standard_normal((10, 5)).astype(np.float32)
    out = model(x)
    assert out.shape == (10, 5)
    out.sum().backward()
    assert all(t.grad is not None for t in model.parameters())
    with pytest.raises(TypeError):
        emt.gen_sequential_model(5, emt.ADCParameters(), device="cpu")


def test_convert_round_trip_with_adam_state():
    tree = jax.tree_util.tree_map(
        np.asarray, jseq.init_params(jax.random.PRNGKey(0),
                                     emj.Parameters(n_neurons=[8, 2],
                                                    activation_functions=["", "tanh", ""]),
                                     3))
    mu = jax.tree_util.tree_map(lambda a: a * 0.5, tree)
    nu = jax.tree_util.tree_map(lambda a: a * a, tree)
    params, opt = params_from_numpy(tree, mu, nu, count=np.int32(7))
    assert opt["count"] == 7
    back, mu2, nu2, count = params_to_numpy(params, opt)
    for a, b in zip(jax.tree_util.tree_leaves((tree, mu, nu)),
                    jax.tree_util.tree_leaves((back, mu2, nu2))):
        np.testing.assert_array_equal(a, b)
    assert count == 7
    assert params_from_numpy(tree)[1] is None
