# tests/test_torch_fused_train.py
"""The fused train kernel's module (ops/fused_train.py) against the JAX
package's ops/pallas_train.py.

On the CPU ``fused_chunk`` runs the kernel's plain version (hand_step plus
clip and Adam, looped over the steps). It is held against the JAX Pallas
kernel in interpret mode and against JAX's hand_step + _adam_update, as
tests/test_pallas_train.py holds the JAX kernel; hand_step's gradients are
held against a float64 autograd oracle. The CUDA kernel itself is compared
with the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances: float32 sums in another order than XLA's. Parameters agree to
2e-5 (Adam divides each gradient by its magnitude, so near-zero gradient
elements amplify rounding), losses to 2e-4 absolute (the JAX test's own
bound). Periodic runs also carry the JAX kernel's polynomial atan2 (error
up to ~2.4e-7, pallas_train.py:49-67) where the port takes the native
atan2."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodermap_tpu.ops import pallas_train as PT
import encodermap_tpu_torch as emt
from encodermap_tpu_torch.ops import _build
from encodermap_tpu_torch.ops import fused_train as FT

torch.set_num_threads(1)

LOSSES = dict(dist_sig_parameters=(4.5, 12, 6, 1, 2, 6), auto_cost_scale=1.0,
              center_cost_scale=1e-4, l2_reg_constant=1e-3,
              distance_cost_scale=500.0)


def _net(rng, d_in, periodic, width=16, scale=0.2):
    """Flat kernel-layout weights [enc_w, dec_w, enc_b(1,d), dec_b(1,d)]."""
    x0 = 2 * d_in if periodic else d_in
    dims = [x0, width, width, 2]
    dd = dims[::-1]
    ws = ([rng.standard_normal((a, b)) * scale for a, b in zip(dims[:-1], dims[1:])]
          + [rng.standard_normal((a, b)) * scale for a, b in zip(dd[:-1], dd[1:])])
    bs = ([rng.standard_normal((1, b)) * 0.05 for b in dims[1:]]
          + [rng.standard_normal((1, b)) * 0.05 for b in dd[1:]])
    return [np.asarray(a, np.float32) for a in ws + bs]


def _case(periodic, steps, B, seed):
    rng = np.random.default_rng(seed)
    d0 = 4 if periodic else 3
    flat = _net(rng, d0, periodic)
    data = (rng.uniform(-np.pi, np.pi, (200, d0)) if periodic
            else rng.standard_normal((200, d0))).astype(np.float32)
    idx = rng.integers(0, len(data), (steps, B))
    losses = dict(LOSSES, periodicity=2 * np.pi if periodic else float("inf"))
    return flat, data, idx, dict(learning_rate=1e-3, losses=losses)


def _port_chunk(flat, data, idx, hyper, step0=0.0):
    p = [torch.tensor(a) for a in flat]
    z = [torch.zeros_like(t) for t in p]
    return FT.fused_chunk(p, z, z, step0, torch.tensor(data), torch.tensor(idx),
                          n_enc=3, hyper=hyper)


@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_plain_chunk_matches_jax_pallas_interpret(periodic):
    flat, data, idx, hyper = _case(periodic, steps=4, B=32, seed=42)
    jflat = [jnp.asarray(a) for a in flat]
    jz = [jnp.zeros_like(a) for a in jflat]
    jp, jm, jv, jmet = PT.fused_chunk(jflat, jz, jz, 0.0, jnp.asarray(data[idx]),
                                      n_enc=3, hyper=hyper, interpret=True)
    tp, tm, tv, tmet = _port_chunk(flat, data, idx, hyper)
    for a, b in zip(tp + tm + tv, jp + jm + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    np.testing.assert_allclose(tmet.numpy(), np.asarray(jmet), atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_plain_chunk_matches_jax_hand_step_and_adam(periodic):
    """20 steps of the port against JAX's hand_step + _adam_update applied
    step by step (the oracle of the JAX kernel's own test), from step 7."""
    flat, data, idx, hyper = _case(periodic, steps=20, B=64, seed=3)
    p = [jnp.asarray(a) for a in flat]
    m = [jnp.zeros_like(a) for a in p]
    v = [jnp.zeros_like(a) for a in p]
    mets = []
    step_j = jax.jit(lambda ws, b: PT.hand_step(ws[:3], [x[0] for x in ws[6:9]],
                                                ws[3:6], [x[0] for x in ws[9:]],
                                                b, **hyper["losses"]))
    for s in range(idx.shape[0]):
        gew, geb, gdw, gdb, met = step_j(p, jnp.asarray(data[idx[s]]))
        grads = list(gew) + list(gdw) + [g[None] for g in geb] + [g[None] for g in gdb]
        for i in range(12):
            p[i], m[i], v[i] = PT._adam_update(p[i], m[i], v[i], grads[i],
                                               float(7 + s + 1), 1e-3)
        mets.append(met)
    tp, tm, tv, tmet = _port_chunk(flat, data, idx, hyper, step0=7.0)
    for a, b in zip(tp + tm + tv, p + m + v):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    np.testing.assert_allclose(tmet.numpy(), np.asarray(jnp.stack(mets)),
                               atol=2e-4, rtol=1e-5)


def _hand_grads(flat, batch, losses):
    ws, bs = flat[:6], [b[0] for b in flat[6:]]
    gew, geb, gdw, gdb, met = FT.hand_step(ws[:3], bs[:3], ws[3:], bs[3:], batch,
                                           **losses)
    return list(gew) + list(gdw) + list(geb) + list(gdb), met


@pytest.mark.parametrize("sig", [(4.5, 12, 6, 1, 2, 6), (4.5, 12, 6, 1, 3, 4),
                                 (3.0, 6, 3, 1.5, 4, 4)], ids=str)
@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_hand_step_gradients_against_f64_oracle(periodic, sig):
    """In float64 hand_step's gradients equal autograd of its own forward;
    in float32 they are no further from that oracle than 3x the JAX
    package's float32 hand_step (plus 1e-7 for noise at tiny errors)."""
    flat, data, idx, hyper = _case(periodic, steps=1, B=48, seed=11)
    losses = dict(hyper["losses"], dist_sig_parameters=sig)
    batch = data[idx[0]]
    f64 = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in flat]
    b64 = torch.tensor(batch, dtype=torch.float64)
    hand64, met64 = _hand_grads(f64, b64, losses)
    bias_grads = [f64[i] for i in range(6, 12)]
    oracle = torch.autograd.grad(met64[-1], f64[:6] + bias_grads)
    for h, o in zip(hand64, oracle):
        np.testing.assert_allclose(h.detach().numpy().reshape(o.shape),
                                   o.numpy(), rtol=1e-9, atol=1e-11)

    with torch.no_grad():
        hand32, _ = _hand_grads([torch.tensor(a) for a in flat], torch.tensor(batch),
                                losses)
    j32 = PT.hand_step([jnp.asarray(a) for a in flat[:3]],
                       [jnp.asarray(a[0]) for a in flat[6:9]],
                       [jnp.asarray(a) for a in flat[3:6]],
                       [jnp.asarray(a[0]) for a in flat[9:]], jnp.asarray(batch),
                       **losses)
    jgrads = list(j32[0]) + list(j32[2]) + list(j32[1]) + list(j32[3])
    for h, j, o in zip(hand32, jgrads, oracle):
        o = o.numpy().reshape(h.shape)
        err_t = np.abs(h.numpy() - o).max()
        err_j = np.abs(np.asarray(j).reshape(h.shape) - o).max()
        assert err_t <= 3 * err_j + 1e-7, (err_t, err_j)


def test_config_gates():
    p = emt.Parameters(periodicity=float("inf"))
    params = {"encoder": [{"kernel": torch.zeros(3, 4)}], "decoder": [{}]}
    assert FT.config_covered(p, params, 3)
    assert not FT.config_covered(p, dict(params, decoder=[]), 3)
    assert not FT.fused_trainer_available(p, params, 3)  # CPU tensors
    assert not FT.fused_trainer_available(p, None)
    assert not FT.config_covered(p, dict(params, densifier={}), 3)
    assert not FT.config_covered(p, params, 33)
    assert FT.config_covered(emt.Parameters(periodicity=2 * math.pi), params, 32)
    for change in (dict(activation_functions=["", "relu", "tanh", ""]),
                   dict(auto_cost_variant="mean_square"),
                   dict(compute_dtype="bfloat16"), dict(center_cost_scale=None)):
        assert not FT.config_covered(emt.Parameters(**change), params, 3)


def test_split_join_round_trip():
    p = emt.Parameters(n_neurons=[8, 2], activation_functions=["", "tanh", ""],
                       periodicity=float("inf"))
    from encodermap_tpu_torch.models import sequential as seq

    params = seq.init_params(torch.Generator().manual_seed(0), p, 3)
    flat, n_enc = FT.split_params(params)
    assert n_enc == 2 and tuple(flat[-1].shape) == (1, 3)
    back = FT.join_params(flat, n_enc, 2)
    for part in ("encoder", "decoder"):
        for a, b in zip(back[part], params[part]):
            assert torch.equal(a["kernel"], b["kernel"])
            assert torch.equal(a["bias"], b["bias"])


@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_fused_trainer_matches_general_route(tmp_path, periodic):
    """On the CPU the fused trainer (through the plain version) and the
    general autograd trainer take the same steps from the same state and
    indices, and leave the same Adam-state layout."""
    data = (np.random.default_rng(0).uniform(-np.pi, np.pi, (300, 4)) if periodic
            else emt.create_n_cube(3, points_along_edge=30, seed=0)[0])
    p = emt.Parameters(main_path=str(tmp_path), n_neurons=[16, 16, 2],
                       periodicity=2 * np.pi if periodic else float("inf"),
                       batch_size=32, steps_per_scan=8, n_steps=8, seed=1)
    emap = emt.EncoderMap(p, data, device="cpu", read_only=True)
    assert emap._maybe_fused_trainer(8) is None  # CPU: the general route
    idx = torch.as_tensor(np.random.default_rng(1).integers(0, len(data), (8, 32)))
    dev = emap._device_data()
    s_gen, m_gen = emap._get_trainer(8)(emap.state, dev, idx)
    before = dict(_build.launch_counts)
    s_fus, m_fus = FT.make_fused_trainer(p, 8, 32)(emap.state, dev, idx)
    assert dict(_build.launch_counts) == before
    for k in FT.METRIC_NAMES:
        np.testing.assert_allclose(m_fus[k].numpy(), m_gen[k].numpy(), rtol=2e-5,
                                   atol=1e-7)
    assert s_fus.step == s_gen.step == 8
    assert s_fus.opt_state["count"] == s_gen.opt_state["count"] == 8
    for part in ("encoder", "decoder"):
        for a, b in zip(s_fus.params[part], s_gen.params[part]):
            for name in ("kernel", "bias"):
                assert a[name].shape == b[name].shape
                np.testing.assert_allclose(a[name].numpy(), b[name].numpy(), atol=2e-5)


def _main_dims(periodic):
    """[128,128,2] on 3 cube columns or 4 periodic ones (sin/cos: 8 wide)."""
    w = 8 if periodic else 3
    return [w, 128, 128, 2, 128, 128, w], (4 if periodic else 3)


@pytest.mark.parametrize("periodic,width,act_bytes,gathered", [
    (True, 530, 33920, 6144), (False, 520, 33280, 5120)], ids=["periodic", "cube"])
def test_cluster_footprint_matches_design_table(periodic, width, act_bytes, gathered):
    """At [128,128,2], B=256, periodic d0=4 (cube d0=3): R = 256 / 16 rows
    of 530 (520) activations, two 128-wide delta buffers, every row's raw
    input and latent (6,144 or 5,120 bytes), two weight buffers that each
    hold a 128 x 128 layer at a row stride of 132 floats (or its 129 x 128
    partial gradients), and both halves of the own rows' pair terms."""
    dims, d0 = _main_dims(periodic)
    f = FT.cluster_footprint(dims, 3, 256, d0)
    assert FT.CLUSTER == 16
    assert sum(dims) == width
    assert f["activations"] == act_bytes == 16 * width * 4
    assert f["deltas"] == 2 * 16 * 128 * 4 == 16384
    assert f["gathered"] == 256 * (d0 + 2) * 4 == gathered
    assert f["weights"] == 2 * 128 * 132 * 4
    assert f["total"] == sum(v for k, v in f.items() if k != "total")
    assert f["total"] <= FT.MAX_SMEM_BYTES
    assert f["pairs"] == 2 * 16 * 128 * 4


@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_fused_route_by_shape(periodic):
    """The main configuration (B=256) takes the cluster kernel; batches
    whose rows outgrow one CTA's shared memory take the grid kernel."""
    dims, d0 = _main_dims(periodic)

    def need(B):
        return FT.cluster_footprint(dims, 3, B, d0)["total"]

    assert need(256) <= FT.MAX_SMEM_BYTES
    assert FT.fused_route(dims, 3, 256, d0) == "fused_train_cluster"
    for B in (1024, 4096):
        assert need(B) > FT.MAX_SMEM_BYTES
        assert FT.fused_route(dims, 3, B, d0) == "fused_train"
    # the footprint grows with the rows a CTA holds
    assert need(512) > need(256)


def test_cluster_footprint_refuses_past_layer_table():
    sixteen = [3] + [8] * 15 + [3]
    assert len(sixteen) - 1 == FT.MAX_LAYERS
    assert FT.fused_route(sixteen, 8, 256, 3) == "fused_train_cluster"
    seventeen = [3] + [8] * 16 + [3]
    with pytest.raises(ValueError, match="layer table"):
        FT.cluster_footprint(seventeen, 9, 256, 3)
    with pytest.raises(ValueError, match="layer table"):
        FT.fused_route(seventeen, 9, 256, 3)
