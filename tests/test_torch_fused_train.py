# tests/test_torch_fused_train.py
"""The fused train kernel's module (ops/fused_train.py) against the JAX
package's ops/pallas_train.py.

On the CPU ``fused_chunk`` runs the kernel's plain version (hand_step plus
clip and Adam, looped over the steps). It is held against the JAX Pallas
kernel in interpret mode and against JAX's hand_step + _adam_update, as
tests/test_pallas_train.py holds the JAX kernel; hand_step's gradients are
held against a float64 autograd oracle. The CUDA kernel itself is compared
with the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py. A float32 numpy mirror of the cluster kernel's pair phase
(half of the pairs per row, each side's s from sigmoid_pairs.cuh's sums)
is held against hand_step's sketch-map term and its gradient, and near
u = 1 against a float64 evaluation.

Tolerances: float32 sums in another order than XLA's. Parameters agree to
2e-5 (Adam divides each gradient by its magnitude, so near-zero gradient
elements amplify rounding), losses to 2e-4 absolute (the JAX test's own
bound). Periodic runs also carry the JAX kernel's polynomial atan2 (error
up to ~2.4e-7, pallas_train.py:49-67) where the port takes the native
atan2."""

import math
import re
from pathlib import Path

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


def _case(periodic, steps, B, seed, width=16):
    rng = np.random.default_rng(seed)
    d0 = 4 if periodic else 3
    flat = _net(rng, d0, periodic, width=width)
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


@pytest.mark.parametrize("periodic,steps,B,width", [
    (False, 20, 64, 16), (True, 20, 64, 16), (False, 3, 24, 144), (True, 3, 24, 144)],
    ids=["cube", "periodic", "cube-144", "periodic-144"])
def test_plain_chunk_matches_jax_hand_step_and_adam(periodic, steps, B, width):
    """The port against JAX's hand_step + _adam_update applied step by step
    (the oracle of the JAX kernel's own test), from step 7: 20 steps at
    width 16, and 3 at [144,144,2], a width the grid kernel takes at the
    default batch (the cluster kernel cannot hold it at B=256)."""
    flat, data, idx, hyper = _case(periodic, steps=steps, B=B, seed=3, width=width)
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
    """The main configuration (B=256) takes the cluster kernel; from
    GRID_MIN_BATCH on the grid kernel, which the H100 runs faster there
    (B=288, where the cluster kernel would still fit), and batches whose
    rows outgrow one CTA's shared memory take the grid kernel too."""
    dims, d0 = _main_dims(periodic)

    def need(B):
        return FT.cluster_footprint(dims, 3, B, d0)["total"]

    assert FT.GRID_MIN_BATCH == 288
    assert need(256) <= FT.MAX_SMEM_BYTES and need(288) <= FT.MAX_SMEM_BYTES
    assert FT.fused_route(dims, 3, 256, d0) == "fused_train_cluster"
    assert FT.fused_route(dims, 3, 287, d0) == "fused_train_cluster"
    assert FT.fused_route(dims, 3, 288, d0) == "fused_train"
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


@pytest.mark.parametrize("width,B,route,footprint", [
    (128, 128, "fused_train_cluster", 168384), (128, 256, "fused_train_cluster", 208224),
    (144, 128, "fused_train_cluster", 206848), (144, 256, "fused_train", 249760),
    (256, 128, "fused_train", 590784), (256, 256, "fused_train", 655200)])
def test_fused_route_at_widths(width, B, route, footprint):
    """Width 128 takes the cluster kernel at the default B=256; width 144
    outgrows one cluster CTA from B=256 on and width 256 at any batch (its
    two staged 256-wide weight buffers alone exceed 227 KB), so both take
    the grid kernel below GRID_MIN_BATCH too."""
    dims = [3, width, width, 2, width, width, 3]
    assert FT.cluster_footprint(dims, 3, B, 3)["total"] == footprint
    assert FT.fused_route(dims, 3, B, 3) == route
    if footprint > FT.MAX_SMEM_BYTES:
        assert route == "fused_train"


_CUBE = [3, 128, 128, 2, 128, 128, 3]


@pytest.mark.parametrize("dims,B,d0,groups,rows,pair_tiles,total", [
    (_CUBE, 1024, 3, 16, 64, 136, 1386576),
    (_CUBE, 1000, 3, 16, 64, 136, 1373208),
    (_CUBE, 4096, 3, 26, 160, 2080, 4640002),
    (_CUBE, 16384, 3, 29, 576, 32896, 22270673),
    ([8, 128, 128, 2, 128, 128, 8], 1024, 4, 16, 64, 136, 1418400),
    ([3, 256, 256, 2, 256, 256, 3], 256, 3, 8, 32, 10, 1476392),
    ([3, 32, 16, 2, 16, 32, 3], 50, 3, 2, 32, 1, None)],
    ids=["cube-1024", "ragged-1000", "cube-4096", "cube-16384", "periodic-1024",
         "256-wide-256", "small-50"])
def test_grid_plan_matches_design_table(dims, B, d0, groups, rows, pair_tiles, total):
    """The grid kernel's plan at the timed shapes on a card that holds 30
    of its 8-CTA clusters (two CTAs on each of 120 SMs): as many row groups
    as 32-row tiles allow up to 30, each a whole number of tiles (B=1024:
    16 groups of 64 rows; B=16384: 29 of 576, the last 144), 64 x 64 pair
    tiles over the upper triangle, and the scratch: activations of every
    layer, two delta buffers of groups x rows x widest layer, the pair
    slots (one per row, latent component and partner tile), two steps of
    per-CTA metric sums, one weight-gradient slot per row group."""
    p = FT.grid_plan(dims, 3, B, d0, max_clusters=30)
    assert (p["cluster"], p["tile"], p["pair_tile"]) == (8, 32, 64)
    assert (p["groups"], p["rows"], p["ctas"]) == (groups, rows, 8 * groups)
    assert p["pair_tiles"] == pair_tiles
    assert (p["groups"] - 1) * p["rows"] < B <= p["groups"] * p["rows"]
    assert p["rows"] % 32 == 0
    nt = -(-B // 64)
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    f = p["floats"]
    assert f["activations"] == B * sum(dims)
    assert f["deltas"] == 2 * groups * rows * max(dims)
    assert f["pair_slots"] == nt * dims[3] * B
    assert f["grad_slots"] == groups * n_params
    assert f["partials"] == 2 * 8 * groups * 4
    assert f["total"] == sum(v for k, v in f.items() if k != "total")
    if total is not None:
        assert f["total"] == total


#: the scratch items of grid_plan by the C source's names for them
_PLAN_ITEMS = {"kPlanBatch": "batch", "kPlanActs": "activations", "kPlanDeltas": "deltas",
               "kPlanPairGrad": "pair_grad", "kPlanSlots": "pair_slots",
               "kPlanParts": "partials", "kPlanGradSlots": "grad_slots"}


@pytest.mark.parametrize("B", [50, 1024, 16384])
def test_grid_plan_array_is_what_the_kernel_reads(B):
    """The grid kernel takes its row groups, rows and scratch sizes from
    grid_plan: the array the wrapper passes holds them in the order of the
    source's ``enum Plan``, and the tile constants it declares are the
    source's own (``kCluster``, ``kTile``, ``kPair``)."""
    src = (Path(FT.__file__).parents[1] / "csrc" / "fused_train.cu").read_text()
    names = [n.strip() for n in re.search(r"enum Plan \{([^}]*)\}", src).group(1).split(",")]
    consts = dict(re.findall(r"constexpr int (kCluster|kTile|kPair) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "kCluster": FT.GRID_CLUSTER, "kTile": FT.GRID_TILE, "kPair": FT.PAIR_TILE}
    plan = FT.grid_plan(_CUBE, 3, B, 3, max_clusters=30)
    want = {"kPlanGroups": plan["groups"], "kPlanRows": plan["rows"], "kPlanCluster": 8,
            "kPlanTile": 32, "kPlanPair": 64,
            **{k: plan["floats"][v] for k, v in _PLAN_ITEMS.items()}}
    assert sorted(names) == sorted(want)
    assert list(FT._plan_array(plan)) == [want[n] for n in names]


def test_grid_plan_fits_the_clusters_the_card_holds():
    """Fewer co-resident clusters give fewer, taller row groups; the plan
    never asks for more clusters than the card holds, and refuses none."""
    for max_clusters in (1, 7, 16, 30, 64):
        for B in (1, 31, 32, 33, 255, 1000, 16384):
            p = FT.grid_plan(_CUBE, 3, B, 3, max_clusters)
            assert 1 <= p["groups"] <= max_clusters
            assert (p["groups"] - 1) * p["rows"] < B <= p["groups"] * p["rows"]
    with pytest.raises(ValueError, match="no cluster"):
        FT.grid_plan(_CUBE, 3, 256, 3, 0)
    with pytest.raises(ValueError, match="layer table"):
        FT.grid_plan([3] + [8] * 16 + [3], 9, 256, 3, 30)


# ------------------------- numpy mirror of the cluster kernel's pair phase
#: sigmoid parameters of the mirror's cases: the defaults (e = -0.5 and -3,
#: sig_s's sums), e = -1.5 on both sides (its half-integer sums) and a
#: non-integer a on both sides (powf for t; e = -4/7 keeps 1 - powf on the
#: high side, e = -2 takes a sum on the latent side, with t / r^2)
PAIR_SIGS = {"defaults": (4.5, 12, 6, 1, 2, 6), "e=-1.5": (4.5, 4, 6, 1, 2, 3),
             "powf a": (4.5, 10.5, 6, 1, 2.5, 5)}


def _cluster_pair_phase(x, lat, params, periodicity):
    """Float32 mirror of csrc/fused_train_cluster.cu's pair phase and
    pair_gradients: row i takes j = (i + t) mod B for t = 1 .. B/2 (t = B/2,
    for even B, only where i < B/2), each unordered pair once; both sides
    through the kernels' t and s (sig_t, sig_s: test_torch_fused_sigmoid's
    mirror), the high side's min-image distance without the sigmoid
    kernels' 1e-12 (hand_step's); m = (s_l - s_h) dscale u^(e-1) [t / r^2
    unless a == 2], 0 where the latent distance is 0. Returns the sigmoid
    loss (twice each pair's squared difference over B^2) and the latent
    gradient (4 / B^2) (sum_j m_ij l_i - sum_j m_ij l_j)."""
    from tests.test_torch_fused_sigmoid import F32, _side, _sig_s, _sig_t

    B = len(x)
    sh, sl = _side(*params[:3]), _side(*params[3:])
    hw = B // 2
    i, t = np.repeat(np.arange(B), hw), np.tile(np.arange(1, hw + 1), B)
    keep = ~((B % 2 == 0) & (i >= hw) & (t == hw))
    i, t = i[keep], t[keep]
    j = (i + t) % B
    assert len({(min(a, b), max(a, b)) for a, b in zip(i, j)}) == len(i) == B * (B - 1) // 2
    dh2 = np.zeros(len(i), F32)
    for k in range(x.shape[1]):
        d = x[i, k] - x[j, k]
        if math.isfinite(periodicity):
            d = np.abs(d)
            d = np.minimum(d, F32(periodicity) - d)
        dh2 = dh2 + d * d
    dl2 = np.zeros(len(i), F32)
    for k in range(lat.shape[1]):
        d = lat[i, k] - lat[j, k]
        dl2 = dl2 + d * d
    s_h, _, _ = _sig_s(sh, _sig_t(sh, dh2, False))
    tl = _sig_t(sl, dl2, False)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = tl / dl2
    s_l, y, iu = _sig_s(sl, tl)
    sdiff = s_l - s_h
    sig, a, b = params[3:]
    c = 2.0 ** (a / b) - 1.0
    gq = F32(b * c / sig ** 2 if a == 2 else b * c) * y * iu
    if a != 2:
        gq = gq * g
    m = np.where(dl2 != 0, sdiff * gq, F32(0))
    loss = float(np.sum(F32(2) * sdiff * sdiff, dtype=F32)) / (B * B)
    M = np.zeros((B, B), F32)
    M[i, j] = m
    M[j, i] = m
    return loss, F32(4.0 / (B * B)) * (M.sum(1)[:, None] * lat - M @ lat)


def _pair_case(periodic, B, seed):
    """Rows of d0 = 3 (cube) or 4 (periodic) columns and the weights of a
    linear encoder onto 2 latent columns, with a decoder back: the inputs
    of hand_step whose latent is x0 W + b."""
    rng = np.random.default_rng(seed)
    d0 = 4 if periodic else 3
    x = (rng.uniform(-np.pi, np.pi, (B, d0)) if periodic
         else rng.uniform(0.0, 8.0, (B, d0))).astype(np.float32)
    x0 = 2 * d0 if periodic else d0
    w = (rng.standard_normal((x0, 2)) / math.sqrt(x0)).astype(np.float32)
    bias = (rng.standard_normal(2) * 0.1).astype(np.float32)
    dec = (rng.standard_normal((2, x0)) * 0.5).astype(np.float32)
    return x, w, bias, dec


def _jax_hand_step_sigmoid(x, w, bias, dec, params, periodicity):
    """hand_step with every loss scale but the sketch-map one at zero:
    (its latent, its sigmoid loss, its gradient of the encoder's weights
    x0^T G and bias sum_i G_i, G the loss's latent gradient)."""
    periodic = math.isfinite(periodicity)
    xj = jnp.asarray(x)
    x0 = jnp.concatenate([jnp.sin(xj), jnp.cos(xj)], axis=1) if periodic else xj
    lat = jax.lax.dot_general(x0, jnp.asarray(w), (((1,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST) + jnp.asarray(bias)
    gew, geb, _, _, met = PT.hand_step(
        [jnp.asarray(w)], [jnp.asarray(bias)], [jnp.asarray(dec)],
        [jnp.zeros(dec.shape[1], jnp.float32)], xj, dist_sig_parameters=params,
        auto_cost_scale=0.0, center_cost_scale=0.0, l2_reg_constant=0.0,
        distance_cost_scale=1.0, periodicity=periodicity)
    return (np.asarray(lat), float(met[3]), np.asarray(gew[0]), np.asarray(geb[0]),
            np.asarray(x0))


@pytest.mark.parametrize("sig", list(PAIR_SIGS))
@pytest.mark.parametrize("B", [32, 33], ids=["B=32", "B=33"])
@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_cluster_pair_phase_matches_jax_hand_step(periodic, B, sig):
    """The mirror's loss and latent gradient against hand_step's (the JAX
    package's 1 - (1 + c t)^e, plain JAX on the CPU), which gives the
    gradient as the encoder's x0^T G and sum_i G_i, and per row against
    autodiff of the JAX package's sigmoid_loss on the same latent (its
    periodic 1e-12 guards move no float32 distance here). Tolerances: the
    two forms of s differ by a few ulp a pair, and the sums run in another
    order: the loss to 1e-5 relative, the latent gradient to 1e-5 of its
    largest entry, and each entry of x0^T G and sum_i G_i (whose rows
    cancel: sum_i G_i is zero but for rounding) to 1e-5 of the sum of its
    terms' magnitudes (measured: 2e-6, 1e-6 and 1e-6)."""
    from encodermap_tpu import losses as JL

    params = PAIR_SIGS[sig]
    periodicity = 2 * np.pi if periodic else float("inf")
    x, w, bias, dec = _pair_case(periodic, B, seed=B + 7 * periodic)
    lat, loss_j, gw_j, gb_j, x0 = _jax_hand_step_sigmoid(x, w, bias, dec, params,
                                                         periodicity)
    loss_m, g_m = _cluster_pair_phase(x, lat, params, periodicity)
    assert np.isfinite(g_m).all()
    assert abs(loss_m - loss_j) <= 1e-5 * abs(loss_j), (loss_m, loss_j)
    # [x0, 1]^T G: hand_step's gradients of the encoder's kernel and bias
    a = np.concatenate([x0, np.ones((B, 1), np.float32)], axis=1).astype(np.float64)
    got, want = a.T @ g_m, np.concatenate([gw_j, gb_j[None]])
    assert (np.abs(got - want) <= 1e-5 * (np.abs(a).T @ np.abs(g_m))).all(), (got, want)
    g_row = np.asarray(jax.grad(lambda l: JL.sigmoid_loss(
        jnp.asarray(x), l, params, periodicity))(jnp.asarray(lat)))
    assert np.abs(g_m - g_row).max() <= 1e-5 * np.abs(g_row).max()


def _f64_pair_term(x, lat, params, periodicity):
    """The sigmoid loss and its latent gradient in float64 from the same
    float32 inputs: s = 1 - u^e as -expm1(e log1p(c t)), s'(r)/r = b c t
    u^(e-1) / r^2."""
    x, lat = x.astype(np.float64), lat.astype(np.float64)
    d = np.abs(x[:, None, :] - x[None, :, :])
    if math.isfinite(periodicity):
        d = np.minimum(d, periodicity - d)
    rh2, rl2 = (d * d).sum(-1), ((lat[:, None, :] - lat[None, :, :]) ** 2).sum(-1)

    def side(r2, sig, a, b):
        c, e = 2.0 ** (a / b) - 1.0, -b / a
        t = (r2 / sig ** 2) ** (a / 2)
        return -np.expm1(e * np.log1p(c * t)), b * c * t * (1 + c * t) ** (e - 1)

    s_h = side(rh2, *params[:3])[0]
    s_l, ds = side(rl2, *params[3:])
    B = len(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = np.where(rl2 > 0, (s_l - s_h) * ds / rl2, 0.0)
    g = (4.0 / (B * B)) * (m.sum(1)[:, None] * lat - m @ lat)
    return float(np.mean((s_l - s_h) ** 2)), g


def _near_u_1(rng, shape, sig, a, b):
    """Uniform rows scaled so that every pair has c t <= 1e-3, t = (r/sig)^a
    (well inside one period: the min-image distance is the difference)."""
    v = rng.uniform(-1.0, 1.0, shape)
    r_max = math.sqrt(((v[:, None] - v[None]) ** 2).sum(-1).max())
    return (v * 0.999 * sig * (1e-3 / (2.0 ** (a / b) - 1.0)) ** (1 / a) / r_max
            ).astype(np.float32)


@pytest.mark.parametrize("sig", ["defaults", "e=-1.5"])
@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_cluster_pair_phase_near_u_1_within_3x_of_jax_from_float64(periodic, sig):
    """Where every pair has c t <= 1e-3 on both sides, s is small and the
    JAX package's float32 1 - (1 + c t)^e keeps the rounding error of a
    number near 1; the mirror's sums do not: its loss and latent gradient
    are no further from a float64 evaluation than 3x the JAX package's own
    float32 form (sigmoid_loss and its autodiff gradient) on the same
    inputs (measured: 35-400x closer)."""
    from encodermap_tpu import losses as JL

    params = PAIR_SIGS[sig]
    periodicity = 2 * np.pi if periodic else float("inf")
    rng = np.random.default_rng(5 + periodic)
    x = _near_u_1(rng, (32, 4 if periodic else 3), *params[:3])
    lat = _near_u_1(rng, (32, 2), *params[3:])
    loss64, g64 = _f64_pair_term(x, lat, params, periodicity)
    loss_m, g_m = _cluster_pair_phase(x, lat, params, periodicity)
    loss_j, g_j = jax.value_and_grad(lambda l: JL.sigmoid_loss(
        jnp.asarray(x), l, params, periodicity))(jnp.asarray(lat))
    err_m, err_j = abs(loss_m - loss64), abs(float(loss_j) - loss64)
    assert err_m <= 3 * err_j, (err_m, err_j)
    err_m, err_j = np.abs(g_m - g64).max(), np.abs(np.asarray(g_j) - g64).max()
    assert err_m <= 3 * err_j, (err_m, err_j)


# ------------------------------------------- clip + Adam over a parameter tree
def _adam_tree_case(dtype, step, seed=0):
    """A small tree with a 1-element leaf, odd widths and a zero gradient,
    gradients up to ~3x past the clip, moments as after ``step - 1`` steps."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"encoder": [{"kernel": (5, 3), "bias": (3,)}, {"kernel": (3, 1), "bias": (1,)}],
              "decoder": [{"kernel": (1, 7), "bias": (7,)}, {"kernel": (7, 5), "bias": (5,)}]}
    rand = lambda s, scale=1.0: (torch.randn(s, generator=g, dtype=torch.float64) * scale
                                 ).to(dtype)
    params = {k: [{n: rand(s) for n, s in layer.items()} for layer in v]
              for k, v in shapes.items()}
    grads = {k: [{n: rand(s, 3.0) for n, s in layer.items()} for layer in v]
             for k, v in shapes.items()}
    grads["decoder"][0]["bias"] = torch.zeros(7, dtype=dtype)
    first = step == 1
    mu = {k: [{n: torch.zeros_like(x) if first else rand(x.shape, 0.1)
               for n, x in layer.items()} for layer in v] for k, v in params.items()}
    nu = {k: [{n: torch.zeros_like(x) if first else rand(x.shape, 0.1).abs()
               for n, x in layer.items()} for layer in v] for k, v in params.items()}
    return params, grads, {"count": step - 1, "mu": mu, "nu": nu}


@pytest.mark.parametrize("schedule", [False, True], ids=["lr", "schedule"])
@pytest.mark.parametrize("step", [1, 2, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_clip_adam_cpu_route_is_adam_update_bit_for_bit(dtype, step, schedule):
    """``ClipAdam.update`` on CPU tensors is ``_adam_update`` leaf by leaf,
    bit for bit, with the learning rate of the count before the step, and
    keeps the tree's layout and the moments' count."""
    from encodermap_tpu_torch.ops.clip_adam import _adam_update
    from encodermap_tpu_torch.train.core import ClipAdam, tree_leaves

    lr = (lambda count: 1e-3 / (1.0 + 0.01 * count)) if schedule else 1e-3
    opt = ClipAdam(lr, clip_value=1.0)
    params, grads, state = _adam_tree_case(dtype, step)
    assert max(float(x.abs().max()) for x in tree_leaves(grads)) > 1.0
    new_p, new_state = opt.update(grads, state, params)
    assert new_state["count"] == step
    lr_now = opt.lr_at(step - 1)
    for i, (p, m, v, gr) in enumerate(zip(*(tree_leaves(x) for x in (
            params, state["mu"], state["nu"], grads)))):
        want = _adam_update(p, m, v, gr, float(step), lr_now, 0.9, 0.999, 1e-7, 1.0)
        got = [tree_leaves(x)[i] for x in (new_p, new_state["mu"], new_state["nu"])]
        for a, b in zip(got, want):
            assert a.dtype == dtype and a.shape == p.shape
            assert torch.equal(a, b), i
    for part in ("encoder", "decoder"):
        for a, b in zip(new_p[part], params[part]):
            assert sorted(a) == sorted(b)


def test_clip_adam_leaves_the_old_state_unchanged():
    """The step is out of place: the parameters, moments and gradients it
    was given keep their values."""
    from encodermap_tpu_torch.train.core import ClipAdam, tree_leaves

    params, grads, state = _adam_tree_case(torch.float32, 2)
    before = [x.clone() for x in tree_leaves((params, grads, state["mu"], state["nu"]))]
    new_p, new_state = ClipAdam(1e-3).update(grads, state, params)
    after = tree_leaves((params, grads, state["mu"], state["nu"]))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not any(a is b for a, b in zip(tree_leaves(new_p), tree_leaves(params)))
    assert state["count"] == 1 and new_state["count"] == 2


@pytest.mark.parametrize("sizes,launches", [
    # the backbone ADC's 12 leaves in tree order (304-wide input), one table
    ([128, 256, 128, 16384, 304, 38912, 128, 38912, 128, 16384, 2, 256],
     [(list(range(12)), [0, 1, 2, 3, 19, 20, 58, 59, 97, 98, 114, 115], 116)]),
    # empty leaves take no block and no place
    ([0, 1024, 0, 1025, 3], [([1, 3, 4], [0, 1, 3], 4)]),
    ([0, 0], []),
], ids=["adc", "empty", "all-empty"])
def test_plan_launches_prefix_offsets(sizes, launches):
    from encodermap_tpu_torch.ops.clip_adam import CHUNK, plan_launches

    assert CHUNK == 1024
    assert plan_launches(sizes) == launches


@pytest.mark.parametrize("n,tables", [(48, [48]), (49, [48, 1]), (100, [48, 48, 4])])
def test_plan_launches_splits_past_one_table(n, tables):
    """More leaves than one table holds take one launch a full table, each
    table's block offsets counted from its own first leaf."""
    from encodermap_tpu_torch.ops.clip_adam import TABLE_LEAVES, plan_launches

    sizes = [1 + 700 * (i % 5) for i in range(n)]
    plan = plan_launches(sizes)
    assert TABLE_LEAVES == 48 and [len(g) for g, _, _ in plan] == tables
    assert [i for g, _, _ in plan for i in g] == list(range(n))
    for group, firsts, blocks in plan:
        per = [-(-sizes[i] // 1024) for i in group]
        assert firsts == [sum(per[:k]) for k in range(len(group))]
        assert blocks == sum(per)


def test_clip_adam_table_rows():
    """Ten int64 a leaf: the seven data pointers, the count, the first block
    and whether all seven pointers are 16-byte aligned (a view one element
    into a buffer is not)."""
    from encodermap_tpu_torch.ops.clip_adam import _table

    buf = torch.zeros(64)
    aligned = [torch.zeros(6) for _ in range(7)]
    shifted = aligned[:3] + [buf[1:7]] + aligned[4:]
    table = list(_table([aligned, shifted], [0, 1], [0, 5]))
    assert len(table) == 20
    assert table[:7] == [x.data_ptr() for x in aligned] and table[7:10] == [6, 0, 1]
    assert table[13] == buf.data_ptr() + 4 and table[17:20] == [6, 5, 0]


@pytest.mark.parametrize("step", [1, 2, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_clip_adam_scalars_are_the_card_operations_scalars(dtype, step):
    """The kernel's scalars: in float32 each one a float32 number (the
    Python scalar rounded as PyTorch rounds it), the bias corrections'
    reciprocals taken in double and rounded once; in float64 Python's own
    numbers."""
    from encodermap_tpu_torch.ops.clip_adam import _scalars

    s = _scalars(dtype, float(step), 1e-3, 0.9, 0.999, 1e-7, 1.0)
    if dtype == torch.float64:
        assert s == (1e-3, 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1.0 / (1.0 - 0.9 ** step),
                     1.0 / (1.0 - 0.999 ** step), 1e-7, 1.0)
    else:
        f = np.float32
        assert all(float(f(x)) == x for x in s)
        assert s[2] == float(f(1.0 - 0.9)) and s[4] == float(f(1.0 - 0.999))
        assert s[5] == float(f(1.0 / (1.0 - 0.9 ** step)))
        assert s[6] == float(f(1.0 / (1.0 - 0.999 ** step)))
