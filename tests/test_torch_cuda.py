# tests/test_torch_cuda.py
"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and skip without one. They import neither JAX
nor the JAX package, so they run on a GPU machine that has neither; there,
skip the JAX-based conftest too:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than torch (and in double for
the forward loss's last pass), so values agree to 1e-5 relative and latent
gradients to 1e-4 relative to their largest entry; five fused train steps
agree to a tenth of one Adam step (1e-4) in the parameters, since Adam
divides each gradient by its magnitude, and to 1e-3 of each moment tensor's
largest entry in the Adam moments, whose later gradients are taken at
parameters that already differ by that much. Both fused train kernels, the
cluster kernel and the grid kernel, are held to the same bounds.

The ADC cases hold the sigmoid-loss kernels at the widths an ADC step
gives them, the backmapping's ``_one_way`` on the card against the CPU
(1e-5 of the largest entry), its CUDA kernels against the plain version
and against the JAX package's output stored in ``data/one_way_jax.npz``
(within 3x JAX's float32 distance from float64), and two ADC steps on the card against the
CPU's general path (losses 1e-5 relative and gradients 1e-3 in relative
norm at the same weights; after Adam's first step, which turns a
gradient of rounding noise into a full step of either sign, losses 1e-4
and all but 1 % of the weights 1e-4). The same holds for the sidechain-
reconstruction and the multimer modes at trp-cage scale. The fast
sidechain backmap (trp-cage, 114 atoms) on the card stays within 3x the
CPU's own float32 distance from float64, forward and backward. Its kernels
(``csrc/backmap_sidechains.cu``) equal the sequential sweep in float64 to
1e-9 nm and autograd through the plain version to 1e-10 of the largest
gradient, on decoded angles of either sign; hold the 3x rule in float32 at
B=1 to 1000 and on specs of 36 branches, of none and of 8-atom branches;
meet the JAX package's output and VJP stored in ``data/sidechain_jax.npz``
(1e-9 in float64, within 3x JAX's float32 distance from float64 in float32);
give the same bits twice and from the decoder's strided slices; and run
their backward under the span ``adc.backmap_backward``, spans on or off.
The multimer backmap at diubiquitin's widths gives autograd's gradients
through its plain operations bit for bit, spans on or off, and launches its
backward's one-way kernels inside that span.

The data layer: featurization of a synthetic peptide on the card against
the CPU (distances and Cartesians 1e-6 nm, angles and dihedrals 1e-5 rad,
dihedrals modulo 2 pi), the minimum image in orthorhombic and triclinic
boxes likewise, and the rotation sweep of ``backmap_topology`` on the card
against the CPU to 1e-4 nm.

Streaming: ``train_streaming`` on the card equals the in-memory chunk
trainer fed the same batches bit for bit, and its uploads come from pinned
memory on a stream of their own; ``ShardedFeaturizer`` on one NCCL rank
equals the plain featurizer bit for bit.

Analysis (slice 6a): ``compute_dssp`` on the card gives the CPU's strings
(float64 on both, a 152-residue synthetic diubiquitin), and
``pairwise_rmsd_matrix`` on the card matches the CPU within 1e-5 nm
(float32 Kabsch fits in another summation order; trp-cage).

The float64 ADC oracle (slice 6c): ``hand_adc_step`` on the card equals
the CPU's to 1e-12 relative, and a small ADC's step on the card (the
sigmoid-loss kernels) parts from it by at most 3x what the same step with
their plain versions does, per parameter tensor and in the latent
gradient of the sigmoid costs (``chip_smoke.py::adc_oracle_check``).

The general route against float64: 100 steps of ``EncoderMap(
fused_trainer=False)`` at cube B=1024, seeds 0 and 1, stay within 3x the
plain float32 step's distance from a float64 run of it
(``chip_smoke.f64_rule``); so does the cluster train kernel over 100
steps at cube B=256, seeds 0 and 1, under ``chip_smoke.hold_f64``'s
gate."""

import contextlib
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SIG = [(4.5, 12, 6, 1, 2, 6), (4.5, 6.0, 10.0, 1.0, 3.0, 7.0),
       (4.5, 4.0, 6.0, 1.0, 2.0, 3.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hl(B, D, d, periodic, seed):
    g = torch.Generator().manual_seed(seed)
    h = (torch.rand((B, D), generator=g) * 2 - 1) * math.pi if periodic else \
        torch.randn((B, D), generator=g)
    l = torch.randn((B, d), generator=g)
    if B > 5:
        h[1], l[1] = h[0], l[0]  # a duplicate point
        l[5] = l[4]  # same latent point, different inputs
    return h, l


def _check_sigmoid(fs, h, l, params, periodicity):
    v_k = fs.sigmoid_loss_fwd(h, l, params, periodicity)
    v_p = fs.sigmoid_loss_fwd_plain(h, l, params, periodicity)
    g_k = fs.sigmoid_loss_bwd(h, l, params, periodicity)
    g_p = fs.sigmoid_loss_bwd_plain(h, l, params, periodicity)
    assert abs(float(v_k) - float(v_p)) <= 1e-5 * abs(float(v_p))
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())


@pytest.mark.parametrize("params", SIG, ids=["a_l=2", "a_l=3", "e=-1.5"])
@pytest.mark.parametrize("B,D,d,periodicity", [
    (1000, 7, 2, float("inf")), (1000, 7, 2, 2 * math.pi),
    (777, 40, 3, 2 * math.pi), (300, 3, 6, float("inf")),
    (1, 3, 2, float("inf")), (2, 3, 2, 2 * math.pi), (65, 7, 2, float("inf")),
    (129, 7, 3, 2 * math.pi), (500, 5, 10, float("inf")),
    (1000, 128, 2, 2 * math.pi), (4500, 7, 3, float("inf")),
    (4500, 3, 100, float("inf")), (33, 3, 33, 2 * math.pi),
    (300, 5, 200, 2 * math.pi), (70, 40, 1000, float("inf"))])
def test_sigmoid_kernels_match_plain(cuda, params, B, D, d, periodicity):
    """Ragged batch sizes and tile edges (1, 2, 65, 129), widths over one
    32-column chunk (40, 128), a ragged 128-wide tile (4500), latent dims
    up to 10, and wider ones that are restaged per pass like a wide input
    (33, 100, 200, 1000; the backward takes 64-wide tiles for them, also at
    a batch where the forward takes 128); the parameter sets take the
    cheap powers (e = -0.5, -3), powf, and e = -1.5 on both sides (u^-1/2
    and a reciprocal of u in the sum of sig_s)."""
    from encodermap_tpu_torch.ops import fused_sigmoid as fs

    h, l = (t.to(cuda) for t in _hl(B, D, d, math.isfinite(periodicity), B + D))
    _check_sigmoid(fs, h, l, params, periodicity)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
def test_sigmoid_kernels_match_plain_at_each_tile_edge(cuda, tile, periodicity):
    """Both tile edges, each at a batch that takes it and leaves a ragged
    last tile: B = 1000 takes 64 (36 tiles of 128 would not fill the card),
    B = 4500 takes 128."""
    from encodermap_tpu_torch.ops import fused_sigmoid as fs

    B = {64: 1000, 128: 4500}[tile]
    h, l = (t.to(cuda) for t in _hl(B, 7, 3, math.isfinite(periodicity), tile))
    _check_sigmoid(fs, h, l, SIG[0], periodicity)


@pytest.mark.parametrize("B", [1000, 4500], ids=["B=1000", "B=4500"])
def test_sigmoid_kernels_are_bit_reproducible(cuda, B):
    """Every sum has a fixed order (no float atomics): two launches of each
    kernel give the same bits."""
    from encodermap_tpu_torch.ops import fused_sigmoid as fs

    h, l = (t.to(cuda) for t in _hl(B, 9, 2, True, 7))
    args = (h, l, SIG[0], 2 * math.pi)
    assert torch.equal(fs.sigmoid_loss_fwd(*args), fs.sigmoid_loss_fwd(*args))
    assert torch.equal(fs.sigmoid_loss_bwd(*args), fs.sigmoid_loss_bwd(*args))


def test_sigmoid_autograd_through_kernels(cuda):
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.ops import fused_sigmoid as fs

    h, l = (t.to(cuda) for t in _hl(2048, 5, 2, False, 1))
    h.requires_grad_(True)
    l.requires_grad_(True)
    before = dict(_build.launch_counts)
    loss = 3.0 * fs.fused_sigmoid_loss(h, l, SIG[0], float("inf"))
    loss.backward()
    assert _build.launch_counts["sigmoid_fwd"] == before.get("sigmoid_fwd", 0) + 1
    assert _build.launch_counts["sigmoid_bwd"] == before.get("sigmoid_bwd", 0) + 1
    ref = 3.0 * fs.sigmoid_loss_bwd_plain(h.detach(), l.detach(), SIG[0], float("inf"))
    assert float((l.grad - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert h.grad is None


def test_router_takes_kernels_unless_h_needs_a_gradient(cuda):
    """On the card the kernels run at any batch size; an ``h`` that needs a
    gradient (which the kernels do not give) keeps the general path."""
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.ops import fused_sigmoid as fs

    h, l = (t.to(cuda) for t in _hl(256, 3, 2, False, 3))
    before = _build.launch_counts["sigmoid_fwd"]
    v_k = fs.fused_or_reference(h, l, SIG[0], float("inf"))
    assert _build.launch_counts["sigmoid_fwd"] == before + 1
    v_g = fs.fused_or_reference(h.requires_grad_(True), l, SIG[0], float("inf"))
    assert _build.launch_counts["sigmoid_fwd"] == before + 1
    assert abs(float(v_k) - float(v_g.detach())) <= 1e-5 * abs(float(v_g.detach()))


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    from encodermap_tpu_torch.ops import fused_sigmoid as fs

    h, l = (t.to(cuda) for t in _hl(64, 3, 2, False, 2))
    with pytest.raises(TypeError):
        fs.sigmoid_loss_fwd(h.double(), l.double(), SIG[0], float("inf"))
    with pytest.raises(ValueError):
        fs.sigmoid_loss_fwd(h, l.cpu(), SIG[0], float("inf"))


def _fused_case(cuda, n_neurons, d0, B, periodic, steps, n_data=500):
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.models import sequential as seq
    from encodermap_tpu_torch.ops import fused_train as ft

    p = em.Parameters(n_neurons=n_neurons, batch_size=B,
                      activation_functions=[""] + ["tanh"] * (len(n_neurons) - 1) + [""],
                      periodicity=2 * math.pi if periodic else float("inf"))
    params = seq.init_params(torch.Generator().manual_seed(0), p, d0, device=cuda)
    flat, n_enc = ft.split_params(params)
    rng = np.random.default_rng(0)
    data = torch.tensor(rng.uniform(-np.pi, np.pi, (n_data, d0)), dtype=torch.float32,
                        device=cuda)
    idx = torch.tensor(rng.integers(0, n_data, (steps, B)), device=cuda)
    z = [torch.zeros_like(t) for t in flat]
    return flat, z, data, idx, dict(n_enc=n_enc, hyper=ft.hyper_from(p))


@pytest.mark.parametrize("kernel", ["fused_train_cluster", "fused_train"])
@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
@pytest.mark.parametrize("n_neurons,d0,B", [([32, 16, 2], 3, 50),
                                            ([16, 12, 10], 11, 300),
                                            ([144, 144, 2], 3, 256),
                                            ([128, 128, 2], 3, 4096),
                                            ([128, 128, 2], 32, 512)],
                         ids=["2-d latent", "10-d latent", "144 wide", "B=4096", "d0=32"])
def test_fused_train_kernel_matches_plain(cuda, periodic, n_neurons, d0, B, kernel):
    """Ragged batch sizes (50 and 300 rows over the cluster's CTAs, the grid
    kernel's 32-row tiles), a latent wider than the kernels' 8-component
    pass, and input widths 3, 6, 11 and 22 (periodic d0=11); then shapes
    only the grid kernel takes (width 144 at B=256, [128,128,2] at
    B=4096: 26 row groups, and at the gate's widest input, d0=32, 64
    sin/cos columns when periodic), where the cluster kernel refuses to
    launch."""
    from encodermap_tpu_torch.ops import fused_train as ft

    flat, z, data, idx, kw = _fused_case(cuda, n_neurons, d0, B, periodic, 5,
                                         n_data=500 if B <= 500 else 5000)
    dims = [flat[0].shape[0]] + [w.shape[1] for w in flat[:len(flat) // 2]]
    if (kernel == "fused_train_cluster"
            and ft.cluster_footprint(dims, kw["n_enc"], B, d0)["total"] > ft.MAX_SMEM_BYTES):
        with pytest.raises(ValueError, match="shared memory"):
            ft.fused_chunk(flat, z, z, 3.0, data, idx, kernel=kernel, **kw)
        return
    kp, km, kv, kmet = ft.fused_chunk(flat, z, z, 3.0, data, idx, kernel=kernel, **kw)
    pp, pm, pv, pmet = ft.fused_chunk_plain(flat, z, z, 3.0, data, idx, **kw)
    for a, b in zip(kp, pp):
        assert float((a - b).abs().max()) <= 1e-4
    # the moments are linear in the gradients (Adam's step is not: it
    # hides a gradient's scale), so they are held relative to their own
    # largest entry
    for a, b in zip(km + kv, pm + pv):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    assert float(((kmet - pmet).abs() / pmet.abs()).max()) <= 1e-4


@pytest.mark.parametrize("kernel", ["fused_train_cluster", "fused_train"])
@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
@pytest.mark.parametrize("sig", SIG + [(4.5, 10.5, 6.0, 1.0, 2.5, 5.0)],
                         ids=["a_l=2", "a_l=3", "e=-1.5", "powf a"])
def test_fused_train_kernels_match_plain_at_each_exponent_class(cuda, periodic, sig, kernel):
    """Both fused kernels take the pair function of csrc/sigmoid_pairs.cuh
    for every class of exponent (a sum for e = -n and e = -(n + 1/2), else
    1 - powf; an even a by squaring, else a sqrt, and powf for a non-integer
    a; t / r^2 where a_l != 2): five steps at [128,128,2] and B=255 (odd:
    each row takes B // 2 partners) against the plain version, to the
    bounds of test_fused_train_kernel_matches_plain."""
    from encodermap_tpu_torch.ops import fused_train as ft

    flat, z, data, idx, kw = _fused_case(cuda, [128, 128, 2], 4 if periodic else 3, 255,
                                         periodic, 5, n_data=5000)
    kw["hyper"]["losses"]["dist_sig_parameters"] = sig
    kp, km, kv, kmet = ft.fused_chunk(flat, z, z, 0.0, data, idx, kernel=kernel, **kw)
    pp, pm, pv, pmet = ft.fused_chunk_plain(flat, z, z, 0.0, data, idx, **kw)
    for a, b in zip(kp, pp):
        assert float((a - b).abs().max()) <= 1e-4
    for a, b in zip(km + kv, pm + pv):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    assert float(((kmet - pmet).abs() / pmet.abs()).max()) <= 1e-4


@pytest.mark.parametrize("kernel", ["fused_train_cluster", "fused_train"])
def test_fused_train_kernels_adam_moments_carry_no_one_signed_error(cuda, kernel):
    """Adam's moments take 1 - b1 and 1 - b2 as the floats nearest 0.1 and
    0.001, as the plain version does (1.f - 0.999f is 1.3e-5 below 0.001):
    after three steps the median over all parameters of each moment's
    relative deviation from a float64 run of the plain version is within
    1e-6 (unbiased rounding gives ~1e-8 there; the float 1 - b2 gave
    1.3e-5 in every second moment)."""
    from encodermap_tpu_torch.ops import fused_train as ft

    flat, z, data, idx, kw = _fused_case(cuda, [128, 128, 2], 3, 256, False, 3, n_data=5000)
    z64 = [t.double() for t in z]
    _, m64, v64, _ = ft.fused_chunk_plain([t.double() for t in flat], z64, z64, 0.0,
                                          data.double(), idx, **kw)
    _, mk, vk, _ = ft.fused_chunk(flat, z, z, 0.0, data, idx, kernel=kernel, **kw)
    for got, want in ((mk, m64), (vk, v64)):
        g = torch.cat([t.double().reshape(-1) for t in got])
        w = torch.cat([t.reshape(-1) for t in want])
        keep = w != 0
        assert float(((g[keep] - w[keep]) / w[keep]).median().abs()) <= 1e-6


def test_fused_router_takes_the_kernel_the_shape_fits(cuda):
    """[128,128,2] at B=256 fits one cluster CTA's shared memory and takes
    the cluster kernel; at B=288 it still fits, but the grid kernel is the
    faster one there (GRID_MIN_BATCH) and takes it, as it takes B=1024,
    which the cluster cannot hold; each matches its plain version."""
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.ops import fused_train as ft

    for B, kernel in ((256, "fused_train_cluster"), (288, "fused_train"),
                      (1024, "fused_train")):
        flat, z, data, idx, kw = _fused_case(cuda, [128, 128, 2], 3, B, False, 3,
                                             n_data=5000)
        before = dict(_build.launch_counts)
        kp, km, kv, kmet = ft.fused_chunk(flat, z, z, 0.0, data, idx, **kw)
        after = dict(_build.launch_counts)
        other = ({"fused_train", "fused_train_cluster"} - {kernel}).pop()
        assert after[kernel] == before.get(kernel, 0) + 1
        assert after.get(other, 0) == before.get(other, 0)
        pp, pm, pv, pmet = ft.fused_chunk_plain(flat, z, z, 0.0, data, idx, **kw)
        for a, b in zip(kp, pp):
            assert float((a - b).abs().max()) <= 1e-4
        for a, b in zip(km + kv, pm + pv):
            assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
        assert float(((kmet - pmet).abs() / pmet.abs()).max()) <= 1e-4


@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_cluster_kernel_is_bit_reproducible(cuda, periodic):
    """Every sum of the cluster kernel is taken in a fixed order (no float
    atomics), so the same chunk gives the same bits twice."""
    from encodermap_tpu_torch.ops import fused_train as ft

    flat, z, data, idx, kw = _fused_case(cuda, [128, 128, 2], 4 if periodic else 3,
                                         256, periodic, 20, n_data=5000)
    first = ft.fused_chunk(flat, z, z, 0.0, data, idx, kernel="fused_train_cluster", **kw)
    second = ft.fused_chunk(flat, z, z, 0.0, data, idx, kernel="fused_train_cluster", **kw)
    for a, b in zip(first[0] + first[1] + first[2] + [first[3]],
                    second[0] + second[1] + second[2] + [second[3]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_grid_kernel_is_bit_reproducible(cuda, periodic):
    """The grid kernel takes every sum in a fixed order too (tile order,
    group order, CTA order; no float atomics), so 20 steps at B=1024 (16
    row groups) give the same bits twice."""
    from encodermap_tpu_torch.ops import fused_train as ft

    flat, z, data, idx, kw = _fused_case(cuda, [128, 128, 2], 4 if periodic else 3,
                                         1024, periodic, 20, n_data=5000)
    first = ft.fused_chunk(flat, z, z, 0.0, data, idx, kernel="fused_train", **kw)
    second = ft.fused_chunk(flat, z, z, 0.0, data, idx, kernel="fused_train", **kw)
    for a, b in zip(first[0] + first[1] + first[2] + [first[3]],
                    second[0] + second[1] + second[2] + [second[3]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_grid_kernel_at_the_widest_input(cuda, periodic):
    """The gate's widest input (d0=32, 64 sin/cos columns when periodic) at
    B=512, over 5 steps, also held to the float64 rule: no further from a
    float64 run of the plain version than 3x the plain float32 version
    (plus 1e-6), a bound that does not depend on the two float32 versions
    summing in one order."""
    from encodermap_tpu_torch.ops import fused_train as ft

    flat, z, data, idx, kw = _fused_case(cuda, [128, 128, 2], 32, 512, periodic, 5,
                                         n_data=5000)
    kp, km, kv, kmet = ft.fused_chunk(flat, z, z, 0.0, data, idx, kernel="fused_train", **kw)
    pp, pm, pv, pmet = ft.fused_chunk_plain(flat, z, z, 0.0, data, idx, **kw)
    f64 = [t.double() for t in flat]
    z64 = [t.double() for t in z]
    qp, qm, qv, qmet = ft.fused_chunk_plain(f64, z64, z64, 0.0, data.double(), idx, **kw)

    def dist(a, b):
        return max(float((x.double() - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

    assert dist(kp, qp) <= 3 * dist(pp, qp) + 1e-6
    assert dist(km + kv, qm + qv) <= 3 * dist(pm + pv, qm + qv) + 1e-6
    assert dist([kmet], [qmet]) <= 3 * dist([pmet], [qmet]) + 1e-6


@pytest.mark.parametrize("B,kernel", [(256, "fused_train_cluster"), (320, "fused_train")])
def test_encodermap_trains_through_fused_kernel(cuda, tmp_path, B, kernel):
    """[64,64,2] trains through the kernel the router picks: the cluster
    kernel at the default B=256, the grid kernel at B=320."""
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.ops import _build

    data = em.create_n_cube(3, points_along_edge=100, seed=0)[0]
    p = em.Parameters(main_path=str(tmp_path), n_neurons=[64, 64, 2],
                      periodicity=float("inf"), n_steps=400, steps_per_scan=200,
                      batch_size=B, seed=0)
    emap = em.EncoderMap(p, data)
    before = dict(_build.launch_counts)
    hist = emap.train()
    other = ({"fused_train", "fused_train_cluster"} - {kernel}).pop()
    assert _build.launch_counts[kernel] == before.get(kernel, 0) + 2
    assert _build.launch_counts[other] == before.get(other, 0)
    assert hist["loss"][-50:].mean() < hist["loss"][:50].mean()
    again = em.EncoderMap.from_checkpoint(tmp_path, train_data=data)
    assert np.array_equal(again.encode(data), emap.encode(data))


def _adc_cvs(n_res, n_frames, seed=0):
    """Synthetic ADC CVs: random internals, backmapped (float64, CPU)."""
    from encodermap_tpu_torch.ops.backmap import backmap

    rng = np.random.default_rng(seed)
    n_atoms = 3 * n_res
    ang = rng.uniform(1.6, 2.4, (n_frames, n_atoms - 2))
    dih = rng.uniform(-np.pi, np.pi, (n_frames, n_atoms - 3))
    dist = rng.uniform(0.13, 0.155, (n_frames, n_atoms - 1))
    cart = backmap(*(torch.tensor(x) for x in (dist, ang, dih))).numpy()
    side = rng.uniform(-np.pi, np.pi, (n_frames, 2 * n_res))
    return {k: v.astype(np.float32) for k, v in (
        ("central_angles", ang), ("central_dihedrals", dih), ("central_cartesians", cart),
        ("central_distances", dist), ("side_dihedrals", side))}


@pytest.mark.parametrize("D,kind", [(155, "periodic"), (190, "flat CA pairs"),
                                    (24964, "CA matrix rows")])
def test_sigmoid_kernels_match_plain_at_adc_shapes(cuda, D, kind):
    """B=256 at the widths one ADC step gives the kernels: the trp-cage
    encoder input (155 periodic columns), its 20 CAs' flat pair distances
    (190), and the 158-residue CA distance-matrix rows (158^2) with the
    sqrt(2)-scaled sigma of ``losses._matrix_sig_params``."""
    from encodermap_tpu_torch.ops import fused_sigmoid as fs
    from encodermap_tpu_torch.ops.distances import pairwise_dist

    B = 256
    g = torch.Generator().manual_seed(D)
    l = torch.randn((B, 2), generator=g).to(cuda)
    params = SIG[0]
    if kind == "periodic":
        h, periodicity = ((torch.rand((B, D), generator=g) * 2 - 1) * math.pi).to(cuda), 2 * math.pi
    else:
        n_res = 20 if D == 190 else 158
        ca = torch.tensor(_adc_cvs(n_res, B)["central_cartesians"][:, 1::3], device=cuda)
        h = pairwise_dist(ca, flat=True) if D == 190 else pairwise_dist(ca).reshape(B, -1)
        periodicity = float("inf")
        if D != 190:
            params = (params[0] * math.sqrt(2.0),) + params[1:]
    assert h.shape == (B, D)
    _check_sigmoid(fs, h.contiguous(), l, params, periodicity)


def test_one_way_on_card_matches_cpu(cuda):
    """``_one_way`` forward and backward at a 158-residue half-chain (236
    dihedrals), B=256: the card against the CPU, float32, to 1e-5 of the
    largest entry."""
    from encodermap_tpu_torch.ops.backmap import _OneWay, chain_in_plane

    rng = np.random.default_rng(0)
    B, n = 256, 236
    chain = chain_in_plane(torch.tensor(rng.uniform(0.13, 0.155, (B, n + 2)), dtype=torch.float32),
                           torch.tensor(rng.uniform(1.6, 2.4, (B, n + 1)), dtype=torch.float32))
    dih = torch.tensor(rng.uniform(-np.pi, np.pi, (B, n)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(B, n + 3, 3)), dtype=torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        x = [t.detach().to(dev).requires_grad_(True) for t in (dih, chain)]
        y = _OneWay.apply(*x)
        (y * g.to(dev)).sum().backward()
        outs[str(dev)] = [t.detach().cpu() for t in (y, x[0].grad, x[1].grad)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


ONE_WAY_N = [1, 28, 29, 31, 32, 33, 64, 236]


def _one_way_case(n, dtype, device, B=256, seed=0):
    """A half-chain's dihedrals, planar chain (moved off the plane a little)
    and output cotangent, at the main path's bond lengths and angles."""
    from encodermap_tpu_torch.ops.backmap import chain_in_plane

    rng = np.random.default_rng(seed + n)
    chain = chain_in_plane(torch.tensor(rng.uniform(0.13, 0.155, (B, n + 2))),
                           torch.tensor(rng.uniform(1.6, 2.4, (B, n + 1))))
    chain = chain + torch.tensor(rng.normal(0, 0.01, (B, n + 3, 3)))
    dih = torch.tensor(rng.uniform(-np.pi, np.pi, (B, n)))
    g = torch.tensor(rng.normal(size=(B, n + 3, 3)))
    return [t.to(device, dtype) for t in (dih, chain, g)]


def _one_way_kernels(dih, chain, g):
    from encodermap_tpu_torch.ops.backmap import _one_way_bwd, _one_way_fwd

    out, saved = _one_way_fwd(dih, chain)
    return [out, *_one_way_bwd(saved, g)]


def _one_way_plain(dih, chain, g):
    from encodermap_tpu_torch.ops.backmap import _one_way_bwd_plain, _one_way_fwd_plain

    out, saved = _one_way_fwd_plain(dih, chain)
    return [out, *_one_way_bwd_plain(saved, g)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", ONE_WAY_N)
def test_one_way_kernels_match_plain(cuda, n, dtype):
    """The one-way kernels' output, dihedral and coordinate cotangents at
    B=256 against the plain version on the CPU in the same type, at n on
    both sides of each 32-bond tile edge and trp-cage's halves (28, 29):
    to 1e-5 of each tensor's largest entry in float32 (the scans associate
    otherwise past 32 bonds, and the suffix sums always), 1e-12 in float64."""
    from encodermap_tpu_torch.ops import _build

    x = _one_way_case(n, dtype, cuda)
    before = {k: _build.launch_counts[k] for k in ("one_way_fwd", "one_way_bwd")}
    got = _one_way_kernels(*x)
    assert {k: _build.launch_counts[k] - v for k, v in before.items()} == {
        "one_way_fwd": 1, "one_way_bwd": 1}
    want = _one_way_plain(*(t.cpu() for t in x))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.cpu() - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("n", ONE_WAY_N)
def test_one_way_kernels_f32_within_3x_of_plain_from_float64(cuda, n):
    """err(kernels f32, plain f64) <= 3 err(plain f32, plain f64), largest
    absolute error, for the output and both cotangents, B=256 (the rule of
    ``test_one_way_f32_gradient_rule``, with the plain float32 version in the
    place of the JAX package's)."""
    x64 = _one_way_case(n, torch.float64, "cpu")
    ref = _one_way_plain(*x64)
    plain = _one_way_plain(*(t.float() for t in x64))
    got = _one_way_kernels(*(t.to(cuda, torch.float32) for t in x64))
    for k, p, r in zip(got, plain, ref):
        err_k = float((k.cpu().double() - r).abs().max())
        err_p = float((p.double() - r).abs().max())
        assert err_k <= 3 * err_p, (err_k, err_p)


@pytest.mark.parametrize("n", [28, 29, 33])
def test_one_way_kernels_against_the_jax_package(cuda, n):
    """The kernels' output and both cotangents, float32, on the half-chains
    of ``data/one_way_jax.npz`` (B=64), against the JAX package's
    ``_one_way`` and its VJP stored there (``tests/test_torch_backmap.py``
    writes and rechecks the file): err(kernels, f64) <= 3 err(JAX f32, f64),
    largest absolute error, with the port's plain version in float64 as
    the f64 side (``gradcheck``-ed on the CPU), as
    ``test_one_way_f32_gradient_rule`` holds the plain version; and the
    kernels within 1e-5 of each tensor's largest entry of JAX's."""
    from pathlib import Path

    stored = np.load(Path(__file__).parent / "data" / "one_way_jax.npz")
    dih, chain, g = (torch.from_numpy(stored[f"n{n}_{k}"]) for k in ("dih", "cart", "g"))
    got = _one_way_kernels(*(t.to(cuda) for t in (dih, chain, g)))
    ref = _one_way_plain(*(t.double() for t in (dih, chain, g)))
    for k, r, name in zip(got, ref, ("out", "d_bar", "v")):
        jx = torch.from_numpy(stored[f"n{n}_{name}"])
        err_k = float((k.cpu().double() - r).abs().max())
        err_j = float((jx.double() - r).abs().max())
        assert err_k <= 3 * err_j, (name, err_k, err_j)
        assert float((k.cpu() - jx).abs().max()) <= 1e-5 * float(jx.abs().max()), name


def test_one_way_kernels_are_bit_reproducible(cuda):
    """Two runs of both kernels at a 236-bond half-chain (eight tiles, every
    carry) give the same bits."""
    x = _one_way_case(236, torch.float32, cuda)
    first, second = _one_way_kernels(*x), _one_way_kernels(*x)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_one_way_kernels_take_strided_views(cuda):
    """``dihedrals_to_cartesian`` hands ``_OneWay`` column slices (the right
    half) and autograd hands it an expanded cotangent (``sum()``, stride 0):
    both halves and both cotangents on the card against the CPU, float32,
    at 1e-5 of the largest entry."""
    from encodermap_tpu_torch.ops.backmap import dihedrals_to_cartesian

    dih, chain, _ = _one_way_case(57, torch.float32, "cpu")
    outs = {}
    for dev in ("cpu", cuda):
        x = [t.detach().to(dev).requires_grad_(True) for t in (dih, chain)]
        y = dihedrals_to_cartesian(*x)
        y.sum().backward()
        outs[str(dev)] = [t.detach().cpu() for t in (y, x[0].grad, x[1].grad)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_adc_chunk_launches_one_way_kernels(cuda, tmp_path):
    """One three-step ADC training chunk on the card at trp-cage scale
    goes through the one-way kernels: each half-chain's forward and
    backward once a step, so twice a step each."""
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.ops import _build

    p = em.ADCParameters(main_path=str(tmp_path), n_neurons=[128, 128, 2], batch_size=256,
                         n_steps=3, steps_per_scan=3, seed=0, cartesian_pwd_start=1,
                         cartesian_pwd_step=3)
    emap = em.AngleDihedralCartesianEncoderMap(_adc_cvs(20, 1024), p, device=cuda)
    before = {k: _build.launch_counts[k] for k in ("one_way_fwd", "one_way_bwd")}
    emap.train()
    torch.cuda.synchronize()
    assert {k: _build.launch_counts[k] - v for k, v in before.items()} == {
        "one_way_fwd": 6, "one_way_bwd": 6}


def test_one_way_wrappers_refuse_what_they_do_not_take(cuda):
    from encodermap_tpu_torch.ops.backmap import _OneWay, _one_way_bwd, _one_way_fwd

    dih, chain, g = _one_way_case(5, torch.float32, cuda, B=4)
    with pytest.raises(TypeError):
        _OneWay.apply(dih.half(), chain.half())
    with pytest.raises(TypeError):
        _one_way_fwd(dih, chain.double())
    with pytest.raises(ValueError):
        _one_way_fwd(dih, chain[:, 1:])
    with pytest.raises(ValueError):
        _one_way_fwd(dih, chain.cpu())
    _, saved = _one_way_fwd(dih, chain)
    with pytest.raises(TypeError):
        _one_way_bwd(saved, g.half())


def test_sidechain_backmap_on_card_matches_cpu(cuda):
    """``backmap_sidechains_fast`` at trp-cage (20 residues, 17 branches,
    114 atoms), B=256: positions and the gradients of a random projection
    with respect to all six inputs, float32 on the card and on the CPU,
    against float64 on the CPU. The card is held to 3x the CPU's own
    distance from float64 (plus 1e-6 of the largest entry): the planar
    headings are cumsums of up to 58 bond-angle supplements (~70 rad), where
    one float32 ulp is 7.6e-6 rad, and the card sums them in another order,
    so the two devices part by ~1e-5 of the largest coordinate (3.2e-5 nm
    at 2.9 nm, measured on the card), as the CPU's float32 parts from
    float64 (up to 1.7e-5 of the largest entry, positions and gradients)."""
    from chip_smoke import TRP_CAGE_SIDECHAIN_INFO
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast, make_spec

    spec = make_spec(TRP_CAGE_SIDECHAIN_INFO)
    rng = np.random.default_rng(0)
    B, ns = 256, spec.n_sidechain_atoms
    x = [rng.uniform(lo, hi, (B, n)) for lo, hi, n in (
        (0.13, 0.155, 59), (1.7, 2.2, 58), (-np.pi, np.pi, 57), (0.13, 0.16, ns),
        (1.7, 2.2, ns), (-np.pi, np.pi, 37))]
    g = rng.normal(size=(B, spec.n_atoms, 3))
    outs = {}
    for dev, dtype in (("cpu", torch.float64), ("cpu", torch.float32), (cuda, torch.float32)):
        xs = [torch.tensor(v, device=dev, dtype=dtype, requires_grad=True) for v in x]
        y = backmap_sidechains_fast(spec, *xs)
        (y * torch.tensor(g, device=dev, dtype=dtype)).sum().backward()
        outs[str(dev), dtype] = [t.detach().cpu().double() for t in [y] + [v.grad for v in xs]]
    ref, cpu, gpu = (outs[k] for k in (("cpu", torch.float64), ("cpu", torch.float32),
                                       ("cuda", torch.float32)))
    for a, b, r in zip(gpu, cpu, ref):
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) <= 3 * float((b - r).abs().max()) + 1e-6 * scale


SIDECHAIN_SPECS = {
    "trp-cage": None,  # chip_smoke.TRP_CAGE_SIDECHAIN_INFO: 17 branches, up to 6 atoms
    "forty": {r: (0 if r % 10 == 5 else 1 + r % 4) for r in range(1, 41)},  # 36 branches
    "none": {1: 0, 2: 0, 3: 0},
    "one-residue": {1: 3},
    "long": {1: 5, 2: 0, 3: 7, 4: 2},  # branches of 6 and 8 atoms
}


def _sidechain_case(name, B, dtype, device, seed=0):
    """A spec and its six inputs, decoded angles of either sign on (-pi, pi]
    (as a fresh model gives them), and a cotangent of the coordinates."""
    from chip_smoke import TRP_CAGE_SIDECHAIN_INFO
    from encodermap_tpu_torch.ops.backmap_sidechains import make_spec

    info = SIDECHAIN_SPECS[name] or TRP_CAGE_SIDECHAIN_INFO
    spec = make_spec(info)
    rng = np.random.default_rng(seed)
    nb, ns = 3 * spec.n_residues, spec.n_sidechain_atoms
    x = [rng.uniform(0.13, 0.155, (B, nb - 1)), rng.uniform(-np.pi, np.pi, (B, nb - 2)),
         rng.uniform(-np.pi, np.pi, (B, nb - 3)), rng.uniform(0.13, 0.16, (B, ns)),
         rng.uniform(-np.pi, np.pi, (B, ns)), rng.uniform(-np.pi, np.pi, (B, sum(info.values())))]
    g = rng.normal(size=(B, spec.n_atoms, 3))
    return spec, [torch.tensor(v, dtype=dtype, device=device) for v in x], \
        torch.tensor(g, dtype=dtype, device=device)


def _sidechain_run(fn, spec, x, g):
    """The coordinates and the gradients of ``sum(out * g)`` with respect to
    the six inputs (zeros for an input of width 0)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in x]
    y = fn(spec, *leaves)
    (y * g).sum().backward()
    return [y.detach()] + [t.grad if t.grad is not None else torch.zeros_like(t)
                           for t in leaves]


@pytest.mark.parametrize("name", SIDECHAIN_SPECS)
def test_sidechain_kernels_f64_equal_the_sequential_sweep(cuda, name):
    """The kernels in float64, B=256, against the sequential sweep measured
    exactly (``angle_clip=None``) on the CPU, to 1e-9 nm, on decoded angles
    of either sign; their gradients against autograd through the plain
    version on the CPU to 1e-10 of each one's largest entry."""
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.ops.backmap_sidechains import (
        _backmap_sidechains_fast_plain,
        backmap_sidechains,
        backmap_sidechains_fast,
    )

    spec, x, g = _sidechain_case(name, 256, torch.float64, cuda)
    before = {k: _build.launch_counts[k] for k in ("sidechain_fwd", "sidechain_bwd")}
    got = _sidechain_run(backmap_sidechains_fast, spec, x, g)
    assert {k: _build.launch_counts[k] - v for k, v in before.items()} == {
        "sidechain_fwd": 1, "sidechain_bwd": 1}
    cpu = [t.cpu() for t in x]
    seq = backmap_sidechains(spec, *cpu, angle_clip=None)
    assert float((got[0].cpu() - seq).abs().max()) <= 1e-9
    want = _sidechain_run(_backmap_sidechains_fast_plain, spec, cpu, g.cpu())
    for a, b in zip(got[1:], want[1:]):
        assert a.shape == b.shape
        if b.numel():  # an input of width 0 has no gradient to compare
            assert float((a.cpu() - b).abs().max()) <= 1e-10 * max(float(b.abs().max()), 1.0)


@pytest.mark.parametrize("name,B", [("trp-cage", 1), ("trp-cage", 33), ("trp-cage", 256),
                                    ("trp-cage", 1000), ("forty", 33), ("none", 33),
                                    ("long", 33)])
def test_sidechain_kernels_f32_within_3x_of_plain_from_float64(cuda, name, B):
    """The coordinates and the gradients of all six inputs, float32:
    err(kernels, f64) <= 3 err(plain f32 on the CPU, f64) + 1e-6 of the
    largest entry, the rule of ``test_sidechain_backmap_on_card_matches_cpu``,
    with the plain version in float64 on the CPU as the f64 side."""
    from encodermap_tpu_torch.ops.backmap_sidechains import (
        _backmap_sidechains_fast_plain,
        backmap_sidechains_fast,
    )

    spec, x64, g64 = _sidechain_case(name, B, torch.float64, "cpu")
    ref = _sidechain_run(_backmap_sidechains_fast_plain, spec, x64, g64)
    plain = _sidechain_run(_backmap_sidechains_fast_plain, spec, [t.float() for t in x64],
                           g64.float())
    got = _sidechain_run(backmap_sidechains_fast, spec,
                         [t.to(cuda, torch.float32) for t in x64], g64.to(cuda, torch.float32))
    for k, p, r in zip(got, plain, ref):
        assert k.dtype == torch.float32 and k.shape == r.shape
        if not r.numel():  # an input of width 0 has no gradient to compare
            continue
        err_k = float((k.cpu().double() - r).abs().max())
        err_p = float((p.double() - r).abs().max())
        assert err_k <= 3 * err_p + 1e-6 * float(r.abs().max()), (err_k, err_p)


@pytest.mark.parametrize("name", ["trp-cage", "forty", "long"])
def test_sidechain_kernels_against_the_jax_package(cuda, name):
    """The kernels' coordinates and the gradients of all six inputs on the
    inputs of ``data/sidechain_jax.npz`` (B=32, decoded angles of either
    sign), against the JAX package's fast form with the sweep's current
    dihedrals and its VJP stored there (``tests/test_torch_sidechains.py``
    writes and rechecks the file): in float64 to 1e-9 nm and 1e-9 of each
    gradient's largest entry; in float32 err(kernels, JAX f64) <= 3
    err(JAX f32, JAX f64), largest absolute error."""
    from pathlib import Path

    from chip_smoke import TRP_CAGE_SIDECHAIN_INFO
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast, make_spec

    stored = np.load(Path(__file__).parent / "data" / "sidechain_jax.npz")
    spec = make_spec(SIDECHAIN_SPECS[name] or TRP_CAGE_SIDECHAIN_INFO)
    x = [torch.from_numpy(stored[f"{name}_{k}"]) for k in ("cd", "ca", "cdi", "sd", "sa", "sdi")]
    g = torch.from_numpy(stored[f"{name}_g"])
    keys = ("out", "d_cd", "d_ca", "d_cdi", "d_sd", "d_sa", "d_sdi")
    for dtype in (torch.float64, torch.float32):
        got = _sidechain_run(backmap_sidechains_fast, spec, [t.to(cuda, dtype) for t in x],
                             g.to(cuda, dtype))
        for k, key in zip(got, keys):
            ref = torch.from_numpy(stored[f"{name}_{key}64"])
            err = float((k.cpu().double() - ref).abs().max())
            if dtype == torch.float64:
                assert err <= 1e-9 * max(float(ref.abs().max()), 1.0), (key, err)
            else:
                err_j = float((torch.from_numpy(stored[f"{name}_{key}32"]).double() - ref)
                              .abs().max())
                assert err <= 3 * err_j, (key, err, err_j)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sidechain_kernels_are_bit_reproducible(cuda, dtype):
    """Two runs of both kernels (40 residues, 36 branches over the warp's
    lanes, B=1000) give the same bits: no atomics."""
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast

    spec, x, g = _sidechain_case("forty", 1000, dtype, cuda)
    first = _sidechain_run(backmap_sidechains_fast, spec, x, g)
    second = _sidechain_run(backmap_sidechains_fast, spec, x, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_sidechain_kernels_take_strided_views(cuda):
    """The decoder hands the backmap column slices of one output
    (``torch.split``) and ``sum()`` an expanded cotangent (stride 0): the
    same bits as from contiguous copies."""
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast

    spec, x, _ = _sidechain_case("trp-cage", 256, torch.float32, cuda)
    widths = [t.shape[1] for t in x]
    slices = torch.split(torch.cat(x, dim=1), widths, dim=1)
    assert not any(t.is_contiguous() for t in slices[1:])
    outs = []
    for inputs in (x, slices):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        y = backmap_sidechains_fast(spec, *leaves)
        y.sum().backward()
        outs.append([y.detach()] + [t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_sidechain_training_call_spans_and_counter_on_card(cuda):
    """With the spans on, ``backmap_sidechains_fast`` launches the same
    kernels as with them off (same bits), its backward kernel's launch lies
    inside the span ``adc.backmap_backward``, and the counter
    ``sidechain_backmap`` counts one call and B rows each way."""
    from encodermap_tpu_torch.misc import profiling as P
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast

    spec, x, g = _sidechain_case("trp-cage", 256, torch.float32, cuda)
    runs = {}
    for spanned in (False, True):
        counts = dict(_build.launch_counts)
        rows = dict(P.counter("sidechain_backmap"))
        with P.record_spans() if spanned else contextlib.nullcontext():
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                runs[spanned] = _sidechain_run(backmap_sidechains_fast, spec, x, g)
                torch.cuda.synchronize()
        moved = {k: v - counts.get(k, 0) for k, v in _build.launch_counts.items()
                 if v != counts.get(k, 0)}
        assert moved == {"sidechain_fwd": 1, "sidechain_bwd": 1}
        counted = {k: v - rows.get(k, 0) for k, v in P.counter("sidechain_backmap").items()
                   if v != rows.get(k, 0)}
        assert counted == ({"fwd": 1, "rows_fwd": 256, "bwd": 1, "rows_bwd": 256}
                           if spanned else {})
        if spanned:
            events = prof.events()
            launch = {e.id: e.time_range.start for e in events
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and e.name.startswith("cu")}
            bwd = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and "sidechain_bwd_kernel" in e.name]
            span_ranges = [e.time_range for e in events if e.name == "adc.backmap_backward"
                           and e.device_type == torch.autograd.DeviceType.CPU]
            assert len(bwd) == 1 and len(span_ranges) == 1
            assert span_ranges[0].start <= launch[bwd[0].id] <= span_ranges[0].end
    assert all(torch.equal(a, b) for a, b in zip(runs[False], runs[True]))


def test_sidechain_wrappers_refuse_what_they_do_not_take(cuda):
    """Half precision, two types, two devices and wrong widths raise."""
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast

    spec, x, _ = _sidechain_case("trp-cage", 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        backmap_sidechains_fast(spec, *(t.half() for t in x))
    with pytest.raises(TypeError):
        backmap_sidechains_fast(spec, *x[:5], x[5].double())
    with pytest.raises(ValueError):
        backmap_sidechains_fast(spec, *x[:5], x[5].cpu())
    with pytest.raises(ValueError):
        backmap_sidechains_fast(spec, *x[:5], x[5][:, 1:])


def test_reconstruct_chunk_launches_sidechain_kernels(cuda, tmp_path):
    """A three-step training chunk of the sidechain-reconstruction mode at
    trp-cage scale goes through the sidechain kernels once a step each way,
    and through no one-way kernel."""
    import encodermap_tpu_torch as em
    from chip_smoke import TRP_CAGE_SIDECHAIN_INFO, sidechain_cvs
    from encodermap_tpu_torch.ops import _build

    p = em.ADCParameters(main_path=str(tmp_path), n_neurons=[128, 128, 2], batch_size=256,
                         n_steps=3, steps_per_scan=3, seed=0, reconstruct_sidechains=True,
                         sidechain_info=TRP_CAGE_SIDECHAIN_INFO, use_backbone_angles=True)
    emap = em.AngleDihedralCartesianEncoderMap(sidechain_cvs(1024), p, device=cuda)
    names = ("sidechain_fwd", "sidechain_bwd", "one_way_fwd", "one_way_bwd")
    before = {k: _build.launch_counts[k] for k in names}
    emap.train()
    torch.cuda.synchronize()
    assert {k: _build.launch_counts[k] - v for k, v in before.items()} == {
        "sidechain_fwd": 3, "sidechain_bwd": 3, "one_way_fwd": 0, "one_way_bwd": 0}


def test_reconstruct_steps_on_card_match_cpu(cuda, tmp_path):
    """Two sidechain-reconstruction steps at trp-cage scale (every atom
    backmapped; kernels 2-3 at D=206 periodic and D=666), card against
    CPU, held as ``test_adc_steps_on_card_match_cpu`` holds its steps."""
    from chip_smoke import TRP_CAGE_SIDECHAIN_INFO, sidechain_cvs

    _card_against_cpu(cuda, tmp_path, sidechain_cvs(1024, device="cpu"),
                      reconstruct_sidechains=True, sidechain_info=TRP_CAGE_SIDECHAIN_INFO)


def test_multimer_steps_on_card_match_cpu(cuda, tmp_path):
    """Two multimer steps on a trp-cage homodimer (kernels 2-3 at D=304
    periodic and D=780), card against CPU, held as
    ``test_adc_steps_on_card_match_cpu`` holds its steps."""
    from chip_smoke import dimer_cvs

    _card_against_cpu(cuda, tmp_path, dimer_cvs(1024, device="cpu"),
                      multimer_training="homogeneous_transformation",
                      multimer_lengths=[20, 20])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_multimer_backmap_gradients_are_plain_autograds_on_card(cuda, dtype):
    """``backmap_multimer`` on the card at diubiquitin's widths (two
    76-residue chains, B=256): with the spans off and on, its coordinates
    and gradients are bit for bit autograd's through its plain operations,
    it launches the same one-way kernels (two each way a chain), with the
    spans on every backward kernel's launch lies inside the span
    ``adc.backmap_backward``, and the counter ``multimer_backmap`` counts one
    call, 256 rows and two proteins each way."""
    import importlib

    from encodermap_tpu_torch.misc import profiling as P
    from encodermap_tpu_torch.ops import _build

    TB = importlib.import_module("encodermap_tpu_torch.ops.backmap")
    lengths, B = [76, 76], 256
    g = torch.Generator(device=cuda).manual_seed(11)

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand((B, n), generator=g, device=cuda, dtype=dtype)

    d = uniform(454, 0.13, 0.155)
    a, t = uniform(452, 1.6, 2.4), uniform(450, -math.pi, math.pi)
    mats = torch.eye(4, device=cuda, dtype=dtype) + 0.3 * torch.randn(
        (B, 1, 4, 4), generator=g, device=cuda, dtype=dtype)
    w = torch.randn((B, 456, 3), generator=g, device=cuda, dtype=dtype)

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in (a, t, mats)]
        out = fn(lengths, d, *leaves)
        loss = (out * w).sum() + sum(torch.sin(x).sum() for x in leaves)
        return [out.detach()] + list(torch.autograd.grad(loss, leaves))

    want = run(TB._backmap_multimer_plain)
    for spanned in (False, True):
        counts, rows = dict(_build.launch_counts), dict(P.counter("multimer_backmap"))
        with P.record_spans() if spanned else contextlib.nullcontext():
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                got = run(TB.backmap_multimer)
                torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        moved = {k: v - counts.get(k, 0) for k, v in _build.launch_counts.items()
                 if v != counts.get(k, 0)}
        assert moved == {"one_way_fwd": 4, "one_way_bwd": 4}
        counted = {k: v - rows.get(k, 0) for k, v in P.counter("multimer_backmap").items()
                   if v != rows.get(k, 0)}
        assert counted == ({"fwd": 1, "rows_fwd": B, "proteins": 2, "bwd": 1, "rows_bwd": B}
                           if spanned else {})
        if spanned:
            events = prof.events()
            launch = {e.id: e.time_range.start for e in events
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and e.name.startswith("cu")}
            bwd = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and "one_way_bwd" in e.name]
            (span_range,) = [e.time_range for e in events if e.name == "adc.backmap_backward"
                             and e.device_type == torch.autograd.DeviceType.CPU]
            assert len(bwd) == 4
            assert all(span_range.start <= launch[e.id] <= span_range.end for e in bwd)


def test_adc_steps_on_card_match_cpu(cuda, tmp_path):
    """Two ADC steps at trp-cage scale ([128,128,2], B=256, 20 residues, CA
    costs, angles and sidechains, the encoder input's sketch-map cost on)
    on the card, through the sigmoid-loss kernels (two forward and two
    backward launches a step), against the same steps on the CPU's
    general path, from the same weights and indices.

    At the initial weights the loss terms agree to 1e-5 relative and every
    gradient leaf to 1e-3 in relative norm: the mean-abs costs
    differentiate |x| to the sign of x, which differs between the devices
    where x is within rounding of 0, and that moves single entries by up
    to ~4e-4 of the leaf's largest (measured on the card). Adam's first step moves
    each weight by the learning rate times the sign of its gradient, so a
    gradient entry that is float32 rounding noise (a bias whose batch sum
    nearly cancels) may step the other way on the other device: the second
    step's losses agree to 1e-4 relative (or 1e-6 of the total loss, for a
    term far below it), and the weights after two steps to 1e-4 in all but
    1 % of their entries."""
    _card_against_cpu(cuda, tmp_path, _adc_cvs(20, 1024))


def _card_against_cpu(cuda, tmp_path, data, **extra):
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.convert import params_to_numpy
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.train.core import tree_unflatten

    idx = np.random.default_rng(1).integers(0, 1024, (2, 256))
    runs = {}
    for dev in ("cpu", cuda):
        p = em.ADCParameters(main_path=str(tmp_path / str(dev)), n_neurons=[128, 128, 2],
                             batch_size=256, n_steps=2, steps_per_scan=2, seed=0,
                             cartesian_pwd_start=1, cartesian_pwd_step=3,
                             use_backbone_angles=True, use_sidechains=True,
                             angle_cost_scale=1.0, distance_cost_scale=1.0, **extra)
        emap = em.AngleDihedralCartesianEncoderMap(data, p, device=dev)
        leaves = [t.detach().requires_grad_(True) for t in _leaves(emap.state.params)]
        batch = tuple(torch.as_tensor(d[idx[0]], device=dev) for d in emap.train_data)
        terms, _ = emap._loss_and_aux(tree_unflatten(emap.state.params, leaves), batch, 0)
        loss = sum(v for k, v in terms.items() if k != "cartesian_cost_scale")
        grads = [g.cpu().numpy() for g in torch.autograd.grad(loss, leaves)]
        before = dict(_build.launch_counts)
        hist = emap.train(index_stream=iter([idx]))
        launched = {k: _build.launch_counts[k] - before.get(k, 0)
                    for k in ("sigmoid_fwd", "sigmoid_bwd")}
        runs[str(dev)] = dict(terms={k: float(v.detach()) for k, v in terms.items()},
                              grads=grads,
                              hist=hist, params=_leaves(params_to_numpy(emap.state.params)[0]),
                              launched=launched)
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu["launched"] == {"sigmoid_fwd": 4, "sigmoid_bwd": 4}  # 2 steps x 2
    assert cpu["launched"] == {"sigmoid_fwd": 0, "sigmoid_bwd": 0}
    bad = []  # every check runs; the failures are listed together
    for k, ref in cpu["terms"].items():
        if not (abs(gpu["terms"][k] - ref) <= 1e-5 * abs(ref)
                and abs(gpu["hist"][k][0] - ref) <= 1e-5 * abs(ref)):
            bad.append((k, "step 1", gpu["terms"][k], gpu["hist"][k][0], ref))
        # a term far below the total (the center loss) is held to 1e-6 of it
        a, b = gpu["hist"][k][1], cpu["hist"][k][1]
        if not abs(a - b) <= max(1e-4 * abs(b), 1e-6 * cpu["hist"]["loss"][1]):
            bad.append((k, "step 2", a, b))
    for i, (a, b) in enumerate(zip(gpu["grads"], cpu["grads"])):
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        if not rel <= 1e-3:
            bad.append(("gradient leaf", i, rel, float(np.abs(a - b).max()),
                        float(np.abs(b).max())))
    off = sum(int((np.abs(a - b) > 1e-4).sum()) for a, b in zip(gpu["params"], cpu["params"]))
    if not off <= 0.01 * sum(a.size for a in cpu["params"]):
        bad.append(("weights off by more than 1e-4", off))
    assert not bad, bad


def _leaves(tree):
    from encodermap_tpu_torch.train.core import tree_leaves

    return tree_leaves(tree)


def _peptide_files(tmp_path, n_frames=16):
    from chip_smoke import ALL_AMINO_ACIDS, synthetic_protein
    from encodermap_tpu_torch.data.pdb import write_pdb
    from encodermap_tpu_torch.data.xtc import write_xtc

    top, xyz = synthetic_protein(ALL_AMINO_ACIDS, n_frames, seed=0)
    write_pdb(tmp_path / "p.pdb", top, xyz[:1])
    write_xtc(tmp_path / "p.xtc", xyz)
    return str(tmp_path / "p.xtc"), str(tmp_path / "p.pdb")


def _wrapped(a, b, dihedral):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    if dihedral:
        d = (d + np.pi) % (2 * np.pi) - np.pi
    return float(np.nanmax(np.abs(d)))


@pytest.mark.parametrize("which", ["all", "full"])
def test_featurization_on_card_matches_cpu(cuda, tmp_path, which):
    """``load_CV(which)`` of a 20-residue peptide, 16 frames, on the card
    against the CPU."""
    import encodermap_tpu_torch as em

    files = _peptide_files(tmp_path)
    out = {}
    for dev in ("cuda", "cpu"):
        traj = em.SingleTraj(*files)
        traj.load_CV(which, device=dev)
        out[dev] = traj.CVs
    assert out["cuda"].keys() == out["cpu"].keys()
    for k in out["cpu"]:
        tol = 1e-5 if ("angle" in k or "dihedral" in k) else 1e-6
        assert _wrapped(out["cuda"][k], out["cpu"][k], "dihedral" in k) <= tol, k


@pytest.mark.parametrize("triclinic", [False, True], ids=["orthorhombic", "triclinic"])
def test_minimum_image_on_card_matches_cpu(cuda, triclinic):
    """Distances, angles and dihedrals of random points in a periodic cell,
    card against CPU. The rows are chosen as in tests/test_torch_featurize.py:
    distinct atoms, both bond angles within 0.5-2.6 rad (a straight triple
    leaves the dihedral ill-conditioned in float32), and no pair whose two
    nearest images lie within 1e-4 nm (a tie the two devices may break
    either way)."""
    from encodermap_tpu_torch.ops import geometry as geom

    rng = np.random.default_rng(1)
    box = np.diag([2.0, 2.3, 2.6])
    if triclinic:
        box[1, 0], box[2, 0], box[2, 1] = 0.7, -0.5, 0.9
    xyz = rng.uniform(-1.0, 3.5, (8, 40, 3)).astype(np.float32)
    boxes = np.broadcast_to(box, (8, 3, 3)).astype(np.float32)
    idx = np.stack([rng.choice(40, 4, replace=False) for _ in range(2000)])
    x64, b64 = torch.tensor(xyz, dtype=torch.float64), torch.tensor(boxes, dtype=torch.float64)
    bends = [geom.compute_angles(x64, idx[:, k:k + 3], b64).numpy() for k in (0, 1)]
    shifts = np.array([[i, j, k] for i in range(-2, 3) for j in range(-2, 3)
                       for k in range(-2, 3)], np.float64) @ box
    ok = np.all([(b > 0.5) & (b < 2.6) for b in bends], axis=(0, 1))
    for a, b in ((0, 1), (1, 2), (2, 3), (0, 2)):
        d = (xyz[:, idx[:, b]] - xyz[:, idx[:, a]]).astype(np.float64)
        lens = np.sort(np.linalg.norm(d[..., None, :] - shifts, axis=-1), axis=-1)
        ok &= (lens[..., 1] - lens[..., 0]).min(0) > 1e-4
    idx = idx[ok][:100]
    assert len(idx) == 100
    res = {}
    for dev in ("cuda", "cpu"):
        x, b = torch.tensor(xyz, device=dev), torch.tensor(boxes, device=dev)
        res[dev] = [f(x, idx[:, :k], b).cpu().numpy() for f, k in (
            (geom.compute_distances, 2), (geom.compute_angles, 3),
            (geom.compute_dihedrals, 4))]
    for j, tol in enumerate((1e-6, 1e-5, 1e-5)):
        assert _wrapped(res["cuda"][j], res["cpu"][j], j == 2) <= tol


def test_dihedral_rotate_on_card_matches_cpu(cuda):
    """``backmap_topology`` of a 20-residue peptide onto 64 random central
    and side dihedral sets: the card's sweep against the CPU's, 1e-4 nm."""
    from chip_smoke import ALL_AMINO_ACIDS, synthetic_protein
    from encodermap_tpu_torch.loading.features import SideChainDihedrals
    from encodermap_tpu_torch.misc.backmapping_offline import backmap_topology

    top, xyz = synthetic_protein(ALL_AMINO_ACIDS, 1, seed=0)
    chain = top.central_atom_indices()
    quads = np.stack([chain[:-3], chain[1:-2], chain[2:-1], chain[3:]], axis=1)
    n_side = len(SideChainDihedrals(top)._indices)
    rng = np.random.default_rng(2)
    cen = rng.uniform(-np.pi, np.pi, (64, len(quads))).astype(np.float32)
    side = rng.uniform(-np.pi, np.pi, (64, n_side)).astype(np.float32)
    out = [backmap_topology(top, xyz[0], cen, dihedral_indices=quads, side_dihedrals=side,
                            device=dev) for dev in ("cuda", "cpu")]
    assert out[0].shape == (64, top.n_atoms, 3)
    assert float(np.abs(out[0] - out[1]).max()) <= 1e-4


# ------------------------------------------------------------ slice 5
def test_streaming_on_card_equals_the_chunk_trainer(cuda, tmp_path):
    """``train_streaming`` (pinned uploads on the side stream, prefetch
    threads) against the in-memory chunk trainer fed the same batches as
    injected indices: the same step on the same values, bit for bit."""
    import encodermap_tpu_torch as emt

    rng = np.random.default_rng(0)
    sbs = [rng.standard_normal((4, 64, 6)).astype(np.float32) for _ in range(3)]
    kw = dict(n_neurons=[32, 32, 2], batch_size=64, steps_per_scan=4, n_steps=12, seed=1,
              periodicity=float("inf"), fused_trainer=False)
    a = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "a"), **kw), sbs[0][0])
    b = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "b"), **kw),
                       np.concatenate([s.reshape(-1, 6) for s in sbs]),
                       model_params=_leaves_tree(a))
    ha = a.train_streaming(iter(sbs))
    hb = b.train(index_stream=iter(np.arange(768).reshape(3, 4, 64)))
    np.testing.assert_array_equal(ha["loss"], hb["loss"])
    for x, y in zip(_leaves(a.state.params), _leaves(b.state.params)):
        assert torch.equal(x, y)


def _leaves_tree(model):
    from encodermap_tpu_torch.train.core import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), model.state.params)


def test_pinned_upload_runs_on_a_side_stream(cuda):
    """A put from a worker thread copies from pinned memory on the
    uploader's own stream; the consumer's stream waits on its event."""
    import threading

    from encodermap_tpu_torch.train.core import PinnedUploader

    put = PinnedUploader(cuda)
    x = np.random.default_rng(1).standard_normal((8, 32, 6)).astype(np.float32)
    got = {}

    def worker():
        got["up"] = put(x)
        got["stream"] = torch.cuda.current_stream()

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    up = got["up"]
    assert put.stream != torch.cuda.current_stream() and got["stream"] != put.stream
    ring = next(iter(put._rings.values()))["slots"]
    assert all(slot[0].is_pinned() for slot in ring)
    assert up.event is not None and put.copies == 1
    np.testing.assert_array_equal(up.ready().cpu().numpy(), x)


def test_sharded_featurizer_on_one_nccl_rank_equals_plain(cuda, tmp_path):
    import torch.distributed as dist

    import encodermap_tpu_torch as emt
    from encodermap_tpu_torch import parallel
    from encodermap_tpu_torch.loading.featurizer import SingleTrajFeaturizer
    from encodermap_tpu_torch.parallel.sharded_featurize import ShardedFeaturizer

    xtc, pdb = _peptide_files(tmp_path, n_frames=20)
    traj = emt.load(xtc, pdb)
    parallel.initialize(init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        with pytest.raises(ValueError, match="gloo"):  # no CPU mesh on an NCCL group
            parallel.make_mesh(dp=1, device="cpu")
        mesh = parallel.make_mesh(dp=1)
        sharded = ShardedFeaturizer(traj, mesh=mesh, block_size=8)
        sharded.add_list_of_feats("all")
        plain = SingleTrajFeaturizer(traj, block_size=8)
        plain.add_list_of_feats("all")
        a, b = sharded.get_output(), plain.get_output()
        for k in b.keys():
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("simplified", [True, False], ids=["3-state", "8-state"])
def test_dssp_on_card_matches_cpu(cuda, simplified):
    from chip_smoke import DIUBI, synthetic_protein
    from encodermap_tpu_torch.ops import dssp
    from encodermap_tpu_torch.ops.dssp import compute_dssp

    top, xyz = synthetic_protein(DIUBI, 24, seed=5)

    class Traj:
        pass

    traj = Traj()
    traj.top, traj.xyz = top, xyz
    got = compute_dssp(traj, simplified=simplified)
    np.testing.assert_array_equal(got, compute_dssp(traj, simplified=simplified,
                                                    device="cpu"))
    R = top.n_residues
    with pytest.MonkeyPatch.context() as mp:  # five frames a block
        mp.setattr(dssp, "DSSP_BLOCK_BYTES", 5 * 12 * R * R * 8)
        np.testing.assert_array_equal(got, compute_dssp(traj, simplified=simplified))


def test_rmsd_matrix_on_card_matches_cpu(cuda):
    from chip_smoke import TRP_CAGE, synthetic_protein
    from encodermap_tpu_torch.misc.clustering import pairwise_rmsd_matrix

    _, xyz = synthetic_protein(TRP_CAGE, 40, seed=3)
    got = pairwise_rmsd_matrix(xyz)
    want = pairwise_rmsd_matrix(xyz, device="cpu")
    assert got.shape == (40, 40)
    assert float(np.abs(got - want).max()) <= 1e-5
    assert float(np.abs(got - got.T).max()) <= 1e-5
    assert float(np.abs(np.diag(got)).max()) <= 1e-5


# ------------------------------------------------ slice 6b: observability
def test_tensorboard_events_on_card_read_back(cuda, tmp_path):
    """Training on the card with ``tensorboard=True``: the event file's
    records pass their CRCs (``chip_smoke.read_events``, bitwise CRC-32C)
    and its scalars equal the JSONL rows as float32; the model summary
    totals the parameters."""
    import json

    import encodermap_tpu_torch as em
    from chip_smoke import read_events
    from encodermap_tpu_torch.train.core import tree_leaves

    data = em.create_n_cube(3, points_along_edge=100, seed=0)[0]
    p = em.Parameters(main_path=str(tmp_path), n_neurons=[64, 64, 2],
                      periodicity=float("inf"), n_steps=200, steps_per_scan=100,
                      batch_size=256, seed=0, tensorboard=True, summary_step=20)
    emap = em.EncoderMap(p, data)
    emap.train()
    events = list((tmp_path / "train").glob("events.out.tfevents.*"))
    assert len(events) == 1
    scalars, images, n_records = read_events(events[0])
    rows = [json.loads(line) for line in (tmp_path / "train_metrics.jsonl").read_text().splitlines()]
    want = {(k, r["step"]): np.float32(v) for r in rows for k, v in r.items() if k != "step"}
    assert sorted(scalars) == sorted(want) and n_records == 1 + len(rows) and not images
    assert all(scalars[k].tobytes() == want[k].tobytes() for k in want)
    total = sum(t.numel() for t in tree_leaves(emap.state.params))
    assert (tmp_path / "complete_model_summary.txt").read_text().splitlines()[-1] == \
        f"Total params: {total:,}"


def test_profiler_trace_names_the_cluster_kernel(cuda, tmp_path):
    """``profile_steps`` traces the card: one traced chunk of the cluster
    kernel appears once among the trace's device kernels."""
    import gzip
    import json

    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.misc.profiling import profile_steps

    data = em.create_n_cube(3, points_along_edge=100, seed=0)[0]
    p = em.Parameters(main_path=str(tmp_path), n_neurons=[64, 64, 2],
                      periodicity=float("inf"), n_steps=50, steps_per_scan=50,
                      batch_size=256, seed=0)
    emap = em.EncoderMap(p, data, read_only=True)
    logdir = profile_steps(emap, n_steps=1, logdir=tmp_path / "profile")
    (trace,) = list((tmp_path / "profile").glob("*.trace.json.gz"))
    assert str(trace.parent) == logdir
    names = [e.get("name", "") for e in json.loads(gzip.decompress(trace.read_bytes()))
             ["traceEvents"] if e.get("cat") == "kernel"]
    assert sum("fused_train_cluster_kernel" in n for n in names) == 1
    assert emap.state.step == 100


def test_block_timer_waits_for_the_card(cuda):
    """``block_timer`` with a CUDA tensor stops its clock after the queued
    kernels finish: at least the CUDA events' time between them."""
    from encodermap_tpu_torch.misc.profiling import block_timer

    x = torch.randn(2048, 2048, device=cuda) / 45.0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with block_timer("matmuls", sync=[x]) as out:
        start.record()
        y = x
        for _ in range(20):
            y = y @ x
        end.record()
    assert out["seconds"] * 1e3 >= 0.95 * start.elapsed_time(end)


def test_function_compiles_on_card(cuda):
    """``function`` compiles with ``torch.compile`` (Inductor, Triton on the
    card) and agrees with its plain ``debug=True`` form."""
    import encodermap_tpu_torch as em

    def f(a, b):
        return torch.tanh(a) * b + a.sum()

    a, b = torch.randn(4096, device=cuda), torch.randn(4096, device=cuda)
    plain = em.function(f, debug=True)(a, b)
    assert em.function(f, debug=True) is f
    got = em.function(f)(a, b)
    assert got.device == a.device
    assert float((got - plain).abs().max()) <= 1e-5 * float(plain.abs().max())


@pytest.mark.parametrize("case", ["odd_side_softstart", "even_no_side", "constant_scale"])
def test_hand_adc_step_on_card_matches_cpu(cuda, case):
    from encodermap_tpu_torch.ops import adc_adjoint
    from tests.test_torch_adc_adjoint import _problem

    net, data, hyper = _problem(case)

    def run(device):
        ws = {k: [torch.tensor(x, dtype=torch.float64, device=device) for x in v]
              for k, v in net.items()}
        d = {k: None if v is None else torch.tensor(v, dtype=torch.float64, device=device)
             for k, v in data.items()}
        *grads, metrics = adc_adjoint.hand_adc_step(
            ws["enc_w"], ws["enc_b"], ws["dec_w"], ws["dec_b"], d["angles"], d["dihedrals"],
            d["ca"], d["distances"], d["side"], 5.0, hyper=hyper)
        leaves = [g.cpu().numpy() for gs in grads for g in gs]
        return leaves, {k: float(v) for k, v in metrics.items()}

    (card, m_card), (cpu, m_cpu) = run(cuda), run("cpu")
    # 1e-12 of each tensor's largest entry: the card's products sum in
    # another order (and fuse multiply-adds), a few ulp of the large terms
    for i, (a, b) in enumerate(zip(card, cpu)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max(),
                                   err_msg=f"gradient {i}")
    for k, v in m_cpu.items():
        assert m_card[k] == pytest.approx(v, rel=1e-12, abs=1e-15), k


def test_adc_step_on_card_within_3x_of_plain_from_float64(cuda, tmp_path):
    """phase_adc's oracle rule at a small size: 8 residues, [32,32,2],
    B=64, after 5 steps on the card."""
    import encodermap_tpu_torch as emt
    from chip_smoke import CV_KEYS, adc_cvs, adc_oracle_check

    cvs = adc_cvs(8, 256, seed=4)
    p = emt.ADCParameters(main_path=str(tmp_path), n_neurons=[32, 32, 2], batch_size=64,
                          n_steps=5, steps_per_scan=5, seed=0, cartesian_pwd_start=1,
                          cartesian_pwd_step=3, use_backbone_angles=True, use_sidechains=True,
                          distance_cost_scale=1.0, cartesian_cost_scale_soft_start=(0, 50))
    emap = emt.AngleDihedralCartesianEncoderMap(cvs, p, read_only=True)
    emap.train()
    batch = tuple(torch.tensor(cvs[k][:64], device=cuda) for k in CV_KEYS)
    out = adc_oracle_check(emap, batch, emap.state.step, "card test")
    assert len(out["errs"]) == 12 and out["loss_rel"] <= 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_general_route_holds_float64_over_100_steps(cuda, seed):
    """phase_general_f64's rule at cube B=1024: 100 steps of the general
    route (EncoderMap(fused_trainer=False), the sigmoid-loss kernels) no
    further from a float64 run of its step than three times the plain
    float32 step (sketch-map loss on the general path), plus 1e-4 in
    parameters and metrics and 1e-3 in the moments. On seed 0's batches
    the plain float32 run itself leaves float64 between steps 60 and 100
    (PERF.md), so the phase holds that seed after 10 steps and only logs
    it after 100; here the rule is held on it after 100 all the same (the
    kernels' route may take the plain run's turn, not go 3x further), and
    on seed 1, where the plain run stays within F64_PART, at full
    strength."""
    import encodermap_tpu_torch as emt
    from chip_smoke import F64_PART, f64_distances, f64_rule, general_f64_runs

    dist = f64_distances(general_f64_runs(emt, "cube", 1024, seed, steps=(100,))[100])
    if seed:
        assert dist["plain f32"]["params"] <= F64_PART, dist
    assert f64_rule(dist), dist


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_kernel_holds_float64_over_100_steps(cuda, seed):
    """phase_fused's float64 hold of the cluster kernel at cube B=256: after
    10 and 100 steps from seed 0's weights over seed ``seed``'s batches, no
    further from a float64 run of its plain version than three times the
    plain float32 version, plus 1e-4 in parameters and metrics and 1e-3 in
    the moments, wherever the plain run stays within F64_PART of float64
    and the plain run on reversed rows passes the rule itself
    (``chip_smoke.hold_f64``). On the cube no float32 run leaves float64 by
    step 10 on any of 16 seeds (PERF.md), so that reading is always held."""
    import encodermap_tpu_torch as emt
    from chip_smoke import fused_drift_runs, hold_f64
    from encodermap_tpu_torch.ops import fused_train as ft

    res = fused_drift_runs(emt, ft, "cube", 256, seed, (10, 100), ("fused_train_cluster",))
    assert hold_f64(f"[cube B=256 seed {seed}]", res, (10, 100),
                    run="fused_train_cluster") >= 1


# ------------------------------------------------------- clip + Adam kernel
def _adc_leaf_shapes(width):
    """The 12 leaves of an ADC at [128,128,2] with a ``width``-wide input, in
    tree order (decoder, then encoder; bias before kernel)."""
    dec = [(2, 128), (128, 128), (128, width)]
    enc = [(width, 128), (128, 128), (128, 2)]
    return [s for k in dec + enc for s in ((k[1],), k)]


#: the benchmark's two ADC configurations: 304 input columns (58 angles, 57
#: dihedrals, 37 side dihedrals on the unit circle) and 412 (206 columns)
ADC_LEAVES = {"adc-128-128-2": _adc_leaf_shapes(304),
              "adc-sidechains-128-128-2": _adc_leaf_shapes(412)}


def _adam_leaves(shapes, dtype, step, device, seed=0):
    """p, m, v and g for leaves of ``shapes``: gradients of scale 1.5, many
    past the clip, the 2-wide bias's gradient zero, moments as after
    ``step - 1`` steps."""
    g = torch.Generator().manual_seed(seed)

    def rand(s, scale=1.0):
        return (torch.randn(s, generator=g, dtype=torch.float64) * scale).to(dtype).to(device)

    p = [rand(s) for s in shapes]
    grads = [torch.zeros(s, dtype=dtype, device=device) if s == (2,) else rand(s, 1.5)
             for s in shapes]
    m = [torch.zeros_like(x) if step == 1 else rand(x.shape, 0.1) for x in p]
    v = [torch.zeros_like(x) if step == 1 else rand(x.shape, 0.1).abs() for x in p]
    return p, m, v, grads


def _plain_adam(p, m, v, grads, step, lr=1e-3):
    from encodermap_tpu_torch.ops.clip_adam import _adam_update

    out = [_adam_update(*x, float(step), lr) for x in zip(p, m, v, grads)]
    return [[o[k] for o in out] for k in range(3)]


@pytest.mark.parametrize("step", [1, 2, 10, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("config", sorted(ADC_LEAVES))
def test_clip_adam_kernel_is_adam_update_bit_for_bit(cuda, config, dtype, step):
    """The kernel against ``_adam_update`` on the card, every leaf of both
    ADC configurations, bit for bit: clipped gradients, a zero gradient, and
    a kernel's gradient handed over transposed (not contiguous); one
    launch, and the inputs keep their values."""
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.ops.clip_adam import clip_adam

    p, m, v, grads = _adam_leaves(ADC_LEAVES[config], dtype, step, cuda)
    grads[3] = grads[3].t().contiguous().t()
    assert not grads[3].is_contiguous()
    assert max(float(x.abs().max()) for x in grads) > 1.0
    before = [x.clone() for x in p + m + v + grads]
    want = _plain_adam(p, m, v, grads, step)
    n = _build.launch_counts["clip_adam"]
    got = clip_adam(p, m, v, grads, float(step), 1e-3)
    torch.cuda.synchronize()
    assert _build.launch_counts["clip_adam"] == n + 1
    for kind, (a, b) in enumerate(zip(got, want)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == dtype and x.shape == y.shape and x.is_contiguous()
            assert torch.equal(x, y), (config, kind, i, float((x - y).abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(before, p + m + v + grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_clip_adam_kernel_over_many_tables_and_unaligned_views(cuda, dtype):
    """100 leaves of ragged sizes (3 to 2,843 elements) take three launches of
    at most 48 leaves; gradients that are views of one flat tensor at odd
    offsets (as the dp route's all-reduced gradients are) go element by
    element; bit for bit ``_adam_update``."""
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.ops.clip_adam import clip_adam

    shapes = [(1 + 29 * (i % 101),) if i % 3 else (i % 7 + 1, 3) for i in range(100)]
    p, m, v, grads = _adam_leaves(shapes, dtype, 7, cuda, seed=1)
    flat = torch.cat([torch.zeros(1, dtype=dtype, device=cuda)]
                     + [x.reshape(-1) for x in grads])
    views, i = [], 1
    for x in grads:
        views.append(flat[i:i + x.numel()].view_as(x))
        i += x.numel()
    want = _plain_adam(p, m, v, views, 7, lr=3e-4)
    n = _build.launch_counts["clip_adam"]
    got = clip_adam(p, m, v, views, 7.0, 3e-4)
    torch.cuda.synchronize()
    assert _build.launch_counts["clip_adam"] == n + 3
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_clip_adam_update_launches_one_kernel_on_the_card(cuda):
    """``ClipAdam.update`` over the sidechain ADC's 12 leaves puts one
    kernel on the card, the clip + Adam kernel, and nothing else (traced in
    a process of its own: CUPTI may stop recording in a process that traced
    much before)."""
    import json
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    code = textwrap.dedent("""
        import json
        import torch
        from torch.profiler import ProfilerActivity, profile
        from tests.test_torch_cuda import ADC_LEAVES, _adam_leaves
        from encodermap_tpu_torch.train.core import ClipAdam, tree_unflatten

        p, m, v, g = _adam_leaves(ADC_LEAVES["adc-sidechains-128-128-2"], torch.float32, 3,
                                  torch.device("cuda"))
        tree = lambda xs: tree_unflatten({"leaves": list(range(12))}, xs)
        opt, state = ClipAdam(1e-3), {"count": 2, "mu": tree(m), "nu": tree(v)}
        opt.update(tree(g), state, tree(p))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opt.update(tree(g), state, tree(p))
            torch.cuda.synchronize()
        print(json.dumps([e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA]))
    """)
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    names = json.loads(run.stdout.splitlines()[-1])
    assert len(names) == 1 and "clip_adam_kernel" in names[0], names


def test_adc_train_launches_one_clip_adam_a_step_and_keeps_the_old_state(cuda, tmp_path):
    """A three-step ADC chunk at trp-cage scale through ``train()``: one
    clip + Adam launch a step, and the state it started from (parameters
    and both moments) keeps its values."""
    import encodermap_tpu_torch as em
    from encodermap_tpu_torch.ops import _build
    from encodermap_tpu_torch.train.core import tree_leaves

    p = em.ADCParameters(main_path=str(tmp_path), n_neurons=[128, 128, 2], batch_size=256,
                         n_steps=3, steps_per_scan=3, seed=0, cartesian_pwd_start=1,
                         cartesian_pwd_step=3)
    emap = em.AngleDihedralCartesianEncoderMap(_adc_cvs(20, 1024), p, device=cuda)
    old = tree_leaves((emap.state.params, emap.state.opt_state["mu"],
                       emap.state.opt_state["nu"]))
    kept = [x.clone() for x in old]
    n = _build.launch_counts["clip_adam"]
    emap.train()
    torch.cuda.synchronize()
    assert _build.launch_counts["clip_adam"] - n == 3
    assert emap.state.opt_state["count"] == 3
    assert all(torch.equal(a, b) for a, b in zip(old, kept))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(emap.state.params), kept))


def test_clip_adam_wrapper_refuses_what_it_does_not_take(cuda):
    """Half precision, two types, two devices, a non-contiguous parameter
    and leaves of different shapes raise before any launch."""
    from encodermap_tpu_torch.ops.clip_adam import clip_adam

    p, m, v, g = _adam_leaves([(5, 3), (3,)], torch.float32, 2, cuda)
    with pytest.raises(TypeError):
        clip_adam([x.half() for x in p], m, v, g, 2.0, 1e-3)
    with pytest.raises(TypeError):
        clip_adam(p, m, v, [g[0].double(), g[1]], 2.0, 1e-3)
    with pytest.raises(ValueError):
        clip_adam(p, m, v, [g[0].cpu(), g[1]], 2.0, 1e-3)
    with pytest.raises(ValueError):
        clip_adam([p[0].t().contiguous().t(), p[1]], m, v, g, 2.0, 1e-3)
    with pytest.raises(ValueError):
        clip_adam(p, m, v, [g[0][:4], g[1]], 2.0, 1e-3)
