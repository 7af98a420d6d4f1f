# tests/test_torch_multimer_reference.py
"""The ADC's multimer training against the benchmark's plain reference of
it (``portbench/reference/adc-multimer-128-128-2.py``), on the CPU at small
sizes, and the benchmark's maker of dimer CVs (``portbench/makers/
dimer-cvs.py``), both loaded by path as the benchmark's harness loads them.

Unequal chains, so that an offset of one protein's columns shows: one
case under ``MIN_MATRIX_ATOMS`` selected CAs, where the program feeds the
CA-pair sketch-map cost its flat pairs, and one over it, where it feeds the
full distance matrices with sigma scaled by sqrt(2): the reference's flat
form checks that route independently. The program's multimer pieces in
float64 equal the reference's; ``train()`` in float32 follows the float64
reference over the benchmark's four checked steps within the cell's
limits."""

import math

import numpy as np
import pytest
import torch

from encodermap_tpu_torch.train.adc_autoencoder import MIN_MATRIX_ATOMS
from portbench import generators, harness, proteins

torch.set_num_threads(1)

CELL = "adc-diubi-dimer-b256"
SEED = 2 ** 31 + 2611
FRAMES, BATCH = 96, 16
#: residues per chain: 9 CAs (flat pairs) and 65 CAs (the matrix route)
CASES = {"flat": [5, 4], "matrix": [34, 31]}


def _cell() -> dict:
    return harness.load_cell(CELL)


def _maker():
    return harness.load_module(harness.ROOT / "portbench" / "makers" / "dimer-cvs.py",
                               "portbench_maker_dimer_cvs")


def _reference():
    return harness.reference_module(_cell())


def _case(lengths: list, frames: int = FRAMES) -> tuple[dict, dict]:
    """The cell's parameters at these chains and a small batch, and CVs of
    chains cut from ubiquitin made by the cell's maker."""
    cell = _cell()
    p = dict(cell["config"]["parameters"], multimer_lengths=list(lengths),
             batch_size=BATCH, steps_per_scan=4)
    seqs = [proteins.SEQUENCES["ubiquitin"][:L] for L in lengths]
    gen = torch.Generator().manual_seed(generators.stream_seed(SEED, "data"))
    with torch.no_grad():
        cvs, _ = _maker().block(cell["traffic"], seqs, gen, frames, "cpu")
    return p, {k: v.to(torch.float32).numpy() for k, v in cvs.items()}


def _weights(p: dict, data: dict) -> dict:
    shapes = _reference().weight_shapes(p, data)
    return generators.weights(shapes, SEED, "cpu")


@pytest.mark.parametrize("route", list(CASES))
def test_the_program_selects_the_route_its_case_names(route):
    n_ca = sum(CASES[route])
    assert (n_ca >= MIN_MATRIX_ATOMS) == (route == "matrix")


@pytest.mark.parametrize("route", list(CASES))
def test_the_programs_float64_multimer_pieces_are_the_references(tmp_path, route):
    """In float64 on one batch (the program's dense layers compute in
    float32 whatever their weights, so its multimer pieces are held one by
    one): the encoder's CA pair block; the multimer backmap with decoded
    transforms that are not rigid; and the Cartesian cost and the CA-pair
    sketch-map cost by the route the program takes, against the
    reference's flat pairs. Values and gradients (to the decoded angles,
    dihedrals and transforms and to the latent) to 1e-9."""
    from encodermap_tpu_torch.models import adc
    from encodermap_tpu_torch.ops.backmap import backmap_multimer
    from portbench.reference import plain

    lengths = CASES[route]
    p, data = _case(lengths)
    ref = _reference()
    model = harness.build_model({"model": "AngleDihedralCartesianEncoderMap",
                                 "parameters": p}, data, _weights(p, data), SEED,
                                str(tmp_path), "cpu")
    angles, dihedrals, xyz, distances, _ = (
        torch.as_tensor(data[k][:BATCH], dtype=torch.float64) for k in ref.CVS)
    sel = slice(p["cartesian_pwd_start"], p["cartesian_pwd_stop"], p["cartesian_pwd_step"])
    inp_pairs = plain.flat_pair_dists(xyz[:, sel])
    assert torch.allclose(adc.cartesian_pwd_slice(model.p, xyz), inp_pairs,
                          rtol=1e-12, atol=0)

    g = torch.Generator().manual_seed(7)
    mats = torch.eye(4, dtype=torch.float64) + 0.3 * torch.randn(
        (BATCH, len(lengths) - 1, 4, 4), generator=g, dtype=torch.float64)
    latent = torch.randn((BATCH, 2), generator=g, dtype=torch.float64)
    # decoded angles and dihedrals: the input's, moved
    decoded = (angles + 0.1 * torch.randn(angles.shape, generator=g, dtype=torch.float64),
               dihedrals + 0.5 * torch.randn(dihedrals.shape, generator=g,
                                             dtype=torch.float64))

    def run(program):
        a, t, m, lat = (x.clone().requires_grad_(True) for x in (*decoded, mats, latent))
        if program:
            back = backmap_multimer(lengths, distances, a, t, m)
            cart, cdist = model._cartesian_terms(
                xyz[:, sel], back[:, sel], lat, torch.tensor(1.0, dtype=torch.float64))
        else:
            back = ref.backmap(lengths, distances, a, t, m)
            cart = torch.abs(inp_pairs - plain.flat_pair_dists(back[:, sel])).mean()
            cdist = ref.ca_sketchmap(inp_pairs, lat, p["cartesian_dist_sig_parameters"])
        w = torch.linspace(-1, 1, back.numel(), dtype=torch.float64).reshape(back.shape)
        total = (back * w).sum() + cart + cdist
        return [back.detach(), cart.detach(), cdist.detach()] + list(
            torch.autograd.grad(total, [a, t, m, lat]))

    for name, got, want in zip(("back", "cart", "cdist", "d_angles", "d_dihedrals",
                                "d_transforms", "d_latent"), run(True), run(False)):
        assert got.dtype == torch.float64, name
        scale = float(want.abs().max()) or 1.0
        assert float((got - want).abs().max()) <= 1e-9 * scale, name


@pytest.mark.parametrize("route", list(CASES))
def test_train_follows_the_reference_over_the_checked_steps(tmp_path, route):
    """``train()`` in float32 through the benchmark's four checked steps
    (step 1 alone, steps 2-4 as one chunk) against the float64 reference:
    every number the cell holds within its limit, and the first step's loss
    and gradient far tighter."""
    p, data = _case(CASES[route])
    weights = _weights(p, data)
    rows = generators.check_rows(FRAMES, harness.CHECK_STEPS, BATCH, SEED, "cpu")
    model = harness.build_model({"model": "AngleDihedralCartesianEncoderMap",
                                 "parameters": p}, data, weights, SEED, str(tmp_path), "cpu")
    prog = harness.check_steps(model, rows)
    ref = _reference().follow(p, weights, data, rows, torch.float64, "cpu")
    numbers = harness.compare(prog, ref)
    assert len(prog["losses"]) == harness.CHECK_STEPS
    for name, limit in _cell()["workload"]["limits"].items():
        assert numbers[name] <= limit, (name, numbers[name])
    assert numbers["loss1_gap"] < 1e-6 and numbers["grad_med_gap"] < 1e-4


def _measure(xyz: np.ndarray) -> tuple:
    """Bond lengths, bond angles and IUPAC dihedrals along a chain."""
    b = np.diff(xyz, axis=1)
    bonds = np.linalg.norm(b, axis=-1)
    u = b / bonds[..., None]
    angles = np.arccos(np.clip(-(u[:, :-1] * u[:, 1:]).sum(-1), -1, 1))
    b1, b2, b3 = b[:, :-2], b[:, 1:-1], b[:, 2:]
    n2 = np.cross(b2, b3)
    dih = np.arctan2(bonds[:, 1:-1] * (b1 * n2).sum(-1), (np.cross(b1, b2) * n2).sum(-1))
    return bonds, angles, dih


@pytest.mark.parametrize("lengths", [[5, 4], [76, 76]], ids=["unequal", "diubiquitin"])
def test_the_maker_places_chains_whose_cvs_measure_back(lengths):
    """Each chain's bond lengths, angles and dihedrals, measured from the
    float64 coordinates after chain 2's transform is undone, are the drawn
    CVs to 1e-9; the transform is rigid, its rotation proper and its shift
    within the mix's range."""
    cell = _cell()
    traffic = cell["traffic"]
    seqs = [proteins.SEQUENCES["ubiquitin"][:L] for L in lengths]
    gen = torch.Generator().manual_seed(generators.stream_seed(SEED, "data"))
    with torch.no_grad():
        cvs, mats = _maker().block(traffic, seqs, gen, 6, "cpu")
    xyz = cvs["central_cartesians"].numpy()
    mats = mats.numpy()
    assert xyz.dtype == np.float64 and mats.shape == (6, 1, 4, 4)
    rot, shift = mats[:, 0, :3, :3], mats[:, 0, 3, :3]
    assert np.allclose(rot @ rot.transpose(0, 2, 1), np.eye(3), atol=1e-12)
    assert np.allclose(np.linalg.det(rot), 1.0, atol=1e-12)
    assert np.allclose(mats[:, 0, :, 3], [0, 0, 0, 1])
    lo, hi = traffic["shift"]
    assert (shift >= lo).all() and (shift <= hi).all()
    n1 = 3 * lengths[0]
    homo = np.concatenate([xyz[:, n1:], np.ones_like(xyz[:, n1:, :1])], -1)
    second = (homo @ np.linalg.inv(mats[:, 0]))[..., :3]
    # the first chain stands where NeRF builds it: atom 0 at the origin
    assert np.abs(xyz[:, 0]).max() == 0.0
    assert np.abs(second[:, 0]).max() < 1e-12
    cols = {"central_distances": (0, -1), "central_angles": (1, -2),
            "central_dihedrals": (2, -3)}
    for c, chain in enumerate((xyz[:, :n1], second)):
        got = _measure(chain)
        for key, (i, off) in cols.items():
            start = sum(3 * L + off for L in lengths[:c])
            want = cvs[key].numpy()[:, start:start + 3 * lengths[c] + off].astype(np.float64)
            diff = got[i] - want
            if key == "central_dihedrals":
                diff = (diff + math.pi) % (2 * math.pi) - math.pi
            assert np.abs(diff).max() < 1e-9, (c, key)
    side = sum(proteins.CHI_COUNT[a] for s in seqs for a in s)
    assert cvs["side_dihedrals"].shape == (6, side)


def test_the_references_widths_are_the_cells():
    """The reference's shapes and weights at the cell's own widths, from a
    few frames of its traffic: 13,924 columns in (2,448 of the angle groups'
    sin and cos and 11,476 CA pairs), 2,464 out (16 transform entries),
    2,133,922 parameters, 456 atoms, 152 CAs, 3,046 float32 a frame."""
    cell = _cell()
    data = harness.make_data(cell, SEED, "cpu", 2)
    ref = _reference()
    s = ref.shapes(cell["config"]["parameters"], data)
    assert s["dims"] == [13924, 128, 128, 2, 128, 128, 2464]
    assert (s["enc_d"], s["n_atoms"], s["n_ca"]) == (1224, 456, 152)
    shapes = ref.weight_shapes(cell["config"]["parameters"], data)
    assert sum(math.prod(x) for _, x in shapes) == 2133922
    assert sum(math.prod(v.shape[1:]) for v in data.values()) == 3046
    assert all(v.dtype == np.float32 for v in data.values())


def _metric(name: str):
    return harness.load_module(harness.ROOT / "portbench" / "metrics" / f"{name}.py",
                               "portbench_metric_" + name.replace(".", "_"))


def test_the_multimer_backmap_readers_read_the_spans_and_the_counter():
    """From a traced run's context: the device time under the backmap's two
    spans a step, and its compulsory bytes (10,960 a row forward and 14,632
    backward on diubiquitin in float32) at the card's peak over that time;
    nothing where the backward has no span (a program without it) or the
    counter is missing."""
    ms, roof = (_metric("multimer_backmap_ms_per_step.adc"),
                _metric("multimer_backmap_roofline.adc"))
    assert roof.row_bytes(456, 2) == (10960, 14632)
    rows = {"fwd": 100, "rows_fwd": 25600, "proteins": 200, "bwd": 100, "rows_bwd": 25600}
    ctx = {"shapes": {"n_atoms": 456},
           "spans": {"traced_steps": 100, "counters": {"multimer_backmap": rows},
                     "trace": {"device_incl_s": {"adc.backmap": 0.004,
                                                 "adc.backmap_backward": 0.006}}}}
    assert ms.read(ctx) == pytest.approx(0.1)
    least = 25600 * (10960 + 14632) / 3.35e12
    assert roof.read(ctx) == pytest.approx(100 * least / 0.01)
    parent = {**ctx, "spans": {**ctx["spans"], "counters": {},
                               "trace": {"device_incl_s": {"adc.backmap": 0.004}}}}
    assert ms.read(parent) is None and roof.read(parent) is None
    no_counter = {**ctx, "spans": {**ctx["spans"], "counters": {}}}
    assert roof.read(no_counter) is None and ms.read(no_counter) == pytest.approx(0.1)
    assert ms.read({}) is None and roof.read({}) is None
