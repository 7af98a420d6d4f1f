"""The generators repeat from a seed and make what the traffic mixes say."""

import math

import numpy as np
import pytest
import torch

from portbench import generators, harness, proteins

SEED = 2 ** 31 + 5


def test_dihedral_frames_repeat_from_a_seed_and_cover_the_range():
    t = harness.load_cell("em-ala2-b256")["traffic"]
    a = generators.make(t, SEED, "cpu", 500)
    b = generators.make(t, SEED, "cpu", 500)
    c = generators.make(t, SEED + 1, "cpu", 500)
    assert a.shape == (500, 4) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= -math.pi and a.max() <= math.pi


def test_protein_dihedrals_take_the_backbone_width():
    t = {"generator": "dihedral_frames", "protein": {"name": "trp-cage"},
         "range": [-math.pi, math.pi]}
    assert generators.make(t, SEED, "cpu", 10).shape == (10, 57)


def _cvs_mix(protein: dict) -> dict:
    t = dict(harness.load_cell("adc-trpcage-b256")["traffic"])
    t["protein"] = protein
    return t


@pytest.mark.parametrize("protein, widths", [
    ({"name": "trp-cage"}, (58, 57, 59, 37, 60)),
    ({"name": "ubiquitin", "copies": 2}, (454, 453, 455, 322, 456)),
])
def test_protein_cvs_repeat_and_have_the_published_widths(protein, widths):
    t = _cvs_mix(protein)
    a = generators.make(t, SEED, "cpu", 6)
    b = generators.make(t, SEED, "cpu", 6)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    got = (a["central_angles"].shape[1], a["central_dihedrals"].shape[1],
           a["central_distances"].shape[1], a["side_dihedrals"].shape[1],
           a["central_cartesians"].shape[1])
    assert got == widths
    assert a["central_cartesians"].shape[2] == 3


def _internal(xyz):
    """Bond lengths, angles and IUPAC dihedrals of (B, n, 3) coordinates:
    atan2(b2/|b2| . (n1 x n2), n1 . n2) with n1 = b1 x b2, n2 = b2 x b3."""
    b = xyz[:, 1:] - xyz[:, :-1]
    d = torch.linalg.norm(b, dim=-1)
    u = b / d[..., None]
    ang = torch.acos((-u[:, :-1] * u[:, 1:]).sum(-1))
    n1 = torch.linalg.cross(b[:, :-2], b[:, 1:-1], dim=-1)
    n2 = torch.linalg.cross(b[:, 1:-1], b[:, 2:], dim=-1)
    y = (torch.linalg.cross(n1, n2, dim=-1) * u[:, 1:-1]).sum(-1)
    dih = torch.atan2(y, (n1 * n2).sum(-1))
    return d, ang, dih


def test_nerf_chain_places_the_internal_coordinates_it_is_given():
    g = torch.Generator().manual_seed(3)
    n = 12
    d = 0.13 + 0.025 * torch.rand((4, n - 1), generator=g, dtype=torch.float64)
    a = 1.6 + 0.8 * torch.rand((4, n - 2), generator=g, dtype=torch.float64)
    t = (2 * torch.rand((4, n - 3), generator=g, dtype=torch.float64) - 1) * math.pi
    xyz = generators.nerf_chain(d, a, t)
    d2, a2, t2 = _internal(xyz)
    assert torch.allclose(d2, d, atol=1e-12)
    assert torch.allclose(a2, a, atol=1e-10)
    assert torch.allclose(torch.remainder(t2 - t + math.pi, 2 * math.pi) - math.pi,
                          torch.zeros_like(t), atol=1e-9)


def test_check_rows_all_differ_and_repeat():
    r = generators.check_rows(1100, 4, 256, SEED, "cpu")
    assert r.shape == (4, 256) and len(np.unique(r)) == 1024
    assert np.array_equal(r, generators.check_rows(1100, 4, 256, SEED, "cpu"))
    with pytest.raises(ValueError):
        generators.check_rows(1000, 4, 256, SEED, "cpu")


def test_weights_repeat_and_have_the_reference_spread():
    shapes = [("encoder.0.kernel", (400, 300)), ("encoder.0.bias", (300,))]
    w = generators.weights(shapes, SEED, "cpu")
    again = generators.weights(shapes, SEED, "cpu")
    assert torch.equal(w["encoder.0.kernel"], again["encoder.0.kernel"])
    assert abs(float(w["encoder.0.kernel"].var()) * 400 - 1.0) < 0.05
    assert abs(float(w["encoder.0.bias"].mean()) - 0.1) < 0.01
    assert abs(float(w["encoder.0.bias"].std()) - 0.05) < 0.01


def test_stream_seeds_differ_and_take_large_seeds():
    s = {generators.stream_seed(2 ** 33 + 1, k) for k in ("data", "weights", "check")}
    assert len(s) == 3 and all(0 <= x < 2 ** 63 for x in s)


def test_side_dihedral_counts():
    assert proteins.widths(proteins.sequence({"name": "trp-cage"}))["side_dihedrals"] == 37
    diubi = proteins.sequence({"name": "ubiquitin", "copies": 2})
    assert len(diubi) == 152 and proteins.widths(diubi)["side_dihedrals"] == 322
