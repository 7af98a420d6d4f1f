"""The plain reference against the port, on the CPU at tiny sizes."""

import math

import pytest
import torch

from portbench.reference import plain

CELLS = ("em-ala2-b256", "adc-trpcage-b256")


@pytest.mark.parametrize("n_atoms", [9, 12, 60])
def test_backmap_equals_the_port(n_atoms):
    from encodermap_tpu_torch.ops.backmap import backmap

    g = torch.Generator().manual_seed(n_atoms)
    B = 5
    d = 0.13 + 0.025 * torch.rand((B, n_atoms - 1), generator=g, dtype=torch.float64)
    a = 1.6 + 0.8 * torch.rand((B, n_atoms - 2), generator=g, dtype=torch.float64)
    t = (2 * torch.rand((B, n_atoms - 3), generator=g, dtype=torch.float64) - 1) * math.pi
    assert torch.allclose(plain.backmap(d, a, t), backmap(d, a, t), atol=1e-11)


@pytest.mark.parametrize("D, period", [(4, 2 * math.pi), (57, 2 * math.pi), (190, math.inf)])
def test_sketchmap_equals_the_port(D, period):
    from encodermap_tpu_torch.ops.fused_sigmoid import sigmoid_loss_general

    g = torch.Generator().manual_seed(D)
    h = (2 * torch.rand((32, D), generator=g, dtype=torch.float64) - 1) * 3
    lat = torch.randn((32, 2), generator=g, dtype=torch.float64)
    params = (4.5, 12, 6, 1, 2, 6)
    assert float(plain.sketchmap(h, lat, params, period)) == pytest.approx(
        float(sigmoid_loss_general(h, lat, params, period)), rel=1e-9)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_of_the_port_on_the_cpu_holds_to_the_reference(cpu_run, cell):
    r = cpu_run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 100 and r["failed"] == 0
