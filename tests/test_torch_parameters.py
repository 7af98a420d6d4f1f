# tests/test_torch_parameters.py
"""The port's Parameters/ADCParameters against the JAX package's: the same
fields with the same defaults, and a parameters.json written by either
package loads in the other."""

import dataclasses
import math

import pytest
import torch

import encodermap_tpu.parameters as jp
import encodermap_tpu_torch.parameters as tp

torch.set_num_threads(1)

PAIRS = [(jp.Parameters, tp.Parameters), (jp.ADCParameters, tp.ADCParameters)]


@pytest.mark.parametrize("jcls,tcls", PAIRS, ids=["Parameters", "ADCParameters"])
def test_same_fields_and_defaults(jcls, tcls):
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert jf == tf
    assert jcls().to_dict() == tcls().to_dict()


@pytest.mark.parametrize("jcls,tcls", PAIRS, ids=["Parameters", "ADCParameters"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_parameters_json_loads_both_ways(tmp_path, jcls, tcls, direction):
    src, dst = (jcls, tcls) if direction == "jax_to_torch" else (tcls, jcls)
    p = src(main_path=str(tmp_path), periodicity=float("inf"),
            n_neurons=[32, 16, 2], n_steps=77, steps_per_scan=11,
            fused_trainer=False, dist_sig_parameters=(3.0, 6, 3, 1, 2, 4))
    path = p.save()
    loaded = dst.from_file(path)
    assert loaded.to_dict() == p.to_dict()
    assert math.isinf(loaded.periodicity)


def test_length_check_and_dict_access():
    with pytest.raises(ValueError):
        tp.Parameters(n_neurons=[8, 2], activation_functions=["", "tanh"])
    p = tp.Parameters()
    p["batch_size"] = 64
    assert p.batch_size == 64
    with pytest.raises(TypeError):
        p.update(learning_rte=1.0)


def test_relocated_file_repairs_main_path(tmp_path):
    p = tp.Parameters(main_path=str(tmp_path / "a"))
    path = p.save()
    moved = tmp_path / "b"
    moved.mkdir()
    (moved / "parameters.json").write_text((tmp_path / "a" / "parameters.json").read_text())
    assert tp.Parameters.from_file(moved / "parameters.json").main_path == str(moved)
    assert path.endswith("parameters.json")
