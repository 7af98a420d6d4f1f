# tests/test_torch_api.py
"""The port's metric classes and streaming entry points against the JAX
package's API.

The metric classes take the JAX package's arguments (compared with
``inspect.signature``: names, kinds and defaults), and each is called once
against its JAX counterpart: ``rmsd_numpy`` to 1e-5 nm on both values of
``translate``, the step-mismatch check, ``get_config``/``from_config``, and
the empty bases. ``train_streaming`` runs on every trainer from a batch
source (its parity with the JAX package is in ``test_torch_streaming.py``)
and refuses a bare path, which only the ADC reads itself.
"""

import inspect

import numpy as np
import pytest
import torch

import encodermap_tpu.train.metrics as MJ
import encodermap_tpu_torch as emt
import encodermap_tpu_torch.train.metrics as MT

torch.set_num_threads(1)

SIGNED = [("rmsd_numpy", None), ("EncoderMapBaseMetric", "__init__"),
          ("EncoderMapBaseMetric", "from_config"), ("EncoderMapBaseMetric", "get_config"),
          ("ADCClashMetric", "__init__"), ("ADCRMSDMetric", "__init__")]


def _params(sig):
    return [(p.name, p.kind, p.default) for p in sig.parameters.values()]


@pytest.mark.parametrize("name,method", SIGNED, ids=lambda x: str(x))
def test_signatures_match_jax(name, method):
    get = (lambda m: getattr(m, name)) if method is None else \
        (lambda m: getattr(getattr(m, name), method))
    assert _params(inspect.signature(get(MT))) == _params(inspect.signature(get(MJ)))


def test_exports_match_jax():
    assert set(MJ.__all__) <= set(MT.__all__)
    for name in ("OmegaAngleBaseMetric", "SidechainVsBackboneFrequencyBaseMetric"):
        cls_t, cls_j = getattr(MT, name), getattr(MJ, name)
        assert issubclass(cls_t, MT.AngleDihedralCartesianEncoderMapBaseMetric)
        assert [c.__name__ for c in cls_t.__mro__[:3]] == [c.__name__ for c in cls_j.__mro__[:3]]


@pytest.mark.parametrize("translate", [True, False])
def test_rmsd_numpy_matches_jax(translate):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 9, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.1, a.shape).astype(np.float32)
    np.testing.assert_allclose(MT.rmsd_numpy(a, b, translate=translate),
                               MJ.rmsd_numpy(a, b, translate=translate), atol=1e-5)


def test_base_metric_checks_the_training_step():
    class Zero(MT.OmegaAngleBaseMetric):
        def update(self, y_true, y_pred):
            return torch.zeros(())

    p = emt.ADCParameters(current_training_step=3)
    assert Zero(parameters=p, current_training_step=3).p is p
    with pytest.raises(Exception, match="training step is 3"):
        Zero(parameters=p, current_training_step=4)
    with pytest.raises(Exception, match="update"):
        MT.SidechainVsBackboneFrequencyBaseMetric()


def test_config_round_trip_matches_jax():
    p = emt.ADCParameters(n_neurons=[8, 8, 2])
    for cls_t, cls_j in ((MT.ADCClashMetric, MJ.ADCClashMetric),
                         (MT.ADCRMSDMetric, MJ.ADCRMSDMetric)):
        kw = dict(distance_unit="ang") if cls_t is MT.ADCClashMetric else {}
        metric = cls_t(parameters=p, **kw)
        config = metric.get_config()
        ref = cls_j(parameters=MJ.ADCParameters(n_neurons=[8, 8, 2]), **kw).get_config()
        assert config.keys() == ref.keys() and config["name"] == ref["name"]
        again = cls_t.from_config(config)
        assert isinstance(again.p, emt.ADCParameters) and again.p.n_neurons == [8, 8, 2]
        assert again.get_config() == config
    assert MT.ADCClashMetric.from_config(
        MT.ADCClashMetric(distance_unit="ang").get_config()).clash_distance == 1.0


def test_train_streaming_waits_for_slice_4(tmp_path):
    data = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    for cls in (emt.Autoencoder, emt.EncoderMap, emt.DihedralEncoderMap):
        emap = cls(emt.Parameters(main_path=str(tmp_path), n_neurons=[8, 8, 2],
                                  batch_size=8), data, read_only=True, device="cpu")
        with pytest.raises(TypeError, match="HDF5BatchSource"):
            emap.train_streaming(str(tmp_path / "data.h5"))
        superbatches = [data[:24].reshape(3, 8, 3), data[24:48].reshape(3, 8, 3)]
        hist = emap.train_streaming(iter(superbatches), n_steps=5)
        assert len(hist["loss"]) == 5 and np.isfinite(hist["loss"]).all()
        assert emap.state.step == 5
