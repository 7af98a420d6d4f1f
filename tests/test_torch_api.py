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

The surface of slices 6a to 6c against the JAX package: the top-level names
(with ``plot``, ``function`` and ``InteractivePlotting``), the public names
of every subpackage and of ``em.callbacks``, the module files, and the
trainers' methods, ``parallel.shard_params_tp`` and ``ops/adc_adjoint.py``
among them; the Pallas modules are the kernel wrappers. Slice 6a's names
(``MolData``, ``get_from_kondata``, ``load_project``, ``DaskFeaturizer``,
``CustomAAsDict``, the subpackages, ``em.callbacks`` with the metric
classes, ``__version__``); the ``misc`` helpers, equal to the JAX
package's outputs exactly (numpy in both); the ``encoder``/``decoder``
submodels with ``predict`` and ``set_train_data`` at the same weights
(1e-5); ``save_model``/``load_model`` both ways and ``load_pytree_into``;
``get_train_data_from_trajs`` exactly; and the ``loss_classes`` losses,
gated on ``ENCODERMAP_TESTING`` and attached to an ADC from the same
weights, over one step (every logged term to 1e-5 relative, the
parameters after it to 1e-5).
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


# ------------------------------------------------------- slice 6a surface
TOP_LEVEL = ["MolData", "get_from_kondata", "load_project", "DaskFeaturizer",
             "CustomAAsDict", "features", "misc", "loading", "data", "parallel",
             "models", "callbacks", "EncoderMapBaseCallback", "__version__",
             "plot", "function", "InteractivePlotting"]


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_names_match_jax(name):
    import encodermap_tpu as emj

    got, ref = getattr(emt, name), getattr(emj, name)
    if name == "__version__":
        assert got == ref
    elif inspect.ismodule(ref):
        assert inspect.ismodule(got)
        assert got.__name__ == ref.__name__.replace("encodermap_tpu", "encodermap_tpu_torch")
    elif name == "EncoderMapBaseCallback":
        assert got is emt.Callback
    elif name != "CustomAAsDict":
        assert got.__name__ == ref.__name__
        if callable(ref) and not inspect.isclass(ref):
            want = [p.name for p in inspect.signature(ref).parameters.values()]
            have = [p.name for p in inspect.signature(got).parameters.values()]
            assert have[:len(want)] == want


#: JAX modules the port replaces by name: the Pallas kernels' modules by the
#: hand kernels' wrappers
KERNEL_MODULES = {"pallas_sigmoid": "fused_sigmoid", "pallas_train": "fused_train"}
#: still to port (ROADMAP.md Queue 1): nothing; the last two, the
#: tensor-parallel axis and the float64 ADC gradient oracle, came in slice 6c
LATER_NAMES: dict = {}
LATER_FILES: set = set()
SUBPACKAGES = ["ops", "models", "misc", "plot", "parallel", "callbacks", "data",
               "loading", "train"]


def _own_names(mod, pkg: str) -> set:
    """Public names of ``mod`` that are the package's own: its submodules and
    the classes and functions it defines (not the helpers it imports)."""
    out = set()
    for name in dir(mod):
        obj = getattr(mod, name)
        if name.startswith("_"):
            continue
        if inspect.ismodule(obj):
            if obj.__name__.startswith(pkg + "."):
                out.add(name)
        elif str(getattr(obj, "__module__", "")).split(".")[0] == pkg:
            out.add(name)
    return out


def _import_submodules(pkg) -> None:
    """Import every Python submodule of the package ``pkg``: a package's
    attributes include the submodules imported so far, so without this its
    names would depend on what earlier tests in the process imported."""
    import importlib
    import importlib.util
    import pkgutil

    for info in pkgutil.walk_packages(getattr(pkg, "__path__", []), pkg.__name__ + "."):
        if str(importlib.util.find_spec(info.name).origin).endswith(".py"):
            importlib.import_module(info.name)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_names_match_jax(sub):
    import importlib

    import encodermap_tpu as emj

    ref = emj.callbacks if sub == "callbacks" else importlib.import_module(
        f"encodermap_tpu.{sub}")
    got = emt.callbacks if sub == "callbacks" else importlib.import_module(
        f"encodermap_tpu_torch.{sub}")
    _import_submodules(ref)
    _import_submodules(got)
    missing = (_own_names(ref, "encodermap_tpu") - _own_names(got, "encodermap_tpu_torch")
               - set(KERNEL_MODULES))
    assert missing <= LATER_NAMES.get(sub, set())
    if hasattr(ref, "__all__"):
        assert set(ref.__all__) - set(got.__all__) <= LATER_NAMES.get(sub, set())
    if sub in ("parallel", "ops"):
        assert not missing and {"shard_params_tp", "adc_adjoint"} & _own_names(
            got, "encodermap_tpu_torch")


def test_module_files_match_jax():
    from pathlib import Path

    root = Path(emt.__file__).parent.parent

    def files(pkg):
        return {str(p.relative_to(root / pkg)) for p in (root / pkg).rglob("*.py")}

    have = files("encodermap_tpu_torch")
    assert files("encodermap_tpu") - have == \
        LATER_FILES | {f"ops/{k}.py" for k in KERNEL_MODULES}
    assert {f"ops/{v}.py" for v in KERNEL_MODULES.values()} <= have


@pytest.mark.parametrize("name", ["Autoencoder", "EncoderMap", "DihedralEncoderMap",
                                  "AngleDihedralCartesianEncoderMap"])
def test_trainer_methods_match_jax(name):
    import encodermap_tpu as emj

    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    assert public(getattr(emj, name)) <= public(getattr(emt, name))
    for method in ("add_images_to_tensorboard", "plot_network"):
        want = inspect.signature(getattr(getattr(emj, name), method))
        have = inspect.signature(getattr(getattr(emt, name), method))
        assert _params(have) == _params(want)


def test_callbacks_namespace_matches_jax():
    import encodermap_tpu as emj

    names = {n for n in dir(emj.callbacks) if not n.startswith("_")
             and not inspect.ismodule(getattr(emj.callbacks, n))}
    have = {n for n in dir(emt.callbacks) if not n.startswith("_")}
    # the helpers the JAX module imports for itself
    helpers = {"annotations", "jax", "jnp", "np", "Any", "Optional", "Path", "Union",
               "Callable", "dataclass", "field", "time", "json", "math", "sys", "os",
               "warnings", "partial"}
    assert names - have <= helpers
    assert "ImageCallback" in have
    assert emt.callbacks.EncoderMapBaseCallback is emt.Callback
    assert emt.callbacks.NoneInterruptCallback is emt.NaNInterrupt
    assert emt.callbacks.EncoderMapBaseMetric is MT.EncoderMapBaseMetric


def test_misc_helpers_match_jax(tmp_path):
    import encodermap_tpu.misc as misc_j
    import encodermap_tpu.ops.distances as dist_j
    import encodermap_tpu_torch.misc as misc_t
    import encodermap_tpu_torch.ops.distances as dist_t

    for a, b in zip(misc_t.random_on_cube_edges(200, sigma=0.05, seed=3),
                    misc_j.random_on_cube_edges(200, sigma=0.05, seed=3)):
        np.testing.assert_array_equal(a, b)
    assert misc_t.run_path(str(tmp_path)).endswith("run0")
    assert misc_j.run_path(str(tmp_path)).endswith("run1")
    assert misc_t.run_path(str(tmp_path)).endswith("run2")
    for seq in ([], [1, 1, 1], [1, 2], "aab"):
        assert misc_t.all_equal(seq) == misc_j.all_equal(seq)
    rows = [{"name": "a", "value": 1}, {"name": "bb", "value": "x￺y"}]
    for kw in ({}, {"colList": ["value"]}, {"sep": "￺"}, {"sep": "|"}):
        assert misc_t.printTable(rows, **kw) == misc_j.printTable(rows, **kw)
    pos = np.random.default_rng(0).normal(size=(16, 4, 3))
    np.testing.assert_array_equal(misc_t.arbitrary_dihedral(pos),
                                  misc_j.arbitrary_dihedral(pos))
    assert misc_t.backbone_hydrogen_oxygen_crossproduct(np.zeros((2, 4, 9))) is None
    with misc_t.temp_seed(7):
        a = np.random.random(4)
    with misc_j.temp_seed(7):
        b = np.random.random(4)
    np.testing.assert_array_equal(a, b)
    x, y = np.linspace(-4, 4, 9), np.linspace(3, -3, 9)
    np.testing.assert_array_equal(misc_t.periodic_distance_np(x, y),
                                  dist_j.periodic_distance_np(x, y))
    for n in (1, 2, 7):
        np.testing.assert_array_equal(dist_t.triu_indices_mask(n),
                                      dist_j.triu_indices_mask(n))


@pytest.fixture()
def emap_pair(tmp_path):
    """A JAX EncoderMap trained 10 steps and the port loaded from its
    checkpoint: the same weights."""
    import encodermap_tpu as emj

    data = np.random.default_rng(0).random((128, 5)).astype(np.float32)
    kw = dict(main_path=str(tmp_path), n_neurons=[16, 16, 2], batch_size=16,
              steps_per_scan=10, n_steps=10, periodicity=float("inf"), seed=2)
    ej = emj.EncoderMap(emj.Parameters(**kw), data)
    ej.train()
    et = emt.EncoderMap.from_checkpoint(tmp_path, train_data=data, device="cpu")
    return data, ej, et


def test_encoder_decoder_submodels_match_jax(emap_pair):
    data, ej, et = emap_pair
    for sub in ("encoder", "decoder"):
        x = data if sub == "encoder" else ej.encode(data)
        got, ref = getattr(et, sub), getattr(ej, sub)
        np.testing.assert_allclose(got(x), ref(x), atol=1e-5)
        np.testing.assert_array_equal(got.predict(x), got(x))
        np.testing.assert_array_equal(got(x), getattr(et, sub[:-1])(x))


def test_set_train_data_matches_jax(emap_pair):
    data, ej, et = emap_pair
    new = np.random.default_rng(1).random((64, 5)).astype(np.float32)
    et.set_train_data(new)
    ej.set_train_data(new)
    assert et.train_data.shape == (64, 5)
    np.testing.assert_allclose(et.encode(), ej.encode(), atol=1e-5)
    with pytest.raises(ValueError, match="features"):
        et.set_train_data(new[:, :3])
    with pytest.raises(AssertionError):  # the JAX package asserts instead
        ej.set_train_data(new[:, :3])
    holes = new.copy()
    holes[0, 0] = np.nan
    with pytest.raises(ValueError, match="dense"):
        et.set_train_data(holes)
    with pytest.raises(ValueError, match="dense"):
        ej.set_train_data(holes)


def test_save_model_and_load_model_both_ways(emap_pair, tmp_path):
    import encodermap_tpu.misc.saving as SJ
    import encodermap_tpu_torch.misc.saving as ST

    data, ej, et = emap_pair
    path = ST.save_model(et, step=10)
    assert path.endswith("saved_model_10.npz")
    with pytest.raises(ValueError, match="main_path"):
        ST.save_model(et, main_path=str(tmp_path / "elsewhere"))
    got = ST.load_model(checkpoint_path=path, train_data=data, device="cpu")
    assert type(got).__name__ == "EncoderMap"
    np.testing.assert_allclose(got.encode(data), ej.encode(data), atol=1e-5)
    ref = SJ.load_model(checkpoint_path=path, train_data=data)
    np.testing.assert_allclose(ref.encode(data), got.encode(data), atol=1e-5)
    enc = ST.load_model(emt.EncoderMap, path, train_data=data, submodel="encoder",
                        device="cpu")
    np.testing.assert_array_equal(enc(data), got.encode(data))
    # the Adam state into a template, as the JAX package's loader does it
    opt = ST.load_pytree_into(et.state.opt_state,
                              path.replace(".npz", ".opt.npz"))
    assert int(opt["count"]) == 10 and opt["mu"].keys() == et.state.opt_state["mu"].keys()


def test_adc_train_data_from_trajs_matches_jax():
    import encodermap_tpu as emj
    from tests.test_torch_adc import _cvs

    data = _cvs()
    for extra in ({}, {"use_sidechains": True}):
        got = emt.AngleDihedralCartesianEncoderMap.get_train_data_from_trajs(
            data, emt.ADCParameters(**extra))
        ref = emj.AngleDihedralCartesianEncoderMap.get_train_data_from_trajs(
            data, emj.ADCParameters(**extra))
        assert len(got) == len(ref) == 4 + len(extra)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


LOSS_CLASSES = ["DihedralLoss", "AngleLoss", "SideDihedralLoss"]


def test_loss_classes_are_gated(monkeypatch):
    import encodermap_tpu_torch.loss_classes as LT

    monkeypatch.delenv("ENCODERMAP_TESTING", raising=False)
    for name in LOSS_CLASSES + ["EncoderMapBaseLoss", "ADCBaseLoss"]:
        with pytest.raises(Exception, match="ENCODERMAP_TESTING"):
            getattr(LT, name)()
    monkeypatch.setenv("ENCODERMAP_TESTING", "True")
    loss = LT.AngleLoss(emt.ADCParameters(n_neurons=[8, 8, 2]))
    again = LT.AngleLoss.from_config(loss.get_config())
    assert isinstance(again.p, emt.ADCParameters) and again.p.n_neurons == [8, 8, 2]
    with pytest.raises(ValueError, match="use_sidechains"):
        LT.SideDihedralLoss().attach(
            type("A", (), {"p": emt.ADCParameters()})())


@pytest.mark.parametrize("name", LOSS_CLASSES)
def test_loss_classes_match_jax_over_one_step(monkeypatch, tmp_path, name):
    import jax

    import encodermap_tpu as emj
    import encodermap_tpu.loss_classes as LJ
    import encodermap_tpu_torch.loss_classes as LT
    from tests.test_torch_adc import _cvs, _jax_indices, _kw

    monkeypatch.setenv("ENCODERMAP_TESTING", "True")
    data = _cvs()
    kw = _kw(use_backbone_angles=True, use_sidechains=True, angle_cost_scale=1.0,
             steps_per_scan=1, n_steps=1)
    ej = emj.AngleDihedralCartesianEncoderMap(
        data, emj.ADCParameters(main_path=str(tmp_path / "jax"), **kw))
    et = emt.AngleDihedralCartesianEncoderMap(
        data, emt.ADCParameters(main_path=str(tmp_path / "torch"), **kw),
        model_params=jax.device_get(ej.state.params), device="cpu")
    getattr(LJ, name)(ej.p).attach(ej)
    getattr(LT, name)(et.p).attach(et)
    idx = _jax_indices(ej.state.rng, len(data["central_angles"]), [1], kw["batch_size"])
    hj, ht = ej.train(), et.train(index_stream=iter(idx))
    term = getattr(LT, name).name
    assert term in ht and hj.keys() == ht.keys()
    for k in hj:
        np.testing.assert_allclose(ht[k], np.asarray(hj[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    builtin = {"DihedralLoss": "dihedral_loss", "AngleLoss": "angle_loss",
               "SideDihedralLoss": "side_dihedral_loss"}[name]
    np.testing.assert_allclose(ht[term], ht[builtin], rtol=1e-6)
    for a, b in zip(tree_leaves_np(et.state.params), jax.tree_util.tree_leaves(
            jax.device_get(ej.state.params))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def tree_leaves_np(tree):
    from encodermap_tpu_torch.train.core import tree_leaves

    return [t.detach().numpy() for t in tree_leaves(tree)]
