# tests/test_torch_projects.py
"""Reference ``.keras`` checkpoints, ``load_project`` and ``MolData`` in
the port against the JAX package, on the CPU.

* ``.keras`` files: TF twins built as ``tests/test_keras_import.py`` builds
  them (the reference's functional Encoder/Decoder layout and its
  subclassed layout with a ``Latent`` bottleneck), saved by keras, load to
  the same parameters in both packages bit for bit, by file and by
  directory, with the step of the file name (-1 for a name stamped with a
  time, which ``from_checkpoint`` replaces by parameters.json's step).
  ``EncoderMap.from_checkpoint`` on them encodes and decodes as TF does, to
  1e-5.
* ``load_project`` resolves a project through an ``ENCODERMAP_DATA_DIR``
  mirror built here (an ensemble ``trajs.h5``, ``parameters.json`` and an
  ADC checkpoint, npz or ``.keras``). Both packages give the same ensemble
  (frames and CVs exactly) and the same encodings (1e-5, float32 forward
  passes in two packages). With no copy anywhere, the download is replaced
  by one that raises, and the port says what it searched. No test reaches
  the network: ``urllib.request.urlretrieve`` is replaced by one that
  fails the test.
* ``MolData``: the six arrays equal the JAX package's on the same files
  (CVs to 1e-6 nm and 1e-5 rad, the tolerances of
  ``test_torch_featurize.py``; Cartesians exactly).

TensorFlow builds the twins (``importorskip``); ``h5py`` reads them.
"""

import urllib.request

import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu.misc.keras_import as KJ
import encodermap_tpu_torch as emt
import encodermap_tpu_torch.kondata as kondata_t
import encodermap_tpu_torch.misc.keras_import as KT
from chip_smoke import ALL_AMINO_ACIDS, synthetic_protein
from encodermap_tpu_torch.data.pdb import write_pdb
from encodermap_tpu_torch.data.xtc import write_xtc
from encodermap_tpu_torch.misc.saving import load_checkpoint

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a test tried to download")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def _tf():
    return pytest.importorskip("tensorflow")


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert len(a[k]) == len(b[k])
        for x, y in zip(a[k], b[k]):
            assert x.keys() == y.keys()
            for leaf in x:
                assert x[leaf].dtype == y[leaf].dtype
                np.testing.assert_array_equal(x[leaf], y[leaf])


@pytest.mark.parametrize("layout", ["functional", "subclassed"])
def test_keras_twin_loads_to_jax_parameters(tmp_path, layout):
    _tf()
    from tests.test_keras_import import _subclassed_twin, _tf_twin

    m = (_tf_twin if layout == "functional" else _subclassed_twin)(10, seed=3)
    f = tmp_path / "saved_model_70.keras"
    m.save(f)
    got, ref = KT.import_keras_checkpoint(f), KJ.import_keras_checkpoint(f)
    assert got[1] == ref[1] == 70
    _equal_trees(got[0], ref[0])
    params, opt, step = load_checkpoint(tmp_path)  # a directory of .keras only
    assert opt is None and step == 70
    _equal_trees(params, ref[0])
    assert [d["name"] for d in KT.read_keras_dense_weights(f)] == \
        [d["name"] for d in KJ.read_keras_dense_weights(f)]
    m.save(tmp_path / "saved_model_2024-01-01T00-00-00.keras")
    (tmp_path / "saved_model_70.keras").unlink()
    assert KT.latest_keras_checkpoint(tmp_path)[1] == KJ.latest_keras_checkpoint(tmp_path)[1] == -1


@pytest.mark.parametrize("stamp", ["60", "2024-01-01T00-00-00"])
def test_encodermap_from_keras_checkpoint(tmp_path, stamp):
    tf = _tf()
    from tests.test_keras_import import ACTS, N_NEURONS, _tf_twin

    in_dim = 12
    data = np.random.default_rng(0).normal(size=(32, in_dim)).astype(np.float32)
    m = _tf_twin(in_dim, seed=11)
    m.save(tmp_path / f"saved_model_{stamp}.keras")
    emt.Parameters(main_path=str(tmp_path), n_neurons=N_NEURONS, activation_functions=ACTS,
                   periodicity=float("inf"), n_steps=60,
                   current_training_step=60).save(tmp_path / "parameters.json")
    emap = emt.EncoderMap.from_checkpoint(tmp_path, train_data=data, device="cpu",
                                          read_only=True)
    ref = emj.EncoderMap.from_checkpoint(tmp_path, train_data=data, read_only=True)
    assert emap.state.step == int(ref.state.step) == 60
    lat = emap.encode(data)
    np.testing.assert_allclose(lat, m.encoder_model(tf.convert_to_tensor(data)).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(emap.decode(lat), m.decoder_model(
        tf.convert_to_tensor(lat)).numpy(), atol=1e-5)
    np.testing.assert_allclose(lat, ref.encode(data), atol=1e-5)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A mirror holding ``my_proj``: two trajectories of a 20-residue
    protein saved as one ensemble ``trajs.h5``, and a JAX ADC trained 2
    steps on it, checkpointed beside them."""
    root = tmp_path_factory.mktemp("mirror")
    files = tmp_path_factory.mktemp("files")
    proj = root / "my_proj"
    proj.mkdir()
    top, xyz = synthetic_protein(ALL_AMINO_ACIDS, 24, seed=4)
    write_pdb(files / "p.pdb", top, xyz[:1])
    write_xtc(files / "a.xtc", xyz[:12])
    write_xtc(files / "b.xtc", xyz[12:])
    trajs = emj.load([str(files / "a.xtc"), str(files / "b.xtc")], str(files / "p.pdb"))
    trajs.load_CVs("all", ensemble=True)
    trajs.save(proj / "trajs.h5")
    p = emj.ADCParameters(main_path=str(proj), n_neurons=[16, 16, 2], batch_size=8,
                          n_steps=2, steps_per_scan=2, use_backbone_angles=True,
                          use_sidechains=True, seed=0)
    adc = emj.AngleDihedralCartesianEncoderMap(trajs, p)
    adc.train()
    return root, adc


def _to_keras(proj, adc):
    """Replace the npz checkpoint by a reference-layout ``.keras`` twin of
    the same weights."""
    from tests.test_keras_import import _tf_twin_from_params

    for f in list(proj.glob("saved_model_*")):
        f.unlink()
    params = {k: [{n: np.asarray(v) for n, v in layer.items()} for layer in adc.state.params[k]]
              for k in ("encoder", "decoder")}
    _tf_twin_from_params(params, params["encoder"][0]["kernel"].shape[0]).save(
        proj / f"saved_model_{int(adc.state.step)}.keras")


@pytest.mark.parametrize("fmt", ["npz", "keras"])
def test_load_project_from_mirror_matches_jax(project, tmp_path, monkeypatch, fmt):
    root, adc = project
    if fmt == "keras":
        _tf()
        import shutil

        shutil.copytree(root / "my_proj", tmp_path / "mirror" / "my_proj")
        root = tmp_path / "mirror"
        _to_keras(root / "my_proj", adc)
    monkeypatch.setenv("ENCODERMAP_DATA_DIR", str(root))
    monkeypatch.chdir(tmp_path)
    trajs_t, adc_t = emt.load_project("my_proj", load_autoencoder=True, device="cpu")
    trajs_j, adc_j = emj.load_project("my_proj", load_autoencoder=True)
    assert trajs_t.n_trajs == trajs_j.n_trajs == 2
    for a, b in zip(trajs_t.trajs, trajs_j.trajs):
        np.testing.assert_array_equal(a.xyz, b.xyz)
    assert sorted(trajs_t.CVs) == sorted(trajs_j.CVs)
    for k in trajs_j.CVs:
        np.testing.assert_array_equal(trajs_t.CVs[k], trajs_j.CVs[k])
    assert adc_t.device.type == "cpu" and adc_t.state.step == int(adc_j.state.step) == 2
    for key in ("encoder", "decoder"):
        for x, y in zip(adc_t.state.params[key], adc_j.state.params[key]):
            np.testing.assert_array_equal(x["kernel"].numpy(), np.asarray(y["kernel"]))
    np.testing.assert_allclose(adc_t.encode(), adc_j.encode(), atol=1e-5)
    np.testing.assert_allclose(adc_t.encode(), adc.encode(), atol=1e-5)
    single = emt.load_project("my_proj", traj=1)
    np.testing.assert_array_equal(single.xyz, trajs_j.trajs[1].xyz)


def test_project_not_found(tmp_path, monkeypatch):
    monkeypatch.delenv("ENCODERMAP_DATA_DIR", raising=False)

    def no_download(*args, **kwargs):
        raise OSError("no network here")

    monkeypatch.setattr(kondata_t, "_download", no_download)
    with pytest.raises(RuntimeError, match="not available locally"):
        emt.get_from_kondata("definitely_missing", output=tmp_path / "x")
    mirror = tmp_path / "m" / "other"
    mirror.mkdir(parents=True)
    (mirror / "trajs.h5").write_bytes(b"\x89HDF")
    assert emt.get_from_kondata("other", output=tmp_path / "y",
                                mirror_dirs=(str(tmp_path / "m"),)) == str(mirror)


@pytest.mark.parametrize("source", ["ensemble", "paths"])
def test_moldata_matches_jax(project, tmp_path, source):
    top, xyz = synthetic_protein(ALL_AMINO_ACIDS, 10, seed=6)
    write_pdb(tmp_path / "p.pdb", top, xyz[:1])
    write_xtc(tmp_path / "a.xtc", xyz)
    args = [str(tmp_path / "a.xtc")], str(tmp_path / "p.pdb")
    if source == "ensemble":
        got = emt.MolData(emt.load(*args), device="cpu")
        ref = emj.MolData(emj.load(*args))
    else:
        got = emt.MolData(args[0], top=args[1], device="cpu")
        ref = emj.MolData(args[0], top=args[1])
    assert len(got) == len(ref) == 10
    np.testing.assert_array_equal(got.cartesians, ref.cartesians)
    for name, tol, periodic in (("angles", 1e-5, False), ("dihedrals", 1e-5, True),
                                ("sidedihedrals", 1e-5, True),
                                ("central_cartesians", 1e-6, False),
                                ("lengths", 1e-6, False), ("distances", 1e-6, False)):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape, name
        d = a.astype(np.float64) - b
        if periodic:
            d = (d + np.pi) % (2 * np.pi) - np.pi
        assert float(np.abs(d).max()) <= tol, name
