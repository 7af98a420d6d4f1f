# tests/test_torch_observability.py
"""Slice 6b's observability against the JAX package, and the port's two
repairs (re-exports, schedule counts in checkpoints).

Every test that imports TensorFlow is in this file (the suite runs
``--dist loadfile``, so one worker pays its import). The port writes its
TensorBoard events itself (``misc/event_file.py``); they are read here with
TensorBoard's own ``EventFileLoader``, and the encoder's field numbers and
enum values are taken from TensorBoard's protobuf descriptors.

* Training with ``tensorboard=True``: the JAX EncoderMap and the port from
  the same initial weights on the same injected batch indices, 25 steps,
  ``summary_step=5``. Their event files hold the same scalar tags and steps,
  with values to ``rtol=1e-5, atol=1e-5 * max|ref|`` (the tolerance
  ``test_torch_encodermap.py::test_training_matches_jax_step_for_step``
  holds the two trainers' metrics to); the port's event scalars equal its
  JSONL rows exactly; images (``add_images_to_tensorboard`` with one
  ``additional_fns`` returning PNG bytes and one returning an array) agree
  by tag, step, width and height.
* ``complete_model_summary.txt`` of one ADC model, line for line;
  ``add_layer_summaries`` and ``histogram_summary`` on the same weights,
  tags and values exactly (numpy statistics of equal arrays).
* ``profile_steps`` leaves a ``*.trace.json.gz``; ``block_timer`` fills
  ``out["seconds"]``; ``function`` (``backend="eager"``, so no Inductor
  build) and ``function(debug=True)`` give the JAX results.
* The repairs: ``em.ops.__all__`` and ``em.models.__all__`` equal the JAX
  package's; a checkpoint trained with a learning-rate schedule resumes in
  the other package and reproduces the next 5 steps' losses (1e-5
  relative), both ways.
"""

import json
import shutil
import struct
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu_torch as emt
from encodermap_tpu_torch.misc import event_file as EF
from tests.test_torch_encodermap import _data, _jax_indices, _kw

torch.set_num_threads(1)


def _png(width: int, height: int) -> bytes:
    """A grey RGB PNG built with zlib and struct."""
    raw = b"".join(b"\x00" + bytes([128] * 3 * width) for _ in range(height))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _read_events(logdir):
    """``({(tag, step): value}, {(tag, step): (width, height)})`` of every
    event file in ``logdir``, through TensorBoard's reader."""
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
    from tensorboard.util import tensor_util

    scalars, images = {}, {}
    files = sorted(Path(logdir).glob("events.out.tfevents.*"))
    assert files, f"no event file in {logdir}"
    for f in files:
        for ev in EventFileLoader(str(f)).Load():
            for v in ev.summary.value:
                if v.tensor.dtype == EF.DT_STRING:
                    w, h = v.tensor.string_val[:2]
                    images[v.tag, ev.step] = (int(w), int(h))
                else:
                    scalars[v.tag, ev.step] = float(tensor_util.make_ndarray(v.tensor))
    return scalars, images


# ------------------------------------------------------------- the writer
def test_event_constants_match_tensorboard_descriptors():
    from tensorboard.compat.proto import event_pb2, summary_pb2, tensor_pb2
    from tensorboard.compat.proto import tensor_shape_pb2, types_pb2

    def num(msg, field):
        return msg.DESCRIPTOR.fields_by_name[field].number

    Value = summary_pb2.Summary.Value
    assert (EF._EVENT_WALL_TIME, EF._EVENT_STEP, EF._EVENT_FILE_VERSION, EF._EVENT_SUMMARY) == \
        tuple(num(event_pb2.Event, f) for f in ("wall_time", "step", "file_version", "summary"))
    assert EF._SUMMARY_VALUE == num(summary_pb2.Summary, "value")
    assert (EF._VALUE_TAG, EF._VALUE_TENSOR, EF._VALUE_METADATA) == \
        tuple(num(Value, f) for f in ("tag", "tensor", "metadata"))
    assert (EF._TENSOR_DTYPE, EF._TENSOR_SHAPE, EF._TENSOR_CONTENT, EF._TENSOR_STRING_VAL) == \
        tuple(num(tensor_pb2.TensorProto, f)
              for f in ("dtype", "tensor_shape", "tensor_content", "string_val"))
    assert EF._SHAPE_DIM == num(tensor_shape_pb2.TensorShapeProto, "dim")
    assert EF._DIM_SIZE == num(tensor_shape_pb2.TensorShapeProto.Dim, "size")
    assert (EF._META_PLUGIN_DATA, EF._META_DATA_CLASS) == \
        tuple(num(summary_pb2.SummaryMetadata, f) for f in ("plugin_data", "data_class"))
    assert EF._PLUGIN_NAME == num(summary_pb2.SummaryMetadata.PluginData, "plugin_name")
    assert (EF.DT_FLOAT, EF.DT_STRING) == (types_pb2.DT_FLOAT, types_pb2.DT_STRING)
    assert (EF.DATA_CLASS_SCALAR, EF.DATA_CLASS_BLOB_SEQUENCE) == \
        (summary_pb2.DATA_CLASS_SCALAR, summary_pb2.DATA_CLASS_BLOB_SEQUENCE)


def test_masked_crc32c_matches_tensorboard():
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

    assert EF.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    rng = np.random.default_rng(0)
    for n in (0, 1, 8, 61, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert EF.masked_crc32c(data) == masked_crc32c(data)


def test_event_file_reads_back_through_tensorboard(tmp_path):
    w = EF.EventFileWriter(tmp_path)
    w.add_scalars(3, {"loss": np.float32(0.1), "a/b": 2.5})
    w.add_scalars(7, {"loss": -1e-30})
    w.add_image(7, "latent", _png(13, 9))
    w.close()
    assert w.path.name.startswith("events.out.tfevents.")
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    first = next(iter(EventFileLoader(str(w.path)).Load()))
    assert first.file_version == "brain.Event:2"
    scalars, images = _read_events(tmp_path)
    assert scalars == {("loss", 3): float(np.float32(0.1)), ("a/b", 3): 2.5,
                       ("loss", 7): float(np.float32(-1e-30))}
    assert images == {("latent", 7): (13, 9)}
    assert EF.png_size(_png(13, 9)) == (13, 9)
    with pytest.raises(ValueError, match="PNG"):
        EF.png_size(b"GIF89a" + bytes(30))


# ------------------------------------------------------ training, two packages
def png_bytes(lowd):
    return _png(32, 24)


def array_image(lowd):
    return np.outer(np.arange(8.0), np.ones(6))


def test_tensorboard_training_matches_jax(tmp_path):
    data = _data(False)
    kw = _kw(False, tensorboard=True, summary_step=5)
    ej = emj.EncoderMap(emj.Parameters(main_path=str(tmp_path / "jax"), **kw), data)
    tree = jax.device_get(ej.state.params)
    idx = _jax_indices(ej.state.rng, len(data), [10, 10, 5], 32)
    et = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "torch"), **kw), data,
                        model_params=tree, device="cpu")
    for e in (ej, et):
        e.add_images_to_tensorboard(data=data[:200], image_step=10,
                                    additional_fns=[png_bytes, array_image])
    ej.train()
    et.train(index_stream=iter(idx))

    sj, ij = _read_events(tmp_path / "jax" / "train")
    st, it = _read_events(tmp_path / "torch" / "train")
    assert sorted(st) == sorted(sj)
    assert {s for _, s in st} == {5, 10, 15, 20, 25}
    for tag in {t for t, _ in sj}:
        steps = sorted(s for t, s in sj if t == tag)
        ref = np.array([sj[tag, s] for s in steps])
        got = np.array([st[tag, s] for s in steps])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=tag)
    rows = [json.loads(line) for line in
            (tmp_path / "torch" / "train_metrics.jsonl").read_text().splitlines()]
    from_jsonl = {(k, r["step"]): float(np.float32(v)) for r in rows
                  for k, v in r.items() if k != "step"}
    assert from_jsonl == st
    assert it == ij
    assert set(it) == {(name, s) for name in ("latent", "png_bytes", "array_image")
                       for s in (10, 20)}
    assert it["png_bytes", 10] == (32, 24)


def test_adc_model_summary_and_layer_summaries_match_jax(tmp_path):
    from encodermap_tpu.misc import summaries as SJ
    from encodermap_tpu_torch.misc import summaries as ST
    from tests.test_torch_adc import _cvs
    from tests.test_torch_adc import _kw as adc_kw

    data = _cvs()
    kw = adc_kw(use_backbone_angles=True, use_sidechains=True, write_summary=True)
    aj = emj.AngleDihedralCartesianEncoderMap(
        data, emj.ADCParameters(main_path=str(tmp_path / "jax"), **kw))
    at = emt.AngleDihedralCartesianEncoderMap(
        data, emt.ADCParameters(main_path=str(tmp_path / "torch"), **kw),
        model_params=jax.device_get(aj.state.params), device="cpu")
    lj = (tmp_path / "jax" / "complete_model_summary.txt").read_text().splitlines()
    lt = (tmp_path / "torch" / "complete_model_summary.txt").read_text().splitlines()
    assert lt[0] == "Model: AngleDihedralCartesianEncoderMap"
    assert lt == lj and lt[-1].startswith("Total params: ")

    for name, pkg, params in (("jax", SJ, aj.state.params), ("torch", ST, at.state.params)):
        w = pkg.MetricsWriter(tmp_path / f"stats_{name}")
        pkg.add_layer_summaries(w, 3, params)
        pkg.add_layer_summaries(w, 4, params, namescope="ADC")
        pkg.histogram_summary(w, 5, params)
        w.close()
    rj, rt = ((tmp_path / f"stats_{n}" / "train_metrics.jsonl").read_text()
              for n in ("jax", "torch"))
    assert rt == rj
    assert "Encoder/encoder/0/kernel/weights/mean" in rt
    # the same rows as TensorBoard scalars, written by the port's writer
    w = ST.MetricsWriter(tmp_path / "tb", tensorboard=True)
    ST.histogram_summary(w, 5, at.state.params)
    w.close()
    scalars, _ = _read_events(tmp_path / "tb" / "train")
    row = json.loads(rt.splitlines()[-1])
    assert scalars == {(k, 5): float(np.float32(v)) for k, v in row.items() if k != "step"}


# --------------------------------------------------- profiling and function
def test_profile_steps_block_timer_and_function(tmp_path):
    from encodermap_tpu_torch.misc.profiling import block_timer, profile_steps

    data = _data(False)
    et = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path), **_kw(False)), data,
                        read_only=True, device="cpu")
    logdir = profile_steps(et, n_steps=1, logdir=tmp_path / "profile")
    assert list(Path(logdir).rglob("*.trace.json.gz"))
    assert et.state.step == 20  # a warm-up chunk and one traced chunk
    with block_timer("block", sync={"x": torch.ones(3)}) as out:
        torch.ones(1000).sum()
    assert out["name"] == "block" and out["seconds"] > 0

    def f(x, y):
        return x * 2.0 + y.sum()

    x = np.linspace(-1, 1, 7).astype(np.float32)
    y = np.arange(3, dtype=np.float32)
    ref = np.asarray(emj.function(f)(x, y))
    np.testing.assert_allclose(emj.function(debug=True)(f)(x, y), ref)
    got = emt.function(backend="eager")(f)(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert emt.function(f, debug=True) is f


# ------------------------------------------------------------ the repairs
def test_ops_and_models_reexports_match_jax():
    assert emt.ops.__all__ == emj.ops.__all__
    assert emt.models.__all__ == emj.models.__all__
    for mod_t, mod_j in ((emt.ops, emj.ops), (emt.models, emj.models)):
        for name in mod_j.__all__:
            got, ref = getattr(mod_t, name), getattr(mod_j, name)
            assert type(got) is type(ref) or (callable(got) and callable(ref)), name
    assert callable(emt.ops.backmap) and callable(emt.ops.compute_dssp)


def _schedule(s):
    return 1e-3 * 0.5 ** (s // 4)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_schedule_checkpoint_resumes_in_the_other_package(tmp_path, direction):
    data = _data(False)
    kw = _kw(False, n_steps=10)
    first_j = direction == "jax_to_port"
    cls_a = emj.EncoderMap if first_j else emt.EncoderMap
    P_a = emj.Parameters if first_j else emt.Parameters
    extra = {} if first_j else {"device": "cpu"}
    a = cls_a(P_a(main_path=str(tmp_path / "a"), **kw), data,
              learning_rate_schedule=_schedule, **extra)
    a.train()
    opt = np.load(tmp_path / "a" / "saved_model_10.opt.npz")
    # Adam's count, mu and nu (12 leaves each at [16,16,2]), the schedule's count
    assert len(opt.files) == 26 and opt.files[-1] == '[["s", 1], ["s", 1], ["a", "count"]]'
    assert int(opt[opt.files[-1]]) == int(opt[opt.files[0]]) == 10

    shutil.copytree(tmp_path / "a", tmp_path / "b")
    if first_j:
        b = emt.EncoderMap.from_checkpoint(tmp_path / "b", train_data=data,
                                           learning_rate_schedule=_schedule, device="cpu")
    else:
        b = emj.EncoderMap.from_checkpoint(tmp_path / "b", train_data=data,
                                           learning_rate_schedule=_schedule)
    ej, et = (a, b) if first_j else (b, a)
    assert int(ej.state.step) == et.state.step == 10
    idx = _jax_indices(ej.state.rng, len(data), [5], 32)
    for e in (ej, et):
        e.p.n_steps = 15
    hj = ej.train()
    ht = et.train(index_stream=iter(idx))
    for k in ("loss", "learning_rate"):
        ref = np.asarray(hj[k])
        assert len(ref) == 5
        np.testing.assert_allclose(ht[k], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert et.state.opt_state["count"] == 15


def test_float_lr_checkpoint_keeps_three_adam_leaves(tmp_path):
    data = _data(False)
    et = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path), **_kw(False, n_steps=10)),
                        data, device="cpu")
    et.train()
    opt = np.load(tmp_path / "saved_model_10.opt.npz")
    assert [json.loads(k)[-1] for k in opt.files][:1] == [["a", "count"]]
    assert not any(k.startswith('[["s", 1], ["s", 1]') for k in opt.files)
    assert len(opt.files) == 1 + 2 * len(jax.tree_util.tree_leaves(
        et.state.opt_state["mu"]))
