# tests/test_torch_streaming.py
"""Out-of-core streaming training in the port against the JAX package.

``HDF5BatchSource`` is a copy of the JAX package's numpy sampler: on the
same file with the same seed and arguments both yield the same superbatches
and frame indices, with tolerance 0, in every layout and option (flat and
ensemble files, windows across a group boundary and past the end of the
file, a batch larger than the file, ``slab_frames``, ``replace=False``,
``skip_all_nan``, one window and eight). ``PrefetchSource`` keeps order,
passes a worker's error on, overlaps a slow producer and lets go of an
abandoned one; every thread is joined with a time limit.

``train_streaming`` is held to the JAX package's on the same weights
(carried over as numpy arrays) and the same superbatches, with slice 1's
tolerances for EncoderMap on cube and periodic data (each loss 1e-5
relative to the largest value of its curve, the parameters 2e-5) and slice
2's for the ADC built by ``from_ensemble_h5`` from an ensemble file that the
port's ``TrajEnsemble.save`` wrote (the parameters 1e-4). The streaming
chunk equals the in-memory chunk trainer fed the same batches bit for bit.
Steps are trimmed to ``n_steps``, the JSONL rows are numbered as the JAX
package numbers them, and a NaN stops the run with nothing persisted.
``TrajEnsemble.batch_iterator`` streams from the file without building the
CVs, falls back to memory when the file is gone, and ``load_CVs`` drops a
stale file.
"""

import json
import math
import threading
import time

import jax
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu_torch as emt
from encodermap_tpu.train import core as core_j
from encodermap_tpu_torch.convert import params_to_numpy
from encodermap_tpu_torch.train import core as core_t

torch.set_num_threads(1)

h5py = pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A flat file of 1000 frames (column 0 the frame number) and an
    ensemble file of three member groups of 300, 450 and 250 frames, some
    rows all-NaN."""
    d = tmp_path_factory.mktemp("h5")
    rng = np.random.default_rng(0)
    data = rng.standard_normal((1000, 6)).astype(np.float32)
    data[:, 0] = np.arange(1000)
    other = rng.standard_normal((1000, 2, 3)).astype(np.float32)
    flat = d / "flat.h5"
    with h5py.File(flat, "w") as f:
        g = f.create_group("CVs")
        g.create_dataset("features", data=data)
        g.create_dataset("xyz", data=other)
    top = d / "top.h5"
    with h5py.File(top, "w") as f:
        f.create_dataset("features", data=data)
    ens = d / "ens.h5"
    nan = data.copy()
    nan[5:40, 1:] = np.nan
    nan[5:40, 0] = np.nan
    with h5py.File(ens, "w") as f:
        for i, (a, b) in enumerate(((0, 300), (300, 750), (750, 1000))):
            g = f.create_group(f"traj_{i}/CVs")
            g.create_dataset("features", data=nan[a:b])
            g.create_dataset("xyz", data=other[a:b])
        f.create_dataset("traj_joined", data=np.zeros(3))
    return {"flat": str(flat), "top": str(top), "ens": str(ens), "data": data}


SOURCE_CASES = {
    "flat": dict(file="flat", names=["features", "xyz"], kw=dict(batch_size=16,
                                                                  steps_per_scan=4)),
    "top_level_datasets": dict(file="top", names=["features"],
                               kw=dict(batch_size=16, steps_per_scan=4, seed=2)),
    "one_window": dict(file="flat", names=["features"],
                       kw=dict(batch_size=50, steps_per_scan=4, seed=3, n_windows=1)),
    "eight_windows_slab": dict(file="flat", names=["features"],
                               kw=dict(batch_size=32, steps_per_scan=8, slab_frames=256,
                                       seed=0, n_windows=8)),
    "batch_larger_than_file": dict(file="flat", names=["features"],
                                   kw=dict(batch_size=1500, steps_per_scan=2, seed=0)),
    "slab_frames": dict(file="flat", names=["features"],
                        kw=dict(batch_size=16, steps_per_scan=4, slab_frames=32, seed=0)),
    "no_replace": dict(file="flat", names=["features"],
                       kw=dict(batch_size=40, steps_per_scan=5, slab_frames=100, seed=4,
                               replace=False)),
    "ensemble": dict(file="ens", names=["features", "xyz"],
                     kw=dict(batch_size=16, steps_per_scan=3, seed=5)),
    "ensemble_skip_all_nan": dict(file="ens", names=["features"],
                                  kw=dict(batch_size=8, steps_per_scan=4, slab_frames=64,
                                          seed=6, skip_all_nan=True)),
}


@pytest.mark.parametrize("case", SOURCE_CASES)
def test_hdf5_source_matches_jax_bit_for_bit(files, case):
    cfg = SOURCE_CASES[case]
    path = files[cfg["file"]]
    st = core_t.HDF5BatchSource(path, cfg["names"], **cfg["kw"])
    sj = core_j.HDF5BatchSource(path, cfg["names"], **cfg["kw"])
    try:
        assert st.n_frames == sj.n_frames
        for _ in range(4):
            bt, bj = next(st), next(sj)
            assert len(bt) == len(bj) == len(cfg["names"])
            for a, b in zip(bt, bj):
                assert a.shape == b.shape == (cfg["kw"]["steps_per_scan"],
                                              cfg["kw"]["batch_size"]) + b.shape[2:]
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(st.last_indices, sj.last_indices)
        for a, b in zip(st.read_prototype(3), sj.read_prototype(3)):
            np.testing.assert_array_equal(a, b)
        if cfg["file"] == "ens":
            # a window across the traj_0 / traj_1 boundary and one past the
            # end of the file, read as the JAX package reads them
            for start, length in ((292, 16), (994, 12)):
                np.testing.assert_array_equal(st._read_slab(0, start, length),
                                              sj._read_slab(0, start, length))
    finally:
        st.close()
        sj.close()


def test_hdf5_source_frame_identity_and_no_repeats(files):
    """One window of 200 frames per superbatch of 200 draws: no frame
    repeats, and ``last_indices`` names each sampled frame."""
    src = core_t.HDF5BatchSource(files["flat"], ["features"], batch_size=50,
                                 steps_per_scan=4, seed=3, n_windows=1)
    try:
        for _ in range(5):
            sb = next(src)[0]
            rows = sb[..., 0].astype(np.int64)
            assert len(np.unique(rows)) == 200
            np.testing.assert_array_equal(src.last_indices, rows)
    finally:
        src.close()


# ------------------------------------------------------------ PrefetchSource
def _joined(src, limit=5.0):
    src._thread.join(timeout=limit)
    assert not src._thread.is_alive(), "the prefetch worker did not finish in time"


def test_prefetch_order_and_completion():
    items = [np.full((4,), i, np.float32) for i in range(10)]
    src = core_t.PrefetchSource(iter(items), depth=2)
    out = list(src)
    _joined(src)
    assert len(out) == 10
    for i, x in enumerate(out):
        np.testing.assert_array_equal(x, items[i])


def test_prefetch_error_reaches_consumer():
    def bad():
        yield np.zeros(2)
        raise ValueError("boom")

    src = core_t.PrefetchSource(bad(), depth=2)
    next(src)
    with pytest.raises(ValueError, match="boom"):
        next(src)
    _joined(src)


def test_prefetch_overlaps_a_slow_producer():
    def slow():
        for _ in range(5):
            time.sleep(0.2)
            yield np.zeros(2)

    src = core_t.PrefetchSource(slow(), depth=2)
    time.sleep(1.0)  # the worker fills the queue meanwhile
    t0 = time.perf_counter()
    next(src)
    next(src)
    assert time.perf_counter() - t0 < 0.1  # served from the queue, not 0.4 s
    src.close()
    _joined(src)


def test_prefetch_close_unblocks_an_abandoned_worker():
    def infinite():
        i = 0
        while True:
            yield np.full((2,), i, np.float32)
            i += 1

    src = core_t.PrefetchSource(infinite(), depth=2)
    next(src)
    closer = threading.Thread(target=src.close, daemon=True)
    closer.start()
    closer.join(timeout=5.0)
    assert not closer.is_alive(), "close() hung"
    _joined(src)


# --------------------------------------------------------- the upload stage
def test_upload_stage_trims_unwraps_and_shards():
    """The last superbatch is trimmed to the budget, a 1-tuple is unwrapped,
    and a dp rank uploads its columns of the batch axis."""
    sbs = [(np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3) + 1000 * i,)
           for i in range(3)]
    put = core_t.PinnedUploader(torch.device("cpu"), shard=(1, 2))
    out = list(core_t._upload_stage(iter(sbs), put, 10))
    assert [n for n, _ in out] == [4, 4, 2]
    for (n, up), (sb,) in zip(out, sbs):
        t = up.ready()
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), sb[:n, 4:8])


def test_streaming_chunk_equals_scan_chunk_bit_for_bit(tmp_path):
    """The streaming trainer runs the scan trainer's step: on the same
    batches the two give the same bits."""
    rng = np.random.default_rng(1)
    sb = rng.standard_normal((5, 16, 6)).astype(np.float32)
    p = emt.Parameters(main_path=str(tmp_path), n_neurons=[8, 8, 2], batch_size=16,
                       steps_per_scan=5, seed=0, periodicity=float("inf"))
    emap = emt.EncoderMap(p, sb[0], read_only=True, device="cpu")
    step = emap._make_train_step()
    s1, m1 = core_t.make_streaming_trainer(step)(emap.state, torch.tensor(sb))
    idx = torch.arange(80).reshape(5, 16)
    s2, m2 = core_t.make_scan_trainer(step, 16, 5)(emap.state,
                                                   torch.tensor(sb.reshape(80, 6)), idx)
    for a, b in zip(core_t.tree_leaves(s1.params), core_t.tree_leaves(s2.params)):
        assert torch.equal(a, b)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


# ----------------------------------------------------- train_streaming vs JAX
def _superbatches(periodic, n=3, steps=4, B=16, D=6):
    rng = np.random.default_rng(7)
    if periodic:
        return [rng.uniform(-np.pi, np.pi, (steps, B, 4)).astype(np.float32)
                for _ in range(n)]
    return [rng.standard_normal((steps, B, D)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("periodic", [False, True], ids=["cube", "periodic"])
def test_encodermap_streaming_matches_jax(tmp_path, periodic):
    """10 steps from three 4-step superbatches (the last trimmed to 2), the
    JSONL rows of every second step."""
    sbs = _superbatches(periodic)
    kw = dict(n_neurons=[16, 16, 2], batch_size=16, steps_per_scan=4, n_steps=10,
              seed=3, summary_step=2,
              periodicity=2 * math.pi if periodic else float("inf"))
    proto = sbs[0][0]
    ej = emj.EncoderMap(emj.Parameters(main_path=str(tmp_path / "jax"), **kw), proto)
    et = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "torch"), **kw), proto,
                        model_params=jax.device_get(ej.state.params), device="cpu")
    hj = ej.train_streaming(iter(sbs))
    ht = et.train_streaming(iter(sbs))
    assert len(ht["loss"]) == len(hj["loss"]) == 10
    assert et.state.step == int(ej.state.step) == 10
    for k in ("loss", "auto_loss", "distance_loss", "center_loss", "regularization_loss"):
        ref = np.asarray(hj[k])
        np.testing.assert_allclose(ht[k], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(et.state.params)[0]),
                    jax.tree_util.tree_leaves(jax.device_get(ej.state.params))):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5)
    rows = {}
    for name in ("jax", "torch"):
        lines = (tmp_path / name / "train_metrics.jsonl").read_text().splitlines()
        rows[name] = [json.loads(line)["step"] for line in lines]
    assert rows["torch"] == rows["jax"] == [2, 4, 6, 8, 10]
    assert (tmp_path / "torch" / "saved_model_10.npz").is_file()
    assert emt.Parameters.from_file(
        tmp_path / "torch" / "parameters.json").current_training_step == 10


@pytest.mark.parametrize("prefetch", [0, 2])
def test_streaming_budget_and_nan_abort(tmp_path, prefetch):
    """``n_steps=None`` is the global budget ``p.n_steps``; a NaN loss stops
    after its chunk and persists nothing, with the host queue or without."""
    sbs = _superbatches(False)
    kw = dict(n_neurons=[8, 8, 2], batch_size=16, steps_per_scan=4, n_steps=6, seed=0,
              periodicity=float("inf"))
    emap = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "a"), **kw), sbs[0][0],
                          device="cpu")
    h = emap.train_streaming(iter(sbs))
    assert len(h["loss"]) == 6 and emap.state.step == 6
    assert emap.train_streaming(iter(sbs)) is emap.history  # nothing left to run

    bad = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "b"), **kw), sbs[0][0],
                         device="cpu")
    bad.add_loss(lambda params, batch: torch.tensor(float("nan")), name="bad")
    h = bad._finish_streaming(core_t.run_streaming(bad, iter(sbs), 12, prefetch=prefetch))
    assert len(h["loss"]) == 4 and bad.state.step == 4
    assert bad._streaming_nan_stop
    assert not list((tmp_path / "b").glob("saved_model_*"))
    assert emt.Parameters.from_file(tmp_path / "b" / "parameters.json").current_training_step == 0


# -------------------------------------------------------------- ensemble file
@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    """Two 40-frame trajectories of a 6-residue peptide, featurized by the
    port and saved by its ``TrajEnsemble.save``."""
    from chip_smoke import synthetic_protein
    from encodermap_tpu_torch.data.pdb import write_pdb
    from encodermap_tpu_torch.data.xtc import write_xtc

    d = tmp_path_factory.mktemp("ens")
    top, xyz = synthetic_protein("FKLDEW", 80, seed=11)
    write_pdb(d / "p.pdb", top, xyz[:1])
    write_xtc(d / "a.xtc", xyz[:40])
    write_xtc(d / "b.xtc", xyz[40:])
    trajs = emt.load([str(d / "a.xtc"), str(d / "b.xtc")], str(d / "p.pdb"))
    trajs.load_CVs("all", ensemble=True, device="cpu")
    path = str(d / "trajs.h5")
    trajs.save(path)
    return path, trajs


def test_adc_from_ensemble_h5_streams_like_jax(ensemble, tmp_path):
    path, trajs = ensemble
    # angle_cost_scale=1: every decoded angle has a gradient (test_torch_adc.py)
    kw = dict(n_neurons=[16, 16, 2], batch_size=16, steps_per_scan=4, n_steps=8, seed=1,
              use_backbone_angles=True, use_sidechains=True, angle_cost_scale=1.0,
              cartesian_pwd_start=1,
              cartesian_pwd_step=3, cartesian_cost_scale_soft_start=(1, 4))
    ej = emj.AngleDihedralCartesianEncoderMap.from_ensemble_h5(
        path, emj.ADCParameters(main_path=str(tmp_path / "jax"), **kw))
    et = emt.AngleDihedralCartesianEncoderMap.from_ensemble_h5(
        path, emt.ADCParameters(main_path=str(tmp_path / "torch"), **kw),
        model_params=jax.device_get(ej.state.params), device="cpu")
    assert len(et.train_data[0]) == 8 and not et.sparse  # 4 frames of each member
    for a, b in zip(et.train_data, ej.train_data):
        np.testing.assert_array_equal(a, np.asarray(b))
    hj = ej.train_streaming(path)
    ht = et.train_streaming(path)
    assert hj.keys() == ht.keys() and len(ht["loss"]) == 8 and et.state.step == 8
    for k, ref in hj.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(ht[k], ref, rtol=1e-5,
                                   atol=max(1e-5 * np.abs(ref).max(), 1e-8), err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(et.state.params)[0]),
                    jax.tree_util.tree_leaves(jax.device_get(ej.state.params))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_lazy_batch_iterator_never_builds_the_cvs(ensemble):
    from encodermap_tpu_torch.data.trajectory import TrajEnsemble

    path, trajs = ensemble
    assert trajs._source_h5 == path
    n_di = trajs.trajs[0]._CVs["central_dihedrals"].shape[1]

    class Trap(TrajEnsemble):
        @property
        def CVs(self):
            raise AssertionError(".CVs built in lazy mode")

    trap = Trap(trajs.trajs)
    trap._source_h5 = path
    names = ["central_angles", "central_dihedrals"]
    it = trap.batch_iterator(batch_size=16, CV_names=names, seed=0)
    src = core_t.HDF5BatchSource(path, names, 16, steps_per_scan=65536 // 16, seed=0,
                                 replace=False, skip_all_nan=True)
    want = next(src)
    src.close()
    for i in range(3):
        batch = next(it)
        assert batch[1].shape == (16, n_di)
        for a, b in zip(batch, want):
            np.testing.assert_array_equal(a, b[i])
    it.close()
    # lazy=<path> on an ensemble with no file of its own, and frame identity
    full = np.concatenate([t._CVs["central_dihedrals"] for t in trajs.trajs])
    plain = Trap(trajs.trajs)
    it2 = plain.batch_iterator(4, CV_names=["central_dihedrals"], yield_index=True, seed=1,
                               lazy=path)
    index, batch = next(it2)
    ids = trajs.id
    for b in range(4):
        row = np.where((ids[:, 0] == index[b, 0]) & (ids[:, 1] == index[b, 1]))[0][0]
        np.testing.assert_array_equal(batch[b], full[row])
    it2.close()


def test_lazy_falls_back_to_memory_and_load_cvs_drops_the_file(ensemble, tmp_path):
    import shutil

    from encodermap_tpu_torch.data.trajectory import TrajEnsemble

    path, trajs = ensemble
    copy = tmp_path / "gone.h5"
    shutil.copy(path, copy)
    ens = TrajEnsemble(trajs.trajs)
    ens._source_h5 = str(copy)
    copy.unlink()
    batch = next(ens.batch_iterator(4, CV_names=["central_dihedrals"], seed=0))
    assert batch.shape == (4, trajs.CVs["central_dihedrals"].shape[1])
    batch = next(trajs.batch_iterator(8, CV_names=["central_dihedrals"], seed=0, lazy=False))
    assert batch.shape[0] == 8
    try:
        trajs.load_CVs("central_dihedrals", device="cpu")
        assert trajs._source_h5 is None
    finally:
        trajs._source_h5 = path


@pytest.mark.parametrize("case", ["flat", "ensemble_skip_all_nan"])
def test_array_source_over_memmaps_matches_hdf5_source(files, tmp_path, case):
    """``ArrayBatchSource`` over ``.npy`` memory maps of the same frames
    (the way ``chip_smoke.py`` streams config 5 on the card machine, which
    has no h5py) yields what ``HDF5BatchSource`` yields from the file, with
    tolerance 0: one member or three, several CVs, windows and
    ``skip_all_nan``."""
    cfg = SOURCE_CASES[case]
    h5 = core_t.HDF5BatchSource(files[cfg["file"]], cfg["names"], **cfg["kw"])
    try:
        groups = []
        for gi, dsets in enumerate(h5._dset_groups):
            maps = []
            for k, d in enumerate(dsets):
                path = tmp_path / f"{gi}_{k}.npy"
                np.save(path, d[()])
                maps.append(np.load(path, mmap_mode="r"))
            groups.append(maps)
        mem = core_t.ArrayBatchSource(groups, **cfg["kw"])
        assert mem.n_frames == h5.n_frames
        for _ in range(4):
            for a, b in zip(next(mem), next(h5)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(mem.last_indices, h5.last_indices)
    finally:
        h5.close()
