# tests/test_torch_encodermap.py
"""The slice as a whole: the port's EncoderMap against the JAX package's.

Both start from the same weights (the JAX initialization, carried over as
numpy arrays) and the port is fed the batch indices the JAX trainer draws,
reproduced outside its jit from ``state.rng`` as train/core.py:119-120 draws
them. On the CPU both take their general routes. Step for step each loss
agrees to 1e-5 relative (to the largest value of its curve, since a term that
has fallen tenfold keeps the absolute rounding of its start) and the
parameters to 2e-5 absolute (float32 sums in another order, through Adam,
whose per-element normalisation amplifies rounding on near-zero gradients). Checkpoints load both ways and encode the
same to 1e-6 (the same float32 products in two libraries)."""

import json
import math
import struct

import jax
import numpy as np
import pytest
import torch

import encodermap_tpu as emj
import encodermap_tpu_torch as emt
from encodermap_tpu_torch.convert import params_to_numpy
from encodermap_tpu_torch.misc.summaries import MetricsWriter

torch.set_num_threads(1)


def _data(periodic):
    if periodic:
        return np.random.default_rng(0).uniform(-np.pi, np.pi, (300, 4)).astype(np.float32)
    return emt.create_n_cube(3, points_along_edge=30, seed=0)[0].astype(np.float32)


def _kw(periodic, **extra):
    kw = dict(n_neurons=[16, 16, 2], batch_size=32, steps_per_scan=10,
              n_steps=25, seed=3, periodicity=2 * math.pi if periodic else float("inf"))
    kw.update(extra)
    return kw


def _jax_indices(rng, n, chunks, batch):
    out = []
    for c in chunks:
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.randint(sub, (c, batch), 0, n)))
    return out


def _assert_params_close(tree_t, tree_j, atol):
    assert tree_t.keys() == tree_j.keys()
    for a, b in zip(jax.tree_util.tree_leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


CASES = {
    "cube": dict(),
    "periodic": dict(periodic=True),
    # batched=False: every step on the whole dataset (core.py full_batch)
    "full_batch": dict(kw=dict(batched=False)),
    # NaN-padded inputs: sparse mode with the trainable densifier
    "sparse": dict(nan=True),
    # a learning-rate schedule evaluated at the step count
    "lr_schedule": dict(schedule=True),
}


@pytest.mark.parametrize("case", CASES)
def test_training_matches_jax_step_for_step(tmp_path, case):
    cfg = CASES[case]
    periodic = cfg.get("periodic", False)
    data = _data(periodic)
    if cfg.get("nan"):
        data = data.copy()
        data[::7, 1] = np.nan
    kw = _kw(periodic, **cfg.get("kw", {}))
    extra_j, extra_t = {}, {}
    if cfg.get("schedule"):
        extra_j["learning_rate_schedule"] = lambda s: 1e-3 * 0.5 ** (s // 10)
        extra_t["learning_rate_schedule"] = lambda s: 1e-3 * 0.5 ** (s // 10)
    ej = emj.EncoderMap(emj.Parameters(main_path=str(tmp_path / "jax"), **kw), data,
                        **extra_j)
    tree = jax.device_get(ej.state.params)
    idx = _jax_indices(ej.state.rng, len(data), [10, 10, 5], 32)
    hj = ej.train()

    et = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "torch"), **kw),
                        data, model_params=tree, device="cpu", **extra_t)
    assert et.sparse == bool(cfg.get("nan"))
    ht = et.train(index_stream=None if "kw" in cfg else iter(idx))
    assert len(ht["loss"]) == len(hj["loss"]) == 25
    for k in ("loss", "auto_loss", "distance_loss", "center_loss",
              "regularization_loss"):
        ref = np.asarray(hj[k])
        np.testing.assert_allclose(ht[k], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    _assert_params_close(params_to_numpy(et.state.params)[0],
                         jax.device_get(ej.state.params), 2e-5)
    assert et.state.step == int(ej.state.step) == 25
    assert et.state.opt_state["count"] == 25


def test_jax_checkpoint_loads_in_port(tmp_path):
    data = _data(False)
    ej = emj.EncoderMap(emj.Parameters(main_path=str(tmp_path), **_kw(False, n_steps=10)),
                        data)
    ej.train()
    et = emt.EncoderMap.from_checkpoint(tmp_path, train_data=data, device="cpu")
    np.testing.assert_allclose(et.encode(data), ej.encode(data), atol=1e-6)
    np.testing.assert_allclose(et.decode(et.encode(data[:20])),
                               ej.decode(ej.encode(data[:20])), atol=1e-5)
    assert et.state.step == 10 and et.state.opt_state["count"] == 10
    adam = ej.state.opt_state[1][0]
    _assert_params_close(params_to_numpy(et.state.opt_state["mu"])[0],
                         jax.device_get(adam.mu), 0)
    np.testing.assert_array_equal(et.state.rng, np.asarray(ej.state.rng))


def test_port_checkpoint_loads_in_jax(tmp_path):
    data = _data(True)
    et = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path), **_kw(True, n_steps=10)),
                        data, device="cpu")
    et.train()
    ej = emj.EncoderMap.from_checkpoint(tmp_path, train_data=data)
    np.testing.assert_allclose(ej.encode(data), et.encode(data), atol=1e-6)
    assert int(ej.state.step) == 10
    adam = ej.state.opt_state[1][0]
    assert int(adam.count) == 10
    _assert_params_close(jax.device_get(adam.nu),
                         params_to_numpy(et.state.opt_state["nu"])[0], 0)


def test_port_checkpoint_reload_is_exact_and_resumes(tmp_path):
    """Reload encodes bit-identically; 10 + 10 resumed steps reproduce 20
    uninterrupted ones (the batch RNG is checkpointed)."""
    data = _data(False)
    full = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "full"),
                                         **_kw(False, n_steps=20)), data, device="cpu")
    h_full = full.train()

    part = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "part"),
                                         **_kw(False, n_steps=10)), data, device="cpu")
    h1 = part.train()
    again = emt.EncoderMap.from_checkpoint(tmp_path / "part", train_data=data,
                                           device="cpu")
    assert np.array_equal(again.encode(data), part.encode(data))
    again.p.n_steps = 20
    h2 = again.train()
    np.testing.assert_array_equal(np.concatenate([h1["loss"], h2["loss"]]),
                                  h_full["loss"])


def test_step_accounting_callbacks_and_metrics_log(tmp_path):
    data = _data(False)
    p = emt.Parameters(main_path=str(tmp_path), **_kw(False, checkpoint_step=10,
                                                      summary_step=5))
    emap = emt.EncoderMap(p, data, device="cpu")
    stop = emt.EarlyStop(patience=10**6)
    emap.add_callback(stop)
    hist = emap.train()
    assert len(hist["loss"]) == 25 and emap.state.step == 25
    for step in (10, 20, 25):
        assert (tmp_path / f"saved_model_{step}.npz").is_file()
    rows = [json.loads(line) for line in
            (tmp_path / "train_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [5, 10, 15, 20, 25]
    assert stop.best <= hist["loss"].min() + 1e-12
    assert emt.Parameters.from_file(tmp_path / "parameters.json").current_training_step == 25
    assert emap.train() == emap.history  # already trained: nothing runs


def test_nan_interrupt_stops_and_keeps_last_finite_checkpoint(tmp_path):
    data = _data(False)
    emap = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path), **_kw(False)),
                          data, device="cpu")
    emap.add_loss(lambda params, batch: torch.tensor(float("nan")), name="bad")
    emap.train()
    assert emap.state.step == 10  # stopped after the first chunk
    assert not (tmp_path / "saved_model_10.npz").exists()


def test_index_stream_is_validated(tmp_path):
    data = _data(False)
    emap = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path), **_kw(False)),
                          data, device="cpu")
    with pytest.raises(ValueError):
        emap.train(index_stream=iter([np.full((10, 32), len(data))]))


def test_dihedral_generate_and_gaps(tmp_path):
    data = _data(True)
    emap = emt.DihedralEncoderMap(
        emt.Parameters(main_path=str(tmp_path), **_kw(True, n_steps=2)), data,
        device="cpu")
    out = emap.generate(np.zeros((3, 2), np.float32))
    assert out.shape == (3, 4) and np.isfinite(out).all()
    # onto a topology: a 3-residue peptide has 2 phi and 2 psi, the 4 inputs
    from chip_smoke import synthetic_protein
    from encodermap_tpu_torch.data.pdb import write_pdb
    from encodermap_tpu_torch.ops import geometry as geom

    top, xyz = synthetic_protein("ASG", 1, seed=0)
    write_pdb(tmp_path / "asg.pdb", top, xyz)
    gen = emap.generate(np.zeros((3, 2), np.float32), top=str(tmp_path / "asg.pdb"))
    assert gen.n_frames == 3 and gen.xyz.shape == (3, top.n_atoms, 3)
    quads = np.vstack([top.indices_phi, top.indices_psi])
    got = geom.compute_dihedrals(torch.tensor(gen.xyz, dtype=torch.float64), quads).numpy()
    assert float(np.abs((got - out + np.pi) % (2 * np.pi) - np.pi).max()) <= 1e-3
    # tensorboard=True writes an event file (the port's own writer): its
    # first record's length and payload carry valid masked CRCs
    from encodermap_tpu_torch.misc.event_file import masked_crc32c

    writer = MetricsWriter(tmp_path, tensorboard=True)
    writer.write_scalars(5, {"loss": 1.5})
    writer.close()
    events = list((tmp_path / "train").glob("events.out.tfevents.*"))
    assert len(events) == 1
    raw = events[0].read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert struct.unpack("<I", raw[8:12])[0] == masked_crc32c(raw[:8])
    assert struct.unpack("<I", raw[12 + n:16 + n])[0] == masked_crc32c(raw[12:12 + n])
    assert b"brain.Event:2" in raw[12:12 + n] and b"loss" in raw[16 + n:]
    # a mesh needs one process per device, on the tensor-parallel axis too
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        emt.EncoderMap(emt.Parameters(main_path=str(tmp_path), mesh_shape={"dp": 2}),
                       data, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        emt.EncoderMap(emt.Parameters(main_path=str(tmp_path),
                                      mesh_shape={"dp": 1, "tp": 2}), data, device="cpu")
    # two processes build the tp mesh and the trainer on it
    from tests.test_torch_tensor_parallel import run_ranks

    np.save(tmp_path / "data.npy", data)
    outs = run_ranks(
        "import numpy as np, encodermap_tpu_torch as emt\n"
        f"p = emt.Parameters(mesh_shape={{'dp': 1, 'tp': 2}}, **{_kw(True, n_steps=2)!r})\n"
        f"m = emt.DihedralEncoderMap(p, np.load({str(tmp_path / 'data.npy')!r}), "
        "read_only=True, device='cpu')\n"
        "print('mesh', m.mesh['dp'].size(), m.mesh['tp'].size(), m._dp[1])\n", 2, tmp_path)
    assert all("mesh 1 2 1" in out for out in outs), outs


def test_default_device_is_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = emt.Parameters(main_path=str(tmp_path), **_kw(False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        emt.EncoderMap(p, _data(False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        emt.SequentialModel(3, p)
