# tests/test_torch_distributed.py
"""Data parallelism of the port over torch.distributed, against the JAX
package's ``{"dp": 2}`` mesh and the port's own single-process step.

Two CPU processes join one gloo group through a ``file://`` rendezvous (no
port: the suite runs in parallel workers) and train with
``mesh_shape={"dp": 2}``: each takes its half of every global batch, the
rows the losses need are gathered, and the all-reduced gradients are
divided by 2. The module fixture starts them once, with a time limit of its
own, and meanwhile runs the same cases in this process: the JAX package on
a mesh of two host devices (``tests/conftest.py`` provides eight) and the
port on one device, from the same weights and batch indices.

Tolerances are those of ``tests/test_sharding.py:63-68``: every logged
loss 1e-5 relative (1e-7 absolute), every parameter 1e-5 absolute; the
Adam first moments, which show a gradient's scale where Adam's step hides
it, 1e-4 of each tensor's largest entry. A weight whose gradient is float32
rounding noise (first moment below 1e-6 of its tensor's largest) takes
Adam's full step of either sign on it, in the JAX package too: such
weights, at most 1 % of a tensor, are held to their steps
(``_assert_same_step``). The cases: EncoderMap over three
steps of the chunk trainer with injected indices; the ADC on its dense and
analytic Cartesian routes, with the batch mean of MeanAngles across the
ranks, and with sidechain reconstruction; BASELINE config 5's shape,
streaming with dp. The two ranks end bit-identical, only rank 0 writes
files, ``process_local_slice`` partitions the rows, and a step of per-rank
losses (the default of data-parallel wrappers) moves the first moments
visibly away from the global step's, which the gathered step does not.
``ShardedFeaturizer`` over both ranks equals the plain featurizer bit for
bit at the same block size.

Run as a script, this file is the worker of one rank::

    python tests/test_torch_distributed.py <rank> <world> <rendezvous file> <dir>
"""

import contextlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: seconds the two worker processes may take together
WORKER_LIMIT = 240

#: case -> (trainer, parameters, steps)
CASES = {
    "encodermap": ("em", dict(n_neurons=[16, 16, 2], batch_size=32, steps_per_scan=3,
                              n_steps=3, seed=5, periodicity=float("inf"),
                              summary_step=1, checkpoint_step=2)),
    "trap": ("em", dict(n_neurons=[16, 16, 2], batch_size=32, steps_per_scan=1, n_steps=1,
                        seed=6, periodicity=float("inf"))),
    # the Cartesian costs at full scale from the first step (test_sharding's
    # soft start (0, 4) gives them scale 0 there)
    "adc_dense": ("adc", dict(batch_size=32, use_backbone_angles=True, use_sidechains=True,
                              n_neurons=[16, 16, 2], seed=7, n_steps=1, steps_per_scan=1)),
    "adc_analytic": ("adc", dict(batch_size=32, use_backbone_angles=True, use_sidechains=True,
                                 n_neurons=[16, 16, 2], seed=7, n_steps=1, steps_per_scan=1)),
    "adc_mean_angles": ("adc", dict(batch_size=32, use_backbone_angles=False,
                                    use_sidechains=False, n_neurons=[16, 16, 2], seed=3,
                                    n_steps=1, steps_per_scan=1)),
    # angle_cost_scale=1: every decoded angle has a gradient, as in the
    # slice's parity tests (test_torch_offline_backmap.py)
    "adc_sidechains": ("adc", dict(batch_size=32, reconstruct_sidechains=True,
                                   use_backbone_angles=True, use_sidechains=True,
                                   angle_cost_scale=1.0, n_neurons=[16, 16, 2], seed=0,
                                   n_steps=1, steps_per_scan=1)),
    "streaming": ("em", dict(n_neurons=[8, 8, 2], batch_size=32, steps_per_scan=2, n_steps=4,
                             seed=0, periodicity=float("inf"))),
}
#: residue -> sidechain dihedrals of the reconstruct case
INFO = {1: 1, 2: 0, 3: 2, 4: 0, 5: 1}


# ------------------------------------------------------------------ worker
def _flat(tree) -> list:
    from encodermap_tpu_torch.train.core import tree_leaves

    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def _result(model, hist) -> dict:
    """Parameters, Adam moments and the loss history of a trained model."""
    st = model.state
    out = {f"p{i}": a for i, a in enumerate(_flat(st.params))}
    out.update({f"mu{i}": a for i, a in enumerate(_flat(st.opt_state["mu"]))})
    out.update({f"h_{k}": np.asarray(v) for k, v in hist.items()})
    return out


def run_case(name: str, spec: dict, main_path: Path, mesh: bool) -> dict:
    """One case through the port, on a dp=2 mesh or on one device."""
    import encodermap_tpu_torch as emt
    from encodermap_tpu_torch.train import adc_autoencoder as adc_mod

    kind, kw = CASES[name]
    kw = dict(kw, main_path=str(main_path))
    if mesh:
        kw["mesh_shape"] = {"dp": 2}
    if kind == "adc":
        if name == "adc_sidechains":
            kw["sidechain_info"] = INFO
        model = emt.AngleDihedralCartesianEncoderMap(
            spec["data"], emt.ADCParameters(**kw), model_params=spec["params"],
            device="cpu")
    else:
        model = emt.EncoderMap(emt.Parameters(**kw), spec["data"],
                               model_params=spec["params"], device="cpu")
    analytic = adc_mod.MIN_ANALYTIC_ATOMS
    if name == "adc_analytic":
        adc_mod.MIN_ANALYTIC_ATOMS = 1
    try:
        if name == "streaming":
            hist = model.train_streaming(iter(spec["superbatches"]))
        else:
            hist = model.train(index_stream=iter(spec["idx"]))
    finally:
        adc_mod.MIN_ANALYTIC_ATOMS = analytic
    return _result(model, hist)


def worker(rank: int, world: int, rendezvous: str, d: Path) -> None:
    """One rank: every case on the dp=2 mesh, the helpers, the sharded
    featurizer; results to ``d/rank<r>_<case>.npz``."""
    import encodermap_tpu_torch as emt
    from encodermap_tpu_torch import parallel
    from encodermap_tpu_torch.loading.featurizer import SingleTrajFeaturizer
    from encodermap_tpu_torch.parallel.sharded_featurize import ShardedFeaturizer

    from encodermap_tpu_torch import losses

    parallel.initialize(init_method=f"file://{rendezvous}", world_size=world, rank=rank,
                        device="cpu")
    parallel.initialize()  # a second call is safe
    with open(d / "specs.pkl", "rb") as f:
        specs = pickle.load(f)
    # on the card the sketch-map losses take the kernels only where the
    # high-D side needs no gradient: record what the gathered batch gives
    route = losses.fused_or_reference
    needs_grad = []

    def recorded(h, *args, **kwargs):
        needs_grad.append(h.requires_grad)
        return route(h, *args, **kwargs)

    losses.fused_or_reference = recorded
    for name in CASES:
        needs_grad.clear()
        res = run_case(name, specs[name], d / f"{name}_rank{rank}", mesh=True)
        res["sketch_h_needs_grad"] = np.array(needs_grad)
        np.savez(d / f"rank{rank}_{name}.npz", **res)
    losses.fused_or_reference = route
    s = parallel.process_local_slice(103)
    info = {"slice": np.array([s.start, s.stop]), "primary": np.array(parallel.is_primary())}
    # the two ranks as a dp=1 x tp=2 mesh, and a trainer on it
    tp_mesh = parallel.make_mesh(dp=1, tp=2, device="cpu")
    tp_model = emt.EncoderMap(emt.Parameters(mesh_shape={"dp": 1, "tp": 2}, n_neurons=[8, 8, 2]),
                              np.zeros((16, 3), np.float32), read_only=True, device="cpu")
    info["tp_mesh"] = np.array([tp_mesh["dp"].size(), tp_mesh["tp"].size(),
                                tp_model.mesh["dp"].size(), tp_model.mesh["tp"].size()])
    traj = emt.load(str(d / "p.xtc"), str(d / "p.pdb"))
    sharded = ShardedFeaturizer(traj, block_size=8, device="cpu")
    sharded.add_list_of_feats("all")
    out = sharded.get_output()
    written = sharded.to_hdf5(d / f"sharded_rank{rank}.h5")
    if rank == 0:
        plain = SingleTrajFeaturizer(traj, block_size=8, device="cpu")
        plain.add_list_of_feats("all")
        want = plain.get_output()
        for k in want.keys():
            info[f"cv_{k}"] = out[k]
            info[f"plain_{k}"] = want[k]
    else:
        info["none"] = np.array(out is None and written is None)
    np.savez(d / f"rank{rank}_info.npz", **info)
    print(f"rank {rank} OK", flush=True)


# ---------------------------------------------------------------- fixture
def _adc_cvs(rng, n_res=4, F=64, side=True) -> dict:
    """The CVs of ``tests/test_sharding.py::_adc_cvs``."""
    from tests.reference_impl import backmap_np

    n_atoms = 3 * n_res
    angles = rng.uniform(1.6, 2.4, (F, n_atoms - 2)).astype(np.float32)
    dihedrals = rng.uniform(-np.pi, np.pi, (F, n_atoms - 3)).astype(np.float32)
    distances = rng.uniform(0.13, 0.155, (F, n_atoms - 1)).astype(np.float32)
    cart = backmap_np(distances, angles, dihedrals).astype(np.float32)
    cvs = dict(central_angles=angles, central_dihedrals=dihedrals,
               central_cartesians=cart, central_distances=distances)
    if side:
        cvs["side_dihedrals"] = rng.uniform(-np.pi, np.pi, (F, 2 * n_res)).astype(np.float32)
    return cvs


def _sidechain_cvs(rng, F=64) -> dict:
    """Seven reconstruct-mode CVs of a 5-residue chain, backmapped by the
    port in float64."""
    from encodermap_tpu_torch.ops.backmap_sidechains import backmap_sidechains_fast, make_spec

    spec = make_spec(INFO)
    nb, ns = 3 * spec.n_residues, spec.n_sidechain_atoms
    x = (rng.uniform(0.13, 0.155, (F, nb - 1)), rng.uniform(1.7, 2.2, (F, nb - 2)),
         rng.uniform(-np.pi, np.pi, (F, nb - 3)), rng.uniform(0.13, 0.16, (F, ns)),
         rng.uniform(1.7, 2.2, (F, ns)), rng.uniform(-np.pi, np.pi, (F, sum(INFO.values()))))
    with torch.no_grad():
        xyz = backmap_sidechains_fast(spec, *(torch.tensor(v) for v in x)).numpy()
    cd, ca, cdi, sd, sa, sdi = (np.asarray(v, np.float32) for v in x)
    return {"central_angles": ca, "central_dihedrals": cdi,
            "all_cartesians": xyz.astype(np.float32), "central_distances": cd,
            "side_angles": sa, "side_dihedrals": sdi, "side_distances": sd}


def _jax_model(name: str, data, main_path: Path):
    """The JAX package's trainer of a case on a mesh of two host devices."""
    import encodermap_tpu as emj

    kind, kw = CASES[name]
    kw = dict(kw, main_path=str(main_path), mesh_shape={"n_devices": 2, "dp": 2})
    if kind == "adc":
        if name == "adc_sidechains":
            kw["sidechain_info"] = INFO
        return emj.AngleDihedralCartesianEncoderMap(data, emj.ADCParameters(**kw))
    return emj.EncoderMap(emj.Parameters(**kw), data)


def _jax_result(model, hist) -> dict:
    import jax

    leaves = jax.tree_util.tree_leaves
    st = model.state
    out = {f"p{i}": np.asarray(a) for i, a in enumerate(leaves(jax.device_get(st.params)))}
    adam = st.opt_state[1][0]
    out.update({f"mu{i}": np.asarray(a) for i, a in enumerate(leaves(jax.device_get(adam.mu)))})
    out.update({f"h_{k}": np.asarray(v) for k, v in hist.items()})
    return out


def _launch(d: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    rendezvous = d / "rendezvous"
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r), "2",
                              str(rendezvous), str(d)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]


def _wait(procs: list) -> list:
    deadline = time.monotonic() + WORKER_LIMIT
    outs = []
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise AssertionError(f"the dp workers took more than {WORKER_LIMIT} s")
        assert proc.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Start both ranks, run the references here meanwhile, collect."""
    import jax

    from chip_smoke import synthetic_protein
    from encodermap_tpu_torch.data.pdb import write_pdb
    from encodermap_tpu_torch.data.xtc import write_xtc

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 host devices")
    d = tmp_path_factory.mktemp("dp")
    top, xyz = synthetic_protein("FKLDEW", 36, seed=3)
    write_pdb(d / "p.pdb", top, xyz[:1])
    write_xtc(d / "p.xtc", xyz)
    rng = np.random.default_rng(42)
    specs, jax_models = {}, {}
    for name, (kind, kw) in CASES.items():
        if name == "adc_sidechains":
            data = _sidechain_cvs(rng)
        elif name == "adc_mean_angles":
            data = _adc_cvs(rng, side=False)
        elif kind == "adc":
            data = _adc_cvs(rng)
        else:
            data = rng.standard_normal((256, 6)).astype(np.float32)
        ej = _jax_model(name, data, d / f"{name}_jax")
        spec = {"data": data, "params": jax.device_get(ej.state.params)}
        if name == "streaming":
            spec["superbatches"] = [rng.standard_normal((2, 32, 6)).astype(np.float32)
                                    for _ in range(2)]
        else:
            key = jax.random.split(ej.state.rng)[1]
            n = len(data) if kind == "em" else len(data["central_angles"])
            spec["idx"] = [np.asarray(jax.random.randint(key, (kw["n_steps"], 32), 0, n))]
        specs[name], jax_models[name] = spec, ej
    with open(d / "specs.pkl", "wb") as f:
        pickle.dump(specs, f)
    procs = _launch(d)
    try:
        ref_jax, ref_port = {}, {}
        from encodermap_tpu_torch.train import adc_autoencoder as adc_t
        import encodermap_tpu.train.adc_autoencoder as adc_j
        from tests.jax_sidechains import measured

        for name, ej in jax_models.items():
            patched = adc_j.MIN_ANALYTIC_ATOMS
            if name == "adc_analytic":
                adc_j.MIN_ANALYTIC_ATOMS = 1
            try:
                # the JAX package's reconstruct mode with the sweep's current
                # dihedrals, as the port takes them (tests/jax_sidechains.py)
                with measured() if name == "adc_sidechains" else contextlib.nullcontext():
                    hist = (ej.train_streaming(iter(specs[name]["superbatches"]))
                            if name == "streaming" else ej.train())
            finally:
                adc_j.MIN_ANALYTIC_ATOMS = patched
            ref_jax[name] = _jax_result(ej, hist)
            ref_port[name] = run_case(name, specs[name], d / f"{name}_single", mesh=False)
        assert adc_t.MIN_ANALYTIC_ATOMS != 1
        # the trap: per-rank losses on each half, gradients averaged
        em_halves = []
        for r in range(2):
            spec = dict(specs["trap"], idx=[specs["trap"]["idx"][0][:, 16 * r:16 * (r + 1)]])
            kind, kw = CASES["trap"]
            CASES["trap_half"] = (kind, dict(kw, batch_size=16))
            try:
                em_halves.append(run_case("trap_half", spec, d / f"half{r}", mesh=False))
            finally:
                del CASES["trap_half"]
    finally:
        _wait(procs)
    ranks = [{name: dict(np.load(d / f"rank{r}_{name}.npz")) for name in CASES}
             for r in range(2)]
    info = [dict(np.load(d / f"rank{r}_info.npz")) for r in range(2)]
    return dict(d=d, jax=ref_jax, port=ref_port, ranks=ranks, info=info, halves=em_halves)


def _rel_to_max(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_same_step(got: dict, want: dict, what: str, lr: float = 1e-3) -> None:
    """test_sharding.py's tolerances, and the first moments to 1e-4 of each
    tensor's largest entry.

    A parameter whose gradient is float32 rounding noise (a first moment
    below 1e-6 of its tensor's largest) moves by Adam's full step of either
    sign on that noise (Adam divides the gradient by its own size): such a
    weight is held to its steps, ``lr`` each, and may be at most 1 % of a
    tensor; its gradient is held by the moment check. The same weights part
    the port on one device from the JAX package as much."""
    hist = [k for k in want if k.startswith("h_")]
    assert hist and set(hist) <= set(got), (what, sorted(got))
    for k in hist:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{what} {k}")
    steps = len(want["h_loss"])
    for k in (k for k in want if k.startswith("p")):
        mu = np.abs(want["mu" + k[1:]])
        noise = mu < 1e-6 * mu.max()
        assert noise.mean() <= 0.01, f"{what} {k}: {noise.sum()} weights of rounding noise"
        np.testing.assert_allclose(got[k][~noise], want[k][~noise], atol=1e-5,
                                   err_msg=f"{what} {k}")
        assert np.all(np.abs(got[k] - want[k])[noise] <= 2 * lr * steps), f"{what} {k}"
    for k in (k for k in want if k.startswith("mu")):
        assert _rel_to_max(got[k], want[k]) <= 1e-4, f"{what} {k}"


@pytest.mark.parametrize("case", [c for c in CASES if c != "trap"])
def test_dp_step_matches_one_device_and_jax_mesh(dp, case):
    got = dp["ranks"][0][case]
    _assert_same_step(got, dp["port"][case], f"{case}: dp=2 against one device")
    _assert_same_step(got, dp["jax"][case], f"{case}: dp=2 against the JAX mesh")


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_inputs_keep_the_kernel_route(dp, case):
    """The sketch-map losses of the gathered batch get a high-D side that
    needs no gradient (dense inputs), the condition for the kernels on the
    card (``ops/fused_sigmoid.py::fused_or_reference``). The analytic
    Cartesian route computes its CA sigmoid itself, and the ADC leaves the
    encoder input's sketch-map cost off by default: no call there."""
    flags = dp["ranks"][0][case]["sketch_h_needs_grad"]
    assert (flags.size > 0) == (case != "adc_analytic") and not flags.any()


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_stay_bit_identical(dp, case):
    a, b = dp["ranks"][0][case], dp["ranks"][1][case]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_per_rank_losses_would_give_another_step(dp):
    """Averaging per-rank losses (each rank's sketch-map cost over its own
    16 rows) moves the Adam moments visibly; the gathered step equals the
    global one, and a gradient left at twice its size would not."""
    got, want = dp["ranks"][0]["trap"], dp["port"]["trap"]
    halves = dp["halves"]
    keys = [k for k in want if k.startswith("mu")]
    gathered = max(_rel_to_max(got[k], want[k]) for k in keys)
    per_rank = max(_rel_to_max(0.5 * (halves[0][k] + halves[1][k]), want[k]) for k in keys)
    doubled = max(_rel_to_max(2 * got[k], want[k]) for k in keys)
    assert gathered <= 1e-4
    assert per_rank > 1e-2 and doubled > 0.5, (per_rank, doubled)


def test_only_rank0_writes_and_slices_partition(dp):
    d = dp["d"]
    info = dp["info"]
    assert [bool(i["primary"]) for i in info] == [True, False]
    assert [tuple(i["slice"]) for i in info] == [(0, 51), (51, 102)]
    for name in CASES:
        assert not (d / f"{name}_rank1").exists(), name
    run = d / "encodermap_rank0"
    assert (run / "parameters.json").is_file() and (run / "train_metrics.jsonl").is_file()
    assert (run / "saved_model_3.npz").is_file()
    assert bool(info[1]["none"]) and not (d / "sharded_rank1.h5").exists()


def test_sharded_featurizer_equals_plain(dp):
    import h5py

    info = dp["info"][0]
    names = [k[3:] for k in info if k.startswith("cv_")]
    assert "central_dihedrals" in names and "side_dihedrals" in names
    with h5py.File(dp["d"] / "sharded_rank0.h5", "r") as f:
        for k in names:
            np.testing.assert_array_equal(info[f"cv_{k}"], info[f"plain_{k}"], err_msg=k)
            np.testing.assert_array_equal(f["CVs"][k][()], info[f"plain_{k}"], err_msg=k)


# --------------------------------------------------------- single process
def test_single_process_helpers(tmp_path, monkeypatch):
    """Without a launcher's environment ``initialize`` is a no-op (twice);
    the process is the primary; it owns every row; a non-primary process
    writes no metrics."""
    from encodermap_tpu_torch import parallel
    from encodermap_tpu_torch.misc.summaries import MetricsWriter

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    parallel.initialize(device="cpu")
    parallel.initialize(device="cpu")
    assert parallel.world() == (0, 1) and parallel.is_primary()
    assert not torch.distributed.is_initialized()
    calls = []

    @parallel.primary_only
    def write(x):
        calls.append(x)
        return x

    assert write(3) == 3 and calls == [3]
    assert parallel.process_local_slice(103) == slice(0, 103)
    monkeypatch.setattr("encodermap_tpu_torch.parallel.distributed.world", lambda: (1, 2))
    assert not parallel.is_primary() and write(4) is None
    assert parallel.process_local_slice(103) == slice(51, 102)
    with pytest.raises(ValueError, match="divide evenly"):
        parallel.host_local_batch(np.zeros((3, 2)), n_global=3, device="cpu")
    w = MetricsWriter(tmp_path / "secondary")
    w.write_scalars(1, {"loss": 1.0})
    w.close()
    assert not (tmp_path / "secondary").exists()


def test_mesh_refusals_and_featurizer_dispatch(tmp_path, dp):
    """A mesh needs one process per device and says how to launch them,
    on the tensor-parallel axis too; the two ranks build a ``dp=1 x tp=2``
    mesh and a trainer on it; ``DaskFeaturizer`` dispatches as the JAX
    package's does."""
    import encodermap_tpu_torch as emt
    from encodermap_tpu_torch.loading.featurizer import EnsembleFeaturizer
    from encodermap_tpu_torch.parallel import make_mesh
    from encodermap_tpu_torch.parallel.sharded_featurize import (DaskFeaturizer,
                                                                 ShardedFeaturizer)
    from chip_smoke import synthetic_protein
    from encodermap_tpu_torch.data.pdb import write_pdb
    from encodermap_tpu_torch.data.xtc import write_xtc

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_mesh(dp=4, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_mesh(dp=2, tp=2, device="cpu")
    for info in dp["info"]:
        assert list(info["tp_mesh"]) == [1, 2, 1, 2]
    top, xyz = synthetic_protein("FKL", 4, seed=1)
    write_pdb(tmp_path / "p.pdb", top, xyz[:1])
    write_xtc(tmp_path / "p.xtc", xyz)
    traj = emt.load(str(tmp_path / "p.xtc"), str(tmp_path / "p.pdb"))
    ens = emt.load([str(tmp_path / "p.xtc")] * 2, str(tmp_path / "p.pdb"))
    assert isinstance(DaskFeaturizer(ens, device="cpu"), EnsembleFeaturizer)
    one = DaskFeaturizer(traj, n_workers=4, device="cpu")
    assert isinstance(one, ShardedFeaturizer) and one.dp == 1
    one.add_list_of_feats("all")
    plain = emt.Featurizer(traj, device="cpu")
    plain.add_list_of_feats("all")
    a, b = one.get_output(), plain.get_output()
    for k in b.keys():
        np.testing.assert_array_equal(a[k], b[k])


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
