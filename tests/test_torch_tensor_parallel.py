# tests/test_torch_tensor_parallel.py
"""Tensor parallelism of the port (the ``tp`` mesh axis and
``shard_params_tp``) against the JAX package's one-device step and the
port's one-process step.

Three groups of CPU processes join gloo groups through ``file://``
rendezvous files: a ``dp=1 x tp=2`` mesh of two ranks, a ``dp=2 x tp=2``
mesh of four and a ``dp=1 x tp=4`` mesh of four. Each rank builds the trainer with that
``mesh_shape``, passes its state through ``shard_params_tp`` (column- and
row-parallel layers over ``tp``, each stack's last layer replicated) and
trains from the JAX package's initial weights on the batch indices the JAX
trainer draws. The module fixture starts the groups once, each with a
time limit of its own, and meanwhile runs the same cases in this process:
the JAX package's trainer on one device and the port on one device.

Tolerances are those of ``tests/test_sharding.py:63-68`` and
``tests/test_torch_distributed.py`` (``_assert_same_step``): every logged
loss 1e-5 relative (1e-7 absolute), every parameter 1e-5 absolute with
ROADMAP's rule for weights whose gradient is float32 rounding noise, the
Adam first moments 1e-4 of each tensor's largest. Against the JAX package
the noise rule reads each step's gradient (from the port's one-device run,
one step a chunk): a mean-abs cost's bias gradient is exactly zero where a
column's residual signs balance, and Adam then steps by ``lr * g / (|g| +
eps)`` on the two packages' different rounding noise. The cases are those of
``tests/test_sharding.py``: the EncoderMap step (and a stack with an odd
number of hidden layers, whose last column-parallel output is all-gathered),
the ADC on its dense and analytic Cartesian routes, and the MeanAngles
batch mean, gathered over ``dp`` only. The tp ranks end bit-identical on
every replicated leaf (parameters and both Adam moments, so the gradients
of replicated leaves agree without a reduction), a sharded state's
checkpoint holds the whole tensors (equal to the gathered shards, loading
on one device and in the JAX package) and shards again through
``shard_params_tp``, also as a trainer's ``model_params``, and
``mesh_shape={"dp": 1, "tp": 2}`` (and the other two) drives
``train()`` over 6 steps with the parameters replicated over ``tp``, as
the JAX trainer keeps them. The slices ``shard_params_tp`` gives are held
to the JAX package's ``_mlp_layer_specs`` at [128,128,2] and at an odd
stack [64,64,64,2].

Run as a script, this file is the worker of one rank::

    python tests/test_torch_tensor_parallel.py <group> <rank> <rendezvous file> <dir>
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import leaf_arrays, replicated_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: seconds each group of worker processes may take
WORKER_LIMIT = 240
#: group -> mesh shape (world size dp * tp); tp4 is the wide leg of
#: ``__graft_entry__.dryrun_multichip``
GROUPS = {"tp2": {"dp": 1, "tp": 2}, "dp2tp2": {"dp": 2, "tp": 2}, "tp4": {"dp": 1, "tp": 4}}

#: case -> (trainer, parameters); every case starts from a shard_params_tp
#: state except "train", which keeps the trainer's replicated parameters
CASES = {
    "encodermap": ("em", dict(n_neurons=[16, 16, 2], batch_size=32, steps_per_scan=3,
                              n_steps=3, seed=5, periodicity=float("inf"))),
    "encodermap_odd": ("em", dict(n_neurons=[32, 32, 32, 2], batch_size=32,
                                  activation_functions=["", "tanh", "tanh", "tanh", ""],
                                  steps_per_scan=2, n_steps=2, seed=2,
                                  periodicity=float("inf"))),
    "adc_dense": ("adc", dict(batch_size=32, use_backbone_angles=True, use_sidechains=True,
                              n_neurons=[16, 16, 2], seed=7, n_steps=1, steps_per_scan=1)),
    "adc_analytic": ("adc", dict(batch_size=32, use_backbone_angles=True, use_sidechains=True,
                                 n_neurons=[16, 16, 2], seed=7, n_steps=1, steps_per_scan=1)),
    "adc_mean_angles": ("adc", dict(batch_size=32, use_backbone_angles=False,
                                    use_sidechains=False, n_neurons=[16, 16, 2], seed=3,
                                    n_steps=1, steps_per_scan=1)),
    # test_sharding.py::test_sharded_adc_scan_trainer: train() on the mesh
    "train": ("adc", dict(batch_size=16, use_backbone_angles=True, use_sidechains=True,
                          n_neurons=[16, 16, 2], seed=0, n_steps=6, steps_per_scan=3,
                          summary_step=100, checkpoint_step=3)),
}
SHARDED = [c for c in CASES if c != "train"]
#: shard_params_tp's layouts held against _mlp_layer_specs
STACKS = {"128_128_2": [128, 128, 2], "64_64_64_2": [64, 64, 64, 2]}


# ------------------------------------------------------------------ worker
def _make_model(name: str, spec: dict, main_path: Path, mesh_shape):
    import encodermap_tpu_torch as emt

    kind, kw = CASES[name]
    kw = dict(kw, main_path=str(main_path), mesh_shape=mesh_shape)
    if kind == "adc":
        return emt.AngleDihedralCartesianEncoderMap(
            spec["data"], emt.ADCParameters(**kw), model_params=spec["params"], device="cpu")
    return emt.EncoderMap(emt.Parameters(**kw), spec["data"], model_params=spec["params"],
                          device="cpu")


def run_case(name: str, spec: dict, main_path: Path, mesh_shape=None, shard: bool = False,
             per_step: bool = False) -> dict:
    """One case through the port: on a mesh (its state passed through
    ``shard_params_tp`` when ``shard``) or on one device. The parameters
    and moments come back whole; ``l*`` are this rank's own leaves.
    ``per_step`` runs one step a chunk (the same steps) and records each
    step's gradient, ``g<step>_<leaf>``, from the Adam first moments."""
    from encodermap_tpu_torch import Callback
    from encodermap_tpu_torch.parallel import shard_params_tp, unshard_params_tp
    from encodermap_tpu_torch.train import adc_autoencoder as adc_mod

    if per_step:
        kind, kw = CASES[name]
        CASES[name + "_per_step"] = (kind, dict(kw, steps_per_scan=1))
        try:
            model = _make_model(name + "_per_step", spec, main_path, mesh_shape)
        finally:
            del CASES[name + "_per_step"]
        idx = [i[s:s + 1] for i in spec["idx"] for s in range(len(i))]
    else:
        model = _make_model(name, spec, main_path, mesh_shape)
        idx = spec["idx"]
    if shard:
        params = shard_params_tp(model.state.params, model.mesh)
        model.state = model.state.replace(params=params, opt_state=model.optimizer.init(params))
    moments: list = []

    class Moments(Callback):
        def on_chunk_end(self, first_step, metrics):
            moments.append(leaf_arrays(unshard_params_tp(model.state.opt_state["mu"])))

    if per_step:
        model.add_callback(Moments())
    analytic = adc_mod.MIN_ANALYTIC_ATOMS
    if name == "adc_analytic":
        adc_mod.MIN_ANALYTIC_ATOMS = 1
    try:
        hist = model.train(index_stream=iter(idx))
    finally:
        adc_mod.MIN_ANALYTIC_ATOMS = analytic
    st = model.state
    out = {f"p{i}": a for i, a in enumerate(leaf_arrays(unshard_params_tp(st.params)))}
    out.update({f"mu{i}": a for i, a in enumerate(leaf_arrays(unshard_params_tp(st.opt_state["mu"])))})
    out.update({f"h_{k}": np.asarray(v) for k, v in hist.items()})
    for name_, tree in (("l", st.params), ("lmu", st.opt_state["mu"]), ("lnu", st.opt_state["nu"])):
        out.update({f"{name_}{i}": a for i, a in enumerate(leaf_arrays(tree))})
    out["replicated"] = np.array(replicated_leaves(st.params))
    prev = [np.zeros_like(m) for m in moments[0]] if moments else []
    for k, mus in enumerate(moments):
        # mu_k = b1 mu_(k-1) + (1 - b1) clip(g_k)
        out.update({f"g{k}_{i}": (m - 0.9 * q) / 0.1 for i, (m, q) in enumerate(zip(mus, prev))})
        prev = mus
    return out


def worker(group: str, rank: int, rendezvous: str, d: Path) -> None:
    """One rank of ``group``: every case on its mesh, the layouts of
    ``shard_params_tp``, a reload of a sharded checkpoint onto the mesh
    (``shard_params_tp`` of the loaded tree) and into a trainer on it;
    results to ``d/<group>_rank<r>_<case>.npz``."""
    import warnings

    import torch.distributed as dist

    import encodermap_tpu_torch as emt
    from encodermap_tpu_torch import parallel
    from encodermap_tpu_torch.misc.saving import load_checkpoint, load_opt_state
    from encodermap_tpu_torch.nn import TPLayer
    from encodermap_tpu_torch.train.core import tree_leaves

    shape = GROUPS[group]
    world = shape["dp"] * shape["tp"]
    parallel.initialize(init_method=f"file://{rendezvous}", world_size=world, rank=rank,
                        device="cpu")
    with open(d / "specs.pkl", "rb") as f:
        specs = pickle.load(f)
    info = {}
    for name in CASES:
        path = d / f"{group}_{name}_rank{rank}"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = run_case(name, specs[name], path, mesh_shape=shape, shard=name != "train")
        res["fused_warned"] = np.array(any("general route" in str(w.message) for w in caught))
        np.savez(d / f"{group}_rank{rank}_{name}.npz", **res)
    # the sharded EncoderMap's final checkpoint, loaded back onto the mesh
    mesh = parallel.make_mesh(**shape, device="cpu")
    info["mesh_shape"] = np.array([mesh["dp"].size(), mesh["tp"].size()])
    ckpt = d / f"{group}_encodermap_rank0" / "saved_model_3.npz"
    whole, opt_file, _ = load_checkpoint(ckpt)
    params = parallel.shard_params_tp(whole, mesh)
    mu = parallel.shard_params_tp(load_opt_state(opt_file)["mu"], mesh)
    info["reload_kinds"] = np.array([getattr(l, "kind", "") for l in params["encoder"]])
    for i, a in enumerate(tree_leaves(params)):
        info[f"reload_p{i}"] = a.numpy()
    for i, a in enumerate(tree_leaves(mu)):
        info[f"reload_mu{i}"] = a.numpy()
    # the shards as a trainer's model_params on the mesh: each rank keeps its own
    ctor = emt.EncoderMap(
        emt.Parameters(**dict(CASES["encodermap"][1], mesh_shape=shape)),
        specs["encodermap"]["data"], model_params=params, read_only=True, device="cpu")
    info["ctor_kinds"] = np.array([getattr(l, "kind", "") for l in ctor.state.params["encoder"]])
    for i, a in enumerate(tree_leaves(ctor.state.params)):
        info[f"ctor_p{i}"] = a.detach().numpy()
    # shard_params_tp's slices of the layouts under test
    for key in STACKS:
        tree = {part: [{"kernel": torch.tensor(k), "bias": torch.tensor(b)} for k, b in layers]
                for part, layers in _stack_layers(key).items()}
        tree["densifiers"] = {"angles": {"kernel": torch.ones(3, 3), "bias": torch.zeros(3)}}
        sharded = parallel.shard_params_tp(tree, mesh)
        for part in ("encoder", "decoder"):
            for i, layer in enumerate(sharded[part]):
                info[f"{key}_{part}{i}_kind"] = np.array(getattr(layer, "kind", "replicated"))
                info[f"{key}_{part}{i}_tp"] = np.array(isinstance(layer, TPLayer))
                for t in ("kernel", "bias"):
                    info[f"{key}_{part}{i}_{t}"] = layer[t].numpy()
        info[f"{key}_densifier_same"] = np.array(
            sharded["densifiers"]["angles"]["kernel"] is tree["densifiers"]["angles"]["kernel"])
    np.savez(d / f"{group}_rank{rank}_info.npz", **info)
    dist.barrier()
    dist.destroy_process_group()
    print(f"{group} rank {rank} OK", flush=True)


def run_ranks(code: str, world: int, d: Path, timeout: float = 120) -> list:
    """Run ``code`` in ``world`` CPU processes that have joined one gloo
    group (``file://`` rendezvous in ``d``; ``rank`` and ``world`` are
    defined for it), which they leave together at the end (a gloo group
    left at interpreter exit can abort a rank); returns each rank's
    output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    head = ("import sys; rank, world = int(sys.argv[1]), int(sys.argv[2])\n"
            "from encodermap_tpu_torch import parallel\n"
            f"parallel.initialize(init_method='file://{d / 'rendezvous'}', world_size=world, "
            "rank=rank, device='cpu')\n")
    tail = "\nimport torch.distributed as dist\ndist.barrier()\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen([sys.executable, "-c", head + code + tail, str(r), str(world)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    outs, deadline = [], time.monotonic() + timeout
    try:
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def _stack_layers(key: str) -> dict:
    """Random (kernel, bias) pairs of a stack's encoder (6 inputs) and
    decoder (back to 6), from a seed."""
    rng = np.random.default_rng(len(STACKS[key]))
    enc = [6] + STACKS[key]
    dec = enc[::-1]
    return {part: [(rng.standard_normal((a, b)), rng.standard_normal(b))
                   for a, b in zip(dims, dims[1:])]
            for part, dims in (("encoder", enc), ("decoder", dec))}


# ---------------------------------------------------------------- fixture
def _jax_model(name: str, data, main_path: Path):
    """The JAX package's trainer of a case on one device."""
    import encodermap_tpu as emj

    kind, kw = CASES[name]
    kw = dict(kw, main_path=str(main_path))
    if kind == "adc":
        return emj.AngleDihedralCartesianEncoderMap(data, emj.ADCParameters(**kw))
    return emj.EncoderMap(emj.Parameters(**kw), data)


def _launch(d: Path, group: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    shape = GROUPS[group]
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), group, str(r),
                              str(d / f"rendezvous_{group}"), str(d)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(shape["dp"] * shape["tp"])]


def _wait(group: str, procs: list, start: float) -> None:
    deadline = start + WORKER_LIMIT
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise AssertionError(f"the {group} workers took more than {WORKER_LIMIT} s")
        assert proc.returncode == 0, f"{group} rank {r} failed:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Start the groups, run the references here meanwhile, collect."""
    import jax

    from encodermap_tpu_torch.train import adc_autoencoder as adc_t
    import encodermap_tpu.train.adc_autoencoder as adc_j
    from tests.test_torch_distributed import _adc_cvs, _jax_result

    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(11)
    specs, jax_models = {}, {}
    for name, (kind, kw) in CASES.items():
        if name == "adc_mean_angles":
            data = _adc_cvs(rng, side=False)
        elif kind == "adc":
            data = _adc_cvs(rng)
        else:
            data = rng.standard_normal((256, 6)).astype(np.float32)
        ej = _jax_model(name, data, d / f"{name}_jax")
        spec = {"data": data, "params": jax.device_get(ej.state.params)}
        n = len(data) if kind == "em" else len(data["central_angles"])
        if name == "train":
            # two chunks' indices from the seed, for the port's runs alone
            spec["idx"] = [rng.integers(0, n, (kw["steps_per_scan"], kw["batch_size"]))
                           for _ in range(kw["n_steps"] // kw["steps_per_scan"])]
        else:
            key = jax.random.split(ej.state.rng)[1]
            spec["idx"] = [np.asarray(jax.random.randint(key, (kw["n_steps"], kw["batch_size"]),
                                                         0, n))]
        specs[name], jax_models[name] = spec, ej
    with open(d / "specs.pkl", "wb") as f:
        pickle.dump(specs, f)
    start = time.monotonic()
    procs = {g: _launch(d, g) for g in GROUPS}
    try:
        ref_jax, ref_port = {}, {}
        for name, ej in jax_models.items():
            if name != "train":
                patched = adc_j.MIN_ANALYTIC_ATOMS
                if name == "adc_analytic":
                    adc_j.MIN_ANALYTIC_ATOMS = 1
                try:
                    ref_jax[name] = _jax_result(ej, ej.train())
                finally:
                    adc_j.MIN_ANALYTIC_ATOMS = patched
            ref_port[name] = run_case(name, specs[name], d / f"{name}_single", per_step=True)
        assert adc_t.MIN_ANALYTIC_ATOMS != 1
    finally:
        for g, ps in procs.items():
            _wait(g, ps, start)
    ranks = {g: [{name: dict(np.load(d / f"{g}_rank{r}_{name}.npz")) for name in CASES}
                 for r in range(s["dp"] * s["tp"])] for g, s in GROUPS.items()}
    info = {g: [dict(np.load(d / f"{g}_rank{r}_info.npz")) for r in range(s["dp"] * s["tp"])]
            for g, s in GROUPS.items()}
    return dict(d=d, jax=ref_jax, port=ref_port, ranks=ranks, info=info, specs=specs)


def _same_step(got: dict, want: dict, what: str, steps_from: dict) -> None:
    """``chip_smoke.py::hold_same_steps``: every logged term 1e-5 relative
    (1e-7 absolute), the first moments 1e-4 of the model's largest, every
    parameter 1e-5, with the rounding-noise rule read at every step of
    ``steps_from`` (a one-device run's per-step gradients). The moments
    are held to the model's scale, not each tensor's: the latent layer's
    bias gradient is a cancellation residual (the sketch-map gradient
    sums to zero over the batch), whose last bits are a visible part of
    its own largest entry."""
    from chip_smoke import hold_same_steps

    hold_same_steps(got, want, what, steps_from=steps_from)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("case", SHARDED)
@pytest.mark.parametrize("group", list(GROUPS))
def test_tp_step_matches_one_device_and_jax(tp, group, case):
    """The tp-sharded steps against the port's one-process steps and the
    JAX package's one-device steps from the same weights and batches."""
    got = tp["ranks"][group][0][case]
    _same_step(got, tp["port"][case], f"{group} {case}: against one device",
               steps_from=tp["port"][case])
    _same_step(got, tp["jax"][case], f"{group} {case}: against JAX's one device",
               steps_from=tp["port"][case])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("group", list(GROUPS))
def test_tp_ranks_bit_identical_on_replicated_leaves(tp, group, case):
    """Every rank holds the same whole parameters and moments; the ranks
    of a tp group hold the same replicated leaves bit for bit, parameters
    and both Adam moments (so their gradients were equal, with no
    reduction over tp), and the sharded leaves differ."""
    ranks = tp["ranks"][group]
    flags = ranks[0][case]["replicated"]
    assert flags.any()
    assert (not flags.all()) == (case != "train")
    for r in ranks[1:]:
        for k in ranks[0][case]:
            if k[0] in "pm":
                np.testing.assert_array_equal(r[case][k], ranks[0][case][k], err_msg=k)
    tp_size = GROUPS[group]["tp"]
    for first in range(0, len(ranks), tp_size):
        a = ranks[first][case]
        for b in (ranks[first + j][case] for j in range(1, tp_size)):
            for i, rep in enumerate(flags):
                for pre in ("l", "lmu", "lnu"):
                    if rep:
                        np.testing.assert_array_equal(a[f"{pre}{i}"], b[f"{pre}{i}"],
                                                      err_msg=f"{pre}{i}")
                    elif pre == "l":
                        assert not np.array_equal(a[f"{pre}{i}"], b[f"{pre}{i}"]), i


@pytest.mark.parametrize("group", list(GROUPS))
def test_tp_trainer_replicated_six_steps_and_checkpoint(tp, group):
    """``train()`` with ``mesh_shape`` over tp (JAX's trainer keeps the
    parameters replicated over tp, and so does the port's): 6 finite steps
    equal to the one-device run; the final checkpoint, written by rank 0
    alone, loads on one device and in the JAX package with the trained
    weights; the fused kernel is left for the general route with a
    warning."""
    import jax

    import encodermap_tpu as emj
    import encodermap_tpu_torch as emt
    from encodermap_tpu_torch.misc.saving import load_checkpoint

    got = tp["ranks"][group][0]["train"]
    assert len(got["h_loss"]) == 6 and np.isfinite(got["h_loss"]).all()
    _same_step(got, tp["port"]["train"], f"{group} train: against one device",
               steps_from=tp["port"]["train"])
    d = tp["d"]
    run = d / f"{group}_train_rank0"
    assert (run / "saved_model_6.npz").is_file() and (run / "saved_model_3.npz").is_file()
    assert not (d / f"{group}_train_rank1" / "saved_model_6.npz").exists()
    data = tp["specs"]["train"]["data"]
    # on one device: the run's parameters without its mesh
    p = emt.ADCParameters.from_file(run / "parameters.json")
    assert p.mesh_shape == GROUPS[group] and p.current_training_step == 6
    p.mesh_shape = None
    params, _, step = load_checkpoint(run)
    port = emt.AngleDihedralCartesianEncoderMap(data, p, model_params=params, read_only=True,
                                                device="cpu")
    jax_ = emj.AngleDihedralCartesianEncoderMap.from_checkpoint(data, run)
    port_leaves = leaf_arrays(port.state.params)
    jax_leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jax.device_get(jax_.state.params))]
    for i, (a, b) in enumerate(zip(port_leaves, jax_leaves)):
        np.testing.assert_array_equal(a, got[f"p{i}"], err_msg=f"port p{i}")
        np.testing.assert_array_equal(b, got[f"p{i}"], err_msg=f"JAX p{i}")
    assert step == port.state.step == jax_.state.step == 6
    for case in CASES:
        assert bool(tp["ranks"][group][0][case]["fused_warned"]) == (CASES[case][0] == "em")


@pytest.mark.parametrize("group", list(GROUPS))
def test_sharded_checkpoint_is_whole_and_reshards(tp, group):
    """The sharded EncoderMap's final checkpoint holds the whole tensors
    (the gathered shards, bit for bit) in the JAX key format: it loads in
    the JAX package; ``shard_params_tp`` of what ``load_checkpoint`` and
    ``load_opt_state`` read gives each rank its own shards back, and a
    trainer on the mesh given those shards as ``model_params`` keeps each
    rank's own."""
    import jax

    import encodermap_tpu as emj

    ranks = tp["ranks"][group]
    run = tp["d"] / f"{group}_encodermap_rank0"
    got = ranks[0]["encodermap"]
    data = tp["specs"]["encodermap"]["data"]
    jax_ = emj.EncoderMap.from_checkpoint(run, train_data=data)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jax.device_get(jax_.state.params))]
    assert len(leaves) == len([k for k in got if k.startswith("p")])
    for i, a in enumerate(leaves):
        np.testing.assert_array_equal(a, got[f"p{i}"], err_msg=f"p{i}")
    assert not (tp["d"] / f"{group}_encodermap_rank1" / "saved_model_3.npz").exists()
    for r, info in enumerate(tp["info"][group]):
        assert list(info["mesh_shape"]) == [GROUPS[group]["dp"], GROUPS[group]["tp"]]
        assert list(info["reload_kinds"]) == list(info["ctor_kinds"]) == ["column", "row", ""]
        own = ranks[r]["encodermap"]
        for i in range(len(leaves)):
            np.testing.assert_array_equal(info[f"reload_p{i}"], own[f"l{i}"], err_msg=f"p{i}")
            np.testing.assert_array_equal(info[f"ctor_p{i}"], own[f"l{i}"], err_msg=f"ctor p{i}")
            np.testing.assert_array_equal(info[f"reload_mu{i}"], own[f"lmu{i}"], err_msg=f"mu{i}")


@pytest.mark.parametrize("stack", list(STACKS))
def test_shard_params_tp_slices_follow_jax_specs(tp, stack):
    """Each rank's slices are the JAX package's ``_mlp_layer_specs`` applied
    to the whole tensors (rank r's part of the axis named ``tp``); the last
    layer of each stack and the densifiers stay whole and replicated."""
    from encodermap_tpu.parallel.mesh import _mlp_layer_specs as jax_specs
    from encodermap_tpu_torch.parallel.mesh import _mlp_layer_specs

    stacks = _stack_layers(stack)
    n = len(stacks["encoder"])
    assert _mlp_layer_specs(n) == [(tuple(k), tuple(b)) for k, b in jax_specs(n)]
    for group, infos in tp["info"].items():
        tp_size = GROUPS[group]["tp"]
        for rank, info in enumerate(infos):
            tp_rank = rank % tp_size
            for part, layers in stacks.items():
                for i, ((kernel, bias), (k_spec, b_spec)) in enumerate(zip(layers, jax_specs(n))):
                    pre = f"{stack}_{part}{i}"
                    last = i == n - 1
                    assert bool(info[f"{pre}_tp"]) == (not last)
                    assert str(info[f"{pre}_kind"]) == (
                        "replicated" if last else ("column" if i % 2 == 0 else "row"))
                    for t, whole, spec in (("kernel", kernel, k_spec), ("bias", bias, b_spec)):
                        want = whole
                        if not last and "tp" in tuple(spec):
                            axis = tuple(spec).index("tp")
                            want = np.split(whole, tp_size, axis=axis)[tp_rank]
                        np.testing.assert_array_equal(info[f"{pre}_{t}"], want, err_msg=pre + t)
            assert bool(info[f"{stack}_densifier_same"])


@pytest.mark.parametrize("local, world, cards, want", [
    ("8", 16, 8, "nccl"),  # torchrun --nnodes 2 --nproc-per-node 8
    ("2", 2, 1, "gloo"),  # two ranks sharing one card
    (None, 2, 1, "gloo"),  # an explicit init_method, no launcher: all ranks here
    (None, 4, 4, "nccl"),
])
def test_backend_follows_ranks_on_the_node(monkeypatch, local, world, cards, want):
    """NCCL on CUDA unless this node's ranks outnumber its cards; a run
    over several nodes with one rank per card stays on NCCL. The CPU
    always takes gloo."""
    from encodermap_tpu_torch.parallel.distributed import backend_for

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert backend_for(torch.device("cuda"), world) == want
    assert backend_for(torch.device("cpu"), world) == "gloo"


def test_tp_refusals(tmp_path):
    """Uneven widths and a row-parallel layer without its column-parallel
    partner are refused; a one-process run cannot build a tp mesh and is
    told how to launch one."""
    from encodermap_tpu_torch.nn import TPLayer, mlp_apply
    from encodermap_tpu_torch.parallel import make_mesh
    from encodermap_tpu_torch.parallel.mesh import _slice

    with pytest.raises(ValueError, match="does not divide over the tp axis of 2"):
        _slice(torch.zeros(4, 5), (None, "tp"), 0, 2)
    row = TPLayer({"kernel": torch.zeros(2, 3), "bias": torch.zeros(3)}, "row", None)
    with pytest.raises(ValueError, match="row-parallel layer needs"):
        mlp_apply([row], torch.zeros(1, 4), [None])
    with pytest.raises(ValueError, match="kind must be"):
        TPLayer({}, "diagonal", None)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_mesh(dp=1, tp=2, device="cpu")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
