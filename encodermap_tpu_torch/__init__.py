# encodermap_tpu_torch/__init__.py
"""EncoderMap in PyTorch, with its kernels hand-written in CUDA for Hopper.

A port of ``encodermap_tpu`` (JAX on a TPU), which stays in the repository
as its reference; each module names its counterpart there. Slice 1 is
plain EncoderMap training: parameters, the MLP autoencoder, the losses,
the chunked trainer with its fused train kernel and sigmoid-loss kernels,
checkpoints that load in both packages, and encode/decode/generate. Slice 2
is the AngleDihedralCartesianEncoderMap (ADC): internal coordinates,
backmapping inside the step, the Cartesian costs, on the same sigmoid-loss
kernels. Slice 3 adds the ADC's sidechain reconstruction
(``reconstruct_sidechains=True``) and multimer training
(``multimer_training="homogeneous_transformation"``). Slice 4 adds the data
layer: trajectories (``load``, ``SingleTraj``, ``TrajEnsemble``, PDB and
XTC files), featurization on the card (``Featurizer``, ``load_CVs``) and
generation onto a topology (``generate(backend="topology")``). Slice 5 is
scale-out: out-of-core training from superbatch sources (``train_streaming``,
``train/core.py::HDF5BatchSource``, pinned uploads on a side stream) and
data parallelism over ``torch.distributed`` (``mesh_shape={"dp": N}`` with
one process per device, ``parallel/``). Slice 6a adds GRO, DCD and TRR
files (``data/formats.py``), secondary structure (``ops/dssp.py``) and RMSD
clustering (``misc/clustering.py``) on the card, ``MolData``, the
reference's ``.keras`` checkpoints (``misc/keras_import.py``) and
``load_project`` (``kondata.py``). Slice 6b adds observability: TensorBoard
event files written by the port itself (``tensorboard=True``; no
TensorFlow needed), latent images (``add_images_to_tensorboard``), layer
statistics, the model summary, ``torch.profiler`` traces with the
training path's spans and the kernel-launch counter (``misc/profiling.py``),
``function`` (``torch.compile`` with a plain debug form), and the host-side
plotting, interactive selection and dashboard pages (``plot``; matplotlib,
ipywidgets and dash imported only where used).

Entry points run on the CUDA card unless ``device="cpu"`` is passed::

    import encodermap_tpu_torch as em
    data, _ = em.create_n_cube(3, points_along_edge=500, seed=0)
    p = em.Parameters(periodicity=float("inf"), n_steps=2000)
    emap = em.EncoderMap(p, data)          # device="cpu" without a card
    emap.train()
    latent = emap.encode(data)

    trajs = em.load(["a.xtc", "b.xtc"], "top.pdb")
    trajs.load_CVs("all", ensemble=True)   # features run on the card
    adc = em.AngleDihedralCartesianEncoderMap(trajs, em.ADCParameters())
    adc.train()                            # or a dict of CV arrays
    xyz = adc.generate(adc.encode()[:10], backend="topology", top=trajs[0])

    from encodermap_tpu_torch.ops.dssp import compute_dssp
    ss = compute_dssp(trajs[0])            # (frames, residues) of H/E/C

    p = em.Parameters(tensorboard=True)    # events in main_path/train/
    from encodermap_tpu_torch.misc import profiling
    profiling.profile_steps(emap, n_steps=2, logdir="profile")  # *.pt.trace.json.gz
    with profiling.trace("profile"):       # the program's spans (off by default)
        emap.train()                       # on in the trace: open it in ui.perfetto.dev
    with profiling.record_spans():         # spans without the profiler
        emap.train()
    profiling.span_totals()["train.fetch"] # (count, total_s, self_s) so far

    trajs.save("ens.h5")                   # out of core (needs h5py)
    adc = em.AngleDihedralCartesianEncoderMap.from_ensemble_h5("ens.h5", em.ADCParameters())
    adc.train_streaming("ens.h5")

    # torchrun --nproc-per-node 4 train.py, with in train.py:
    p = em.Parameters(mesh_shape={"dp": 4})  # each rank 1/4 of every batch
"""

__version__ = "0.1.0"

from . import data, loading, misc, models, parallel
from .data.api import load
from .data.custom_topology import CustomAAsDict, CustomTopology
from .data.trajectory import SingleTraj, TrajEnsemble
from .loading.featurizer import Featurizer
from .losses import (
    angle_loss,
    auto_loss,
    cartesian_distance_loss,
    cartesian_loss,
    center_loss,
    dihedral_loss,
    distance_loss,
    loss_combinator,
    reconstruction_loss,
    regularization_loss,
    side_dihedral_loss,
    sigmoid_loss,
)
from .kondata import get_from_kondata, load_project
from .misc.misc import create_n_cube
from .models.sequential import SequentialModel, gen_sequential_model
from .moldata import MolData
from .parallel.sharded_featurize import DaskFeaturizer
from .parameters import ADCParameters, Parameters
from .train.adc_autoencoder import AngleDihedralCartesianEncoderMap
from .train.autoencoder import Autoencoder, DihedralEncoderMap, EncoderMap
from .train.callbacks import (
    Callback,
    CheckpointSaver,
    EarlyStop,
    NaNInterrupt,
    ProgressBar,
)

__all__ = [
    "__version__",
    "plot",
    "function",
    "InteractivePlotting",
    "data",
    "loading",
    "misc",
    "models",
    "parallel",
    "features",
    "callbacks",
    "EncoderMapBaseCallback",
    "MolData",
    "get_from_kondata",
    "load_project",
    "DaskFeaturizer",
    "CustomAAsDict",
    "load",
    "SingleTraj",
    "TrajEnsemble",
    "Featurizer",
    "CustomTopology",
    "Parameters",
    "ADCParameters",
    "create_n_cube",
    "SequentialModel",
    "gen_sequential_model",
    "Autoencoder",
    "EncoderMap",
    "DihedralEncoderMap",
    "AngleDihedralCartesianEncoderMap",
    "Callback",
    "CheckpointSaver",
    "EarlyStop",
    "NaNInterrupt",
    "ProgressBar",
    "angle_loss",
    "auto_loss",
    "cartesian_distance_loss",
    "cartesian_loss",
    "center_loss",
    "dihedral_loss",
    "distance_loss",
    "loss_combinator",
    "reconstruction_loss",
    "regularization_loss",
    "side_dihedral_loss",
    "sigmoid_loss",
]


def __getattr__(name):
    # namespaces built on first use, as in the JAX package
    import importlib

    if name == "features":
        return importlib.import_module(".loading.features", __name__)
    if name == "plot":
        return importlib.import_module(".plot", __name__)
    if name == "function":
        from .misc.function_def import function

        return function
    if name == "InteractivePlotting":
        from .plot.interactive import InteractivePlotting

        return InteractivePlotting
    if name == "EncoderMapBaseCallback":
        return Callback
    if name == "callbacks":
        # em.callbacks: the callbacks, the reference's base-callback name,
        # and the metric classes that its callbacks package re-exports
        # (metrics.py:250-581) with the Kabsch helpers it defines
        mod = importlib.import_module(".train.callbacks", __name__)
        if not hasattr(mod, "EncoderMapBaseMetric"):
            metrics_mod = importlib.import_module(".train.metrics", __name__)
            for _name in metrics_mod.__all__:
                setattr(mod, _name, getattr(metrics_mod, _name))
            from .ops.kabsch import kabsch_weighted, rmsd

            mod.kabsch_weighted = kabsch_weighted
            mod.rmsd = rmsd
            mod.EncoderMapBaseCallback = mod.Callback
            # the reference's weight-NaN abort; the loss-NaN abort catches
            # the same divergence a step earlier
            mod.NoneInterruptCallback = mod.NaNInterrupt
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
