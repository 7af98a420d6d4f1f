# encodermap_tpu_torch/train/autoencoder.py
"""User-facing autoencoders: Autoencoder, EncoderMap, DihedralEncoderMap.

Counterpart of ``encodermap_tpu/train/autoencoder.py`` (after the
reference's ``autoencoder/autoencoder.py:573-1400``): ``train()``,
``encode()``, ``decode()``, ``generate()``, ``save()`` and
``from_checkpoint()``, hypercube fallback data, exact ``n_steps``
accounting, callbacks at chunk granularity.

The dataset lives on the device. A chunk of ``steps_per_scan`` steps runs
either through the fused train kernel (``ops/fused_train.py``, one launch
per chunk) where :meth:`EncoderMap._maybe_fused_trainer` allows it, or
through the general route: one autograd step per batch, the sketch-map loss
through the sigmoid-loss kernels. Entry points run on the card
(``device=None`` means ``"cuda"``) unless the caller asks for the CPU.

The general route's step is shared with the ADC trainer
(``train/adc_autoencoder.py``), which plugs in through the JAX package's
hooks: ``_loss_and_aux`` (the terms at a global step, plus forward
intermediates), ``_aux_metric_terms`` (metrics from those intermediates)
and ``_metrics_only`` (terms logged but not summed into the loss).

Out-of-core training: :meth:`Autoencoder.train_streaming` runs
``train/core.py::run_streaming`` on superbatches from a batch source.

Data parallelism: ``p.mesh_shape={"dp": N}`` trains over N processes, one
per device (``parallel/mesh.py``). Every rank holds rank 0's parameters and
takes its ``B/N`` rows of each global batch; the per-row forward runs on
those rows, and the rows the losses need are gathered across the ranks
(:meth:`Autoencoder._gather_rows`), so every rank computes the global
batch's loss, as the JAX package's GSPMD step does. The gradients are
all-reduced and divided by N (:meth:`Autoencoder._reduce_grads`), which
keeps the ranks' parameters bit-identical. Each rank keeps the whole
training set on its device, where the JAX package shards it (ROADMAP.md
Queue 3). Checkpoints, the metrics log and the progress output come from
rank 0 only.

Tensor parallelism: ``p.mesh_shape={"dp": d, "tp": t}`` runs ``d * t``
processes. As in the JAX package, whose trainers never call
``shard_params_tp``, the batch is split over ``dp`` only and the
parameters stay replicated over ``tp``: the ranks of one dp index take the
same rows, and the gathers and the gradient reduction run over the ``dp``
group alone. A state passed through ``parallel.shard_params_tp`` (its
layers then ``nn.TPLayer``s) steps as the unsharded one does
(:meth:`Autoencoder._make_train_step`): the forward pass and the L2 sum run
the tp collectives, a shard's gradient stays on its rank, and clipping and
Adam act on shards elementwise. :meth:`Autoencoder.save` of such a state
writes whole tensors, gathered over ``tp``.

Observability: ``p.tensorboard=True`` mirrors the metrics rows to a
TensorBoard event file in ``main_path/train/`` (written by the port itself,
``misc/event_file.py``), :meth:`Autoencoder.add_images_to_tensorboard`
adds latent images, and ``p.tensorboard or p.write_summary`` writes
``complete_model_summary.txt`` when the model is built.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterator, Optional, Union

import numpy as np
import torch

from .. import losses as L
from ..device import resolve_device
from ..misc.misc import create_n_cube
from ..misc.profiling import span, spans_enabled
from ..misc.saving import (
    load_checkpoint,
    load_checkpoint_rng,
    load_opt_state,
    save_checkpoint,
)
from ..misc.summaries import MetricsWriter
from ..models import sequential as seq
from ..nn import has_tp_layers
from ..ops.fused_train import fused_trainer_available, make_fused_trainer
from ..parameters import Parameters
from ..parallel.distributed import gather_rows, is_primary
from .callbacks import Callback, CheckpointSaver, NaNInterrupt, ProgressBar
from .core import (
    TrainState,
    make_optimizer,
    make_scan_trainer,
    seed_rng,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = ["Autoencoder", "EncoderMap", "DihedralEncoderMap"]


class _SubModel:
    """The encoder or decoder as a callable with keras's call conventions,
    ``model(x)`` and ``model.predict(x)`` (counterpart of the JAX package's
    ``_SubModel``)."""

    def __init__(self, fn) -> None:
        self._fn = fn

    def __call__(self, x, *args, **kwargs):
        return self._fn(x)

    def predict(self, x, *args, **kwargs):
        """keras's name for ``__call__`` (batching is internal)."""
        return self._fn(x)


def _tree_to_device(tree: Any, device: torch.device) -> Any:
    """float32 tensors on ``device`` from a tree of arrays or tensors."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, np.float32))
        return x.to(device=device, dtype=torch.float32)

    return tree_map(one, tree)


class Autoencoder:
    """Base autoencoder: auto + center + regularization losses.

    Args:
        parameters: a :class:`Parameters` instance (defaults if None).
        train_data: ``(n_samples, n_features)`` array; None generates the
            hypercube toy data, as the reference does.
        model_params: initial ``{"encoder", "decoder"}`` parameters (numpy
            arrays or tensors), e.g. weights carried over from the JAX
            package with :func:`encodermap_tpu_torch.convert.params_from_numpy`.
        read_only: write nothing to ``main_path``.
        sparse: expect NaN-padded inputs (adds a trainable densifier).
        learning_rate_schedule: callable ``step -> lr`` replacing the
            constant ``p.learning_rate`` (general route only).
        device: where to train; None means ``"cuda"`` and raises without a
            card (pass ``device="cpu"`` to train on the CPU).
    """

    def __init__(self, parameters: Optional[Parameters] = None,
                 train_data: Optional[np.ndarray] = None,
                 model_params: Optional[dict] = None, read_only: bool = False,
                 sparse: bool = False, learning_rate_schedule=None,
                 device: Any = None) -> None:
        self._init_run(parameters if parameters is not None else Parameters(),
                       "sequential", read_only, learning_rate_schedule, device)
        self.sparse = sparse

        if train_data is None:
            train_data, _ = create_n_cube(seed=self.p.seed)
            self.p.using_hypercube = True
        train_data = np.asarray(train_data, np.float32)
        self._nan_mask = np.isnan(train_data)
        if self._nan_mask.any():
            self.sparse = True
        self.train_data = train_data
        self.input_dim = train_data.shape[1]
        self._init_state(model_params, lambda gen: seq.init_params(
            gen, self.p, self.input_dim, sparse=self.sparse))

    def _init_run(self, p, model_api: str, read_only: bool,
                  learning_rate_schedule, device: Any) -> None:
        """What every trainer sets first: device, parameters, options."""
        self.device = resolve_device(device)
        self.p = p
        self._mesh = None
        self._dp = None
        if self.p.mesh_shape:
            from ..parallel.mesh import dp_info, make_mesh

            self._mesh = make_mesh(**dict(self.p.mesh_shape), device=self.device)
            self._dp = dp_info(self._mesh)
        self._validate_model_api(model_api)
        self._lr_schedule = learning_rate_schedule
        self.read_only = read_only
        self._metrics_writer: Optional[MetricsWriter] = None
        self.history: dict = {}

    def _init_state(self, model_params: Optional[dict], init_fn) -> None:
        """Write parameters.json, take ``model_params`` (or
        ``init_fn(generator)`` seeded from ``p.seed``) to the device, and
        build the optimizer and the train state. On a mesh every rank takes
        rank 0's parameters, and only rank 0 writes."""
        if not self.read_only and is_primary():
            Path(self.p.main_path).mkdir(parents=True, exist_ok=True)
            self.p.save(Path(self.p.main_path) / "parameters.json")
        seed = self.p.seed if self.p.seed is not None else 0
        if model_params is None:
            model_params = init_fn(torch.Generator().manual_seed(int(seed)))
        model_params = _tree_to_device(model_params, self.device)
        if self._mesh is not None:
            from ..parallel.mesh import replicate

            replicate(model_params, self._mesh)
        self.optimizer = make_optimizer(
            self._lr_schedule if self._lr_schedule is not None
            else self.p.learning_rate)
        self.state = TrainState.create(model_params, self.optimizer,
                                       seed_rng(seed),
                                       step=self.p.current_training_step)
        self._trainer: dict = {}
        self.callbacks: list[Callback] = []
        self.custom_losses: list = []
        self.custom_metrics: list = []
        self._maybe_write_summary()

    def _maybe_write_summary(self) -> Optional[str]:
        """``main_path/complete_model_summary.txt`` when ``p.tensorboard or
        p.write_summary``, as the reference writes keras's
        ``model.summary()`` (``models/models.py:1051-1059``): one row per
        parameter under the JAX package's path names, with its shape and
        size, and the total (``encodermap_tpu/train/autoencoder.py:
        329-350``)."""
        from ..misc.summaries import param_paths

        if self.read_only or not is_primary() or not (
                self.p.tensorboard or getattr(self.p, "write_summary", False)):
            return None
        lines = [f"Model: {type(self).__name__}", "-" * 60]
        total = 0
        for name, w in param_paths(self.state.params):
            n = int(np.prod(w.shape))
            total += n
            lines.append(f"{name:<40} {str(tuple(w.shape)):<16} {n:>10,}")
        lines += ["-" * 60, f"Total params: {total:,}"]
        out = Path(self.p.main_path) / "complete_model_summary.txt"
        out.write_text("\n".join(lines) + "\n")
        return str(out)

    @property
    def encoder(self) -> _SubModel:
        """:meth:`encode` as a submodel with keras's ``predict`` (reference
        ``autoencoder.py:936``/``2161`` return the keras submodel)."""
        return _SubModel(self.encode)

    @property
    def decoder(self) -> _SubModel:
        """:meth:`decode` as a submodel with keras's ``predict`` (reference
        ``autoencoder.py:941``/``2166``)."""
        return _SubModel(self.decode)

    def set_train_data(self, data: np.ndarray) -> None:
        """Replace the training data by an array of the same width
        (reference ``autoencoder.py:788``). NaN-padded data needs a model
        built sparse (with its densifier)."""
        data = np.asarray(data, np.float32)
        if data.ndim != 2 or data.shape[1] != self.input_dim:
            raise ValueError(f"new data has shape {data.shape}, the model takes "
                             f"{self.input_dim} features")
        nan_mask = np.isnan(data)
        if nan_mask.any() and "densifier" not in self.state.params:
            raise ValueError("the new data holds NaNs (sparse mode) but this model "
                             "was built dense (no densifier layer); rebuild it on the "
                             "NaN-padded data or with sparse=True")
        self._nan_mask = nan_mask
        if nan_mask.any():
            self.sparse = True
        self.train_data = data

    # ------------------------------------------------------------ extensions
    def add_callback(self, callback: Callback) -> None:
        """Append a :class:`Callback` dispatched at chunk granularity."""
        self.callbacks.append(callback)

    def add_images_to_tensorboard(self, data: Optional[Any] = None,
                                  image_step: Optional[int] = None,
                                  max_size: int = 10000,
                                  additional_fns: Optional[list] = None) -> None:
        """Write latent scatter and density images every ``image_step``
        steps (default ``p.summary_step``; the reference's method of the
        same name, ``autoencoder.py:1031``). ``additional_fns`` are user
        callables ``fn(lowd) -> Figure | png bytes | array`` written beside
        them (its customization tutorial 03). Rendering needs matplotlib."""
        from .callbacks import ImageCallback

        step = image_step if image_step is not None else self.p.summary_step
        self.callbacks.append(ImageCallback(self, step, data=data, max_points=max_size,
                                            additional_fns=additional_fns))

    def plot_network(self) -> Optional[str]:
        """Draw the layer stack to ``main_path/network.png`` (the analog of
        the reference's keras ``plot_model`` call, ``autoencoder.py:1094``);
        needs matplotlib."""
        from ..misc.misc import draw_layer_stack

        out = Path(self.p.main_path) / "network.png"
        draw_layer_stack(self.p.n_neurons, getattr(self, "input_dim", None),
                         f"{type(self).__name__} layer stack", out)
        print(f"network diagram saved to {out}")
        return str(out)

    def add_loss(self, loss_fn, name: Optional[str] = None) -> None:
        """Add a custom loss ``fn(params, batch) -> 0-d tensor`` to the
        total (general route only)."""
        self.custom_losses.append(
            (name or getattr(loss_fn, "__name__", "custom_loss"), loss_fn))
        self._trainer = {}

    def add_metric(self, metric_fn, name: Optional[str] = None) -> None:
        """Log a metric every step, without a gradient (general route
        only): a plain ``fn(params, batch) -> 0-d tensor``, or a metric
        class or instance of :mod:`encodermap_tpu_torch.train.metrics`,
        whose ``update(y_true, y_pred)`` gets :meth:`_metric_io`'s pair
        (reference ``autoencoder.py:1045``)."""
        from .metrics import EncoderMapBaseMetric

        if isinstance(metric_fn, type) and issubclass(metric_fn,
                                                      EncoderMapBaseMetric):
            metric_fn = metric_fn(parameters=self.p)
        if isinstance(metric_fn, EncoderMapBaseMetric):
            metric = metric_fn
            name = name or metric.name

            def metric_fn(params, batch):
                return metric.update(*self._metric_io(params, batch))

        self.custom_metrics.append(
            (name or getattr(metric_fn, "__name__", "custom_metric"),
             metric_fn))
        self._trainer = {}

    def _validate_model_api(self, expected: str) -> None:
        api = getattr(self.p, "model_api", expected)
        if api == expected:
            return
        if api == "custom":
            raise NotImplementedError("No custom API currently supported")
        if api in ("sequential", "functional"):
            raise ValueError(f"{type(self).__name__} uses the {expected!r} "
                             f"model api; p.model_api={api!r} belongs to the "
                             f"{'ADC' if api == 'functional' else 'sequential'}"
                             f" family")
        raise ValueError(f"p.model_api must be 'sequential', 'functional' or "
                         f"'custom', got {api!r}")

    # ----------------------------------------------------------- persistence
    @classmethod
    def _parameters_class(cls):
        return Parameters

    def save(self, step: Optional[int] = None) -> Optional[str]:
        """Checkpoint parameters, Adam state, RNG and step
        (``autoencoder.py:1197``); nothing when read-only or off rank 0. A
        tp-sharded state is gathered over ``tp`` first, on every rank."""
        if self.read_only or not (is_primary() or has_tp_layers(self.state.params)):
            return None
        step = self.state.step if step is None else int(step)
        return save_checkpoint(self.p.main_path, self.state.params, step,
                               opt_state=self.state.opt_state,
                               parameters=self.p, rng=self.state.rng,
                               scheduled=self._lr_schedule is not None)

    @classmethod
    def _load_checkpoint_checked(cls, ckpt_path: Path,
                                 use_previous_model: bool):
        """``(p, model_params, opt_npz, step, directory)`` of a checkpoint,
        checking its step against parameters.json."""
        directory = ckpt_path if ckpt_path.is_dir() else ckpt_path.parent
        p = cls._parameters_class().from_file(directory / "parameters.json")
        model_params, opt_npz, step = load_checkpoint(
            ckpt_path, n_encoder=len(p.n_neurons))
        if step < 0:
            # a reference .keras file named by time carries no step;
            # parameters.json has it
            step = p.current_training_step
        if step != p.current_training_step and not use_previous_model:
            raise ValueError(
                f"Checkpoint step {step} disagrees with parameters.json "
                f"({p.current_training_step}). Pass use_previous_model=True "
                f"to load this intermediate checkpoint anyway.")
        return p, model_params, opt_npz, step, directory

    def _restore_checkpoint_state(self, step: int, opt_npz, ckpt_path
                                  ) -> None:
        """Adopt step, Adam state and RNG from a checkpoint."""
        self.state = self.state.replace(step=int(step))
        if opt_npz is not None:
            opt = load_opt_state(opt_npz)
            self.state = self.state.replace(opt_state={
                "count": opt["count"],
                "mu": _tree_to_device(opt["mu"], self.device),
                "nu": _tree_to_device(opt["nu"], self.device)})
        rng = load_checkpoint_rng(ckpt_path)
        if rng is not None:
            self.state = self.state.replace(rng=np.asarray(rng, np.uint32))

    @classmethod
    def from_checkpoint(cls, checkpoint_path: Union[str, Path],
                        train_data: Optional[np.ndarray] = None,
                        sparse: bool = False,
                        use_previous_model: bool = False,
                        **kwargs: Any) -> "Autoencoder":
        """Rebuild from a checkpoint directory or file, written by either
        package (``autoencoder.py:889-931``). ``kwargs`` go to the
        constructor (e.g. ``device``)."""
        ckpt_path = Path(checkpoint_path)
        p, model_params, opt_npz, step, directory = (
            cls._load_checkpoint_checked(ckpt_path, use_previous_model))
        if train_data is None and not p.using_hypercube:
            raise ValueError(
                f"The model in {directory} was trained on user data "
                f"(using_hypercube=False). Pass that data via "
                f"from_checkpoint(..., train_data=...) to reload it.")
        out = cls(parameters=p, train_data=train_data,
                  model_params=model_params, sparse=sparse, **kwargs)
        out._restore_checkpoint_state(step, opt_npz, ckpt_path)
        return out

    @property
    def model_params(self) -> dict:
        """The current parameter tree."""
        return self.state.params

    # ---------------------------------------------------------------- losses
    #: terms logged every step but not summed into the loss
    _metrics_only: tuple = ()

    def _loss_and_aux(self, params: dict, batch: Any, step: int
                      ) -> tuple[dict, tuple]:
        """``(terms, aux)`` for one batch at global ``step``; ``aux`` carries
        forward intermediates for :meth:`_aux_metric_terms` (none here)."""
        return self._loss_terms(params, batch), ()

    def _aux_metric_terms(self, aux: tuple, batch: Any) -> dict:
        """Metrics computed from the loss forward's ``aux``."""
        return {}

    def _metric_io(self, params: dict, batch: torch.Tensor) -> tuple:
        """``(y_true, y_pred)`` for metric objects: the densified batch and
        its reconstruction."""
        batch = seq.densify(params, batch)
        return batch, seq.decode(params, self.p, seq.encode(params, self.p, batch))

    def _forward_rows(self, params: dict, batch: torch.Tensor) -> tuple:
        """The per-row forward pass of this rank's rows, then the global
        batch's ``(densified inputs, latent, reconstruction)``."""
        batch = seq.densify(params, batch)
        latent = seq.encode(params, self.p, batch)
        return self._gather_rows(batch, latent, seq.decode(params, self.p, latent))

    def _row_terms(self, params: dict, batch: torch.Tensor, latent: torch.Tensor,
                   out: torch.Tensor) -> dict:
        """The auto, center and L2 losses of the global batch."""
        p = self.p
        return {
            "auto_loss": L.auto_loss(batch, out, p),
            "center_loss": L.center_loss(latent, p),
            "regularization_loss": L.regularization_loss(
                seq.regularization_sum(params), p),
        }

    def _loss_terms(self, params: dict, batch: torch.Tensor) -> dict:
        """All loss contributions for one batch; subclasses extend."""
        return self._row_terms(params, *self._forward_rows(params, batch))

    # -------------------------------------------------------- data parallel
    @property
    def mesh(self):
        """The ``("dp", "tp")`` mesh of ``p.mesh_shape``; None on one
        device."""
        return self._mesh

    def _gather_rows(self, *xs: torch.Tensor) -> tuple:
        """The global batch's rows of per-row tensors: every dp rank's, in
        rank order (differentiable); the tensors themselves on one device.
        The tensors that need a gradient travel as one (their rows side by
        side, one gather, one reduce-scatter back), the others as another
        with no backward. A tensor that needed no gradient comes back
        without one, so the sketch-map loss of plain inputs still takes the
        kernels."""
        if self._dp is None:
            return xs
        out: list = [None] * len(xs)
        for needs_grad in (True, False):
            sel = [i for i, x in enumerate(xs) if x.requires_grad == needs_grad]
            if not sel:
                continue
            rows = gather_rows(torch.cat([xs[i].reshape(len(xs[i]), -1) for i in sel], dim=1),
                               self._dp[2])
            parts = torch.split(rows, [int(np.prod(xs[i].shape[1:])) for i in sel], dim=1)
            for i, o in zip(sel, parts):
                out[i] = o.reshape((len(rows),) + xs[i].shape[1:])
        return tuple(out)

    def _reduce_grads(self, grads: list) -> list:
        """The global gradient on every rank: each rank's gradient of the
        global loss, summed over the dp group and divided by its size (the
        gathered rows' backward adds one copy per rank), as one
        all-reduce."""
        if self._dp is None:
            return grads
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self._dp[2])
        flat /= self._dp[1]
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return out

    def _global_batch(self, batch: Any) -> Any:
        """The global batch's inputs, for user losses and metrics, which
        see the whole batch as the JAX package's do."""
        if self._dp is None:
            return batch
        if isinstance(batch, tuple):
            return self._gather_rows(*batch)
        return self._gather_rows(batch)[0]

    def _make_train_step(self):
        """One optimizer step ``(state, batch) -> (state, metrics)`` by
        autograd: the general route."""

        def train_step(state: TrainState, batch: Any):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(state.params)]
            params = tree_unflatten(state.params, leaves)
            with span("step.forward"):
                terms, aux = self._loss_and_aux(params, batch, state.step)
                if self.custom_losses or self.custom_metrics:
                    batch = self._global_batch(batch)
                terms.update({name: fn(params, batch)
                              for name, fn in self.custom_losses})
                loss = torch.zeros((), dtype=torch.float32, device=self.device)
                for k, v in terms.items():
                    if k not in self._metrics_only:
                        loss = loss + v
            # a leaf outside the graph (a frozen densifier) gets a zero
            # gradient, as JAX gives it
            with span("step.backward"):
                grads = self._reduce_grads(
                    [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, torch.autograd.grad(
                         loss, leaves, allow_unused=True))])
            metrics = {k: v.detach() for k, v in terms.items()}
            metrics["loss"] = loss.detach()
            if self._lr_schedule is not None:
                metrics["learning_rate"] = torch.tensor(
                    self.optimizer.lr_at(state.opt_state["count"]),
                    dtype=torch.float32, device=self.device)
            with torch.no_grad():
                with span("step.optimizer"):
                    new_params, opt_state = self.optimizer.update(
                        tree_unflatten(state.params, grads),
                        state.opt_state, state.params)
                with span("step.metrics"):
                    metrics.update(self._aux_metric_terms(aux, batch))
                    metrics.update({name: fn(new_params, batch).detach()
                                    for name, fn in self.custom_metrics})
            return (state.replace(params=new_params, opt_state=opt_state,
                                  step=state.step + 1), metrics)

        return train_step

    def _maybe_fused_trainer(self, steps: int):
        """Subclasses may provide the fused kernel for their config."""
        return None

    def _get_trainer(self, steps: Optional[int] = None):
        """The chunk trainer for ``steps`` steps (cached)."""
        if steps is None:
            steps = max(1, min(self.p.steps_per_scan, self.p.n_steps))
        if steps not in self._trainer:
            trainer = self._maybe_fused_trainer(steps)
            if trainer is None:
                trainer = make_scan_trainer(
                    self._make_train_step(), self.p.batch_size, steps,
                    full_batch=not getattr(self.p, "batched", True),
                    shard=self._dp[:2] if self._dp is not None else None)
            self._trainer[steps] = trainer
        return self._trainer[steps]

    def _device_data(self) -> torch.Tensor:
        data = self.train_data
        if self._nan_mask.any():
            data = np.nan_to_num(data, nan=0.0)
        return torch.as_tensor(data, dtype=torch.float32, device=self.device)

    # -------------------------------------------------------------- training
    def _streaming_sharding(self) -> Optional[tuple[int, int]]:
        """``(rank, size)`` of the dp axis for the superbatches' batch axis;
        None without a mesh."""
        return self._dp[:2] if self._dp is not None else None

    def _streaming_budget(self, n_steps: Optional[int]) -> int:
        """Steps to run: an explicit ``n_steps`` counts from here; None
        means ``p.n_steps`` as a global budget, as ``train()`` has it."""
        if n_steps is not None:
            return int(n_steps)
        start = self.state.step
        remaining = self.p.n_steps - start
        if remaining <= 0:
            print(f"This model has already been trained for {start} steps. "
                  f"Increase p.n_steps to train further.")
        return remaining

    def _persist(self, nan_stop: bool) -> None:
        """After a run: parameters.json and a checkpoint at the current
        step, unless a NaN stopped the run (then the newest checkpoint on
        disk stays the last finite one)."""
        if nan_stop:
            print("Not persisting the diverged state; the newest on-disk "
                  "checkpoint remains the last finite one.")
            return
        self.p.current_training_step = self.state.step
        if not self.read_only and is_primary():
            self.p.save(Path(self.p.main_path) / "parameters.json")
        self.save()

    def _finish_streaming(self, history: dict) -> dict:
        """Persist after a streaming run (see :meth:`_persist`)."""
        self.history = history
        self._persist(getattr(self, "_streaming_nan_stop", False))
        return history

    def train_streaming(self, source: Any, n_steps: Optional[int] = None) -> dict:
        """Out-of-core training from a host superbatch source, e.g.
        ``train/core.py::HDF5BatchSource`` (``encodermap_tpu/train/
        autoencoder.py:694-708``): the million-frame path where the data
        never lives on the device whole. Each superbatch is a
        ``(steps, B, features)`` array (or a 1-tuple of one). With
        ``p.mesh_shape`` set, each rank uploads its share of the batch axis
        (BASELINE config 5: streaming with data parallelism)."""
        from .core import run_streaming

        if isinstance(source, (str, Path)):
            raise TypeError(
                f"{type(self).__name__}.train_streaming takes a batch source; "
                f"for an HDF5 file pass HDF5BatchSource(path, [name], "
                f"batch_size, steps_per_scan)")
        n = self._streaming_budget(n_steps)
        if n <= 0:
            return self.history
        history = run_streaming(self, source, n, sharding=self._streaming_sharding())
        return self._finish_streaming(history)

    def _setup_callbacks(self) -> list:
        cbs: list = [ProgressBar(self.p.n_steps), NaNInterrupt()]
        if not self.read_only:
            cbs.append(CheckpointSaver(self, self.p.checkpoint_step))
        return cbs + self.callbacks

    def close(self) -> None:
        """Close the metrics log."""
        if self._metrics_writer is not None:
            self._metrics_writer.close()

    def train(self, index_stream: Optional[Iterator] = None) -> dict:
        """Run ``n_steps - current_training_step`` optimizer steps.

        ``index_stream`` optionally supplies each chunk's ``(steps, B)``
        batch indices (arrays or tensors) instead of the trainer's own draw,
        e.g. the indices another implementation drew. Returns the metric
        history (dict of per-step arrays) and, as the reference does,
        persists parameters and a final checkpoint.
        """
        if self.p.training not in ("auto", "custom"):
            raise ValueError(
                f"Parameter `training` has to be one of 'custom', 'auto'. "
                f"You supplied {self.p.training!r}.")
        start = self.state.step
        remaining = self.p.n_steps - start
        if remaining <= 0:
            print(f"This model has already been trained for {start} steps. "
                  f"Increase p.n_steps to train further.")
            return self.history

        sps = max(1, min(self.p.steps_per_scan, self.p.n_steps))
        with span("train.upload"):
            data = self._device_data()
        n_rows = (data[0] if isinstance(data, tuple) else data).shape[0]
        cbs = self._setup_callbacks()
        # the callbacks' span names, made only where spans record
        cb_spans = ([f"train.callback.{type(cb).__name__}" for cb in cbs]
                    if spans_enabled() else [None] * len(cbs))
        if not self.read_only:
            self.close()
            self._metrics_writer = MetricsWriter(
                self.p.main_path, tensorboard=self.p.tensorboard)
        for cb in cbs:
            cb.on_train_begin(self)

        history: dict[str, list] = {}
        stop = nan_stop = False
        done = 0
        while done < remaining and not stop:
            first_step = self.state.step
            # the final chunk shrinks to the remainder: never past n_steps
            chunk = min(sps, remaining - done)
            idx = None
            if index_stream is not None:
                idx = np.asarray(next(index_stream), np.int64)
                if (idx.shape[0] != chunk or idx.min() < 0
                        or idx.max() >= n_rows):
                    raise ValueError(
                        f"index_stream gave {idx.shape} indices in "
                        f"[{idx.min()}, {idx.max()}]; this chunk needs "
                        f"{chunk} rows in [0, {n_rows})")
                idx = torch.from_numpy(idx).to(self.device)
            with span("train.chunk", first_step):
                self.state, metrics = self._get_trainer(chunk)(self.state, data,
                                                               idx)
            with span("train.fetch", first_step):
                metrics = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
            n = len(next(iter(metrics.values())))
            with span("train.log", first_step):
                for k, v in metrics.items():
                    history.setdefault(k, []).append(v)
                if self._metrics_writer is not None:
                    stride = max(1, self.p.summary_step)
                    for i in range(n):
                        step_i = first_step + i + 1
                        if step_i % stride == 0:
                            self._metrics_writer.write_scalars(
                                step_i, {k: v[i] for k, v in metrics.items()})
            for cb, name in zip(cbs, cb_spans):
                with span(name, first_step):
                    stopped = cb.on_chunk_end(first_step, metrics) is False
                if stopped:
                    stop = True
                    nan_stop = isinstance(cb, NaNInterrupt)
                    break
            done += n

        for cb in cbs:
            cb.on_train_end(self)
        self.history = {k: np.concatenate(v) for k, v in history.items()}
        with span("train.persist"):
            self._persist(nan_stop)
        self.close()
        self._metrics_writer = None
        return self.history

    # ------------------------------------------------------------- inference
    def _batched_apply(self, fn, data, max_batch: int = 8192) -> np.ndarray:
        data = np.asarray(data, np.float32)
        single = data.ndim == 1
        if single:
            data = data[None]
        outs = []
        with torch.no_grad():
            for i in range(0, len(data), max_batch):
                x = torch.as_tensor(data[i:i + max_batch], device=self.device)
                outs.append(fn(x).cpu().numpy())
        out = np.concatenate(outs, axis=0)
        return out[0] if single else out

    def encode(self, data: Optional[np.ndarray] = None) -> np.ndarray:
        """Project data to the latent space (``autoencoder.py:1110``)."""
        if data is None:
            data = self.train_data
        params = self.state.params
        return self._batched_apply(
            lambda x: seq.encode(params, self.p, seq.densify(params, x)), data)

    def decode(self, latent: np.ndarray) -> np.ndarray:
        """Decode latent points back to input space (``autoencoder.py:1147``)."""
        params = self.state.params
        return self._batched_apply(lambda z: seq.decode(params, self.p, z),
                                   latent)

    def generate(self, latent: np.ndarray) -> np.ndarray:
        """Alias of :meth:`decode` for the base class (``autoencoder.py:1177``)."""
        return self.decode(latent)


class EncoderMap(Autoencoder):
    """Adds the sketch-map sigmoid distance loss
    (reference: ``autoencoder.py:1232-1307``)."""

    def _loss_terms(self, params: dict, batch: torch.Tensor) -> dict:
        batch, latent, out = self._forward_rows(params, batch)
        terms = self._row_terms(params, batch, latent, out)
        terms["distance_loss"] = L.distance_loss(batch, latent, self.p)
        return terms

    def _maybe_fused_trainer(self, steps: int):
        """The fused train kernel for eligible configurations: the flag on,
        batched sampling, no densifier or user extensions, a constant lr,
        EncoderMap's own loss stack, and :func:`fused_trainer_available`
        (parameters on the card, input dim, activations, cost variant,
        dtype). A mesh takes the general route, with a warning once, as in
        the JAX package: the fused kernel is a single-device program."""
        if not getattr(self.p, "fused_trainer", True):
            return None
        if self.mesh is not None:
            if not getattr(self, "_warned_fused_mesh", False):
                self._warned_fused_mesh = True
                import warnings

                warnings.warn(
                    "mesh_shape is set: the fused train kernel is "
                    "single-device and this run takes the general route "
                    "(the sigmoid-loss kernels on the gathered global batch) "
                    "instead. Set fused_trainer=False to silence.",
                    stacklevel=3)
            return None
        if not getattr(self.p, "batched", True):
            return None
        if (self.sparse or "densifier" in self.state.params
                or self.custom_losses or self.custom_metrics
                or self._lr_schedule is not None):
            return None
        if type(self)._loss_terms is not EncoderMap._loss_terms:
            return None
        if not fused_trainer_available(self.p, self.state.params,
                                       self.input_dim):
            return None
        return make_fused_trainer(self.p, steps, self.p.batch_size)


class DihedralEncoderMap(EncoderMap):
    """EncoderMap over backbone dihedrals whose ``generate`` backmaps onto a
    real topology by rotating its phi/psi bonds (reference
    ``autoencoder.py:1310-1400``, which uses MDAnalysis; here the rotation
    sweep of ``misc/backmapping_offline.py`` on the model's device).

    Training data layout must be [all phi, all psi] in residue order, as the
    reference's ``dihedral_backmapping`` expects.
    """

    def generate(self, latent: np.ndarray, top: Any = None) -> Any:
        """Decode latent points to dihedrals and rotate a topology into them.

        Args:
            latent: ``(n, 2)`` latent points.
            top: a pdb path or :class:`SingleTraj` providing topology + seed
                coordinates. Without it, raw dihedrals are returned.

        Returns:
            A :class:`SingleTraj` of generated conformations (or the raw
            dihedral array when ``top`` is None).
        """
        dihedrals = self.decode(np.asarray(latent, np.float32))
        if top is None:
            return dihedrals
        from ..data.trajectory import SingleTraj
        from ..misc.backmapping_offline import backmap_topology

        if not isinstance(top, SingleTraj):
            top = SingleTraj(top)
        xyz = backmap_topology(top.top, top.xyz[0], dihedrals, device=self.device)
        out = top[np.zeros(len(xyz), dtype=int)]
        out.load()
        out._xyz = xyz
        out._materialized = True
        return out
