# encodermap_tpu_torch/train/callbacks.py
"""Host-side training callbacks, dispatched once per chunk.

Counterpart of ``encodermap_tpu/train/callbacks.py`` (after the reference's
Keras callbacks, ``callbacks/callbacks.py``): ProgressBar, CheckpointSaver,
EarlyStop, NaNInterrupt and ImageCallback. In a multi-process run the
progress output, the checkpoints and the images come from rank 0 only
(``callbacks.py:94-96`` there).
"""

from __future__ import annotations

import sys
import warnings
from typing import Any, Optional

import numpy as np

from ..parallel.distributed import is_primary
from .core import tree_map

__all__ = [
    "Callback",
    "ProgressBar",
    "CheckpointSaver",
    "EarlyStop",
    "NaNInterrupt",
    "ImageCallback",
]


class Callback:
    """Base callback; receives per-step metric rows after each chunk.

    ``on_chunk_end(first_step, metrics)`` gets ``metrics`` as a dict of 1-D
    numpy arrays of the chunk's length, where row i belongs to global step
    ``first_step + i + 1`` (the 1-based number of the completed step, the
    ``step`` of train_metrics.jsonl). Return ``False`` to stop training.
    """

    def on_train_begin(self, autoencoder: Any) -> None:
        """Called once before the first chunk."""

    def on_chunk_end(self, first_step: int, metrics: dict) -> Optional[bool]:
        """Called after every chunk."""

    def on_train_end(self, autoencoder: Any) -> None:
        """Called once after the last chunk."""


class ProgressBar(Callback):
    """tqdm progress bar (line prints without tqdm) showing the current
    loss, like the reference's ProgressBar (``callbacks.py:272-330``)."""

    def __init__(self, n_steps: int) -> None:
        self.n_steps = n_steps
        self._bar = None
        self._quiet = False

    def on_train_begin(self, autoencoder: Any) -> None:
        self._quiet = not is_primary()
        if self._quiet:
            return
        try:
            from tqdm import tqdm  # type: ignore

            self._bar = tqdm(total=self.n_steps, unit="step", file=sys.stdout)
        except ImportError:
            self._bar = None

    def on_chunk_end(self, first_step: int, metrics: dict) -> None:
        if self._quiet:
            return
        n = len(next(iter(metrics.values())))
        loss = float(np.asarray(metrics.get("loss", [np.nan])[-1]))
        if self._bar is not None:
            self._bar.update(n)
            self._bar.set_postfix(loss=f"{loss:.4f}")
        else:
            print(f"step {first_step + n}: loss={loss:.4f}", flush=True)

    def on_train_end(self, autoencoder: Any) -> None:
        if self._bar is not None:
            self._bar.close()


class CheckpointSaver(Callback):
    """Save a checkpoint every ``checkpoint_step`` steps
    (reference: ``callbacks.py:519-529``); ``<= 0`` disables it."""

    def __init__(self, autoencoder: Any, checkpoint_step: int) -> None:
        self.autoencoder = autoencoder
        self.checkpoint_step = checkpoint_step
        self._last_saved = -1

    def on_chunk_end(self, first_step: int, metrics: dict) -> None:
        if self.checkpoint_step <= 0:
            return
        last = first_step + len(next(iter(metrics.values())))
        due = (last // self.checkpoint_step) * self.checkpoint_step
        if due > self._last_saved and due > first_step:
            self.autoencoder.save(step=last)
            self._last_saved = due


class EarlyStop(Callback):
    """Stop when the monitored loss has not improved for ``patience`` steps
    (reference: ``callbacks.py:219-269``). ``restore_best_weights`` puts the
    parameters of the best chunk back on stop."""

    def __init__(self, monitor: str = "loss", patience: int = 1000,
                 min_delta: float = 0.0,
                 restore_best_weights: bool = False) -> None:
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.restore_best_weights = restore_best_weights
        self.best = np.inf
        self.best_step = 0
        self._autoencoder: Any = None
        self._best_params: Any = None
        self._warned_missing = False

    def on_train_begin(self, autoencoder: Any) -> None:
        self._autoencoder = autoencoder

    def on_chunk_end(self, first_step: int, metrics: dict) -> Optional[bool]:
        if self.monitor not in metrics:
            if not self._warned_missing:
                warnings.warn(f"EarlyStop: monitored metric {self.monitor!r} "
                              f"not in emitted metrics {sorted(metrics)}; "
                              f"skipping.")
                self._warned_missing = True
            return None
        vals = np.asarray(metrics[self.monitor])
        i = int(vals.argmin())
        if vals[i] < self.best - self.min_delta:
            self.best = float(vals[i])
            self.best_step = first_step + i + 1
            if self.restore_best_weights and self._autoencoder is not None:
                self._best_params = tree_map(
                    lambda x: x.detach().clone(), self._autoencoder.state.params)
        elif first_step + len(vals) - self.best_step > self.patience:
            print(f"EarlyStop: no {self.monitor} improvement for "
                  f"{self.patience} steps (best {self.best:.6f}).")
            if self._best_params is not None:
                print("Restoring model weights from the best chunk.")
                self._autoencoder.state = self._autoencoder.state.replace(
                    params=self._best_params)
            return False
        return None


class NaNInterrupt(Callback):
    """Abort when the loss goes NaN or Inf (the reference's
    NoneInterruptCallback, ``callbacks.py:87-109``)."""

    def on_chunk_end(self, first_step: int, metrics: dict) -> Optional[bool]:
        if metrics.get("loss") is None:
            return None
        loss = np.asarray(metrics["loss"])
        if not np.all(np.isfinite(loss)):
            bad = int(np.argmax(~np.isfinite(loss)))
            print(f"NaN/Inf loss at step {first_step + bad + 1}; "
                  f"stopping training.")
            return False
        return None


class ImageCallback(Callback):
    """Write latent scatter and density images every ``image_step`` steps
    (reference ``callbacks.py:333-516``; ``encodermap_tpu/train/
    callbacks.py:190-260``); ``<= 0`` disables it.

    ``additional_fns`` are user callables ``fn(lowd) -> image`` run at every
    image step with the latent projection (the reference's
    ``additional_fns``, its customization tutorial 03). Each may return a
    matplotlib Figure, raw PNG bytes or an ``(H, W[, C])`` array, written as
    ``<fn name>_{step}.png`` and to the metrics writer. A function that
    raises is reported and skipped; training goes on.
    """

    def __init__(self, autoencoder: Any, image_step: int,
                 data: Optional[np.ndarray] = None, max_points: int = 10000,
                 additional_fns: Optional[list] = None) -> None:
        self.autoencoder = autoencoder
        self.image_step = image_step
        self.data = data
        self.max_points = max_points
        self.additional_fns = list(additional_fns or [])
        self._last = -1

    def on_chunk_end(self, first_step: int, metrics: dict) -> None:
        if self.image_step <= 0 or not is_primary():
            return
        last = first_step + len(next(iter(metrics.values())))
        due = (last // self.image_step) * self.image_step
        if not (due > self._last and due > first_step):
            return
        from ..misc.summaries import image_summary, write_user_image

        data = self.data if self.data is not None else self.autoencoder.train_data
        if isinstance(data, (tuple, list)):
            # ADC data: a tuple of CV arrays of different widths, sliced by
            # frames member by member
            data = tuple(np.asarray(d)[:self.max_points] for d in data)
        else:
            data = np.asarray(data)[:self.max_points]
        latent = self.autoencoder.encode(data)
        writer = getattr(self.autoencoder, "_metrics_writer", None)
        main_path = self.autoencoder.p.main_path
        image_summary(latent, last, main_path, writer=writer,
                      max_points=self.max_points)
        for k, fn in enumerate(self.additional_fns):
            fn_name = getattr(fn, "__name__", "")
            if not fn_name.isidentifier():  # lambdas, partials, ...
                fn_name = f"custom_{k}"
            try:
                write_user_image(fn(np.asarray(latent)), last, main_path,
                                 name=fn_name, writer=writer)
            except Exception as e:  # a broken user function must not stop training
                print(f"ImageCallback: additional_fns[{k}] failed "
                      f"({type(e).__name__}: {e}); skipping.")
        self._last = due
