# encodermap_tpu_torch/misc/summaries.py
"""Training observability: scalar metrics, TensorBoard events and
latent-space images.

Counterpart of ``encodermap_tpu/misc/summaries.py`` (after the reference's
``misc/summaries.py:73-696``):

* :class:`MetricsWriter` appends one ``{"step": ..., "<metric>": ...}`` row
  per written step to ``main_path/train_metrics.jsonl`` and, with
  ``tensorboard=True``, the same row as float32 scalars to a TensorBoard
  event file in ``main_path/train/``. The JAX package writes its events
  through ``tf.summary``; the port writes them itself
  (:mod:`.event_file`), so TensorBoard output needs no optional package.
  In a multi-process run only rank 0 writes (every rank computes the same
  global metrics).
* :func:`image_summary` and :func:`write_user_image` render PNGs with
  matplotlib (imported inside them, as in the JAX package, so rendering
  raises ``ImportError`` where matplotlib is missing) and hand them to the
  writer.
* :func:`histogram_summary` and :func:`add_layer_summaries` log per-layer
  weight statistics under the JAX package's parameter path names
  (``encoder/0/kernel``: dict keys sorted, list indices), so both packages
  write the same tags.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator, Optional, Union

import numpy as np

from .event_file import EventFileWriter

__all__ = ["MetricsWriter", "image_summary", "histogram_summary",
           "add_layer_summaries"]


def _host(x: Any) -> np.ndarray:
    """A numpy copy of an array or tensor (on any device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MetricsWriter:
    """Append-only scalar metrics log with an optional TensorBoard mirror."""

    def __init__(self, main_path: Union[str, Path], tensorboard: bool = False,
                 filename: str = "train_metrics.jsonl") -> None:
        from ..parallel.distributed import is_primary

        self.main_path = Path(main_path)
        self.path = self.main_path / filename
        self._fh = None
        self._tb_writer: Optional[EventFileWriter] = None
        if is_primary():
            self.main_path.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
            if tensorboard:
                self._tb_writer = EventFileWriter(self.main_path / "train")

    def write_scalars(self, step: int, scalars: dict[str, Any]) -> None:
        """Append one row for ``step`` (and one event with TensorBoard)."""
        if self._fh is None:
            return
        row = {"step": int(step)}
        for k, v in scalars.items():
            row[k] = float(_host(v))
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        if self._tb_writer is not None:
            self._tb_writer.add_scalars(row.pop("step"), row)

    def write_image(self, step: int, name: str, png_bytes: bytes) -> None:
        """An image event for ``step`` (TensorBoard only)."""
        if self._tb_writer is not None:
            self._tb_writer.add_image(step, name, png_bytes)

    def close(self) -> None:
        """Close the log and the event file."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None


def param_paths(params: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """``(path_name, leaf)`` for every leaf of a dict/list parameter tree in
    JAX's leaf order, named as ``jax.tree_util.tree_flatten_with_path``'s
    keys joined by ``"/"`` (``encodermap_tpu/misc/summaries.py:90-100``)."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from param_paths(params[k], prefix + (str(k),))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from param_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), params


def _param_leaf_stats(params: Any):
    """``(path_name, numpy leaf)`` for every parameter leaf: the one tree
    walk and naming :func:`histogram_summary` and
    :func:`add_layer_summaries` share."""
    for name, leaf in param_paths(params):
        yield name, _host(leaf)


def histogram_summary(writer: MetricsWriter, step: int, params: Any) -> None:
    """Log weight and bias statistics per layer (the stand-in for the
    reference's per-layer histograms, ``summaries.py:73-98``)."""
    stats = {}
    for name, arr in _param_leaf_stats(params):
        stats[f"weights/{name}/mean"] = float(arr.mean())
        stats[f"weights/{name}/std"] = float(arr.std())
    writer.write_scalars(step, stats)


def image_summary(latent: Any, step: int, main_path: Union[str, Path],
                  writer: Optional[MetricsWriter] = None,
                  max_points: int = 10000, name: str = "latent") -> Optional[str]:
    """Latent scatter and 2D histogram density image, saved as PNG
    (``misc/summaries.py:424-497`` of the reference), with its placeholder
    text where the latent holds NaN or inf."""
    import io

    # offscreen, without touching the process-global backend
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    latent = _host(latent)
    if latent.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(latent.shape[0], max_points, False)
        latent = latent[idx]

    fig = Figure(figsize=(8, 4))
    FigureCanvasAgg(fig)
    axes = fig.subplots(1, 2)
    if not np.all(np.isfinite(latent)):
        # hist2d fails on NaN and inf alike; a diverged latent gets the
        # placeholder, not an exception inside the image callback
        bad = "NaN" if np.any(np.isnan(latent)) else "inf"
        for ax in axes:
            ax.text(0.5, 0.5, f"{bad} in latent", ha="center", va="center")
            ax.set_axis_off()
    elif latent.ndim < 2 or latent.shape[1] < 2:
        # a 1-D bottleneck: the single coordinate and its histogram
        flat = latent.reshape(len(latent), -1)
        col = flat[:, 0] if flat.shape[1] else np.zeros(len(flat))
        axes[0].plot(col, ".", ms=2)
        axes[0].set_title("latent (1-D) per point")
        axes[1].hist(col, bins=50)
        axes[1].set_title("latent density")
    else:
        axes[0].scatter(latent[:, 0], latent[:, 1], s=2)
        axes[0].set_title("latent scatter")
        axes[1].hist2d(latent[:, 0], latent[:, 1], bins=50)
        axes[1].set_title("latent density")
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100)
    png = buf.getvalue()

    out = Path(main_path) / f"{name}_{step}.png"
    out.write_bytes(png)
    if writer is not None:
        writer.write_image(step, name, png)
    return str(out)


def write_user_image(img: object, step: int, main_path: Union[str, Path],
                     name: str = "custom",
                     writer: Optional[MetricsWriter] = None) -> str:
    """Save an image an ``ImageCallback`` hook returned (reference
    ``callbacks.py:346-496``): a matplotlib Figure, raw PNG bytes, or an
    ``(H, W[, C])`` array. Bytes pass through untouched; the other two are
    rendered with matplotlib."""
    import io

    if hasattr(img, "savefig"):  # a matplotlib Figure
        buf = io.BytesIO()
        img.savefig(buf, format="png", dpi=100)
        png = buf.getvalue()
    elif isinstance(img, (bytes, bytearray)):
        png = bytes(img)
    else:
        arr = _host(img)
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        fig = Figure(figsize=(5, 5))
        FigureCanvasAgg(fig)
        ax = fig.subplots()
        ax.imshow(arr, origin="lower")
        ax.set_axis_off()
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100)
        png = buf.getvalue()
    out = Path(main_path) / f"{name}_{step}.png"
    out.write_bytes(png)
    if writer is not None:
        writer.write_image(step, name, png)
    return str(out)


def add_layer_summaries(writer: MetricsWriter, step: int, params: Any,
                        namescope: str = "") -> None:
    """Per-layer weight and bias statistics under the reference's
    Encoder/Decoder/Latent namescopes (``summaries.py:73-98``), derived from
    the parameter path names."""
    stats = {}
    for name, arr in _param_leaf_stats(params):
        low = name.lower()
        if "encoder" in low:
            scope = "Encoder"
        elif "decoder" in low:
            scope = "Decoder"
        elif "latent" in low:
            scope = "Latent"
        else:
            scope = "InputOutputLayers"
        if namescope:
            scope = f"{namescope}/{scope}"
        kind = "biases" if arr.ndim == 1 else "weights"
        stats[f"{scope}/{name}/{kind}/mean"] = float(arr.mean())
        stats[f"{scope}/{name}/{kind}/std"] = float(arr.std())
    writer.write_scalars(step, stats)
