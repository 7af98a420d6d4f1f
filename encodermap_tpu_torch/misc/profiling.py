# encodermap_tpu_torch/misc/profiling.py
"""Profiling: the program's spans and counters, a ``torch.profiler`` trace,
a synchronising block timer, and a trace of a few training chunks.

Counterpart of ``encodermap_tpu/misc/profiling.py`` (``trace`` :23,
``block_timer`` :37, ``profile_steps`` :58), which records
``jax.profiler`` traces. Here :func:`trace` records the host's operators
and, for a CUDA device, the card's kernels and copies (CUPTI), and writes a
gzipped Chrome trace ``<host>.<pid>.<ms>.pt.trace.json.gz`` into
``logdir``, which ui.perfetto.dev and TensorBoard's profile plugin open.

The spans and counters (:func:`span`, :func:`record_spans`,
:func:`spans_enabled`, :func:`span_totals`, :class:`SpanTotal`,
:func:`counter`, :data:`launches` and the registry ``_counters``) live in
``encodermap_tpu_torch/_tracing.py``, which documents them, and are
re-exported here as the same objects.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Any, Iterator, Optional, Union

import torch

from .._tracing import (  # noqa: F401  (re-exported; _counters for the benchmark)
    SpanTotal,
    _counters,
    counter,
    launches,
    record_spans,
    span,
    span_totals,
    spans_enabled,
)

__all__ = ["trace", "block_timer", "profile_steps", "span", "record_spans",
           "spans_enabled", "span_totals", "SpanTotal", "counter", "launches"]


# ---------------------------------------------------------------- profiler
def _on_cuda(device: Any) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(logdir: Union[str, Path], device: Any = None) -> Iterator[Any]:
    """Context manager: record a ``torch.profiler`` trace of the block into
    ``logdir``, with the program's spans on. ``device`` decides whether the
    card's activity is recorded too (None: whenever there is a card).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    cuda = _on_cuda(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with record_spans(), profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:  # the block's kernels finish inside the trace
                torch.cuda.synchronize()
    name = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1e3)}"
    prof.export_chrome_trace(str(logdir / f"{name}.pt.trace.json.gz"))


def _sync(x: Any) -> None:
    """Wait for every CUDA tensor among ``x``'s leaves."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _sync(v)


@contextlib.contextmanager
def block_timer(name: str = "block", sync: Optional[object] = None
                ) -> Iterator[dict]:
    """Wall-clock a block; ``out["seconds"]`` afterwards. ``sync``: tensors
    (or a tree of them) whose device is synchronised before the clock
    stops, so the time includes the kernels the block queued."""
    out: dict = {"name": name}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if sync is not None:
            _sync(sync)
        out["seconds"] = time.perf_counter() - t0
        print(f"{name}: {out['seconds'] * 1000:.2f} ms")


def profile_steps(autoencoder, n_steps: int = 5,
                  logdir: Union[str, Path] = "profile") -> str:
    """Run one warm-up chunk outside the trace, then ``n_steps`` training
    chunks inside it, through the trainer's own chunk function (the analog
    of the TF1 engine's ``Autoencoder.profile()``), with the spans on. The
    newest state is always handed back to the model, also when a chunk
    raises."""
    trainer = autoencoder._get_trainer()
    data = autoencoder._device_data()
    state = autoencoder.state
    try:
        state, metrics = trainer(state, data)
        float(metrics["loss"][-1])
        with trace(logdir, device=autoencoder.device):
            for _ in range(n_steps):
                state, metrics = trainer(state, data)
            float(metrics["loss"][-1])
    finally:
        autoencoder.state = state
    return str(logdir)
