# encodermap_tpu_torch/misc/profiling.py
"""Profiling: the program's spans and counters, a ``torch.profiler`` trace,
a synchronising block timer, and a trace of a few training chunks.

Counterpart of ``encodermap_tpu/misc/profiling.py`` (``trace`` :23,
``block_timer`` :37, ``profile_steps`` :58), which records
``jax.profiler`` traces. Here :func:`trace` records the host's operators
and, for a CUDA device, the card's kernels and copies (CUPTI), and writes a
gzipped Chrome trace ``<host>.<pid>.<ms>.pt.trace.json.gz`` into
``logdir``, which ui.perfetto.dev and TensorBoard's profile plugin open.

**Spans.** The training path marks its layers with :func:`span`: inside
``train()`` ``train.upload``, ``train.chunk``, ``train.fetch``,
``train.log``, ``train.callback.<ClassName>`` and ``train.persist``; in the
chunk trainer ``trainer.draw`` and ``trainer.launch`` (fused kernel) or
``trainer.step`` (the general route, one a step); in a general-route step
``step.forward``, ``step.backward``, ``step.optimizer`` and
``step.metrics``; in the ADC's forward and losses ``adc.encode``,
``adc.decode``, ``adc.backmap`` and ``adc.losses``, and in the sidechain
backmap's backward (``reconstruct_sidechains=True``, under
``step.backward``) ``adc.backmap_backward``. Spans are **off by default**,
and then cost one flag check. Two ways to see them:

- :func:`trace` and :func:`profile_steps` switch them on for their block:
  each span is then a ``record_function`` range in the Chrome trace, on the
  profiler's clock with the card's kernels, nested under its parent
  (``trainer.step`` under ``train.chunk``; the chunk spans carry the
  chunk's first step as their argument). Open the file in ui.perfetto.dev.
- Without the profiler, :func:`record_spans` switches them on and
  :func:`span_totals` reads, by span name, the count, the total seconds
  and the self seconds (the total less the time of the spans nested in
  it). Totals only grow; subtract two snapshots for a window::

      from encodermap_tpu_torch.misc import profiling
      with profiling.record_spans():
          before = profiling.span_totals()
          emap.train()
          after = profiling.span_totals()
      steps = after["trainer.step"].count - before["trainer.step"].count

**Counters.** :func:`counter` returns a named ``collections.Counter`` of
the process; :data:`launches` counts the port's kernel launches by kernel
name (``ops/_build.py::launch_counts`` is the same object), and, while the
spans are on, ``sidechain_backmap`` the sidechain backmap's calls and rows
forward and backward (``ops/backmap_sidechains.py::backmap_sidechains_train``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import threading
import time
from pathlib import Path
from typing import Any, Iterator, NamedTuple, Optional, Union

import torch

__all__ = ["trace", "block_timer", "profile_steps", "span", "record_spans",
           "spans_enabled", "span_totals", "SpanTotal", "counter", "launches"]

# ----------------------------------------------------------------- counters
_counters: dict[str, collections.Counter] = {}


def counter(name: str) -> collections.Counter:
    """The process's counter ``name`` (created empty on first use)."""
    return _counters.setdefault(name, collections.Counter())


#: kernel launches by kernel name: each kernel wrapper adds one where it
#: launches its kernel, so a run shows which kernels its path went through
launches = counter("launches")

# -------------------------------------------------------------------- spans
_on = False
_NULL = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()
#: span name -> [count, total ns, self ns]
_totals: dict[str, list] = {}


class SpanTotal(NamedTuple):
    """What the spans of one name took so far."""

    count: int
    total_s: float
    self_s: float


class _Span:
    """One open span: its time goes to the running totals, its children's
    time out of its self time, and while a profiler records it is also a
    ``record_function`` range."""

    __slots__ = ("name", "args", "t0", "child", "rf")

    def __init__(self, name: str, args: Any) -> None:
        self.name, self.args = name, args

    def __enter__(self) -> "_Span":
        self.child, self.rf = 0, None
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(
                self.name, None if self.args is None else str(self.args))
            self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        with _lock:
            tot = _totals.setdefault(self.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += dt
            tot[2] += dt - self.child
        if self.rf is not None:
            self.rf.__exit__(*exc)


def span(name: Optional[str], args: Any = None):
    """Context manager marking a layer of the training path as ``name``
    (see the module docstring). Off, it returns a shared null context and
    records nothing; ``name=None`` also records nothing. ``args`` (e.g. the
    chunk's first step) becomes the profiler range's argument, as a string
    made only while a profiler records."""
    if not _on or name is None:
        return _NULL
    return _Span(name, args)


def spans_enabled() -> bool:
    """Whether :func:`span` records."""
    return _on


@contextlib.contextmanager
def record_spans() -> Iterator[None]:
    """Context manager: spans record inside the block (nested blocks keep
    them on until the outermost ends)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def span_totals() -> dict[str, SpanTotal]:
    """A snapshot of every span name's :class:`SpanTotal` so far."""
    with _lock:
        return {k: SpanTotal(c, t * 1e-9, s * 1e-9) for k, (c, t, s) in _totals.items()}


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
