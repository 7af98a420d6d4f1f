# encodermap_tpu_torch/_tracing.py
"""The program's spans and counters: a leaf module that imports nothing of
the package, so that every layer, the kernel binder ``ops/_build.py``
included, can mark spans and count without an import cycle.
``misc/profiling.py`` re-exports every name here as the same object and
adds the ``torch.profiler`` trace.

**Spans.** The training path marks its layers with :func:`span`: inside
``train()`` ``train.upload``, ``train.chunk``, ``train.fetch``,
``train.log``, ``train.callback.<ClassName>`` and ``train.persist``; in the
chunk trainer ``trainer.draw`` and ``trainer.launch`` (fused kernel) or
``trainer.step`` (the general route, one a step); in a general-route step
``step.forward``, ``step.backward``, ``step.optimizer`` and
``step.metrics``; in the ADC's forward and losses ``adc.encode``,
``adc.decode``, ``adc.backmap`` and ``adc.losses``, and in the sidechain
backmap's backward (``reconstruct_sidechains=True``, under
``step.backward``) and in the multimer backmap's backward
(``multimer_training``, under ``step.backward``) ``adc.backmap_backward``,
both opened by :func:`backward_in_span`. Spans are **off by default**,
and then cost one flag check. Two ways to see them:

- ``misc/profiling.py``'s ``trace`` and ``profile_steps`` switch them on
  for their block: each span is then a ``record_function`` range in the
  Chrome trace, on the profiler's clock with the card's kernels, nested
  under its parent (``trainer.step`` under ``train.chunk``; the chunk spans
  carry the chunk's first step as their argument). Open the file in
  ui.perfetto.dev.
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
name (``ops/_build.py::launch_counts`` is the same object, and
``ops/_build.py::launch`` alone adds to it), and, while the spans are on
(:func:`count_rows`), ``sidechain_backmap`` the sidechain backmap's calls
and rows forward and backward (``ops/backmap_sidechains.py``) and
``multimer_backmap`` the multimer backmap's, with the proteins it placed
(``ops/backmap.py::backmap_multimer``).

**A backward's span.** :func:`backward_in_span` runs a differentiable
function so that its whole backward, whatever operations and autograd
functions it holds, runs inside one span; ``misc/profiling.py`` re-exports
the spans and counters above, not this helper of the ops.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Iterator, NamedTuple, Optional

import torch

__all__ = ["span", "record_spans", "spans_enabled", "span_totals", "SpanTotal", "counter",
           "launches", "count_rows", "backward_in_span"]

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


# ------------------------------------------------------- a backward's span
def count_rows(name: str, way: str, rows: int, **more: int) -> None:
    """While the spans are on, one call and its ``rows`` in the counter
    ``name``, under ``way`` and ``rows_<way>`` (``way`` is ``"fwd"`` or
    ``"bwd"``), and each of ``more`` beside them; off, a flag check."""
    if not _on:
        return
    count = counter(name)
    count[way] += 1
    count["rows_" + way] += rows
    for key, n in more.items():
        count[key] += n


class _InSpan(torch.autograd.Function):
    """``fn(*inputs)`` built as a graph of its own on detached inputs; the
    backward runs autograd over that saved graph inside the span. The
    operations and their order are those of autograd through ``fn``:
    nothing is recomputed, and each input reaches the output through the
    same uses, so its gradient is the same sum; an input the graph does not
    use gets none."""

    @staticmethod
    def forward(ctx, fn, name, count, more, *inputs):
        count_rows(count, "fwd", inputs[0].shape[0], **more)
        needs = ctx.needs_input_grad[4:]
        leaves = [x.detach().requires_grad_(need) for x, need in zip(inputs, needs)]
        with torch.enable_grad():
            ctx.out = fn(*leaves)
        ctx.leaves = [x for x, need in zip(leaves, needs) if need]
        ctx.name, ctx.count = name, count
        return ctx.out.detach()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[4:]
        with span(ctx.name):
            # the graph is kept for a second backward through the caller's
            # graph, as autograd through ``fn`` would allow
            taken = iter(torch.autograd.grad(ctx.out, ctx.leaves, grad,
                                             retain_graph=True, allow_unused=True))
            grads = [next(taken) if need else None for need in needs]
        count_rows(ctx.count, "bwd", grad.shape[0])
        return (None,) * 4 + tuple(grads)


def backward_in_span(name: str, count: str, fn, *inputs: torch.Tensor,
                     **more: int) -> torch.Tensor:
    """``fn(*inputs)``, one tensor of rows, whose backward runs inside the
    span ``name``, spans on or off alike: one route whatever the spans. While
    the spans are on, the counter ``count`` counts each call and its rows
    forward and backward (:func:`count_rows`; ``more`` forward). Take it
    where a gradient is taken; without one, call ``fn`` itself."""
    return _InSpan.apply(fn, name, count, more, *inputs)
