# encodermap_tpu_torch/misc/function_def.py
"""The ``em.function`` decorator: compiled, with a plain debug escape.

Counterpart of ``encodermap_tpu/misc/function_def.py`` (after the
reference's re-wrap of ``tf.function``,
``misc/function_def.py:38-61``). The JAX package compiles with XLA
(``jax.jit``); the port compiles with ``torch.compile``, whose default
backend, Inductor, generates Triton kernels on the card and C++ on the
CPU. ``debug=True`` returns the plain function, so breakpoints and prints
work. Other keyword arguments (``jit_kwargs``, named as in the JAX
package) go to ``torch.compile``: ``backend``, ``mode``, ``dynamic``,
``fullgraph``, ...
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["function"]


def function(fn: Callable = None, *, debug: bool = False, **jit_kwargs: Any):
    """Decorator: ``@function`` compiles; ``@function(debug=True)`` stays
    plain PyTorch."""

    def wrap(f: Callable) -> Callable:
        if debug:
            return f
        return torch.compile(f, **jit_kwargs)

    if fn is not None:
        return wrap(fn)
    return wrap
