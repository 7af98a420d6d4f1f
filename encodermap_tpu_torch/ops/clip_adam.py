# encodermap_tpu_torch/ops/clip_adam.py
"""One step of element-wise clipping and Adam over every leaf of a
parameter tree: the general route's optimizer (``train/core.py::ClipAdam``).

Counterpart of the JAX package's ``optax.chain(optax.clip(clip),
optax.adam(lr, eps=1e-7))`` (``encodermap_tpu/train/core.py:62-77``).
CUDA tensors go through one hand-written kernel over all leaves
(``csrc/clip_adam.cu``, launch counter ``clip_adam``), CPU tensors through
the plain version, :func:`_adam_update` once per leaf (which the fused
train kernels' plain version, ``ops/fused_train.py::fused_chunk_plain``,
takes too). On the card the kernel gives ``_adam_update``'s bits: the
source says how.

The step is out of place: the old parameters and moments are not written,
so callbacks and checkpoints that hold them keep them.

The leaves ride in tables of at most :data:`TABLE_LEAVES` leaves passed by
value as the kernel's argument; :func:`plan_launches` packs them, one
launch a table, each leaf taking ``ceil(n / CHUNK)`` blocks after the
blocks of the leaves before it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import _build

__all__ = ["clip_adam", "plan_launches"]

_LIB = "clip_adam"
_build.register(_LIB, [
    ("em_clip_adam", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p]),
])

#: leaves in one launch's table (``kMaxLeaves`` in ``csrc/clip_adam.cu``)
TABLE_LEAVES = 48
#: elements one block updates (a multiple of four: whole 16-byte vectors)
CHUNK = 1024


def _adam_update(p_, m, v, g, t, lr, b1=0.9, b2=0.999, eps=1e-7, clip=1.0):
    """``optax.chain(clip(1), adam(lr, eps=1e-7))`` on one tensor at step
    ``t`` (1-based); returns ``(p, m, v)``. The kernel's plain version."""
    g = torch.clamp(g, -clip, clip)
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    mhat = m / (1.0 - b1 ** t)
    vhat = v / (1.0 - b2 ** t)
    return p_ - lr * mhat / (torch.sqrt(vhat) + eps), m, v


def plan_launches(sizes: Sequence[int]) -> list[tuple[list[int], list[int], int]]:
    """The launches that update leaves of ``sizes`` elements: for each, the
    indices of its leaves (at most :data:`TABLE_LEAVES`, in order), the
    first block of each (its prefix offset) and its number of blocks.
    Empty leaves take no block and no place in a table."""
    leaves = [i for i, n in enumerate(sizes) if n > 0]
    out = []
    for k in range(0, len(leaves), TABLE_LEAVES):
        group = leaves[k:k + TABLE_LEAVES]
        firsts, blocks = [], 0
        for i in group:
            firsts.append(blocks)
            blocks += -(-sizes[i] // CHUNK)
        out.append((group, firsts, blocks))
    return out


def _table(leaves: Sequence[tuple], group: Sequence[int], firsts: Sequence[int]):
    """One launch's table, ten int64 a leaf of ``group``: the data pointers
    of its seven tensors ``(p, m, v, g, new p, new m, new v)``, its element
    count, its first block, and 1 where all seven pointers lie on 16-byte
    boundaries (the kernel then moves whole 16-byte vectors), else 0."""
    rows = []
    for i, first in zip(group, firsts):
        ptrs = [x.data_ptr() for x in leaves[i]]
        rows += [*ptrs, leaves[i][0].numel(), first, int(all(q % 16 == 0 for q in ptrs))]
    return (ctypes.c_longlong * len(rows))(*rows)


def _scalars(dtype: torch.dtype, t: float, lr: float, b1: float, b2: float, eps: float,
             clip: float) -> tuple:
    """The kernel's nine scalars as ``_adam_update``'s operations on the card
    take them: each Python number rounded to the tensors' type, and each
    bias correction's reciprocal taken in double and then rounded (PyTorch
    2.11's CUDA division by a host scalar multiplies by that reciprocal; one
    taken in float32 gives other bits in float32)."""
    f = np.float32 if dtype == torch.float32 else np.float64
    return tuple(float(x) for x in (f(lr), f(b1), f(1.0 - b1), f(b2), f(1.0 - b2),
                                    f(1.0 / (1.0 - b1 ** t)), f(1.0 / (1.0 - b2 ** t)),
                                    f(eps), f(clip)))


def clip_adam(params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
              nu: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], t: float,
              lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7,
              clip: float = 1.0) -> tuple[list, list, list]:
    """``_adam_update`` on every leaf at step ``t`` (1-based): the new
    parameters, first and second moments, each a list in the leaves' order.

    CUDA tensors (float32 or float64, one device, one type) go to the
    kernel: the parameters and moments must be contiguous (a gradient that
    is not is made so), and each leaf's four tensors of one shape."""
    if not len(params) == len(mu) == len(nu) == len(grads):
        raise ValueError(f"{len(params)} parameters, {len(mu)} first moments, {len(nu)} "
                         f"second moments and {len(grads)} gradients")
    if not _build.kernel_route([*params, *mu, *nu, *grads], "the clip + Adam kernel"):
        out = [_adam_update(p, m, v, g, t, lr, b1, b2, eps, clip)
               for p, m, v, g in zip(params, mu, nu, grads)]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]
    for i, (p, m, v, g) in enumerate(zip(params, mu, nu, grads)):
        if not p.shape == m.shape == v.shape == g.shape:
            raise ValueError(f"leaf {i}: shapes {[tuple(x.shape) for x in (p, m, v, g)]} "
                             "differ")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"leaf {i}: the clip + Adam kernel takes contiguous "
                             "parameters and moments")
    grads = [g.contiguous() for g in grads]
    new = [[torch.empty_like(p) for p in params] for _ in range(3)]
    scalars = (ctypes.c_double * 9)(*_scalars(params[0].dtype, t, lr, b1, b2, eps, clip))
    is_double = int(params[0].dtype == torch.float64)
    leaves = list(zip(params, mu, nu, grads, *new))
    for group, firsts, blocks in plan_launches([p.numel() for p in params]):
        _build.launch(_LIB, "em_clip_adam", is_double, len(group), _table(leaves, group, firsts),
                      blocks, CHUNK, scalars)
    return new[0], new[1], new[2]
