# encodermap_tpu_torch/parallel/distributed.py
"""Multi-process execution on ``torch.distributed``: one process per device.

Counterpart of ``encodermap_tpu/parallel/distributed.py``. JAX runs one
SPMD program over a mesh of devices; here every device has its own process
(``torchrun --nproc-per-node N``, or an explicit ``init_method``), and the
trainers stay process-count agnostic through these helpers:

* :func:`initialize` joins the process group: ``env://`` when the launcher
  set ``RANK``/``WORLD_SIZE``, or an explicit ``init_method``; NCCL for
  CUDA devices and gloo for the CPU. A single-process run is a no-op and a
  second call is safe.
* :func:`is_primary` / :func:`primary_only` gate checkpoints, metrics and
  progress output to rank 0, the way every trainer writes output.
* :func:`process_local_slice` and :func:`host_local_batch` give each rank
  its equal share of a global batch.
* :func:`global_mesh` is the ``("dp", "tp")`` mesh over every rank.
* :func:`gather_rows` is the data-parallel step's one collective in the
  forward pass: each rank's rows, concatenated in rank order on every
  rank, with the all-gather's adjoint (a reduce-scatter) in the backward
  pass.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = [
    "initialize",
    "is_primary",
    "primary_only",
    "global_mesh",
    "host_local_batch",
    "process_local_slice",
    "gather_rows",
    "world",
]

#: what :func:`initialize` did: None (not called), "no-op", "joined"
_initialized: Optional[str] = None


def world() -> tuple[int, int]:
    """``(rank, world_size)`` of this process; ``(0, 1)`` without a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device: Any = None) -> None:
    """Join the process group of a multi-process run.

    ``init_method`` is any ``torch.distributed`` rendezvous
    (``"tcp://host:port"``, ``"file:///shared/path"``) with ``world_size``
    and ``rank``; without it the launcher's environment is read
    (``env://``: ``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``). Neither given:
    a single-process run, and this is a no-op.

    The backend follows ``device`` (None means the card): NCCL for CUDA,
    gloo for the CPU. On CUDA each process takes the card ``LOCAL_RANK`` (else its rank
    modulo the visible cards). Calling again is safe; an explicit
    ``init_method`` after a no-op still joins.
    """
    global _initialized
    if dist.is_initialized():
        _initialized = "joined"
        return
    if _initialized == "no-op" and init_method is None:
        return
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and not env:
        _initialized = "no-op"
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError(f"init_method={init_method!r} needs world_size and rank")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    _initialized = "joined"


def is_primary() -> bool:
    """True on the process that writes checkpoints, summaries and logs:
    rank 0, or the only process."""
    return world()[0] == 0


def primary_only(fn: Callable) -> Callable:
    """Decorator: run ``fn`` only on rank 0 (None elsewhere)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None

    return wrapper


def global_mesh(dp: Optional[int] = None, tp: int = 1, device: Any = None):
    """The ``("dp", "tp")`` mesh over every rank; ``dp`` defaults to
    ``world_size // tp``."""
    from .mesh import make_mesh

    return make_mesh(dp=dp, tp=tp, device=device)


def process_local_slice(n_global: int) -> slice:
    """The half-open range of global rows this rank loads.

    Every rank gets exactly ``n_global // world_size`` rows and the
    remainder is dropped, so the shards stack into one global batch."""
    rank, size = world()
    k = n_global // size
    return slice(rank * k, (rank + 1) * k)


def host_local_batch(local: Any, mesh: Any = None, n_global: Optional[int] = None,
                     device: Any = None) -> Any:
    """This rank's rows (from :func:`process_local_slice`) as tensors on
    its device: the rank's share of the global batch, which the
    data-parallel step gathers where the loss needs it.

    Shards must be uniform over the ranks; ``n_global`` is only checked
    for that. ``local`` may be an array, a tuple/list or a dict of them."""
    _, size = world()
    if n_global is not None and n_global % size:
        raise ValueError(
            f"n_global={n_global} does not divide evenly over {size} processes; "
            f"slice your rows with process_local_slice (which drops the "
            f"remainder) and pass n_global={n_global - n_global % size} or None.")
    dev = resolve_device(device if device is not None else
                         getattr(mesh, "device_type", None))

    def put(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    if isinstance(local, (tuple, list)):
        return tuple(put(x) for x in local)
    if isinstance(local, dict):
        return {k: put(v) for k, v in local.items()}
    return put(local)


class _GatherRows(torch.autograd.Function):
    """All-gather along the leading axis; the backward pass is the
    all-gather's adjoint, a reduce-scatter: every rank's gradient of the
    gathered tensor summed, each rank receiving its own rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        size = dist.get_world_size(group)
        ctx.group, ctx.rows = group, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.new_empty((ctx.rows,) + grad.shape[1:])
        dist.reduce_scatter(out, list(grad.contiguous().split(ctx.rows)), group=ctx.group)
        return out, None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The rows of ``x`` from every rank of ``group``, in rank order.

    Differentiable. Every rank then computes the same global loss from the
    gathered rows, so the backward pass adds each rank's identical gradient
    once per rank: the parameter gradients come out ``world_size`` times
    the global one, and the caller divides the all-reduced sum by the
    world size (``train/autoencoder.py::Autoencoder._reduce_grads``)."""
    return _GatherRows.apply(x, group)
