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
* :func:`enter_tp`, :func:`reduce_tp` and :func:`gather_tp` are Megatron's
  three collectives over the ``tp`` group, which ``nn.py`` runs around
  tensor-parallel layers: the input of a column-parallel layer (identity
  forward, all-reduce backward), a row-parallel layer's partial product
  (all-reduce forward, identity backward), and a column-parallel output
  that feeds a replicated layer (all-gather forward, this rank's slice
  backward).
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
    "enter_tp",
    "reduce_tp",
    "gather_tp",
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
    gloo for the CPU, and gloo for CUDA too where this node runs more
    ranks than it has visible cards (NCCL refuses two ranks on one card;
    gloo stages each collective through the host). On CUDA each process
    takes the card ``LOCAL_RANK`` (else its rank modulo the visible cards).
    Calling again is safe; an explicit ``init_method`` after a no-op still
    joins.
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
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError(f"init_method={init_method!r} needs world_size and rank")
    backend = backend_for(dev, int(world_size))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    _initialized = "joined"


def backend_for(device: torch.device, world_size: int) -> str:
    """The process group's backend for a run of ``world_size`` ranks on
    ``device``: NCCL on CUDA, gloo on the CPU, and gloo on CUDA where the
    ranks on this node outnumber its visible cards (NCCL refuses two ranks
    on one). The ranks on this node are the launcher's
    ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it); without it, every rank
    is taken to be on this node."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


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
    ``world_size // tp``, ``tp`` goes to ``make_mesh`` as it is."""
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


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order (not differentiable)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherRows(torch.autograd.Function):
    """All-gather along the leading axis; the backward pass is the
    all-gather's adjoint, a reduce-scatter: every rank's gradient of the
    gathered tensor summed, each rank receiving its own rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_cat(x, group, dim=0)

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


def _group_rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank()) if group is not None \
        else dist.get_rank()


class _EnterTP(torch.autograd.Function):
    """Identity forward; the backward pass sums the gradient over the tp
    group (each rank's column slice contributes its part of the input's
    gradient)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceTP(torch.autograd.Function):
    """All-reduce (sum) over the tp group forward; identity backward (the
    sum's gradient reaches every rank's partial unchanged)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _GatherTP(torch.autograd.Function):
    """All-gather along the last axis over the tp group, in rank order;
    the backward pass keeps this rank's slice of the gradient (what
    follows is replicated, so every rank holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.rank, ctx.width = _group_rank(group), x.shape[-1]
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(-1, ctx.rank * ctx.width, ctx.width).contiguous(), None


def enter_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over the tp group) as the input of a
    column-parallel layer: unchanged, its gradient summed over the group."""
    return _EnterTP.apply(x, group)


def reduce_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every tp rank's ``x`` (a row-parallel layer's partial
    product, or a sharded tensor's square sum), differentiable."""
    return _ReduceTP.apply(x, group)


def gather_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Every tp rank's slice of the last axis, concatenated in rank order:
    a column-parallel output made whole, differentiable."""
    return _GatherTP.apply(x, group)
