# encodermap_tpu_torch/parallel/mesh.py
"""The ``("dp", "tp")`` device mesh over the processes of a run.

Counterpart of ``encodermap_tpu/parallel/mesh.py``. There a mesh arranges
the devices of one SPMD program and GSPMD places every array; here it is a
``torch.distributed.device_mesh.DeviceMesh`` over one process per device,
and the trainers move data themselves:

* ``dp``: batch data parallelism. Every rank holds the parameters and
  takes its equal share of each global batch (:func:`shard_batch`); the
  rows the losses need are gathered across the ``dp`` group
  (``distributed.gather_rows``), so each step computes the global batch's
  loss and gradient, as GSPMD's layout change does in the JAX package.
* ``tp``: tensor parallelism over the MLP's hidden width
  (``shard_params_tp`` in the JAX package, used by no JAX trainer) is not
  ported yet: ``tp > 1`` raises ``NotImplementedError`` naming its
  ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_mesh", "shard_batch", "replicate", "dp_info", "TP_LATER"]

#: what a tensor-parallel mesh says
TP_LATER = ("tp > 1 (tensor parallelism over the hidden width, the JAX "
            "package's shard_params_tp) is not ported to encodermap_tpu_torch "
            "yet; it is ROADMAP.md Queue 1 item 15. Use a mesh with tp=1")


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1, device: Any = None):
    """A ``("dp", "tp")`` ``DeviceMesh`` over the run's processes.

    Joins the process group first (``distributed.initialize``, from the
    launcher's environment). The mesh needs ``dp * tp`` processes, one per
    device: a run of another size raises a ``ValueError`` that says how to
    launch one. ``device`` (None means the card) must match the group's
    backend: NCCL for CUDA, gloo for the CPU."""
    from .distributed import initialize

    if tp != 1:
        raise NotImplementedError(TP_LATER)
    dev = resolve_device(device)
    initialize(device=dev)
    size = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = dp * tp if dp is not None else size
    if dp is None:
        dp = n_devices // tp
    if dp * tp != n_devices or n_devices != size or not dist.is_initialized():
        raise ValueError(
            f"a mesh of dp={dp} x tp={tp} needs {dp * tp} processes, one per "
            f"device, but this run has "
            + (f"{size}" if dist.is_initialized() else "no process group")
            + f". Launch it with `torchrun --nproc-per-node {dp * tp} ...` (or call "
            f"encodermap_tpu_torch.parallel.initialize(init_method=..., "
            f"world_size={dp * tp}, rank=...) in each process), or leave "
            f"mesh_shape None for one device.")
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(
            f"a mesh on {dev.type} needs a {want} process group; this run's "
            f"is {backend}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (dp, tp), mesh_dim_names=("dp", "tp"))


def dp_info(mesh) -> tuple[int, int, Any]:
    """``(rank, size, group)`` of this process on the mesh's ``dp`` axis."""
    return (mesh.get_local_rank("dp"), mesh["dp"].size(), mesh.get_group("dp"))


def shard_batch(data: Any, mesh) -> Any:
    """This rank's equal share of the leading axis of (a tuple of) arrays or
    tensors: rows ``[r k, (r + 1) k)`` for dp rank r, ``k = n / dp``."""
    rank, size, _ = dp_info(mesh)

    def take(x):
        n = x.shape[0]
        if n % size:
            raise ValueError(f"{n} rows do not divide over the dp axis of {size}")
        k = n // size
        return x[rank * k:(rank + 1) * k]

    if isinstance(data, (tuple, list)):
        return tuple(take(x) for x in data)
    return take(data)


def replicate(tree: Any, mesh) -> Any:
    """Every tensor of ``tree`` set to dp rank 0's values (a broadcast over
    the ``dp`` group, in place); returns ``tree``."""
    from ..train.core import tree_leaves

    _, _, group = dp_info(mesh)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                dist.broadcast(t, src=src, group=group)
    return tree

