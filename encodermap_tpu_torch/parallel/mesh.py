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
  The ranks of one ``dp`` index across ``tp`` take the same rows.
* ``tp``: Megatron-style tensor parallelism over the MLP's hidden width
  (:func:`shard_params_tp`): even layers split the kernel's output width
  (column-parallel), odd layers its input width (row-parallel), so the
  activations alternate between sliced and partial with one all-reduce a
  pair (``nn.py`` runs them). Each stack's last layer and every entry
  other than ``encoder``/``decoder`` stay replicated. As in the JAX
  package no trainer shards by itself: with ``mesh_shape={"dp": d, "tp":
  t}`` the trainers keep the parameters replicated over ``tp``, and a
  step on a state passed through :func:`shard_params_tp` equals the
  unsharded step. Checkpoints of a sharded state hold the whole tensors
  (``misc/saving.py``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_mesh", "shard_batch", "shard_params_tp", "unshard_params_tp",
           "replicate", "dp_info", "tp_info"]


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1, device: Any = None):
    """A ``("dp", "tp")`` ``DeviceMesh`` over the run's processes.

    Joins the process group first (``distributed.initialize``, from the
    launcher's environment). The mesh needs ``dp * tp`` processes, one per
    device: a run of another size raises a ``ValueError`` that says how to
    launch one. ``device`` (None means the card) must match the group's
    backend: NCCL for CUDA, gloo for the CPU. A CUDA mesh takes gloo only
    where this node runs more ranks than it has visible cards
    (``distributed.backend_for``; NCCL refuses two ranks on one card):
    then several ranks share a card and every collective is staged
    through the host."""
    from .distributed import backend_for, initialize

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
    backend, want = dist.get_backend(), backend_for(dev, size)
    if backend != want and not (dev.type == "cuda" and backend == "nccl"):
        raise ValueError(
            f"a mesh on {dev.type} needs a {want} process group; this run's "
            f"is {backend}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (dp, tp), mesh_dim_names=("dp", "tp"))


def dp_info(mesh) -> tuple[int, int, Any]:
    """``(rank, size, group)`` of this process on the mesh's ``dp`` axis."""
    return (mesh.get_local_rank("dp"), mesh["dp"].size(), mesh.get_group("dp"))


def tp_info(mesh) -> tuple[int, int, Any]:
    """``(rank, size, group)`` of this process on the mesh's ``tp`` axis."""
    return (mesh.get_local_rank("tp"), mesh["tp"].size(), mesh.get_group("tp"))


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
    """Every tensor of ``tree`` set to rank 0's values on every rank of the
    mesh, in place; a tp shard (a tensor of an ``nn.TPLayer``) to the
    values of dp rank 0 at its own tp index, a broadcast over the ``dp``
    group, so each tp rank keeps its own slice. Returns ``tree``."""
    from ..nn import TPLayer

    _, _, dp_group = dp_info(mesh)
    dp_src = dist.get_global_rank(dp_group, 0)

    def visit(node, shard: bool) -> None:
        if isinstance(node, torch.Tensor):
            if shard:
                dist.broadcast(node, src=dp_src, group=dp_group)
            else:
                dist.broadcast(node, src=0)
        elif isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], shard or isinstance(node, TPLayer))
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v, shard)

    with torch.no_grad():
        visit(tree, False)
    return tree


def _mlp_layer_specs(n_layers: int) -> list[tuple[tuple, tuple]]:
    """``(kernel_spec, bias_spec)`` per layer, as tuples of axis names:
    column-parallel at even indices, row-parallel at odd ones."""
    specs = []
    for i in range(n_layers):
        if i % 2 == 0:
            specs.append(((None, "tp"), ("tp",)))  # column-parallel
        else:
            specs.append((("tp", None), ()))  # row-parallel
    return specs


def _slice(x: torch.Tensor, spec: tuple, rank: int, size: int) -> torch.Tensor:
    """This tp rank's slice of ``x`` along the axis ``spec`` names."""
    if "tp" not in spec:
        return x
    dim = spec.index("tp")
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"a width of {n} does not divide over the tp axis of {size}")
    k = n // size
    return x.narrow(dim, rank * k, k).contiguous().clone()


def shard_params_tp(params: dict, mesh) -> dict:
    """Tensor-parallel shards of a ``{"encoder": [...], "decoder": [...]}``
    MLP parameter tree, with the JAX package's layout: layer ``i`` of a
    stack column-parallel for even ``i``, row-parallel for odd ``i``
    (``_mlp_layer_specs``), as ``nn.TPLayer``s holding this rank's slices.
    Each stack's last layer (the latent layer and the output layer, tiny)
    and every other entry (an ADC's densifiers) stay replicated. Leaves
    may be numpy arrays (then tensors on the mesh's device) or tensors."""
    from ..nn import TPLayer

    rank, size, group = tp_info(mesh)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def tensor(x):
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=dev)

    def shard_stack(layers: list) -> list:
        n = len(layers)
        out = []
        for i, (layer, (k_spec, b_spec)) in enumerate(zip(layers, _mlp_layer_specs(n))):
            if i == n - 1:
                out.append({k: tensor(v) for k, v in layer.items()})
                continue
            out.append(TPLayer(
                {"kernel": _slice(tensor(layer["kernel"]), k_spec, rank, size),
                 "bias": _slice(tensor(layer["bias"]), b_spec, rank, size)},
                "column" if i % 2 == 0 else "row", group))
        return out

    from ..train.core import tree_map

    result = {k: tree_map(tensor, v) for k, v in params.items()
              if k not in ("encoder", "decoder")}
    result["encoder"] = shard_stack(params["encoder"])
    result["decoder"] = shard_stack(params["decoder"])
    return result


def unshard_params_tp(tree: Any) -> Any:
    """``tree`` with every tp-sharded layer's tensors made whole
    (all-gathered over its tp group, in rank order) as plain dict layers:
    what a checkpoint stores. A collective: every tp rank must call it."""
    from ..nn import TPLayer
    from .distributed import all_gather_cat

    def whole(x: torch.Tensor, spec: tuple, group) -> torch.Tensor:
        return all_gather_cat(x, group, spec.index("tp")) if "tp" in spec else x

    def visit(node):
        if isinstance(node, TPLayer):
            specs = node.specs
            return {k: whole(node[k], specs[k], node.group) for k in sorted(node)}
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [visit(v) for v in node]
        return node

    with torch.no_grad():
        return visit(tree)
