# encodermap_tpu_torch/parallel/__init__.py
"""Data and tensor parallelism over ``torch.distributed`` (one process per
device): the ``("dp", "tp")`` mesh, ``shard_params_tp``, the
multi-process runtime helpers and sharded featurization.

Counterpart of ``encodermap_tpu/parallel/``."""

from .distributed import (
    gather_rows,
    global_mesh,
    host_local_batch,
    initialize,
    is_primary,
    primary_only,
    process_local_slice,
    world,
)
from .mesh import make_mesh, replicate, shard_batch, shard_params_tp, unshard_params_tp

__all__ = [
    "make_mesh",
    "shard_batch",
    "shard_params_tp",
    "unshard_params_tp",
    "replicate",
    "initialize",
    "is_primary",
    "primary_only",
    "global_mesh",
    "host_local_batch",
    "process_local_slice",
    "gather_rows",
    "world",
]
