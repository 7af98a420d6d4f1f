# encodermap_tpu_torch/parallel/__init__.py
"""Data parallelism over ``torch.distributed`` (one process per device),
the multi-process runtime helpers and sharded featurization.

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
from .mesh import make_mesh, replicate, shard_batch

__all__ = [
    "make_mesh",
    "shard_batch",
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
