# encodermap_tpu_torch/parallel/sharded_featurize.py
"""Featurization with frame blocks split over the ranks of a run.

Counterpart of ``encodermap_tpu/parallel/sharded_featurize.py`` (the
reference's DaskFeaturizer, ``loading/featurizer.py:2071-2336``). There one
SPMD program shards every block's frames over the mesh; here every rank of
the ``dp`` axis featurizes whole blocks on its own device (round j gives
block ``j * dp + rank`` to each rank) through the port's
``loading/featurizer.py``, and the results of each round gather on rank 0,
which concatenates them in frame order or streams them into HDF5. Without a
process group (one process) it is the plain featurizer's block loop.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.cvstore import CVCollection, labels_bytes
from ..device import resolve_device
from ..loading.featurizer import SingleTrajFeaturizer, _cv_names, _to_host, _upload
from ..ops import geometry as geom
from .mesh import dp_info

__all__ = ["ShardedFeaturizer", "DaskFeaturizer"]


class ShardedFeaturizer:
    """Featurize a trajectory with its frame blocks split over the ranks.

    Args:
        traj: a SingleTraj.
        mesh: a ``("dp", "tp")`` mesh (``parallel.make_mesh``); None takes
            every rank of the process group, or this process alone.
        block_size: frames per block.
        device: this rank's device (None means the card).
    """

    def __init__(self, traj: Any, mesh: Any = None, block_size: int = 4096,
                 device: Any = None) -> None:
        self.traj = traj
        self.mesh = mesh
        if mesh is not None:
            self.rank, self.dp, self._group = dp_info(mesh)
        elif dist.is_initialized():
            self.rank, self.dp, self._group = dist.get_rank(), dist.get_world_size(), None
        else:
            self.rank, self.dp, self._group = 0, 1, None
        self.block_size = int(block_size)
        self.device = device
        self._inner = SingleTrajFeaturizer(traj, block_size, device)

    def __getattr__(self, name: str):
        # every add_* feature registration goes to the inner featurizer
        if name.startswith("add_"):
            return getattr(self._inner, name)
        raise AttributeError(name)

    @property
    def features(self):
        return self._inner.features

    def _block(self, run, slice_xyz, dev, start: int) -> list[np.ndarray]:
        """One block's results on the host."""
        traj = self.traj
        sub = traj[np.arange(start, min(start + self.block_size, traj.n_frames))]
        xyz_np = slice_xyz(np.asarray(sub.xyz, np.float32))
        box = sub.unitcell_vectors
        box_np = np.asarray(box, np.float32) if box is not None else None
        # the minimum image's wrap from the block's own boxes: reading the
        # whole trajectory's would load it into memory
        triclinic = box_np is not None and geom.boxes_are_triclinic(box_np)
        xb = _upload(xyz_np, dev)
        bb = _upload(box_np, dev) if box_np is not None else None
        if getattr(run, "accepts_host_blocks", False):
            res = run(xb, bb, triclinic, xyz_np, box_np)
        else:
            res = run(xb, bb, triclinic)
        return [_to_host(r) for r in res]

    def _rounds(self) -> Iterator[Optional[list]]:
        """Per round, on rank 0 the round's block results in frame order
        (a list of per-block result lists); None on the other ranks."""
        if not self._inner.features:
            raise ValueError("no features registered: call add_* methods first")
        run, slice_xyz = self._inner._get_runner()
        dev = resolve_device(self.device)
        starts = list(range(0, self.traj.n_frames, self.block_size))
        for j in range(0, len(starts), self.dp):
            mine = j + self.rank
            res = self._block(run, slice_xyz, dev, starts[mine]) \
                if mine < len(starts) else None
            if self.dp == 1:
                yield [res]
                continue
            got = [None] * self.dp if self.rank == 0 else None
            dist.gather_object(res, got, dst=dist.get_global_rank(self._group, 0)
                               if self._group is not None else 0, group=self._group)
            yield [r for r in got if r is not None] if self.rank == 0 else None

    def get_output(self, ensemble: bool = False) -> Optional[CVCollection]:
        """Run all features; the CVs on rank 0, None on the other ranks."""
        feats = self._inner.features
        parts: list[list[np.ndarray]] = [[] for _ in feats]
        for blocks in self._rounds():
            for res in blocks or ():
                for j, r in enumerate(res):
                    parts[j].append(r)
        if self.rank != 0:
            return None
        out = CVCollection()
        for f, name, blocks in zip(feats, _cv_names(feats), parts):
            data = (np.concatenate(blocks, axis=0) if blocks
                    else np.zeros((0, f.dimension), np.float32))
            labels = f.generic_describe() if ensemble else f.describe()
            attrs = None
            if getattr(f, "deg", None) is not None and not getattr(f, "cossin", False):
                attrs = {"angle_units": "deg" if f.deg else "rad"}
            out.add(name, data, labels, f.indices, attrs)
        return out

    def to_hdf5(self, path: Union[str, Path], group: str = "CVs",
                ensemble: bool = False) -> Optional[str]:
        """Stream the results into an HDF5 file, a round at a time, from
        rank 0 (the other ranks featurize and return None); the same
        datasets, labels, unit attributes and index tables as
        ``CVCollection.to_hdf5``."""
        feats = self._inner.features
        if self.rank != 0:
            for _ in self._rounds():
                pass
            return None
        import h5py

        n_frames = self.traj.n_frames

        def create(g, tails):
            dsets = []
            for f, name, (tail, dtype) in zip(feats, _cv_names(feats), tails):
                d = g.create_dataset(name, shape=(n_frames,) + tail, dtype=dtype)
                lab = labels_bytes(f.generic_describe() if ensemble else f.describe())
                if lab.nbytes < 60_000:
                    d.attrs["labels"] = lab
                else:  # HDF5's 64 KB attribute cap: a sidecar dataset
                    g.create_dataset(f"{name}__labels", data=lab)
                if getattr(f, "deg", None) is not None and not getattr(f, "cossin", False):
                    d.attrs["attr_angle_units"] = "deg" if f.deg else "rad"
                if f.indices is not None:
                    g.create_dataset(f"{name}__indices", data=f.indices)
                dsets.append(d)
            return dsets

        with h5py.File(path, "a") as fh:
            if group in fh:
                del fh[group]
            g = fh.create_group(group)
            dsets, row = None, 0
            for blocks in self._rounds():
                for res in blocks:
                    if dsets is None:
                        dsets = create(g, [(r.shape[1:], r.dtype) for r in res])
                    for d, r in zip(dsets, res):
                        d[row:row + len(r)] = r
                    row += len(res[0])
            if dsets is None:  # zero frames: the empty datasets all the same
                create(g, [((f.dimension,), np.float32) for f in feats])
        return str(path)


class DaskFeaturizer:
    """The reference's dask featurizer by name (``loading/featurizer.py:
    2071-2110``): ``n_workers`` and ``client`` are accepted for its
    signature, and the ranks of the run do the work. A TrajEnsemble gets
    the EnsembleFeaturizer, a SingleTraj the :class:`ShardedFeaturizer`."""

    def __new__(cls, trajs: Any, n_workers: Union[str, int] = "cpu-2",
                client: Any = None, **kwargs: Any):
        del n_workers, client
        if hasattr(trajs, "itertrajs"):  # TrajEnsemble
            from ..loading.featurizer import EnsembleFeaturizer

            return EnsembleFeaturizer(trajs, **kwargs)
        return ShardedFeaturizer(trajs, **kwargs)
