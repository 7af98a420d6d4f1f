# encodermap_tpu_torch/data/cvstore.py
"""Labeled CV (collective variable) storage with HDF5 round-trip.

The reference keeps CVs as ``xarray.Dataset`` objects aligned to trajectory
frames (``encodermap/trajinfo/info_single.py`` `_CVs`).
xarray is unavailable here; this is a minimal labeled-array container with
the pieces EncoderMap actually uses: per-CV feature labels, frame alignment,
NaN-padded stacking across topologies, HDF5 persistence.

Counterpart of ``encodermap_tpu/data/cvstore.py``; host numpy, copied near verbatim.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np

__all__ = ["CVEntry", "CVCollection", "labels_bytes"]


def labels_bytes(labels) -> np.ndarray:
    """Labels -> bytes array for HDF5. A plain ``dtype="S"`` coercion
    raises UnicodeEncodeError on any non-ASCII label (mid-write, after the
    old group was already deleted); explicit UTF-8 round-trips through the
    readers' default ``.decode()``."""
    return np.asarray([str(l).encode("utf-8") for l in labels])


class CVEntry:
    """One named CV: data ``(n_frames, ...)`` + feature labels + indices +
    free-form string attrs (e.g. ``angle_units``, mirroring the reference's
    per-DataArray attrs, ``misc/xarray.py:486-800``)."""

    def __init__(
        self,
        name: str,
        data: np.ndarray,
        labels: Optional[list[str]] = None,
        indices: Optional[np.ndarray] = None,
        attrs: Optional[dict[str, str]] = None,
    ) -> None:
        self.name = name
        self.data = np.asarray(data)
        self.labels = labels
        self.indices = None if indices is None else np.asarray(indices)
        self.attrs: dict[str, str] = dict(attrs) if attrs else {}

    @property
    def shape(self) -> tuple:
        return self.data.shape

    def __repr__(self) -> str:
        return f"<CV {self.name} {self.data.shape} {self.data.dtype}>"


class CVCollection:
    """Dict-like collection of CVEntry, frame-aligned."""

    def __init__(self) -> None:
        self._entries: dict[str, CVEntry] = {}

    def add(
        self,
        name: str,
        data: np.ndarray,
        labels: Optional[list[str]] = None,
        indices: Optional[np.ndarray] = None,
        attrs: Optional[dict[str, str]] = None,
    ) -> None:
        if name.endswith("__indices") or name.endswith("__labels"):
            # the HDF5 writer uses these suffixes for sidecar datasets; a
            # CV so named would be mistaken for metadata on reload (and
            # could collide with a sibling entry's sidecar on write)
            raise ValueError(
                f"CV name {name!r} ends with a reserved sidecar suffix "
                f"('__indices'/'__labels'); choose another name"
            )
        self._entries[name] = CVEntry(name, data, labels, indices, attrs)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._entries[name].data

    def entry(self, name: str) -> CVEntry:
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return [(k, v.data) for k, v in self._entries.items()]

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {v.data.shape}" for k, v in self._entries.items())
        return f"<CVCollection {{{inner}}}>"

    # ------------------------------------------------------------------ frame ops
    def index_frames(self, idx) -> "CVCollection":
        out = CVCollection()
        for k, e in self._entries.items():
            out.add(k, e.data[idx], e.labels, e.indices, e.attrs)
        return out

    # ------------------------------------------------------------------ HDF5
    def to_hdf5(self, path: Union[str, Path], group: str = "CVs") -> None:
        import h5py

        with h5py.File(path, "a") as f:
            if group in f:
                del f[group]
            g = f.create_group(group)
            for k, e in self._entries.items():
                ds = g.create_dataset(k, data=e.data)
                if e.labels is not None:
                    lab = labels_bytes(e.labels)
                    if lab.nbytes < 60_000:
                        ds.attrs["labels"] = lab
                    else:
                        # HDF5 caps attributes at 64 KB; all-atom
                        # cartesian labels on mid-size proteins exceed it
                        # — store as a sidecar dataset instead
                        g.create_dataset(f"{k}__labels", data=lab)
                for ak, av in e.attrs.items():
                    ds.attrs[f"attr_{ak}"] = str(av)
                if e.indices is not None:
                    g.create_dataset(f"{k}__indices", data=e.indices)

    @classmethod
    def from_hdf5(cls, path: Union[str, Path], group: str = "CVs") -> "CVCollection":
        import h5py

        out = cls()
        with h5py.File(path, "r") as f:
            if group not in f:
                return out
            g = f[group]
            for k in g:
                if k.endswith("__indices") or k.endswith("__labels"):
                    continue
                labels = None
                if "labels" in g[k].attrs:
                    labels = [s.decode() for s in g[k].attrs["labels"]]
                elif f"{k}__labels" in g:
                    labels = [s.decode() for s in g[f"{k}__labels"][:]]
                attrs = {
                    ak[5:]: (av.decode() if isinstance(av, bytes) else str(av))
                    for ak, av in g[k].attrs.items()
                    if ak.startswith("attr_")
                }
                indices = None
                if f"{k}__indices" in g:
                    indices = g[f"{k}__indices"][:]
                out.add(k, g[k][:], labels, indices, attrs or None)
        return out
