# encodermap_tpu_torch/data/trajectory.py
"""SingleTraj / TrajEnsemble: lazy MD trajectory containers with a CV store.

Self-contained re-design of the reference's trajinfo layer
(``encodermap/trajinfo/info_single.py:206``,
``info_all.py:790``): lazy loading (paths + frame indices only until
coordinates are touched), frame fancy-indexing that composes lazily, CV
loading by name shortcut / array / Feature, HDF5 round-trip, ensemble
stacking with NaN-padding across different topologies, and a
``batch_iterator``/``tf_dataset`` replacement that feeds the device.

Counterpart of ``encodermap_tpu/data/trajectory.py``; host numpy, copied near verbatim.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Iterator, Optional, Sequence, Union

import numpy as np

from .cvstore import CVCollection
from .pdb import load_pdb, write_pdb
from .topology import Topology

__all__ = ["SingleTraj", "TrajEnsemble"]


CV_SHORTCUTS = (
    "central_angles",
    "central_dihedrals",
    "central_cartesians",
    "central_distances",
    "side_dihedrals",
    "all",
)


def _bonds_for_save(top: Topology, xyz: np.ndarray):
    """Connectivity for the mdtraj-schema topology JSON: a loaded file's
    own bond list when present (ground truth an mdtraj writer recorded —
    includes disulfides/custom bonds), otherwise distance-guessed from
    frame 0. Never lets bond guessing fail a save."""
    file_bonds = getattr(top, "_file_bonds", None)
    if file_bonds:
        return file_bonds
    try:
        from ..misc.backmapping_offline import guess_bonds

        return guess_bonds(top, np.asarray(xyz)[0])
    except Exception:
        return []


def _fetch_url_cached(url: str, cache_dir: Optional[str] = None) -> str:
    """Download ``url`` into a local cache (once) and return the path.
    Lets ``SingleTraj("https://files.rcsb.org/view/1GHC.pdb")`` work like
    the reference (``info_single.py:593-609``) while all IO stays local."""
    import hashlib

    name = Path(url).name or "download"
    digest = hashlib.sha1(url.encode()).hexdigest()[:12]
    if cache_dir is None:
        import tempfile

        cache_dir = str(Path(tempfile.gettempdir()) / "em_url_cache")
    cache = Path(cache_dir)
    cache.mkdir(parents=True, exist_ok=True)
    target = cache / f"{digest}_{name}"
    if not target.exists():
        import urllib.request

        try:
            tmp = target.with_suffix(target.suffix + ".part")
            urllib.request.urlretrieve(url, tmp)  # noqa: S310
            tmp.replace(target)  # atomic publish: no half-written cache hits
        except Exception as e:
            raise RuntimeError(
                f"could not download {url} ({e}); this environment may "
                f"have no network egress — place the file at {target} "
                f"manually"
            ) from e
    return str(target)


class SingleTraj:
    """One trajectory: (traj_file, top_file) pair (or a single PDB/H5),
    loaded lazily, with frame indexing composing before any IO happens.

    Examples:
        >>> from encodermap_tpu_torch import SingleTraj
        >>> traj = SingleTraj("asp7.xtc", "asp7.pdb")  # doctest: +SKIP
        >>> traj.n_atoms
        73
        >>> sub = traj[::10]          # indexing composes lazily (no IO yet)
        >>> sub.load_CV("central_dihedrals")
        >>> sub.CVs["central_dihedrals"].shape[1]
        18
    """

    def __init__(
        self,
        traj: Union[str, Path],
        top: Optional[Union[str, Path]] = None,
        common_str: str = "",
        backend: str = "no_load",
        index: Optional[Any] = None,
        traj_num: Optional[int] = None,
        basename_fn=None,
        custom_top: Optional[Any] = None,
    ) -> None:
        # keyword names and order match the reference
        # (``info_single.py:360-370``) so reference call sites port verbatim
        if not isinstance(traj, (str, Path)):
            raise ValueError(
                f"Please provide a str or Path for `traj`; got "
                f"{type(traj)}. (mdtraj.Trajectory inputs are not "
                f"supported in this mdtraj-free build — save to a file "
                f"first.)"
            )
        if backend not in ("no_load", "mdtraj"):
            raise ValueError(
                f"`backend` must be 'no_load' or 'mdtraj', got {backend!r}"
            )
        self.backend = backend
        self.traj_file = str(traj)
        self.top_file = str(top) if top is not None else self.traj_file
        # coordinates-only formats carry no topology — catching swapped
        # (traj, top) arguments here, like the reference
        # (tests/test_trajinfo.py:1293)
        _top_suffix = Path(self.top_file).suffix.lower()
        if _top_suffix in (".xtc", ".dcd", ".trr"):
            raise ValueError(
                f"{self.top_file!r} is a coordinates-only format and "
                f"cannot serve as a topology. Did you swap the traj and "
                f"top arguments?"
            )
        if self.traj_file.startswith(("http://", "https://")):
            # URL loading (reference ``info_single.py:593-609``): fetch into
            # the shared cache, keep reporting the URL as traj_file/top_file
            local = _fetch_url_cached(self.traj_file)
            self._local_file = local
            if self.top_file == self.traj_file:
                self._local_top = local
            elif self.top_file.startswith(("http://", "https://")):
                self._local_top = _fetch_url_cached(self.top_file)
            else:
                self._local_top = self.top_file
        elif self.top_file.startswith(("http://", "https://")):
            self._local_file = self.traj_file
            self._local_top = _fetch_url_cached(self.top_file)
        self.index = index  # None = all frames; else np index into file frames
        self.traj_num = traj_num
        self.common_str = common_str
        self.basename_fn = basename_fn or (lambda p: Path(p).stem)
        self._top: Optional[Topology] = None
        self._xyz: Optional[np.ndarray] = None
        self._time: Optional[np.ndarray] = None
        self._unitcell: Optional[np.ndarray] = None
        self._n_frames_file: Optional[int] = None
        self._CVs = CVCollection()
        if custom_top is not None:
            self.load_custom_topology(custom_top)
        if backend == "mdtraj":
            # the reference's mdtraj backend loads eagerly at construction
            # (``info_single.py:365``); our native loader plays that role
            self.load_traj()

    @classmethod
    def from_pdb_id(cls, pdb_id: str, cache_dir: Optional[str] = None
                    ) -> "SingleTraj":
        """Fetch a structure from RCSB by 4-letter id (needs egress;
        reference: ``info_single.py:712``). Uses a local cache dir."""
        from pathlib import Path as _P

        if cache_dir is None:
            import tempfile

            cache_dir = str(_P(tempfile.gettempdir()) / "pdb_cache")
        cache = _P(cache_dir)
        cache.mkdir(parents=True, exist_ok=True)
        target = cache / f"{pdb_id.upper()}.pdb"
        if not target.exists():
            import urllib.request

            url = f"https://files.rcsb.org/view/{pdb_id.upper()}.pdb"
            try:
                # atomic publish like _fetch_url_cached: a download killed
                # mid-write must not become a permanent corrupt cache hit
                tmp = target.with_suffix(".pdb.part")
                urllib.request.urlretrieve(url, tmp)  # noqa: S310
                tmp.replace(target)
            except Exception as e:
                raise RuntimeError(
                    f"could not download {pdb_id} from RCSB ({e}); this "
                    f"environment may have no network egress — place the "
                    f"file at {target} manually"
                ) from e
        return cls(target)

    # ------------------------------------------------------------------ lazy IO
    @property
    def _traj_path(self) -> str:
        """Local filesystem path behind ``traj_file`` (differs only for
        URL-loaded trajectories, which download into a cache)."""
        return getattr(self, "_local_file", self.traj_file)

    @property
    def _top_path(self) -> str:
        return getattr(self, "_local_top", self.top_file)

    @property
    def basename(self) -> str:
        return self.basename_fn(self.traj_file)

    @property
    def extension(self) -> str:
        return Path(self.traj_file).suffix

    @property
    def top(self) -> Topology:
        if self._top is None:
            if self.top_file.endswith(".pdb"):
                self._top, xyz, cell = load_pdb(self._top_path)
                if self.traj_file == self.top_file:
                    self._file_xyz = xyz
                    self._file_box = cell
            elif self.top_file.endswith(".gro"):
                from .formats import load_gro

                self._top, xyz, cell = load_gro(self._top_path)
                if self.traj_file == self.top_file:
                    self._file_xyz = xyz
                    self._file_box = cell
            elif self.top_file.endswith((".h5", ".hdf5")):
                self._load_h5(top_only=True)
                if self._top is None:
                    import h5py

                    with h5py.File(self._top_path, "r") as f:
                        groups = [k for k in f if k.startswith("traj_")]
                    hint = (
                        " This looks like a multi-trajectory ensemble file "
                        "(TrajEnsemble.save layout) — load it with "
                        "TrajEnsemble.from_dataset(path)."
                        if groups else ""
                    )
                    raise ValueError(
                        f"{self.top_file} has no root-level 'topology' "
                        f"dataset.{hint}"
                    )
            else:
                raise ValueError(f"unsupported topology file {self.top_file}")
        return self._top

    @property
    def _frame_index(self) -> np.ndarray:
        n = self.n_frames_file
        idx = np.arange(n)
        if self.index is not None:
            idx = idx[self.index]
        return np.atleast_1d(idx)

    @property
    def n_frames_file(self) -> int:
        if self._n_frames_file is None:
            if self.traj_file.endswith(".xtc"):
                from .xtc import XTCReader

                self._reader = XTCReader(self._traj_path)
                self._n_frames_file = self._reader.n_frames
            elif self.traj_file.endswith(".pdb"):
                _, xyz, cell = load_pdb(self._traj_path)
                self._file_xyz = xyz
                self._file_box = cell
                self._n_frames_file = len(xyz)
            elif self.traj_file.endswith(".gro"):
                from .formats import load_gro

                _, xyz, cell = load_gro(self._traj_path)
                self._file_xyz = xyz
                self._file_box = cell
                self._n_frames_file = len(xyz)
            elif self.traj_file.endswith(".dcd"):
                from .formats import DCDReader

                self._reader = DCDReader(self._traj_path)
                self._n_frames_file = self._reader.n_frames
            elif self.traj_file.endswith(".trr"):
                from .formats import TRRReader

                self._reader = TRRReader(self._traj_path)
                self._n_frames_file = self._reader.n_frames
            elif self.traj_file.endswith((".h5", ".hdf5")):
                self._load_h5(top_only=False, lazy_count=True)
            else:
                raise ValueError(f"unsupported trajectory file {self.traj_file}")
        return self._n_frames_file

    def _load_h5(self, top_only: bool = False, lazy_count: bool = False) -> None:
        import h5py

        # the topology may live in a NON-h5 file (e.g. traj.h5 + top.pdb):
        # only read it here when the top file actually is HDF5 — the frame
        # count below needs only _traj_path
        if self._top_path.endswith((".h5", ".hdf5")):
            with h5py.File(self._top_path, "r") as f:
                if self._top is None and "topology" in f:
                    from .mdtraj_h5 import topology_from_json

                    self._top = topology_from_json(f["topology"][0].decode())
                    if "custom_topology" in f.attrs:
                        from .custom_topology import CustomTopology

                        self._top = CustomTopology.from_json(
                            self._top, f.attrs["custom_topology"]
                        ).apply()
                if not self.common_str and "common_str" in f.attrs:
                    # persisted by save() like the reference
                    # (info_single.py:1897-1902)
                    self.common_str = str(f.attrs["common_str"])
        if not top_only:
            with h5py.File(self._traj_path, "r") as ft:
                self._n_frames_file = ft["coordinates"].shape[0]
                # reference-written trajs.h5 embed CVs under /CVs
                # (``info_all.py:2551``); attach frame-aligned ones to
                # unsliced trajs (a slice would desynchronize the rows)
                if "CVs" in ft and self.index is None:
                    # go through the canonical reader so labels, indices,
                    # attrs (angle_units!), and the __labels/__indices
                    # sidecar conventions survive the round-trip — a raw
                    # dataset walk dropped them AND could mistake a
                    # sidecar for a CV (review wave 27)
                    from .cvstore import CVCollection

                    loaded = CVCollection.from_hdf5(
                        self._traj_path, group="CVs"
                    )
                    for name in loaded:
                        e = loaded.entry(name)
                        if (e.data.ndim >= 1
                                and e.data.shape[0] == self._n_frames_file
                                and name not in self._CVs):
                            self._CVs.add(name, e.data, e.labels,
                                          e.indices, e.attrs)

    def load_traj(self) -> None:
        """Eagerly materialize the trajectory, raising ``FileNotFoundError``
        for missing traj/top files (reference ``info_single.py:1040`` — its
        tests rely on this surfacing before any decode attempt)."""
        import os

        for f in (self._traj_path, self._top_path):
            if (not str(f).startswith(("http://", "https://"))
                    and not os.path.isfile(str(f))):
                raise FileNotFoundError(f"No such file: {f}")
        self.load()

    def load(self) -> None:
        """Materialize coordinates for the (composed) frame index."""
        if self._xyz is not None:
            return
        idx = self._frame_index
        if self.traj_file.endswith(".xtc"):
            from .xtc import XTCReader

            reader = getattr(self, "_reader", None) or XTCReader(self._traj_path)
            xyz, box, time, _ = reader.read(idx)
            self._xyz = xyz
            self._time = time
            # vacuum trajectories store an all-zero box; a singular cell
            # would NaN the minimum-image convention downstream
            if box.size and np.abs(np.linalg.det(box)).min() < 1e-12:
                box = None
            self._unitcell = box
        elif self.traj_file.endswith((".pdb", ".gro")):
            if not hasattr(self, "_file_xyz"):
                if self.traj_file.endswith(".pdb"):
                    _, self._file_xyz, self._file_box = load_pdb(
                        self._traj_path
                    )
                else:
                    from .formats import load_gro

                    _, self._file_xyz, self._file_box = load_gro(
                        self._traj_path
                    )
            self._xyz = self._file_xyz[idx]
            self._time = np.arange(len(idx), dtype=np.float32)
            # CRYST1 / gro box lines give per-frame box LENGTHS
            # (orthorhombic) or (F, 3, 3) cell rows (triclinic);
            # all-zero/singular cells mean vacuum
            box = getattr(self, "_file_box", None)
            if box is not None:
                box = np.asarray(box, np.float32)
                if box.ndim == 3:
                    box = box[np.minimum(idx, len(box) - 1)]
                    if box.size and \
                            np.abs(np.linalg.det(box)).min() < 1e-12:
                        box = None
                else:
                    if box.ndim == 1:
                        box = np.broadcast_to(
                            box, (len(self._file_xyz), 3)
                        )
                    box = box[np.minimum(idx, len(box) - 1)]
                    if box.size and np.abs(box).min() < 1e-12:
                        box = None
                    else:
                        box = np.stack([np.diag(v) for v in box])
            self._unitcell = box
        elif self.traj_file.endswith(".dcd"):
            from .formats import DCDReader

            reader = getattr(self, "_reader", None) or DCDReader(self._traj_path)
            xyz, cells = reader.read(idx)
            self._xyz = xyz
            self._time = np.arange(len(idx), dtype=np.float32)
            self._unitcell = (
                np.stack([np.diag(c) for c in cells]) if cells is not None
                else None
            )
        elif self.traj_file.endswith(".trr"):
            from .formats import TRRReader

            reader = getattr(self, "_reader", None) or TRRReader(self._traj_path)
            xyz, box, steps = reader.read(idx)
            self._xyz = xyz
            self._time = steps.astype(np.float32)
            # a TRR written without a box stores none, which reads as zeros:
            # vacuum, as in the XTC branch (the JAX package keeps the
            # singular cell, and its minimum image then gives NaN CVs)
            if box.size and np.abs(np.linalg.det(box)).min() < 1e-12:
                box = None
            self._unitcell = box
        elif self.traj_file.endswith((".h5", ".hdf5")):
            import h5py

            with h5py.File(self._traj_path, "r") as f:
                # h5py fancy indexing requires strictly increasing UNIQUE
                # indices; read unique rows once and scatter back so
                # repeated frame selections (bootstrap resampling) work
                uniq, inverse = np.unique(idx, return_inverse=True)
                xyz = f["coordinates"][uniq]
                self._xyz = xyz[inverse]
                self._time = (
                    f["time"][uniq][inverse] if "time" in f
                    else np.arange(len(idx), dtype=np.float32)
                )
                if "cell_vectors" in f:
                    # lossless triclinic-capable layout (ours)
                    self._unitcell = f["cell_vectors"][uniq][inverse]
                elif "cell_lengths" in f:
                    cl = f["cell_lengths"][uniq][inverse]
                    self._unitcell = np.stack([np.diag(v) for v in cl])
                else:
                    self._unitcell = None
        else:
            raise ValueError(f"unsupported trajectory file {self.traj_file}")

    @property
    def xyz(self) -> np.ndarray:
        self.load()
        return self._xyz

    @property
    def time(self) -> np.ndarray:
        self.load()
        return self._time

    @property
    def unitcell_vectors(self) -> Optional[np.ndarray]:
        self.load()
        return self._unitcell

    @property
    def n_frames(self) -> int:
        return len(self._frame_index)

    @property
    def n_atoms(self) -> int:
        return self.top.n_atoms

    @property
    def n_residues(self) -> int:
        return self.top.n_residues

    # ------------------------------------------------------------------ indexing
    def __getitem__(self, item) -> "SingleTraj":
        # normalize so a scalar index yields a 1-frame traj whose CVs KEEP
        # their frame axis (a raw int would drop it in the CV store)
        if isinstance(item, (int, np.integer)):
            item = np.asarray([item])
        new_index = self._frame_index[item]
        out = SingleTraj(
            self.traj_file, self.top_file, index=np.atleast_1d(new_index),
            traj_num=self.traj_num, common_str=self.common_str,
        )
        out._top = self._top
        if self._n_frames_file is not None:
            # inherit the known file frame count: grouped ensemble HDF5
            # members cannot re-count it from traj_file
            out._n_frames_file = self._n_frames_file
        if self._xyz is not None:
            # materialized trajs (stack/join/from_dataset/generated frames)
            # may not be re-readable from traj_file (e.g. grouped ensemble
            # HDF5) — slice in memory instead of re-reading lazily. The
            # composed `index` is KEPT so `.id` still reports original
            # file frame numbers.
            out._xyz = self._xyz[item]
            out._materialized = getattr(self, "_materialized", False)
            if self._time is not None:
                out._time = self._time[item]
            if self._unitcell is not None:
                out._unitcell = self._unitcell[item]
        if len(self._CVs):
            out._CVs = self._CVs.index_frames(item)
        return out

    def atom_slice(self, atom_indices: Any) -> "SingleTraj":
        """New trajectory restricted to the given atoms (ascending order),
        with a subset topology — the analog of mdtraj/reference
        ``SingleTraj.atom_slice`` (``info_single.py:2210``). CVs are NOT
        carried over (their atom indices would dangle)."""
        idx = np.unique(np.asarray(atom_indices, np.int64))
        self.load()
        keep = set(idx.tolist())
        new_top = Topology()
        for res in self.top.residues:
            sel = [a for a in res.atoms if a.index in keep]
            if not sel:
                continue
            new_res = new_top.add_residue(res.name, res.resSeq,
                                          res.chain_index)
            for a in sel:
                new_top.add_atom(a.name, a.element, new_res)
        out = SingleTraj(
            self.traj_file, self.top_file, traj_num=self.traj_num,
            common_str=self.common_str,
        )
        out._top = new_top
        out._xyz = self.xyz[:, idx]
        out._materialized = True
        out._time = self.time
        out._unitcell = self._unitcell
        out._n_frames_file = self.n_frames
        out.index = None
        return out

    def __len__(self) -> int:
        return self.n_frames

    def _shallow_copy(self) -> "SingleTraj":
        """Copy sharing coordinate arrays but owning its own CV collection
        and identity fields (traj_num, common_str) — mutating the copy's
        metadata or adding CVs leaves the original untouched."""
        import copy as _copy

        out = _copy.copy(self)
        cvs = CVCollection()
        cvs._entries = dict(self._CVs._entries)
        out._CVs = cvs
        # the cached featurizer is bound to SELF; a copy whose coordinates
        # get replaced (superpose, traj_joined) must rebuild its own
        out.__dict__.pop("_featurizer", None)
        return out

    def get_single_frame(self, key: int) -> "SingleTraj":
        """Frame ``key`` as a 1-frame trajectory (reference
        ``info_single.py:1365``)."""
        return self[int(key)]

    def __add__(self, y: "SingleTraj") -> "TrajEnsemble":
        """Adding two trajectories yields a TrajEnsemble of shallow copies
        (the operands keep their own traj_num/CVs; reference
        ``info_single.py:2152``)."""
        return TrajEnsemble([self._shallow_copy(), y._shallow_copy()])

    def _gen_ensemble(self) -> "TrajEnsemble":
        """This trajectory as a 1-member :class:`TrajEnsemble` (reference
        ``info_single.py:_gen_ensemble``)."""
        return TrajEnsemble([self._shallow_copy()])

    def __iter__(self) -> Iterator["SingleTraj"]:
        for k in range(self.n_frames):
            yield self[k]

    def __eq__(self, other: object) -> bool:
        """Value equality: same files, same (possibly sliced) frames, same
        loaded CVs (reference ``info_single.py:2014-2023``)."""
        if not isinstance(other, SingleTraj):
            return NotImplemented
        if self is other:
            return True
        if (self.traj_file, self.top_file) != (other.traj_file,
                                               other.top_file):
            return False
        if self.n_frames != other.n_frames or not np.array_equal(
            self._frame_index, other._frame_index
        ):
            return False
        if not np.array_equal(self.xyz, other.xyz):
            return False
        if set(self.CVs) != set(other.CVs):
            return False
        return all(
            np.array_equal(self.CVs[k], other.CVs[k], equal_nan=True)
            for k in self.CVs
        )

    def __hash__(self) -> int:
        fi = self._frame_index
        return hash((self.traj_file, self.top_file, self.n_frames,
                     fi.tobytes()))

    def __reversed__(self) -> "SingleTraj":
        """Frame order reversed — same as ``traj[::-1]``, CVs included
        (reference ``info_single.py:2025``)."""
        return self[::-1]

    @property
    def fsel(self) -> "_FrameSelector":
        """Select frames by their ORIGINAL file frame number instead of
        positional index (reference ``SingleTrajFsel``,
        ``info_single.py:169-213``): ``traj[::10].fsel[20]`` is the frame
        that was frame 20 in the file, wherever it now sits."""
        return _FrameSelector(self)

    def __enter__(self) -> "SingleTraj":
        """Keep coordinates materialized for the block (reference
        ``info_single.py:2029``)."""
        self.load()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.unload()

    @property
    def id(self) -> np.ndarray:
        """Per-frame identifiers: the ORIGINAL file frame numbers, shape
        ``(n_frames,)`` — or ``(n_frames, 2)`` of ``[traj_num, frame]``
        when this traj carries a ``traj_num`` (reference
        ``info_single.py:897-918``)."""
        fi = self._frame_index
        if self.traj_num is None:
            return fi.copy()
        return np.stack(
            [np.full(len(fi), self.traj_num, dtype=fi.dtype), fi], axis=1
        )

    def iterframes(self, with_traj_num: bool = False):
        """Yield ``(original_frame_num, 1-frame-traj)`` — or the three-tuple
        ``(traj_num, frame_num, frame)`` with ``with_traj_num=True``
        (reference ``info_single.py:1936-1984``)."""
        fid = self.id
        frames = fid[:, 1] if fid.ndim == 2 else fid
        for i, frame in zip(frames, self):
            if with_traj_num:
                yield self.traj_num, int(i), frame
            else:
                yield int(i), frame

    def copy(self) -> "SingleTraj":
        """Deep copy (reference ``info_single.py:copy``)."""
        import copy as _copy

        return _copy.deepcopy(self)

    def __deepcopy__(self, memo):
        import copy as _copy

        out = self.__class__.__new__(self.__class__)
        memo[id(self)] = out
        for k, v in self.__dict__.items():
            # native decoder handles (ctypes) and cached featurizers
            # cannot deep-copy; both are recreated lazily on demand
            if k in ("_reader", "_featurizer"):
                continue
            out.__dict__[k] = _copy.deepcopy(v, memo)
        return out

    def del_CVs(self) -> None:
        """Drop all loaded CVs (files untouched; reference
        ``info_single.py:1164``)."""
        self._CVs = CVCollection()

    @property
    def CVs_in_file(self) -> bool:
        """True when ``traj_file`` is an HDF5 file containing a CVs group
        (reference ``info_single.py:1022-1029``)."""
        if self.extension in (".h5", ".hdf5"):
            import h5py

            with h5py.File(self._traj_path, "r") as f:
                if "CVs" in f:
                    return True
                tn = self.traj_num
                if tn is not None and f"traj_{tn}/CVs" in f:
                    return True
        return False

    @property
    def n_chains(self) -> int:
        return self.top.n_chains

    def select(self, expr: str) -> np.ndarray:
        """Atom indices matching the selection expression (delegates to
        :meth:`Topology.select`; reference ``info_single.py:select``)."""
        return self.top.select(expr)

    def sidechain_info(self) -> dict[int, int]:
        """Per-residue sidechain-dihedral counts (delegates to the
        topology; reference ``info_single.py:1700``)."""
        return self.top.sidechain_info()

    @property
    def featurizer(self):
        """A cached :class:`SingleTrajFeaturizer` over this traj (reference
        ``info_single.py:featurizer`` / ``info_all.py:1242-1248``)."""
        if not hasattr(self, "_featurizer"):
            from ..loading.featurizer import SingleTrajFeaturizer

            self._featurizer = SingleTrajFeaturizer(self)
        return self._featurizer

    def superpose(
        self, reference, frame: int = 0, atom_indices=None,
        ref_atom_indices=None,
    ) -> "SingleTraj":
        """New trajectory with every conformation Kabsch-aligned onto frame
        ``frame`` of ``reference`` (a traj-like or coordinates; reference
        ``info_single.py:1800-1860``, which delegates to mdtraj). CVs are
        NOT inherited — extrinsic CVs (absolute coordinates) would be
        invalidated by the rotation, matching the reference's refusal."""
        from ..ops.kabsch import align_frames

        ref = np.asarray(reference.xyz if hasattr(reference, "xyz")
                         else reference, np.float32)
        if ref.ndim == 3:
            ref = ref[frame]
        sel = (np.arange(self.n_atoms) if atom_indices is None
               else np.asarray(atom_indices, np.int64))
        ref_sel = sel if ref_atom_indices is None else np.asarray(
            ref_atom_indices, np.int64
        )
        import torch

        aligned = align_frames(
            torch.as_tensor(np.asarray(self.xyz, np.float32)),
            torch.as_tensor(np.ascontiguousarray(ref[ref_sel])),
            torch.as_tensor(sel),
        ).numpy()
        out = self._shallow_copy()
        out._CVs = CVCollection()
        out._xyz = aligned
        out._materialized = True
        return out

    def join(self, other: "SingleTraj") -> "SingleTraj":
        """Join two trajectories along the frame axis (reference
        ``info_single.py:1778`` — which returns a bare mdtraj Trajectory;
        here a materialized SingleTraj). Like the reference's, the result
        loses CVs and file provenance."""
        return TrajEnsemble([self.copy(), other.copy()]).traj_joined

    def stack(self, other: "SingleTraj") -> "SingleTraj":
        """Stack two trajectories along the ATOM axis into one
        merged-topology trajectory (reference ``info_single.py:1789``;
        same frame counts required). Loses CVs, like the reference's."""
        return TrajEnsemble([self.copy(), other.copy()]).stack()

    def unload(self, CVs: bool = False) -> None:
        """Free the cached coordinate arrays so the next access re-reads
        from file (reference ``info_single.py:1294-1316``). A no-op for
        materialized trajectories (atom_slice/stack/generated/-from-grouped-
        h5 products), whose coordinates exist only in memory."""
        if getattr(self, "_materialized", False):
            if CVs:
                self.del_CVs()
            return
        self._xyz = None
        self._time = None
        self._unitcell = None
        for attr in ("_file_xyz", "_file_box", "_reader"):
            if hasattr(self, attr):
                delattr(self, attr)
        if CVs:
            self.del_CVs()

    def save_CV_as_numpy(
        self, attr_name: str, fname=None, overwrite: bool = False
    ) -> None:
        """Save one loaded CV as a ``.npy`` file (reference
        ``info_single.py:1673-1698``)."""
        import os

        if fname is None:
            fname = f"{self.basename}_{attr_name}.npy"
        if os.path.isdir(str(fname)):
            fname = os.path.join(str(fname), f"{self.basename}_{attr_name}.npy")
        if os.path.isfile(str(fname)) and not overwrite:
            raise IOError(
                f"{fname} already exists. Set overwrite=True to overwrite."
            )
        np.save(str(fname), self.CVs[attr_name])

    # ------------------------------------------------------------------ dihedral indices
    @property
    def indices_phi(self) -> np.ndarray:
        return self.top.indices_phi

    @property
    def indices_psi(self) -> np.ndarray:
        return self.top.indices_psi

    @property
    def indices_omega(self) -> np.ndarray:
        return self.top.indices_omega

    @property
    def indices_chi1(self) -> np.ndarray:
        return self.top.indices_chi1

    @property
    def indices_chi2(self) -> np.ndarray:
        return self.top.indices_chi2

    @property
    def indices_chi3(self) -> np.ndarray:
        return self.top.indices_chi3

    @property
    def indices_chi4(self) -> np.ndarray:
        return self.top.indices_chi4

    @property
    def indices_chi5(self) -> np.ndarray:
        return self.top.indices_chi5

    # ------------------------------------------------------------------ CVs
    def _ensure_h5_cvs(self) -> None:
        """Embedded /CVs attach during the lazy frame count; the reference
        exposes them from a bare ``.CVs`` or CV-attribute access too."""
        if (not len(self._CVs) and self._n_frames_file is None
                and self.traj_file.endswith((".h5", ".hdf5"))):
            _ = self.n_frames_file

    @property
    def CVs(self) -> dict[str, np.ndarray]:
        self._ensure_h5_cvs()
        return {k: self._CVs[k] for k in self._CVs}

    def _add_cv_checked(
        self,
        name: str,
        data: np.ndarray,
        labels=None,
        indices=None,
        attrs: Optional[dict] = None,
        override: bool = False,
    ) -> None:
        """Insert one CV entry with the reference's merge rules: angle
        units must stay homogeneous across this traj's CVs
        (``trajinfo_utils.py:1614-1618``), and a same-named CV with
        different values raises unless ``override``
        (``info_single.py:1634-1663``)."""
        if attrs and "angle_units" in attrs:
            for e in self._CVs._entries.values():
                eu = e.attrs.get("angle_units")
                if eu is not None and eu != attrs["angle_units"]:
                    raise AssertionError(
                        f"Can't combine datasets with inhomogeneous angle "
                        f"types. The CV {e.name!r} uses {eu!r}, the new CV "
                        f"{name!r} uses {attrs['angle_units']!r}."
                    )
        if name in self._CVs and not override:
            old = self._CVs[name]
            new = np.asarray(data)
            equal_nan = (old.dtype.kind == "f" and new.dtype.kind == "f")
            same = old.shape == new.shape and np.array_equal(
                old, new, equal_nan=equal_nan
            )
            if not same:
                raise Exception(
                    f"Could not add the CV `{name}` to the CVs of the traj, "
                    f"likely due to it being already in the CVs "
                    f"({list(self._CVs.keys())}). Set `override` to True to "
                    f"overwrite these CVs."
                )
        elif name in self._CVs and override:
            warnings.warn(
                f"Overwriting the following CVs with new values: {{{name!r}}}."
            )
        self._CVs.add(name, data, labels, indices, attrs)

    def load_CV(
        self,
        data: Any,
        attr_name: Optional[str] = None,
        cols: Optional[list] = None,
        deg: Optional[bool] = None,
        periodic: bool = True,
        labels: Optional[list[str]] = None,
        override: bool = False,
        device=None,
    ) -> None:
        """Load a CV: by name shortcut ("central_dihedrals", ..., "all",
        "full"), from an ``.npy``/``.txt`` file path, from a numpy array
        (or nested list), or from a Feature instance
        (reference: ``info_single.py:1475-1665``). ``cols`` selects columns
        of file/array data; ``deg`` asks for degrees from angular features
        (for raw arrays it records the unit so deg and rad CVs can't be
        mixed); a same-named CV with different values raises unless
        ``override``. Features run on ``device`` (the card unless
        ``device="cpu"``)."""
        from pathlib import Path as _Path

        if isinstance(data, _Path):
            data = str(data)
        if isinstance(data, str) and data.endswith((".npy", ".txt")):
            arr = (np.load(data) if data.endswith(".npy")
                   else np.loadtxt(data))
            name = attr_name or _Path(data).stem
            return self.load_CV(np.asarray(arr), attr_name=name, cols=cols,
                                deg=deg, labels=labels, override=override,
                                device=device)
        if isinstance(data, (list, tuple)) and data and not isinstance(
                data[0], str):
            data = np.asarray(data, dtype=np.float32)
        if isinstance(data, str):
            from ..loading.featurizer import SingleTrajFeaturizer

            feat = SingleTrajFeaturizer(self, device=device)
            which = data if data in ("all", "full") else [data]
            feat.add_list_of_feats(which, periodic=periodic, deg=bool(deg))
            results = feat.get_output()
            for name, entry in results._entries.items():
                self._add_cv_checked(name, entry.data, entry.labels,
                                     entry.indices, entry.attrs,
                                     override=override)
            return
        if isinstance(data, np.ndarray):
            assert attr_name is not None, "attr_name required for raw arrays"
            if cols is not None:
                data = data[:, cols]
            if len(data) != self.n_frames:
                raise ValueError(
                    f"CV length {len(data)} != n_frames {self.n_frames}"
                )
            attrs = (
                {"angle_units": "deg" if deg else "rad"}
                if deg is not None else None
            )
            self._add_cv_checked(attr_name, data, labels, attrs=attrs,
                                 override=override)
            return
        if hasattr(data, "transform") and hasattr(data, "describe"):
            from ..loading.featurizer import SingleTrajFeaturizer

            feat = SingleTrajFeaturizer(self, device=device)
            feat.add_custom_feature(data)
            results = feat.get_output()
            for name, entry in results._entries.items():
                self._add_cv_checked(name, entry.data, entry.labels,
                                     entry.indices, entry.attrs,
                                     override=override)
            return
        raise TypeError(f"cannot load CV from {type(data)}")

    def load_custom_topology(self, custom: Any) -> None:
        """Patch this trajectory's topology with user residue definitions
        (unnatural amino acids), so every chi-derived feature honors them
        (reference ``SingleTraj.load_custom_topology``,
        ``info_single.py:1388``).

        ``custom`` is a :class:`CustomTopology`, the reference's
        ``CustomAAsDict`` format ``{resname: (one_letter_code,
        {"optional_bonds": [...], "CHI1": [...], ...})}``, or the simple
        dict ``{resname: {"chi1": [4 atom names], ...}}``.
        """
        from .custom_topology import CustomTopology

        if isinstance(custom, CustomTopology):
            ct = CustomTopology(self.top)
            ct._custom_chi = custom._custom_chi
            ct._dihedral_overrides = custom._dihedral_overrides
            ct._extra_bonds = list(custom._extra_bonds)
            ct._delete_bonds = list(custom._delete_bonds)
            ct._not_dihedrals = custom._not_dihedrals
            ct._protein_names = custom._protein_names
        else:
            # (common_str, resname) tuple keys scope definitions to trajs
            # with that common_str (reference trajinfo_utils.py:591-594)
            ct = CustomTopology.from_custom_aas(
                self.top, custom, common_str=self.common_str
            )
        self._top = ct.apply()
        self._validate_strict_deletes()

    def _validate_strict_deletes(self) -> None:
        """Strict 'delete_bonds' are validated ONCE, here, against this
        trajectory's own first frame — the analog of the reference
        validating at topology-patch time (``trajinfo_utils.py:980-991``).
        After a successful pass they are downgraded to optional so a later
        ``guess_bonds`` on distorted/generated coordinates can never raise
        geometry-dependently from deep inside plotting or backmapping."""
        dels = getattr(self._top, "_deleted_bonds", [])
        if not any(strict for _, _, strict in dels):
            return
        from ..misc.backmapping_offline import guess_bonds

        frame0 = self.xyz[0] if self._xyz is not None else self[0].xyz[0]
        guess_bonds(self._top, frame0)  # raises on a strict miss
        self._top._deleted_bonds = [
            (lo, hi, False) for lo, hi, _ in dels
        ]

    def __getattr__(self, name: str):
        # CV access as attributes (reference behavior)
        if name.startswith("_"):
            raise AttributeError(name)
        cvs = self.__dict__.get("_CVs")
        if cvs is not None:
            if name not in cvs:
                self._ensure_h5_cvs()
            if name in cvs:
                return cvs[name]
        raise AttributeError(name)

    # ------------------------------------------------------------------ save
    def save(self, path: Union[str, Path],
             CVs: Union[str, list] = "all",
             overwrite: bool = False) -> None:
        """Write trajectory + CVs to one HDF5 file (mdtraj-compatible layout
        plus a CVs group, like ``TrajEnsemble.save``).

        Args:
            CVs: ``"all"`` stores every loaded CV; a list of names stores
                only those (reference ``info_single.py:1858-1925``).
            overwrite: an existing file raises ``IOError`` unless True,
                like the reference.
        """
        import h5py

        from .mdtraj_h5 import topology_to_json

        if Path(path).is_file() and not overwrite:
            raise IOError(
                f"{path} already exists. Set overwrite=True to overwrite."
            )
        # Validate the CVs argument BEFORE the file is opened (mode "w"
        # truncates) — a typo'd name must not destroy an existing file.
        if isinstance(CVs, (list, tuple)):
            for name in CVs:
                if name not in self._CVs:
                    raise KeyError(
                        f"CV {name!r} is not loaded on this trajectory "
                        f"(have: {sorted(self._CVs.keys())})"
                    )
        elif CVs != "all":
            raise ValueError(
                f"CVs must be 'all' or a list of CV names, got {CVs!r}"
            )
        self.load()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(path, "w") as f:
            f.create_dataset("coordinates", data=self.xyz)
            f.create_dataset("time", data=self.time)
            if self._unitcell is not None:
                box = np.asarray(self._unitcell, np.float64)
                # true lengths/angles (mdtraj-compatible datasets) — a
                # bare np.diag would silently flatten triclinic cells
                a, b, c = box[:, 0], box[:, 1], box[:, 2]
                na = np.linalg.norm(a, axis=-1)
                nb = np.linalg.norm(b, axis=-1)
                nc = np.linalg.norm(c, axis=-1)
                lengths = np.stack([na, nb, nc], axis=1)

                def _ang(u, v, nu, nv):
                    cos = np.einsum("fi,fi->f", u, v) / np.maximum(
                        nu * nv, 1e-12)
                    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))

                angles = np.stack(
                    [_ang(b, c, nb, nc), _ang(a, c, na, nc),
                     _ang(a, b, na, nb)], axis=1,
                )
                f.create_dataset("cell_lengths",
                                 data=lengths.astype(np.float32))
                f.create_dataset("cell_angles",
                                 data=angles.astype(np.float32))
                # lossless vectors alongside (our loader prefers them)
                f.create_dataset("cell_vectors",
                                 data=box.astype(np.float32))
            f.create_dataset(
                "topology",
                data=np.asarray(
                    [topology_to_json(
                        self.top, bonds=_bonds_for_save(self.top, self.xyz)
                    ).encode()]
                ),
            )
            # custom residue definitions (unnatural AAs) survive round trips
            custom = getattr(self.top, "_custom_def_json", None)
            if custom is not None:
                f.attrs["custom_topology"] = custom
            if self.common_str:
                # persisted like the reference (info_single.py:1897-1902)
                f.attrs["common_str"] = self.common_str
        if len(self._CVs):
            if CVs == "all":
                self._CVs.to_hdf5(path)
            elif isinstance(CVs, (list, tuple)):
                subset = type(self._CVs)()
                for name in CVs:
                    if name not in self._CVs:
                        raise KeyError(
                            f"CV {name!r} is not loaded on this trajectory "
                            f"(have: {sorted(self._CVs.keys())})"
                        )
                    e = self._CVs.entry(name)
                    subset.add(name, e.data, e.labels, e.indices, e.attrs)
                subset.to_hdf5(path)
            else:
                raise ValueError(
                    f"CVs must be 'all' or a list of CV names, got {CVs!r}"
                )

    def save_xtc(self, path: Union[str, Path], precision: float = 1000.0
                 ) -> str:
        """Write the (loaded) coordinates as a compressed XTC file via the
        native encoder."""
        from .xtc import write_xtc

        self.load()
        return write_xtc(
            path, self.xyz, box=self._unitcell, time=self._time,
            precision=precision,
        )

    def save_pdb(self, path: Union[str, Path]) -> None:
        # pass the (F, 3, 3) cell through: dropping it silently turned
        # periodic systems non-periodic on a PDB round-trip (wave 29)
        self.load()
        write_pdb(path, self.top, self.xyz, self._unitcell)

    @property
    def traj(self) -> "SingleTraj":
        """The loaded trajectory (reference ``info_single.py:838`` returns
        an ``mdtraj.Trajectory``; this framework's trajectory object IS the
        container, so the loaded self is the drop-in)."""
        self.load()
        return self

    def show_traj(self, gui: bool = True):
        """An nglview widget of this trajectory (reference
        ``info_single.py:1391``; nglview is optional — the matplotlib
        equivalent is :func:`encodermap_tpu.plot.plot_ball_and_stick`)."""
        try:
            import nglview
        except ImportError as e:
            raise ImportError(
                "show_traj needs nglview (not installed). For a "
                "matplotlib rendering use em.plot.plot_ball_and_stick(traj)."
            ) from e
        from ..misc.misc import _session_tmpfile

        fname = _session_tmpfile(".pdb")
        self.save_pdb(fname)
        return nglview.show_file(fname, gui=gui)

    def dash_summary(self):
        """A :obj:`pandas.DataFrame` summarizing this trajectory
        (reference ``info_single.py:1407-1460``)."""
        import pandas as pd

        self.load()
        dt = np.unique(self.time[1:] - self.time[:-1])
        if len(dt) == 1:
            dt = dt[0]
        elif len(dt) == 0:
            dt = "single frame"
        index = "[::]" if self.index is None else self.index
        return pd.DataFrame(
            {
                "field": ["n_frames", "n_atoms", "dt (ps)", "traj_file",
                          "top_file", "index", "common_str"],
                "value": [self.n_frames, self.n_atoms, dt, self.traj_file,
                          self.top_file, index, self.common_str],
            }
        ).astype(str)

    def __repr__(self) -> str:
        return (
            f"<SingleTraj {self.basename}: {self.n_frames} frames, "
            f"{self.top.n_atoms if self._top else '?'} atoms, "
            f"CVs: {list(self._CVs.keys())}>"
        )


class _FrameSelector:
    """``traj.fsel[...]``: frames by original file frame number."""

    def __init__(self, traj: SingleTraj) -> None:
        self._traj = traj

    def __getitem__(self, item) -> SingleTraj:
        frames = np.asarray(self._traj._frame_index)
        if isinstance(item, (int, np.integer)):
            wanted = np.asarray([item])
        elif isinstance(item, (list, np.ndarray)):
            wanted = np.asarray(item)
        else:
            raise ValueError(
                f"fsel[] takes an int or a list/array of ints, "
                f"got {type(item)}"
            )
        idx = np.where(np.isin(frames, wanted))[0]
        if len(idx) == 0:
            raise ValueError(
                f"No frames with original frame number(s) {item} in this "
                f"trajectory (available: {frames[:5]}...{frames[-1]})"
            )
        if isinstance(item, (int, np.integer)):
            return self._traj[int(idx[0])]
        return self._traj[idx]


class _TrajSelector:
    """``trajs.tsel[...]``: member trajectories by traj_num."""

    def __init__(self, trajs: "TrajEnsemble") -> None:
        self._trajs = trajs

    def __getitem__(self, item):
        by_num = self._trajs.trajs_by_traj_num
        if isinstance(item, (int, np.integer)):
            if int(item) not in by_num:
                raise ValueError(
                    f"No trajectory with traj_num {item} in this ensemble "
                    f"(available: {sorted(by_num)})"
                )
            return by_num[int(item)]
        if isinstance(item, (list, np.ndarray)):
            arr = np.asarray(item)
            if arr.ndim == 2 and arr.shape[1] == 2:
                # (traj_num, frame) pair rows — the reference's
                # _pyemma_indexing_tsel (``info_all.py:774``): select the
                # named frames of the named trajectories
                members = []
                for tn in dict.fromkeys(int(t) for t in arr[:, 0]):
                    if tn not in by_num:
                        raise ValueError(
                            f"No trajectory with traj_num {tn} in this "
                            f"ensemble (available: {sorted(by_num)})"
                        )
                    frames = arr[arr[:, 0] == tn, 1].astype(int)
                    members.append(by_num[tn][frames])
                return TrajEnsemble._from_members(members)
            wanted = [int(i) for i in arr.ravel()]
            missing = [i for i in wanted if i not in by_num]
            if missing:
                raise ValueError(
                    f"No trajectories with traj_nums {missing} in this "
                    f"ensemble (available: {sorted(by_num)})"
                )
            return TrajEnsemble._from_members([by_num[i] for i in wanted])
        raise ValueError(
            f"tsel[] takes an int or a list/array of ints, got {type(item)}"
        )


class TrajEnsemble:
    """Ordered collection of SingleTrajs, possibly with different topologies."""

    def __init__(
        self,
        trajs: Sequence[Union[str, Path, SingleTraj]],
        tops: Optional[Sequence[Union[str, Path]]] = None,
        common_str: Optional[Sequence[str]] = None,
        basename_fn=None,
    ) -> None:
        self.trajs: list[SingleTraj] = []
        #: Path of the ensemble HDF5 this object is backed by (set by
        #: from_dataset/save); enables lazy, out-of-core batch_iterator
        self._source_h5: Optional[str] = None
        if isinstance(tops, (str, Path)):
            # one topology file shared by all members (reference
            # info_all.py accepts a bare str/Path for `tops`)
            tops = [tops]
        if tops is not None and len(tops) not in (1, len(trajs)):
            raise ValueError("tops must have length 1 or len(trajs)")
        for i, t in enumerate(trajs):
            if isinstance(t, SingleTraj):
                if t.traj_num is not None and t.traj_num != i:
                    # renumbering would mutate a traj that may belong to
                    # another ensemble (e.g. ens + ens self-addition) —
                    # renumber a shallow copy instead
                    t = t._shallow_copy()
                t.traj_num = i
                self.trajs.append(t)
            else:
                top = None
                if tops is not None:
                    top = tops[0] if len(tops) == 1 else tops[i]
                cs = ""
                if common_str:
                    matches = [c for c in common_str if c in str(t)]
                    cs = max(matches, key=len) if matches else ""
                self.trajs.append(
                    SingleTraj(t, top, traj_num=i, common_str=cs,
                               basename_fn=basename_fn)
                )

    @classmethod
    def from_dataset(cls, path: Union[str, Path]) -> "TrajEnsemble":
        """Rebuild an ensemble from one HDF5 file written by :meth:`save`
        (per-traj groups with coordinates, topology JSON, and CVs) —
        reference ``info_all.py:1185``.

        Note:
            Member coordinates and per-traj CVs are materialized eagerly
            (convenient for analysis-sized ensembles). For datasets too
            large for RAM, skip this constructor: build the model with
            :meth:`AngleDihedralCartesianEncoderMap.from_ensemble_h5`
            (reads a tiny prototype) and train with
            ``train_streaming(path)`` / iterate with the file-backed
            ``batch_iterator`` — both stream from disk."""
        import h5py

        out = []
        with h5py.File(path, "r") as f:
            names = sorted(
                (k for k in f if k.startswith("traj_")),
                key=lambda k: int(k.split("_")[1]),
            )
            for name in names:
                g = f[name]
                from .mdtraj_h5 import topology_from_json

                t = SingleTraj(
                    str(path), str(path),
                    traj_num=int(name.split("_")[1]),
                    common_str=g.attrs.get("common_str", ""),
                )
                t._top = topology_from_json(g["topology"][0].decode())
                if "custom_topology" in g.attrs:
                    from .custom_topology import CustomTopology

                    t._top = CustomTopology.from_json(
                        t._top, g.attrs["custom_topology"]
                    ).apply()
                t._xyz = g["coordinates"][:]
                t._materialized = True
                t._time = g["time"][:]
                t._unitcell = (
                    g["cell_vectors"][:] if "cell_vectors" in g else None
                )
                t._n_frames_file = len(t._xyz)
                t.index = None
                if "CVs" in g:
                    t._CVs = CVCollection.from_hdf5(path, group=f"{name}/CVs")
                out.append(t)
        ens = cls(out)
        ens._source_h5 = str(path)
        return ens

    # ------------------------------------------------------------------ basic
    @property
    def n_trajs(self) -> int:
        return len(self.trajs)

    @property
    def n_frames(self) -> int:
        return sum(t.n_frames for t in self.trajs)

    @property
    def common_str(self) -> list[str]:
        return sorted({t.common_str for t in self.trajs})

    # -------------------------------------------------- reference conveniences
    @property
    def basenames(self) -> list[str]:
        """Basenames of the member trajs (reference ``info_all.py:1516``)."""
        return [t.basename for t in self.trajs]

    @property
    def traj_nums(self) -> list[int]:
        return [t.traj_num for t in self.trajs]

    @property
    def traj_files(self) -> list[str]:
        return [t.traj_file for t in self.trajs]

    @property
    def locations(self) -> list[str]:
        """Duplication of :attr:`traj_files` (reference
        ``info_all.py:1818-1822``)."""
        return [t.traj_file for t in self.trajs]

    @property
    def top_files(self) -> list[str]:
        """Minimal (deduplicated, order-preserving) set of topology files
        (reference ``info_all.py:1250-1260``)."""
        return list(dict.fromkeys(t.top_file for t in self.trajs))

    @property
    def top(self) -> list:
        """Minimal set of member topologies — length 1 when all trajs share
        one (reference ``info_all.py:1342-1356``)."""
        out = []
        for t in self.trajs:
            if t.top not in out:
                out.append(t.top)
        return out

    @property
    def n_residues(self) -> list[int]:
        """Per-traj residue counts (reference ``info_all.py:1511-1513``)."""
        return [t.n_residues for t in self.trajs]

    @property
    def frames(self) -> list[int]:
        """Per-traj frame counts (reference ``info_all.py:1855-1857``)."""
        return [t.n_frames for t in self.trajs]

    @property
    def index_arr(self) -> np.ndarray:
        """``(n_frames, 2)`` array of [traj_num, frame] identifiers —
        identical to :attr:`id` (reference ``info_all.py:1825-1835``)."""
        return self.id

    @property
    def name_arr(self) -> np.ndarray:
        """Member basename repeated per frame, length ``n_frames``
        (reference ``info_all.py:1838-1848``)."""
        out: list[str] = []
        for t in self.trajs:
            out.extend([t.basename] * t.n_frames)
        return np.array(out)

    @property
    def xyz(self) -> np.ndarray:
        """All coordinates stacked along frames — requires every member to
        share the atom count (reference accesses via mdtraj the same way)."""
        n_at = {t.n_atoms for t in self.trajs}
        if len(n_at) > 1:
            raise ValueError(
                f"members have different atom counts {sorted(n_at)}; "
                f"a stacked xyz is only defined for homogeneous ensembles"
            )
        return np.concatenate([t.xyz for t in self.trajs], axis=0)

    @property
    def CVs_in_file(self) -> bool:
        """True when every member can load CVs from its file (reference
        ``info_all.py:1860-1864``)."""
        return bool(self.trajs) and all(t.CVs_in_file for t in self.trajs)

    @classmethod
    def _from_members(cls, members: Sequence[SingleTraj]) -> "TrajEnsemble":
        """Sub-ensemble over shallow copies that PRESERVES each member's
        traj_num (the public constructor renumbers 0..n-1; grouping views
        must keep parent provenance so ``id``/``trajs_by_traj_num`` still
        refer to the parent's numbering)."""
        out = cls.__new__(cls)
        out.trajs = [m._shallow_copy() for m in members]
        out._source_h5 = None
        return out

    @property
    def trajs_by_top(self) -> dict:
        """Member trajs grouped into sub-ensembles by topology — value
        equality, so independently parsed copies of one topology file land
        in one group (reference ``info_all.py:1363-1376``). Sub-ensembles
        keep the parent's traj_nums."""
        groups: list[tuple] = []  # (top, members); list keeps insert order
        for t in self.trajs:
            for top, members in groups:
                if top == t.top:
                    members.append(t)
                    break
            else:
                groups.append((t.top, [t]))
        return {top: TrajEnsemble._from_members(members)
                for top, members in groups}

    @property
    def trajs_by_common_str(self) -> dict:
        """Member trajs grouped by common_str (reference
        ``info_all.py:1379-1391``); sub-ensembles keep the parent's
        traj_nums."""
        groups: dict[str, list] = {}
        for t in self.trajs:
            groups.setdefault(t.common_str, []).append(t)
        return {cs: TrajEnsemble._from_members(members)
                for cs, members in groups.items()}

    @property
    def trajs_by_traj_num(self) -> dict[int, SingleTraj]:
        return {t.traj_num: t for t in self.trajs}

    @property
    def tsel(self) -> _TrajSelector:
        """Select members by traj_num instead of list position (reference
        ``TrajEnsembleTsel``, ``info_all.py:757-790``): after grouping or
        renumbering, ``trajs.tsel[2]`` is the member whose traj_num is 2."""
        return _TrajSelector(self)

    def sidechain_info(self) -> dict[int, int]:
        """Sidechain-dihedral counts of the FIRST topology — the ensemble
        must agree for ADC training (reference ``info_all.py:1393``)."""
        return self.trajs[0].top.sidechain_info()

    @property
    def traj_joined(self) -> SingleTraj:
        """All members' frames as ONE trajectory over the first member's
        topology — requires a homogeneous atom count (reference
        ``info_all.py:1932``, used for rendering/clustering whole
        ensembles)."""
        base = self.trajs[0]
        out = base._shallow_copy()
        out._CVs = CVCollection()
        out._xyz = self.xyz  # validates homogeneous atom counts
        out._materialized = True
        out._time = np.concatenate([t.time for t in self.trajs])
        cells = [t.unitcell_vectors for t in self.trajs]
        out._unitcell = (
            np.concatenate(cells, axis=0)
            if all(c is not None for c in cells) else None
        )
        out._n_frames_file = len(out._xyz)
        out.index = None
        return out

    @property
    def featurizer(self):
        """A cached :class:`EnsembleFeaturizer` over this ensemble
        (reference ``info_all.py:1242-1248``)."""
        if not hasattr(self, "_featurizer"):
            from ..loading.featurizer import EnsembleFeaturizer

            self._featurizer = EnsembleFeaturizer(self)
        return self._featurizer

    def del_featurizer(self) -> None:
        """Drop the cached featurizer (reference ``info_all.py:1237``)."""
        if hasattr(self, "_featurizer"):
            del self._featurizer

    def unload(self) -> None:
        """Free every member's cached coordinates (reference
        ``info_all.py:2804``); materialized members are left intact."""
        for t in self.trajs:
            t.unload()

    def itertrajs(self) -> Iterator[tuple[int, SingleTraj]]:
        """Yield ``(traj_num, traj)`` (reference ``info_all.py:3156``)."""
        for t in self.trajs:
            yield t.traj_num, t

    def iterframes(self) -> Iterator[tuple[int, int, SingleTraj]]:
        """Yield ``(traj_num, frame_num, 1-frame-traj)`` over all members
        (reference ``info_all.py:3181``)."""
        for t in self.trajs:
            yield from t.iterframes(with_traj_num=True)

    def copy(self) -> "TrajEnsemble":
        import copy as _copy

        return _copy.deepcopy(self)

    def del_CVs(self, CVs: Optional[Sequence[str]] = None) -> None:
        """Drop all (or the named) CVs from every member; files untouched
        (reference ``info_all.py:1622-1635``)."""
        # the backing h5 still holds the old CVs: streaming them from
        # batch_iterator after a delete would resurrect deleted data
        self._source_h5 = None
        if CVs is None:
            for t in self.trajs:
                t.del_CVs()
            return
        if isinstance(CVs, str):
            CVs = [CVs]
        for t in self.trajs:
            for name in CVs:
                t._CVs._entries.pop(name, None)

    def save_CVs(self, path: Union[str, Path]) -> None:
        """Save every member's CVs to one HDF5 file under per-traj groups
        (the h5 analog of the reference's NETCDF ``save_CVs``,
        ``info_all.py:1995-1997``; readable back via
        ``CVCollection.from_hdf5(path, group="traj_N/CVs")``)."""
        for t in self.trajs:
            t._CVs.to_hdf5(path, group=f"traj_{t.traj_num}/CVs")

    @classmethod
    def with_overwrite_trajnums(cls, *trajs) -> "TrajEnsemble":
        """Build an ensemble from trajs and/or ensembles, renumbering
        copies to traj_num = 0, 1, 2, ... (reference
        ``info_all.py:1077-1118``)."""
        members = []
        for t in trajs:
            if isinstance(t, TrajEnsemble):
                members.extend(m._shallow_copy() for m in t)
            else:
                members.append(t._shallow_copy())
        for i, m in enumerate(members):
            m.traj_num = i
        return cls(members)

    @classmethod
    def from_textfile(cls, fname: Union[str, Path],
                      basename_fn=None) -> "TrajEnsemble":
        """Build an ensemble from a space-separated textfile with 2-3
        columns: traj_file top_file [common_str] (reference
        ``info_all.py:1120-1160``)."""
        traj_files, top_files, common_strs = [], [], []
        for line in Path(fname).read_text().splitlines():
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if len(parts) < 2:
                raise ValueError(
                    f"each line needs 'traj_file top_file [common_str]', "
                    f"got {line!r}"
                )
            traj_files.append(parts[0])
            top_files.append(parts[1])
            common_strs.append(parts[2] if len(parts) > 2 else "")
        out = cls(traj_files, top_files,
                  common_str=[c for c in common_strs if c] or None)
        for t, cs in zip(out.trajs, common_strs):
            t.common_str = cs
            if basename_fn is not None:
                t.basename_fn = basename_fn
        return out

    def to_alignment_query(self) -> str:
        """FASTA-formatted sequences, one record per (common_str, chain),
        for pasting into alignment software (the reference's
        ``to_alignment_query``, ``info_all.py:1530-1558`` — whose loop
        drops its records; this returns what it evidently intends)."""
        out = ""
        for cs, trajs in self.trajs_by_common_str.items():
            tops = trajs.top
            if len(tops) != 1:
                raise ValueError(
                    f"common_str {cs!r} maps to {len(tops)} topologies; "
                    f"regroup the ensemble so each common_str has one"
                )
            for j, seq in enumerate(tops[0].to_fasta()):
                out += f">{cs or trajs.trajs[0].basename}_{j}\n{seq}\n"
        return out

    def dash_summary(self):
        """A :obj:`pandas.DataFrame` summarizing this ensemble (reference
        ``info_all.py:2362-2412``; single-member ensembles delegate to the
        member's summary)."""
        import pandas as pd

        if self.n_trajs == 1:
            return self.trajs[0].dash_summary()
        n_atoms = np.unique([t.n_atoms for t in self.trajs])
        if len(n_atoms) == 1:
            n_atoms = n_atoms[0]
        dt: list = []
        for t in self.trajs:
            t.load()
            dt.extend(np.unique(t.time[1:] - t.time[:-1]))
        dt = np.unique(np.asarray(dt))
        if len(dt) == 1:
            dt = dt[0]
        elif len(dt) == 0:
            dt = "single frames"
        return pd.DataFrame(
            {
                "field": ["n_trajs", "n_frames", "n_atoms", "dt (ps)",
                          "trajs", "multiple tops", "common_str"],
                "value": [self.n_trajs, self.n_frames, n_atoms, dt,
                          [t.basename for t in self.trajs],
                          len({t.top for t in self.trajs}) != 1,
                          list(set(self.common_str))],
            }
        ).astype(str)

    def to_dataframe(self, CV: Union[str, Sequence[str]]):
        """One row per frame with traj provenance + the named CV columns
        (labeled by ``describe()`` labels when available; reference
        ``info_all.py:2309-2380``)."""
        import pandas as pd

        cols = {
            "traj_file": [t.traj_file for t in self for _ in range(t.n_frames)],
            "top_file": [t.top_file for t in self for _ in range(t.n_frames)],
            "traj_num": np.repeat(self.traj_nums, self.frames),
            "frame_num": self.id[:, 1] if self.id.ndim == 2 else self.id,
            "time": np.concatenate([t.time for t in self.trajs]),
        }
        names = [CV] if isinstance(CV, str) else list(CV)
        for name in names:
            data = np.concatenate(
                [np.asarray(t.CVs[name]).reshape(t.n_frames, -1)
                 for t in self.trajs], axis=0,
            )
            labels = None
            e = self.trajs[0]._CVs
            if name in e and e.entry(name).labels:
                labels = e.entry(name).labels
            if labels is None or len(labels) != data.shape[1]:
                labels = ([name] if data.shape[1] == 1 else
                          [f"{name} {k}" for k in range(data.shape[1])])
            for k, lbl in enumerate(labels):
                cols[lbl] = data[:, k]
        return pd.DataFrame(cols)

    def __iter__(self) -> Iterator[SingleTraj]:
        return iter(self.trajs)

    def __len__(self) -> int:
        return self.n_trajs

    def __eq__(self, other: object) -> bool:
        """Value equality: same member files and frame identifiers
        (reference ``info_all.py:3272-3292``)."""
        if not isinstance(other, TrajEnsemble):
            return NotImplemented
        if len(self) != len(other):
            return False
        if [t.traj_file for t in self.trajs] != [
            t.traj_file for t in other.trajs
        ]:
            return False
        return np.array_equal(self.id, other.id)

    def __getitem__(self, item):
        if isinstance(item, int):
            return self.trajs[item]
        if isinstance(item, slice):
            return TrajEnsemble(self.trajs[item])
        item = np.asarray(item)
        if item.ndim == 2 and item.shape[1] == 2:
            # (traj, frame) pair array -> frame-indexed sub-ensemble
            out = []
            for tn in np.unique(item[:, 0]):
                frames = item[item[:, 0] == tn, 1]
                out.append(self.trajs[int(tn)][frames])
            return TrajEnsemble(out)
        return TrajEnsemble([self.trajs[int(i)] for i in item])

    # ------------------------------------------------------------------ CVs
    @property
    def CVs(self) -> dict[str, np.ndarray]:
        """CVs stacked along frames across trajs (only keys every traj has)."""
        if not self.trajs:
            return {}
        common = set(self.trajs[0]._CVs.keys())
        for t in self.trajs[1:]:
            common &= set(t._CVs.keys())
        out = {}
        for k in sorted(common):
            arrays = [t._CVs[k] for t in self.trajs]
            widths = {a.shape[1:] for a in arrays}
            if len(widths) > 1:
                arrays = _nan_pad(arrays)
            out[k] = np.concatenate(arrays, axis=0)
        return out

    def __getattr__(self, name: str):
        # ensemble-stacked CV access as attributes, like the reference's
        # `trajs.y_coordinate` (info_all.py __getattr__) — stacks ONLY the
        # requested CV, not the whole .CVs dict
        if name.startswith("_") or name == "trajs":
            raise AttributeError(name)
        trajs = self.__dict__.get("trajs")
        if trajs and all(name in t._CVs for t in trajs):
            arrays = [t._CVs[name] for t in trajs]
            if len({a.shape[1:] for a in arrays}) > 1:
                arrays = _nan_pad(arrays)
            return np.concatenate(arrays, axis=0)
        raise AttributeError(name)

    def load_trajs(self) -> None:
        """Force-load every member's coordinates (the reference's explicit
        backend switch, ``info_all.py:load_trajs``)."""
        for t in self.trajs:
            t.load()

    def load_CVs(
        self,
        data: Any = None,
        attr_name: Optional[str] = None,
        cols: Optional[list] = None,
        deg: Optional[bool] = None,
        periodic: bool = True,
        labels: Optional[list[str]] = None,
        directory: Optional[Union[str, Path]] = None,
        ensemble: bool = False,
        override: bool = False,
        custom_aas: Any = None,
        alignment: Optional[str] = None,
        device=None,
    ) -> None:
        """Featurize all trajectories, or attach precomputed values.

        Accepts feature-name shortcuts, a raw array shaped
        ``(n_trajs, n_frames, ...)`` or flat ``(n_frames, ...)`` (split
        across members by ``index_arr``), a list of per-traj arrays or of
        per-traj CV files (both need ``attr_name``), matching the
        reference's dispatch (``info_all.py:2414``,
        ``trajinfo_utils.py:1950-2355``). With ``ensemble=True`` mixed
        topologies get NaN-padded feature alignment via generic labels
        (reference: ``trajinfo_utils.py:2357-2415``). ``custom_aas``
        patches every member's topology first; ``alignment`` feeds a
        CLUSTAL W alignment into ensemble label matching; ``data=None``
        applies this ensemble's recorded :attr:`featurizer`, or loads
        basename-matched files from ``directory``. Features run on
        ``device`` (the card unless ``device="cpu"``)."""
        # in-memory CVs are about to change: a previously-saved backing h5
        # would now be stale, so stop lazy batch_iterator from serving it
        self._source_h5 = None
        from pathlib import Path as _Path

        if custom_aas is not None:
            self.load_custom_topology(custom_aas)
        if alignment is not None:
            if ensemble:
                self.parse_clustal_w_alignment(alignment)
            else:
                print(
                    "Providing a CLUSTAL W alignment for featurization of "
                    "ensembles of protein families makes only sense when "
                    "`ensemble` is also set to True."
                )
        if data is None:
            if directory is not None:
                return self.load_CVs_from_dir(directory, attr_name=attr_name)
            data = self.featurizer
        if isinstance(data, _Path):
            data = str(data)
        if isinstance(data, str) and data.endswith(".nc"):
            # xarray/netCDF datasets like the reference writes (NetCDF4 is
            # HDF5-based, so h5py reads it without the netCDF4 package)
            import h5py

            with h5py.File(data, "r") as f:
                n_trajs = len(self.trajs)
                for name, dset in f.items():
                    if (getattr(dset, "ndim", 0) >= 2
                            and dset.shape[0] == n_trajs):
                        arr = np.asarray(dset)
                        for traj, part in zip(self.trajs, arr):
                            part = part[: traj.n_frames]
                            traj.load_CV(
                                np.asarray(part, np.float32), attr_name=name
                            )
            return
        if isinstance(data, str):
            # feature-name shortcuts win over a same-named directory in
            # CWD (reference checks 'all' before is_dir,
            # trajinfo_utils.py:2042 vs :2072)
            from ..loading.features import ADC_FEATURES

            if (
                data not in ("all", "full")
                and data not in ADC_FEATURES
                and Path(data).is_dir()
            ):
                return self.load_CVs_from_dir(data, attr_name=attr_name)
        if isinstance(data, str):
            data = [data]
        if isinstance(data, (list, tuple)) and all(
                isinstance(d, str) for d in data):
            from ..loading.features import ADC_FEATURES

            # a list of per-traj CV FILES with one consistent suffix
            # (trajinfo_utils.py:2196-2227): anything that LOOKS like a
            # file path (has a suffix or a separator) routes here so a
            # typo'd filename raises FileNotFoundError instead of
            # "unknown feature shortcut"
            looks_like_files = data and all(
                d not in ("all", "full") and d not in ADC_FEATURES
                and (Path(d).suffix or "/" in str(d)) for d in data
            )
            if looks_like_files:
                missing = [d for d in data if not Path(d).is_file()]
                if missing:
                    raise FileNotFoundError(
                        f"CV file(s) not found: {missing}"
                    )
                if len(data) != len(self.trajs):
                    raise ValueError(
                        f"{len(data)} CV files != {len(self.trajs)} trajs"
                    )
                suffixes = {Path(d).suffix for d in data}
                if len(suffixes) != 1:
                    raise Exception(
                        f"Please provide a list with consistent file "
                        f"extensions and not a mish-mash, like: {suffixes}"
                    )
                for traj, f in zip(self.trajs, data):
                    traj.load_CV(str(f), attr_name=attr_name, cols=cols,
                                 deg=deg, labels=labels, override=override)
                return
            from ..loading.featurizer import EnsembleFeaturizer

            feat = EnsembleFeaturizer(self, device=device)
            for name in data:
                feat.add_list_of_feats(
                    name if name in ("all", "full") else [name],
                    periodic=periodic, deg=bool(deg),
                )
            feat.apply(ensemble=ensemble)
            return
        if isinstance(data, (list, tuple)) and len(data) == len(self.trajs):
            assert attr_name is not None, "attr_name required for raw arrays"
            for traj, arr in zip(self.trajs, data):
                traj.load_CV(np.asarray(arr, dtype=np.float32),
                             attr_name=attr_name, cols=cols, deg=deg,
                             labels=labels, override=override)
            return
        if isinstance(data, np.ndarray):
            assert attr_name is not None, "attr_name required for raw arrays"
            if len(data) == self.n_frames and len(data) != len(self.trajs):
                # a flat per-frame array: split across members by
                # index_arr (trajinfo_utils.py:2245-2266)
                idx = self.index_arr
                data = [
                    data[np.where(idx[:, 0] == t.traj_num)[0]]
                    for t in self.trajs
                ]
            elif len(data) != len(self.trajs):
                raise ValueError(
                    f"leading dim {len(data)} != n_trajs {len(self.trajs)} "
                    f"and != n_frames {self.n_frames}"
                )
            for traj, arr in zip(self.trajs, data):
                traj.load_CV(np.asarray(arr), attr_name=attr_name, cols=cols,
                             deg=deg, labels=labels, override=override)
            return
        # a pre-built EnsembleFeaturizer with recorded add_* calls
        # (reference trajinfo_utils.py:2129-2174 accepts Featurizer objects)
        from ..loading.featurizer import EnsembleFeaturizer

        if isinstance(data, EnsembleFeaturizer):
            if device is not None:
                data.device = device
            data.apply(ensemble=ensemble)
            return
        # a single Feature instance, executed per trajectory (reference
        # trajinfo_utils.py:1638-2447 accepts Feature objects); with
        # ensemble=True the outputs are NaN-aligned like named features
        if hasattr(data, "transform") and hasattr(data, "describe"):
            feat = EnsembleFeaturizer(self, device=device)
            feat.add_custom_feature(data)
            feat.apply(ensemble=ensemble)
            return
        raise TypeError(f"cannot load CVs from {type(data)}")

    def load_CVs_from_dir(
        self, directory: Union[str, Path], attr_name: Optional[str] = None
    ) -> None:
        """Load one ``.npy``/``.txt`` CV file per member trajectory from a
        directory, matched by basename substring (the reference's
        ``load_CVs_from_dir``, ``trajinfo_utils.py:2418-2447``; also
        reachable as ``load_CVs(directory)``). ``.npy`` files win over
        ``.txt`` when both match a trajectory."""
        directory = Path(directory)
        files = [p for p in sorted(directory.iterdir()) if p.is_file()]
        for traj in self.trajs:
            hits = [p for p in files if traj.basename in p.name
                    and p.suffix in (".npy", ".txt")]
            if not hits:
                raise FileNotFoundError(
                    f"No .npy/.txt file in {directory} matches trajectory "
                    f"basename {traj.basename!r}."
                )
            hits.sort(key=lambda p: (p.suffix != ".npy", p.name))
            traj.load_CV(str(hits[0]), attr_name=attr_name)

    def load_custom_topology(self, custom: Any) -> None:
        """Apply user residue definitions (unnatural AAs) to every member
        trajectory (reference ``TrajEnsemble.load_custom_topology``)."""
        for t in self.trajs:
            t.load_custom_topology(custom)

    @property
    def id(self) -> np.ndarray:
        """``(n_frames, 2)`` array of [traj_num, original_file_frame] for
        every frame of the concatenated ensemble — frame numbers are the
        ORIGINAL file indices (a subsampled ensemble reports e.g.
        0, 10, 20, ...), matching the reference's frame bookkeeping
        (``info_single.py:908``)."""
        if not self.trajs:
            return np.zeros((0, 2), np.int64)
        out = []
        for t in self.trajs:
            out.append(
                np.stack(
                    [np.full(t.n_frames, t.traj_num),
                     np.asarray(t._frame_index)],
                    axis=1,
                )
            )
        return np.concatenate(out, axis=0)

    def split_into_frames(self) -> "TrajEnsemble":
        """An ensemble of 1-frame trajectories, one per frame (reference
        ``info_all.py:1977``)."""
        return TrajEnsemble(
            [t[i] for t in self.trajs for i in range(t.n_frames)]
        )

    def subsample(self, stride: Optional[int] = None,
                  total: Optional[int] = None) -> "TrajEnsemble":
        """Sub-sampled ensemble: every ``stride``-th frame of each member
        trajectory independently, or ``total`` evenly spaced frames over
        the concatenated ensemble (reference ``info_all.py:2701``)."""
        if stride is not None and total is None:
            return TrajEnsemble(
                [t[slice(None, None, stride)] for t in self.trajs]
            )
        if total is not None and stride is None:
            idx = np.unique(
                np.round(np.linspace(0, self.n_frames - 1, total)).astype(int)
            )
            bounds = np.cumsum([0] + [t.n_frames for t in self.trajs])
            parts = []
            for ti, t in enumerate(self.trajs):
                local = idx[(idx >= bounds[ti]) & (idx < bounds[ti + 1])]
                if len(local):
                    parts.append(t[local - bounds[ti]])
            return TrajEnsemble(parts)
        raise ValueError("Provide either stride or total (exactly one).")

    def get_single_frame(self, key: int) -> SingleTraj:
        """Frame ``key`` of the concatenated ensemble as a 1-frame traj
        (reference ``info_all.py:2753``)."""
        bounds = np.cumsum([0] + [t.n_frames for t in self.trajs])
        if not 0 <= key < bounds[-1]:
            raise IndexError(
                f"frame {key} out of range for {bounds[-1]}-frame ensemble"
            )
        ti = int(np.searchsorted(bounds, key, side="right")) - 1
        return self.trajs[ti][int(key - bounds[ti])]

    def __add__(self, y: "TrajEnsemble") -> "TrajEnsemble":
        """Concatenate two ensembles along the trajectory axis (reference
        ``info_all.py:3315``). Every member is shallow-copied so the sum
        shares coordinate data with, but never mutates, the operands
        (renumbering or loading CVs on the sum leaves them untouched)."""
        if not getattr(y, "trajs", None):
            raise ValueError(f"{y} contains no trajectories")
        return TrajEnsemble(
            [t._shallow_copy() for t in list(self.trajs) + list(y.trajs)]
        )

    # ------------------------------------------------------------------ batching
    #: the reference's default CV set for the batch iterator
    #: (``info_all.py:2950-2958``)
    _BATCH_ITER_DEFAULT_CVS = (
        "central_angles",
        "central_dihedrals",
        "central_cartesians",
        "central_distances",
        "side_dihedrals",
    )

    def batch_iterator(
        self,
        batch_size: int,
        replace: bool = False,
        CV_names: Optional[Sequence[str]] = None,
        deterministic: bool = False,
        yield_index: bool = False,
        start: int = 1,
        seed: Optional[int] = None,
        lazy: Union[bool, str, Path, None] = None,
    ) -> Iterator[Any]:
        """Infinite random-batch iterator over the ensemble's CVs,
        replacing the reference's lazy HDF5 iterator + `tf.data` pipeline
        (``info_all.py:2815-3078``; same signature plus the extras
        ``seed``/``lazy``).

        ``CV_names=None`` uses the 5 ADC training arrays; a single name
        yields bare arrays instead of 1-tuples. ``replace=False`` keeps
        samples unique within a batch (raises like the reference when the
        ensemble is too small). ``deterministic=True`` (or ``seed``) makes
        the stream reproducible, with ``start`` selecting among
        deterministic datasets. ``yield_index=True`` yields
        ``(index, batch)`` with ``index`` the ``(batch, 2)``
        [traj_num, frame_num] rows of :attr:`id`. Frames whose row is
        all-NaN for any requested CV (ragged ensembles) are skipped.

        When the ensemble is backed by an on-disk HDF5 file (after
        :meth:`save`, or built by ``from_dataset``), batches are sampled
        straight from the file through slab reads
        (``train/core.py::HDF5BatchSource``) and the stacked CV arrays are
        never built in memory, the reference's out-of-core design
        (``info_all.py:2870-3078``). Pass ``lazy=False`` to iterate in
        memory, or ``lazy=<path>`` to stream from a given ensemble h5. A
        file that is gone (or lacks the CVs) falls back to memory.
        """
        if CV_names is None:
            CV_names = list(self._BATCH_ITER_DEFAULT_CVS)
        single = len(CV_names) == 1
        if seed is None and deterministic:
            seed = start
        path = (str(lazy) if isinstance(lazy, (str, Path))
                else (self._source_h5 if lazy is not False else None))
        if path is not None:
            src = None
            try:
                from ..train.core import HDF5BatchSource

                # a resident slab of ~64k frames: one sequential read per
                # ~64k / batch_size batches; seed=None keeps OS entropy
                # like the in-memory path
                k = max(1, 65536 // max(1, batch_size))
                src = HDF5BatchSource(path, CV_names, batch_size, steps_per_scan=k,
                                      seed=seed, replace=replace, skip_all_nan=True)
            except (KeyError, OSError):
                # CVs not on disk, or the file moved or deleted: memory
                src = None
            if src is not None:
                ids = None
                if yield_index:
                    # the source concatenates traj_N groups sorted by
                    # traj_num; self.id follows the ensemble's list order
                    members = sorted(self.trajs, key=lambda t: t.traj_num or 0)
                    ids = np.concatenate([np.atleast_1d(t.id) for t in members], axis=0)
                return self._lazy_batches(src, single, yield_index, ids)
        cvs = self.CVs
        arrays = [cvs[name] for name in CV_names]
        ids = self.id
        n = len(arrays[0])
        # frames all-NaN for ANY requested CV can't train (ragged
        # ensembles); the reference re-draws them (info_all.py:3028-3046)
        valid = np.ones(n, bool)
        for a in arrays:
            if a.dtype.kind == "f":
                flat = a.reshape(n, -1)
                valid &= ~np.all(np.isnan(flat), axis=1)
        pool = np.where(valid)[0]
        if not replace and batch_size > len(pool):
            raise Exception(
                f"Can't find {batch_size} unique indices among "
                f"{len(pool)} valid frames. Pass replace=True."
            )
        rng = np.random.default_rng(seed)

        def gen():
            while True:
                idx = rng.choice(pool, batch_size, replace=replace)
                out = tuple(a[idx] for a in arrays)
                batch = out[0] if single else out
                yield (ids[idx], batch) if yield_index else batch

        return gen()

    @staticmethod
    def _lazy_batches(src, single: bool = False, yield_index: bool = False,
                      ids=None) -> Iterator[Any]:
        """Batches of an HDF5 source's superbatches, one step at a time;
        the file closes with the generator."""
        try:
            for superbatch in src:
                rows = src.last_indices if yield_index else None
                for i in range(superbatch[0].shape[0]):
                    out = tuple(a[i] for a in superbatch)
                    batch = out[0] if single else out
                    if yield_index:
                        yield ids[rows[i]], batch
                    else:
                        yield batch
        finally:
            src.close()

    def tf_dataset(
        self,
        batch_size: int,
        replace: bool = False,
        sidechains: bool = False,
        reconstruct_sidechains: bool = False,
        CV_names: Optional[Sequence[str]] = None,
        deterministic: bool = False,
        prefetch: bool = True,
        start: int = 1,
    ):
        """A ``tf.data.Dataset`` over :meth:`batch_iterator` batches — the
        reference's signature (``info_all.py:3080-3154``), for users whose
        downstream pipelines still consume tf.data. The framework's own
        trainers do NOT go through this (they sample on device /
        stream superbatches); it exists for migration interop and needs
        tensorflow importable. ``sidechains``/``reconstruct_sidechains``
        pick the reference's CV_names defaults; batches are dense float32
        (this framework's sparse story is masked-dense, so no
        SparseTensors are emitted)."""
        import tensorflow as tf

        if CV_names is None:
            if reconstruct_sidechains:
                CV_names = [
                    "central_angles", "central_dihedrals", "all_cartesians",
                    "central_distances", "side_angles", "side_dihedrals",
                    "side_distances",
                ]
            elif sidechains:
                CV_names = [
                    "central_angles", "central_dihedrals",
                    "central_cartesians", "central_distances",
                    "side_dihedrals",
                ]
            else:
                CV_names = [
                    "central_angles", "central_dihedrals",
                    "central_cartesians", "central_distances",
                ]
        # cheap key check (does NOT materialize lazy CV data)
        available = set(self.trajs[0]._CVs.keys())
        for t in self.trajs[1:]:
            available &= set(t._CVs.keys())
        for o in CV_names:
            assert o in available, (
                f"The CV '{o}' is not loaded in this ensemble."
            )

        kwargs = dict(
            batch_size=batch_size, replace=replace, CV_names=list(CV_names),
            deterministic=deterministic, start=start,
        )
        _spec_it = self.batch_iterator(**kwargs)
        try:
            sample = next(_spec_it)
        finally:
            # lazy sources hold the backing h5 open until generator close
            _spec_it.close()
        if isinstance(sample, tuple):
            specs = tuple(
                tf.TensorSpec(shape=s.shape, dtype="float32")
                for s in sample
            )
        else:
            specs = tf.TensorSpec(shape=sample.shape, dtype="float32")
        dataset = tf.data.Dataset.from_generator(
            lambda: self.batch_iterator(**kwargs), output_signature=specs
        )
        if prefetch:
            dataset = dataset.prefetch(batch_size * 4)
        if deterministic:
            options = tf.data.Options()
            options.deterministic = True
            dataset = dataset.with_options(options)
        return dataset

    # ------------------------------------------------------------------ analysis
    def cluster(
        self,
        cluster_id: Union[int, np.ndarray, Sequence, None] = None,
        col: str = "cluster_membership",
        memberships: Optional[np.ndarray] = None,
        n_points: int = -1,
    ) -> Union["TrajEnsemble", dict[int, "TrajEnsemble"]]:
        """Sub-ensembles by cluster membership over stacked frames
        (reference ``info_all.py:1999-2006``, same signature):
        ``cluster_id`` selects the frames whose loaded CV ``col`` (or the
        explicit ``memberships`` array) equals it; ``n_points`` evenly
        subsamples the cluster to that many frames (-1 keeps all).

        Convenience beyond the reference: passing a membership ARRAY as
        the first argument returns a dict of all sub-ensembles (noise
        label -1 skipped); an int + array is the explicit-memberships
        form."""
        if cluster_id is not None and not isinstance(
                cluster_id, (int, np.integer)):
            # legacy/convenience form: first arg is the membership array
            memberships, cluster_id = np.asarray(cluster_id), None
        if memberships is None:
            memberships = getattr(self, col)  # AttributeError when absent
        membership = np.asarray(memberships)
        assert len(membership) == self.n_frames
        bounds = np.cumsum([0] + [t.n_frames for t in self.trajs])

        def subset(cid: int) -> "TrajEnsemble":
            idx = np.where(membership == cid)[0]
            if n_points > 0 and len(idx) > n_points:
                sel = np.unique(
                    np.round(np.linspace(0, len(idx) - 1, n_points))
                    .astype(int)
                )
                idx = idx[sel]
            parts = []
            for ti, t in enumerate(self.trajs):
                local = idx[(idx >= bounds[ti]) & (idx < bounds[ti + 1])]
                if len(local):
                    parts.append(t[local - bounds[ti]])
            return TrajEnsemble(parts)

        if cluster_id is not None:
            return subset(int(cluster_id))
        return {
            int(c): subset(int(c)) for c in np.unique(membership) if c != -1
        }

    def join(self) -> list[SingleTraj]:
        """Concatenate trajs sharing a topology file into single trajs
        (reference ``info_all.py:2145``)."""
        groups: dict[str, list[SingleTraj]] = {}
        for t in self.trajs:
            groups.setdefault(t.top_file, []).append(t)
        out = []
        for top_file, members in groups.items():
            base = members[0]
            joined = SingleTraj(
                base.traj_file, top_file, traj_num=base.traj_num,
                common_str=base.common_str,
            )
            joined._top = base.top
            joined._xyz = np.concatenate([m.xyz for m in members], axis=0)
            joined._materialized = True
            joined._time = np.concatenate([m.time for m in members], axis=0)
            cells = [m.unitcell_vectors for m in members]
            # a vacuum member (box nulled at load) makes the ensemble
            # box-less — checking only cells[0] would crash concatenating
            joined._unitcell = (
                np.concatenate(cells, axis=0)
                if all(c is not None for c in cells) else None
            )
            joined._n_frames_file = len(joined._xyz)
            joined.index = None
            # joined CVs where all members carry them
            common = set(members[0]._CVs.keys())
            for m in members[1:]:
                common &= set(m._CVs.keys())
            for k in common:
                joined._CVs.add(
                    k,
                    np.concatenate([m._CVs[k] for m in members], axis=0),
                    members[0]._CVs.entry(k).labels,
                    attrs=members[0]._CVs.entry(k).attrs,
                )
            out.append(joined)
        return out

    def parse_clustal_w_alignment(self, aln: Union[str, Path]) -> None:
        """Attach a ClustalW multiple-sequence alignment (text or path);
        sequence names must match trajs' ``common_str`` or ``basename``.
        Ensemble featurization then aligns per-residue generic labels by
        alignment column (reference ``info_all.py:1560``)."""
        from ..loading.alignment import parse_clustal_w, residue_to_column_maps

        seqs = parse_clustal_w(aln)
        maps = residue_to_column_maps(seqs)
        for t in self.trajs:
            key = t.common_str if t.common_str in maps else t.basename
            if key not in maps:
                raise ValueError(
                    f"no alignment sequence for traj {t.basename!r} "
                    f"(have {sorted(maps)})"
                )
            if len(maps[key]) != t.n_residues:
                # reference asserts this (features.py:3172-3177) — a
                # same-named sequence from a different construct would
                # silently land every label on wrong-homolog columns
                raise ValueError(
                    f"alignment sequence {key!r} has {len(maps[key])} "
                    f"residues but traj {t.basename!r} has "
                    f"{t.n_residues}; cannot use this alignment"
                )
            t.clustal_w = maps[key]

    def stack(self) -> SingleTraj:
        """Stack trajs along the ATOM axis (same n_frames required) into one
        merged-topology traj (reference ``info_all.py:2145-2286``)."""
        n = {t.n_frames for t in self.trajs}
        assert len(n) == 1, f"stack() needs equal frame counts, got {n}"
        merged = Topology()
        xyzs = []
        chain_offset = 0
        for t in self.trajs:
            for res in t.top.residues:
                new_res = merged.add_residue(
                    res.name, res.resSeq, res.chain_index + chain_offset
                )
                for a in res.atoms:
                    merged.add_atom(a.name, a.element, new_res)
            chain_offset += t.top.n_chains
            xyzs.append(t.xyz)
        out = SingleTraj(self.trajs[0].traj_file, self.trajs[0].top_file)
        out._top = merged
        out._xyz = np.concatenate(xyzs, axis=1)
        out._materialized = True
        out._time = self.trajs[0].time
        out._unitcell = self.trajs[0].unitcell_vectors
        out._n_frames_file = len(out._xyz)
        out.index = None
        return out

    # ------------------------------------------------------------------ save
    def save(self, path: Union[str, Path],
             CVs: Union[str, list, bool] = "all",
             overwrite: bool = False,
             only_top: bool = False) -> None:
        """Save the ensemble into one multi-group ``.h5`` file.

        Args:
            CVs: ``"all"`` stores every loaded CV, a list of names stores
                only those, ``False`` stores none (reference
                ``info_all.py:2551-2640``).
            overwrite: an existing file raises ``IOError`` unless True.
            only_top: write only the topologies (no coordinates/CVs).
        """
        import h5py

        from .mdtraj_h5 import topology_to_json

        if Path(path).is_file() and not overwrite and not only_top:
            raise IOError(
                f"File {path} already exists. Set `overwrite` to True to "
                f"overwrite."
            )
        # Validate the CVs selection BEFORE the file is opened: mode "w"
        # truncates, and a typo'd name must neither destroy an existing
        # file nor leave some trajs' CV groups written and others not.
        if isinstance(CVs, (list, tuple)) and not only_top:
            for t in self.trajs:
                if not len(t._CVs):
                    continue
                for name in CVs:
                    if name not in t._CVs:
                        raise KeyError(
                            f"CV {name!r} is not loaded on traj "
                            f"{t.traj_num} (have: {sorted(t._CVs.keys())})"
                        )
        elif CVs not in ("all", False) and not only_top:
            raise ValueError(
                f"CVs must be 'all', False, or a list of CV names, "
                f"got {CVs!r}"
            )
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        # only_top bypasses the overwrite guard like the reference — which
        # is only safe because the reference APPENDS in that flow
        # (info_all.py:2599 opens mode "a"); truncating here would destroy
        # previously saved coordinates/CVs.
        mode = "a" if only_top else "w"
        with h5py.File(path, mode) as f:
            for t in self.trajs:
                g = f.require_group(f"traj_{t.traj_num}")
                if not only_top:
                    t.load()
                    g.create_dataset("coordinates", data=t.xyz)
                    g.create_dataset("time", data=t.time)
                    if t.unitcell_vectors is not None:
                        g.create_dataset("cell_vectors",
                                         data=t.unitcell_vectors)
                if "topology" in g:
                    del g["topology"]
                g.create_dataset(
                    "topology",
                    data=np.asarray(
                        [topology_to_json(
                            t.top, bonds=_bonds_for_save(t.top, t.xyz)
                        ).encode()]
                    ),
                )
                g.attrs["traj_file"] = t.traj_file
                g.attrs["common_str"] = t.common_str
                custom = getattr(t.top, "_custom_def_json", None)
                if custom is not None:
                    g.attrs["custom_topology"] = custom
        if only_top or CVs is False:
            return
        for t in self.trajs:
            if not len(t._CVs):
                continue
            store = t._CVs
            if isinstance(CVs, (list, tuple)):
                # names already validated before the file was truncated
                store = type(t._CVs)()
                for name in CVs:
                    e = t._CVs.entry(name)
                    store.add(name, e.data, e.labels, e.indices, e.attrs)
            store.to_hdf5(path, group=f"traj_{t.traj_num}/CVs")
        self._source_h5 = str(path)

    def __repr__(self) -> str:
        return (
            f"<TrajEnsemble: {self.n_trajs} trajs, common_str "
            f"{self.common_str}>"
        )


def _nan_pad(arrays: list[np.ndarray]) -> list[np.ndarray]:
    """Pad feature axes with NaN to the max width (ensemble alignment)."""
    max_shape = tuple(
        max(a.shape[i] for a in arrays) for i in range(1, arrays[0].ndim)
    )
    out = []
    for a in arrays:
        pad = [(0, 0)] + [
            (0, m - s) for m, s in zip(max_shape, a.shape[1:])
        ]
        out.append(np.pad(a, pad, constant_values=np.nan))
    return out
