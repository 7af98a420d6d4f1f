# encodermap_tpu_torch/loading/features.py
"""Feature classes: CV definitions computed from trajectory coordinates.

Re-designs the reference's feature zoo
(``encodermap/loading/features.py:410-4522``, itself derived from PyEMMA):
every feature is (static index tables computed on the host from the
topology) + (a PyTorch transform over coordinates on the featurizer's
device). The mdtraj C kernels the reference calls (``features.py:153-157``)
are replaced by the batched ops of ``encodermap_tpu_torch.ops.geometry``.

Counterpart of ``encodermap_tpu/loading/features.py``: the same classes,
labels and index tables (host numpy, built once per topology); each
``transform`` takes a ``(frames, atoms, 3)`` float32 tensor (and an
optional ``(frames, 3, 3)`` cell tensor) on any device and returns a tensor
on that device. ``CustomFeature`` stays host numpy, as in JAX.

Feature inventory (matching reference names):
    SelectionFeature, DistanceFeature, InverseDistanceFeature,
    ContactFeature, AngleFeature, DihedralFeature, BackboneTorsionFeature,
    ResidueMinDistanceFeature, GroupCOMFeature, ResidueCOMFeature,
    SideChainTorsions, MinRmsdFeature, AlignFeature,
    CentralDihedrals, SideChainDihedrals, AllCartesians, CentralCartesians,
    SideChainCartesians, AllBondDistances, CentralBondDistances,
    SideChainBondDistances, CentralAngles, SideChainAngles, CustomFeature.

Each feature exposes ``describe()`` (specific labels) and
``generic_describe()`` (topology-agnostic labels used for NaN-padded
ensemble alignment, reference ``features.py:3162-3238``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.topology import CHI_ATOMS, Topology
from ..ops import geometry as geom
from ..ops.kabsch import rmsd as rmsd_op

__all__ = [
    "Feature",
    "CustomFeature",
    "SelectionFeature",
    "DistanceFeature",
    "InverseDistanceFeature",
    "ContactFeature",
    "AngleFeature",
    "DihedralFeature",
    "BackboneTorsionFeature",
    "ResidueMinDistanceFeature",
    "GroupCOMFeature",
    "ResidueCOMFeature",
    "SideChainTorsions",
    "MinRmsdFeature",
    "AlignFeature",
    "CentralDihedrals",
    "SideChainDihedrals",
    "AllCartesians",
    "CentralCartesians",
    "SideChainCartesians",
    "AllBondDistances",
    "CentralBondDistances",
    "SideChainBondDistances",
    "CentralAngles",
    "SideChainAngles",
    "ADC_FEATURES",
    "pair",
    "unpair",
    "describe_last_feats",
]


def _take(xyz: torch.Tensor, idx) -> torch.Tensor:
    """``xyz[:, idx]`` with a host index table moved to ``xyz``'s device."""
    return xyz[:, torch.as_tensor(np.asarray(idx), device=xyz.device)]


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """A host array as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


class Feature:
    """Base feature: name, index table, labels, pure transform."""

    name: str = "Feature"
    #: whether values live in a periodic (angular) space
    periodic: bool = False
    #: True when transform() reads atoms ONLY through self._indices — the
    #: featurizer may then slice xyz down to the union of needed atoms and
    #: remap, slashing host->device transfer for solvated systems
    remappable: bool = False

    def __init__(self, top: Topology) -> None:
        self.top = top

    @property
    def indices(self) -> Optional[np.ndarray]:
        return getattr(self, "_indices", None)

    @property
    def indexes(self) -> Optional[np.ndarray]:
        """Reference-named alias of :attr:`indices` — the reference's
        features carry their atom-index table as ``.indexes``
        (``features.py:651-734``) and its xarray bridge assigns to it."""
        return self.indices

    @indexes.setter
    def indexes(self, val) -> None:
        self._indices = np.asarray(val)

    def remap(self, mapping: np.ndarray) -> Optional["Feature"]:
        """A shallow copy whose atom indices are translated through
        ``mapping`` (old index -> sliced-xyz index), or None when this
        feature cannot be remapped."""
        if not self.remappable or self.indices is None:
            return None
        import copy

        out = copy.copy(self)
        out._indices = np.asarray(mapping)[self._indices]
        return out

    def describe(self) -> list[str]:
        raise NotImplementedError

    def generic_describe(self) -> list[str]:
        return self.describe()

    @property
    def dimension(self) -> int:
        d = getattr(self, "_dim", None)
        return len(self.describe()) if d is None else d

    @dimension.setter
    def dimension(self, val) -> None:
        # the reference's dimension is settable (``features.py:485-487``);
        # CustomFeature subclasses assign it directly in __init__
        self._dim = int(val)

    def transform(self, xyz, unitcell=None):
        """(n_frames, n_atoms, 3) -> (n_frames, dimension) feature values."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__}: dim {self.dimension}>"

    def __eq__(self, other: object) -> bool:
        """Value equality so featurizers can refuse to add the same
        feature twice (reference ``features.py:489-536``): same class,
        same labels (which encode atom names/indices), same index table,
        same periodicity, same topology (Topology compares by value)."""
        if not isinstance(other, Feature):
            return NotImplemented
        if type(self) is not type(other):
            return False
        try:
            if self.describe() != other.describe():
                return False
        except Exception:
            return self is other
        a, b = self.indices, other.indices
        if (a is None) != (b is None):
            return False
        if a is not None and not np.array_equal(a, b):
            return False
        if getattr(self, "periodic", None) != getattr(other, "periodic",
                                                      None):
            return False
        # parameter attributes describe() may not encode (reference
        # checks the same set; `mic` is this framework's name for the
        # min-image flag on distance-family features)
        for attr in ("mic", "scheme", "threshold", "ignore_nonprotein",
                     "count_contacts", "deg", "mass_weighted"):
            if getattr(self, attr, None) != getattr(other, attr, None):
                return False
        # array-valued parameters describe() may not encode: the residue
        # pair table of count_contacts residue-mindist features (its label
        # is the same for every pair set) and AlignFeature's superposition
        # atom selections (reference features.py:520-522 compares these)
        for attr in ("contacts", "align_indices", "ref_align_indices"):
            va, vb = getattr(self, attr, None), getattr(other, attr, None)
            if (va is None) != (vb is None):
                return False
            if va is not None and not np.array_equal(
                    np.asarray(va), np.asarray(vb)):
                return False
        ra, rb = getattr(self, "ref", None), getattr(other, "ref", None)
        if (ra is None) != (rb is None):
            return False
        if ra is not None:
            ra, rb = np.asarray(ra), np.asarray(rb)
            # shape check first: np.allclose raises on non-broadcastable
            # refs (e.g. MinRmsd features over different topologies)
            if ra.shape != rb.shape or not np.allclose(ra, rb, rtol=1e-4):
                return False
        ga = getattr(self, "group_definitions", None)
        gb = getattr(other, "group_definitions", None)
        if (ga is None) != (gb is None):
            return False
        if ga is not None and (
            len(ga) != len(gb)
            or any(not np.array_equal(x, y) for x, y in zip(ga, gb))
        ):
            return False
        ta, tb = getattr(self, "top", None), getattr(other, "top", None)
        if (ta is None) != (tb is None):
            return False
        return ta is None or ta == tb

    def __hash__(self) -> int:
        try:
            return hash((type(self).__name__, tuple(self.describe())))
        except Exception:
            return object.__hash__(self)


class _TrajProxy:
    """What a CustomFeature's ``fun``/``call`` receives: duck-types the
    slice of the mdtraj.Trajectory surface the reference hands to user
    functions (``features.py:770-795``) — ``xyz``, ``top``/``topology``,
    ``n_atoms``, ``n_frames``, ``unitcell_vectors``."""

    def __init__(self, xyz: np.ndarray, top=None, unitcell=None) -> None:
        self.xyz = xyz
        self.top = top
        self.topology = top
        self.unitcell_vectors = unitcell

    @property
    def n_frames(self) -> int:
        return len(self.xyz)

    @property
    def n_atoms(self) -> int:
        return self.xyz.shape[1]


class CustomFeature(Feature):
    """Wraps a user function over host numpy coordinates (reference
    ``features.py:647-799``).

    ``fun`` is called as ``fun(traj, *fun_args, **fun_kwargs)`` where
    ``traj`` duck-types a trajectory (``.xyz``, ``.top``); subclasses may
    instead define ``call(traj)`` plus their own ``describe``/``name``.
    Because the function is arbitrary Python it runs on HOST, outside the
    device feature block — the featurizer splices its output back
    into feature order (``featurizer.py::make_feature_runner``)."""

    _is_custom = True
    #: host-side: excluded from the device block
    remappable = False

    def __init__(
        self,
        fun: Callable,
        dim: int,
        traj=None,
        description=None,
        fun_args: tuple = (),
        fun_kwargs: Optional[dict] = None,
    ) -> None:
        if dim <= 0:
            raise AssertionError("Feature dimensions need to be greater than 0.")
        self.id: Optional[int] = None
        self.traj = traj
        self.top = getattr(traj, "top", None)
        self._fun = fun
        self._args = tuple(fun_args)
        self._kwargs = dict(fun_kwargs or {})
        self._dim = int(dim)
        self.desc = description

    def describe(self) -> list[str]:
        if isinstance(self.desc, str):
            desc = [self.desc]
        elif self.desc is None:
            arg_str = (
                f"{self._args}, {self._kwargs}" if self._kwargs
                else f"{self._args}"
            )
            desc = [
                f"CustomFeature_{self.id} calling {self._fun} "
                f"with args {arg_str}"
            ]
        elif len(self.desc) not in (1, self._dim):
            raise ValueError(
                f"to avoid confusion, ensure the lengths of 'description' "
                f"list matches dimension - or give a single element which "
                f"will be repeated. Input was {self.desc}"
            )
        else:
            desc = list(self.desc)
        if len(desc) == 1 and self.dimension > 0:
            desc = desc * self.dimension
        return desc

    def transform(self, xyz, unitcell=None):
        if isinstance(xyz, torch.Tensor):
            xyz = xyz.detach().cpu().numpy()
        if isinstance(unitcell, torch.Tensor):
            unitcell = unitcell.detach().cpu().numpy()
        xyz = np.asarray(xyz)
        cell = None if unitcell is None else np.asarray(unitcell)
        top = self.top if self.top is not None else getattr(
            self.traj, "top", None)
        proxy = _TrajProxy(xyz, top, cell)
        if hasattr(self, "call"):
            out = self.call(proxy)
        else:
            out = self._fun(proxy, *self._args, **self._kwargs)
        if not isinstance(out, np.ndarray):
            raise ValueError("Your function should return a NumPy array!")
        if out.ndim == 1:
            # per-frame scalar features come back flat (reference test
            # ``test_add_custom_feature``: dim=1 fun returning (n,))
            out = out.reshape(len(out), -1)
        return out


# ----------------------------------------------------------------------------
# generic (PyEMMA-style) features
# ----------------------------------------------------------------------------


class SelectionFeature(Feature):
    """Flattened xyz of selected atoms (reference ``features.py:834``)."""

    name = "SelectionFeature"
    remappable = True

    def __init__(self, top: Topology, indexes: Sequence[int]) -> None:
        super().__init__(top)
        self._indices = np.asarray(indexes, np.int64)

    def describe(self) -> list[str]:
        out = []
        for i in self._indices:
            for ax in "XYZ":
                out.append(f"{ax} SELECTION ATOM {self.top.atom(int(i))} {i}")
        return out

    def transform(self, xyz, unitcell=None):
        sel = _take(xyz, self._indices)
        return sel.reshape(sel.shape[0], -1)


class DistanceFeature(Feature):
    """Distances between atom pairs (reference ``features.py:1490``)."""

    name = "DistanceFeature"
    remappable = True

    def __init__(self, top: Topology, pairs: Sequence, periodic: bool = True) -> None:
        super().__init__(top)
        self._indices = np.asarray(pairs, np.int64).reshape(-1, 2)
        self.mic = periodic

    def describe(self) -> list[str]:
        return [
            f"DIST: {self.top.atom(int(a))} - {self.top.atom(int(b))}"
            for a, b in self._indices
        ]

    def transform(self, xyz, unitcell=None):
        box = unitcell if self.mic else None
        return geom.compute_distances(xyz, self._indices, box)


class InverseDistanceFeature(DistanceFeature):
    """1/r of atom pairs (reference ``features.py:1763``)."""

    name = "InverseDistanceFeature"

    def describe(self) -> list[str]:
        return [
            f"INVDIST: {self.top.atom(int(a))} - {self.top.atom(int(b))}"
            for a, b in self._indices
        ]

    def transform(self, xyz, unitcell=None):
        return 1.0 / super().transform(xyz, unitcell)


class ContactFeature(DistanceFeature):
    """Binary contacts dist < threshold (reference ``features.py:1909``)."""

    name = "ContactFeature"

    def __init__(
        self, top: Topology, pairs: Sequence, threshold: float = 0.45,
        periodic: bool = True, count_contacts: bool = False,
    ) -> None:
        super().__init__(top, pairs, periodic)
        self.threshold = threshold
        self.count_contacts = count_contacts

    def describe(self) -> list[str]:
        if self.count_contacts:
            return ["CONTACT COUNT"]
        return [
            f"CONTACT: {self.top.atom(int(a))} - {self.top.atom(int(b))}"
            for a, b in self._indices
        ]

    def transform(self, xyz, unitcell=None):
        box = unitcell if self.mic else None
        c = geom.compute_contacts(xyz, self._indices, self.threshold, box)
        if self.count_contacts:
            return torch.sum(c, dim=1, keepdim=True)
        return c


class AngleFeature(Feature):
    """Angles over atom triplets (reference ``features.py:966``)."""

    name = "AngleFeature"
    remappable = True
    periodic = True

    def __init__(
        self, top: Topology, indexes: Sequence, deg: bool = False,
        cossin: bool = False, periodic: bool = True,
    ) -> None:
        super().__init__(top)
        if deg and cossin:
            raise ValueError(
                "deg=True cannot combine with cossin=True (cos/sin values "
                "are not angles; the reference forbids this too)"
            )
        self._indices = np.asarray(indexes, np.int64).reshape(-1, 3)
        self.deg = deg
        self.cossin = cossin
        self.mic = periodic

    def describe(self) -> list[str]:
        base = [
            f"ANGLE: {self.top.atom(int(a))} - {self.top.atom(int(b))} - "
            f"{self.top.atom(int(c))}"
            for a, b, c in self._indices
        ]
        if self.cossin:
            return [f"{f}({lbl})" for lbl in base for f in ("COS", "SIN")]
        return base

    def transform(self, xyz, unitcell=None):
        box = unitcell if self.mic else None
        ang = geom.compute_angles(xyz, self._indices, box)
        if self.cossin:
            ang = torch.stack([torch.cos(ang), torch.sin(ang)], -1).reshape(
                ang.shape[0], -1
            )
        if self.deg:
            ang = torch.rad2deg(ang)
        return ang


class DihedralFeature(Feature):
    """Dihedrals over atom quadruplets (reference ``features.py:1222``)."""

    name = "DihedralFeature"
    periodic = True
    remappable = True

    def __init__(
        self, top: Topology, dih_indexes: Sequence, deg: bool = False,
        cossin: bool = False, periodic: bool = True,
    ) -> None:
        super().__init__(top)
        if deg and cossin:
            raise ValueError(
                "deg=True cannot combine with cossin=True (cos/sin values "
                "are not angles; the reference forbids this too)"
            )
        self._indices = np.asarray(dih_indexes, np.int64).reshape(-1, 4)
        self.deg = deg
        self.cossin = cossin
        self.mic = periodic

    def describe(self) -> list[str]:
        base = [
            "DIH: " + " - ".join(str(self.top.atom(int(i))) for i in quad)
            for quad in self._indices
        ]
        if self.cossin:
            return [f"{f}({lbl})" for lbl in base for f in ("COS", "SIN")]
        return base

    def transform(self, xyz, unitcell=None):
        box = unitcell if self.mic else None
        dih = geom.compute_dihedrals(xyz, self._indices, box)
        if self.cossin:
            dih = torch.stack([torch.cos(dih), torch.sin(dih)], -1).reshape(
                dih.shape[0], -1
            )
        if self.deg:
            dih = torch.rad2deg(dih)
        return dih


class BackboneTorsionFeature(DihedralFeature):
    """phi+psi torsions (reference ``features.py:2116``)."""

    name = "BackboneTorsionFeature"

    def __init__(
        self, top: Topology, selstr: Optional[str] = None, deg: bool = False,
        cossin: bool = False, periodic: bool = True,
    ) -> None:
        phi = np.asarray(top.indices_phi, np.int64).reshape(-1, 4)
        psi = np.asarray(top.indices_psi, np.int64).reshape(-1, 4)
        self.selstr = selstr
        if selstr:
            # the reference keeps a torsion when its SECOND atom (phi: N_i,
            # psi: CA_i — both in residue i) is in the selection
            # (``features.py:2131-2143``)
            sel = np.asarray(top.select(selstr))
            phi = phi[np.isin(phi[:, 1], sel)]
            psi = psi[np.isin(psi[:, 1], sel)]
        # reference-EXACT interleave (``features.py:2145-2148``): plain
        # ``zip(phi, psi)``, so the k-th kept phi pairs with the k-th kept
        # psi — for a full chain that is (phi_2, psi_1, phi_3, psi_2, ...)
        # since phi starts at residue 2 and psi at residue 1. An
        # all-phi-then-all-psi stack (or a residue-sorted interleave) would
        # permute columns relative to reference-produced CVs. zip also
        # truncates to the shorter list, as the reference does.
        n = min(len(phi), len(psi))
        idx = (
            np.stack([phi[:n], psi[:n]], axis=1).reshape(-1, 4)
            if n else np.zeros((0, 4), np.int64)
        )
        super().__init__(top, idx, deg, cossin, periodic)

    def describe(self) -> list[str]:
        # reference label format (``features.py:2182-2221``):
        # "PHI <chain> <resname> <resSeq>" from the torsion's second atom
        def lbl(q) -> str:
            r = self.top.atom(int(q[1])).residue
            return f"{r.chain_index} {r.name} {r.resSeq}"

        kinds = ("PHI", "PSI")
        base = [
            f"{kinds[i % 2]} {lbl(q)}" for i, q in enumerate(self._indices)
        ]
        if self.cossin:
            return [f"{f}({s})" for s in base for f in ("COS", "SIN")]
        return base


class ResidueMinDistanceFeature(Feature):
    """Min distance between residue pairs (reference ``features.py:2223``).

    ``contacts="all"`` resolves to every residue pair at least 3 apart in
    sequence (mdtraj ``compute_contacts`` convention the reference rides),
    restricted to protein residues when ``ignore_nonprotein``.
    ``count_contacts`` collapses the output to a single per-frame count of
    pairs below ``threshold`` (reference ``features.py:2242-2255``).
    """

    name = "ResidueMinDistanceFeature"

    def __init__(
        self, top: Topology, contacts="all", scheme: str = "closest-heavy",
        threshold: Optional[float] = None, periodic: bool = True,
        ignore_nonprotein: bool = True, count_contacts: bool = False,
    ) -> None:
        super().__init__(top)
        if count_contacts and threshold is None:
            raise ValueError(
                "Cannot count contacts when no contact threshold is supplied."
            )
        if isinstance(contacts, str):
            if contacts != "all":
                raise ValueError(
                    f"residue_pairs must be 'all' or an (n, 2) array, "
                    f"got {contacts!r}"
                )
            # sequence separation >= 3 is measured on ORIGINAL residue
            # indices, non-protein filtering applied afterwards (mdtraj's
            # order of operations)
            keep = {
                r.index for r in top.residues
                if (r.is_protein or not ignore_nonprotein)
            }
            n_res = top.n_residues
            contacts = [
                (i, j)
                for i in range(n_res) for j in range(i + 3, n_res)
                if i in keep and j in keep
            ]
        if scheme not in ("closest", "closest-heavy", "ca",
                          "sidechain", "sidechain-heavy"):
            # a typo'd scheme must not silently fall back to all-atom
            # distances (mdtraj/the reference raise the same way)
            raise ValueError(
                f"scheme must be one of 'ca', 'closest', 'closest-heavy', "
                f"'sidechain', 'sidechain-heavy'; got {scheme!r}"
            )
        self.contacts = np.asarray(contacts, np.int64).reshape(-1, 2)
        self.scheme = scheme
        self.threshold = threshold
        self.count_contacts = count_contacts
        self.mic = periodic
        _BB = ("N", "CA", "C", "O", "H", "HA")

        def _atoms(res):
            atoms = list(res.atoms)
            if scheme.startswith("sidechain"):
                side = [a for a in atoms if a.name not in _BB]
                atoms = side or atoms  # GLY: fall back to whole residue
            if scheme.endswith("heavy"):
                atoms = [a for a in atoms if a.element != "H"]
            return atoms

        # per residue-pair: scheme-selected cross pairs, reduced by min
        self._pair_blocks = []
        for r0, r1 in self.contacts:
            a0 = [a.index for a in _atoms(top.residue(int(r0)))]
            a1 = [a.index for a in _atoms(top.residue(int(r1)))]
            if scheme == "ca":
                ca0 = top.residue(int(r0)).atom("CA")
                ca1 = top.residue(int(r1)).atom("CA")
                if ca0 is None or ca1 is None:
                    raise ValueError(
                        f"scheme='ca' but residue "
                        f"{top.residue(int(r0 if ca0 is None else r1))} "
                        f"has no CA atom"
                    )
                a0, a1 = [ca0.index], [ca1.index]
            block = np.array([(i, j) for i in a0 for j in a1], np.int64)
            self._pair_blocks.append(block)
        # one fused computation: concatenate all blocks, compute every
        # atom-pair distance in ONE call, then segment-min per residue
        # pair (a per-pair Python loop emitted N gather+min ops — small
        # irregular ops, one launch each)
        if self._pair_blocks:
            self._all_pairs = np.concatenate(self._pair_blocks, axis=0)
            sizes = [len(b) for b in self._pair_blocks]
            self._segments = np.repeat(np.arange(len(sizes)), sizes)
            self._n_segments = len(sizes)
        else:
            self._all_pairs = np.zeros((0, 2), np.int64)
            self._segments = np.zeros((0,), np.int64)
            self._n_segments = 0

    def describe(self) -> list[str]:
        # reference label format: "RES_DIST (scheme) RES1 - RES2", with a
        # "counted " prefix (and a single column) for count_contacts
        # (``features.py:2250-2296``)
        prefix = f"RES_DIST ({self.scheme})"
        if self.count_contacts:
            prefix = "counted " + prefix
            return [f"{prefix} number of contacts"]
        return [
            f"{prefix} {self.top.residue(int(a))} - {self.top.residue(int(b))}"
            for a, b in self.contacts
        ]

    def transform(self, xyz, unitcell=None):
        box = unitcell if self.mic else None
        d = geom.compute_distances(xyz, self._all_pairs, box)
        # segment min over the per-residue-pair blocks
        # _segments is np.repeat(arange, sizes): always sorted, so the
        # cheaper sorted-segment lowering applies (no scatter/sort pass)
        seg = torch.as_tensor(self._segments, device=d.device)
        out = torch.full((d.shape[0], self._n_segments), float("inf"),
                         dtype=d.dtype, device=d.device).scatter_reduce(
            1, seg.expand(d.shape[0], -1), d, "amin")
        if self.threshold is not None:
            out = (out < self.threshold).to(torch.float32)
            if self.count_contacts:
                out = torch.sum(out, dim=1, keepdim=True)
        return out


class GroupCOMFeature(Feature):
    """Center of mass of atom groups (reference ``features.py:2457``)."""

    name = "GroupCOMFeature"

    def __init__(
        self, top: Topology, group_definitions: Sequence[Sequence[int]],
        mass_weighted: bool = True, ref_geom=None,
        image_molecules: bool = False,
    ) -> None:
        super().__init__(top)
        if image_molecules:
            raise NotImplementedError(
                "image_molecules=True (mdtraj's whole-molecule PBC repair "
                "before COM averaging) is not implemented; pre-process the "
                "trajectory instead (reference features.py:2519-2524 "
                "documents it as optional and slow)"
            )
        self.groups = [np.asarray(g, np.int64) for g in group_definitions]
        # the names Feature.__eq__ probes: without them, COM features over
        # DIFFERENT groups/weightings compare equal (describe() only
        # encodes the group NUMBER) and the featurizer warn-drops one
        self.group_definitions = self.groups
        self.mass_weighted = mass_weighted
        self.masses = [
            np.asarray(
                [top.atom(int(i)).mass if mass_weighted else 1.0 for i in g],
                np.float32,
            )
            for g in self.groups
        ]
        # reference ``features.py:2647-2648``: with a ref_geom, frames are
        # superposed onto it before the COM average
        if ref_geom is not None:
            ref = np.asarray(
                ref_geom.xyz if hasattr(ref_geom, "xyz") else ref_geom
            )
            if ref.ndim == 3:
                ref = ref[0]
            self.ref = np.asarray(ref, np.float32)
        else:
            self.ref = None

    def describe(self) -> list[str]:
        out = []
        for gi in range(len(self.groups)):
            for ax in "xyz":
                out.append(f"COM-{ax} of group {gi}")
        return out

    def transform(self, xyz, unitcell=None):
        if self.ref is not None:
            from ..ops.kabsch import align_frames

            xyz = align_frames(xyz, _const(self.ref, xyz))
        # ONE flat gather + segment sum for ALL groups, not one small
        # gather per residue
        G = len(self.groups)
        flat_idx = np.concatenate(self.groups)
        seg = np.repeat(np.arange(G, dtype=np.int64),
                        [len(g) for g in self.groups])
        w = np.concatenate(self.masses).astype(np.float32)
        wsum = np.asarray(
            [m.sum() for m in self.masses], np.float32
        ).reshape(G, 1)
        pts = _take(xyz, flat_idx)  # (F, N, 3)
        weighted = pts * _const(w, xyz)[None, :, None]
        sums = torch.zeros((xyz.shape[0], G, 3), dtype=xyz.dtype,
                           device=xyz.device).index_add_(
            1, torch.as_tensor(seg, device=xyz.device), weighted)
        coms = sums / _const(wsum, xyz)[None]
        return coms.reshape(xyz.shape[0], 3 * G)


class ResidueCOMFeature(GroupCOMFeature):
    """Center of mass per residue (reference ``features.py:2731``)."""

    name = "ResidueCOMFeature"

    def __init__(
        self, top: Topology, residue_indices: Sequence[int],
        scheme: str = "all", mass_weighted: bool = True, ref_geom=None,
        image_molecules: bool = False,
    ) -> None:
        if scheme not in ("all", "backbone", "sidechain"):
            raise ValueError(f"unknown scheme {scheme!r}")
        self.scheme = scheme  # probed by Feature.__eq__
        self.residue_indices = list(residue_indices)
        groups = []
        for ri in residue_indices:
            res = top.residue(int(ri))
            atoms = res.atoms
            if scheme == "backbone":
                atoms = [a for a in atoms if a.name in ("N", "CA", "C", "O")]
            elif scheme == "sidechain":
                atoms = [a for a in atoms if a.name not in ("N", "CA", "C", "O")]
            if not atoms:
                # reference ``featurizer.py:1117-1120``: a scheme that
                # selects no atoms (e.g. sidechain of GLY) falls back to
                # the whole residue instead of producing a NaN COM
                atoms = res.atoms
            groups.append([a.index for a in atoms])
        super().__init__(top, groups, mass_weighted, ref_geom=ref_geom,
                         image_molecules=image_molecules)

    def describe(self) -> list[str]:
        out = []
        for ri in self.residue_indices:
            for ax in "xyz":
                out.append(f"COM-{ax} of residue {self.top.residue(int(ri))}")
        return out


class SideChainTorsions(DihedralFeature):
    """chi1-5 over all residues (reference ``features.py:2775``)."""

    name = "SideChainTorsions"

    def __init__(
        self, top: Topology, selstr: Optional[str] = None, deg: bool = False,
        cossin: bool = False, periodic: bool = True, which="all",
    ) -> None:
        idx = []
        labels = []
        # 'which' accepts "all", one "chiN" string, or a sequence of them
        # (the reference wraps lone strings and validates the options)
        if isinstance(which, str):
            which = [which]
        if "all" in which:
            chis = list(range(1, 6))
        else:
            valid = {f"chi{n}" for n in range(1, 6)}
            bad = sorted(set(which) - valid)
            if bad:
                raise ValueError(
                    f"'which' entries must be 'all' or chi1..chi5, got {bad}"
                )
            chis = sorted(int(w[-1]) for w in which)
        # the reference keeps a chi torsion when its SECOND atom is in the
        # selstr selection (``features.py:2802-2808``)
        self.selstr = selstr
        sel = np.asarray(top.select(selstr)) if selstr else None
        for n in chis:
            table = top.indices_chi(n)
            for quad in table:
                if sel is not None and int(quad[1]) not in sel:
                    continue
                idx.append(quad)
                res = top.atom(int(quad[1])).residue
                labels.append(f"CHI{n} {res.name} {res.resSeq}")
        if not idx:
            raise ValueError(
                "Could not determine any side chain dihedrals for this "
                "topology (the reference raises here too)"
            )
        self._labels = labels
        idx = np.asarray(idx, np.int64).reshape(-1, 4)
        super().__init__(top, idx, deg, cossin, periodic)

    def describe(self) -> list[str]:
        if self.cossin:
            # transform emits interleaved cos/sin columns — labels (and
            # therefore dimension) must double with them, like the base
            # DihedralFeature and the reference
            return [f"{f}({lbl})" for lbl in self._labels
                    for f in ("COS", "SIN")]
        return list(self._labels)


class MinRmsdFeature(Feature):
    """Kabsch-minimal RMSD to a reference frame (reference ``features.py:2884``)."""

    name = "MinRmsdFeature"

    def __init__(
        self, top: Topology, ref_xyz: np.ndarray,
        atom_indices: Optional[Sequence[int]] = None,
    ) -> None:
        super().__init__(top)
        self.atom_indices = (
            np.arange(top.n_atoms) if atom_indices is None
            else np.asarray(atom_indices, np.int64)
        )
        ref_xyz = np.asarray(ref_xyz)
        if ref_xyz.ndim == 3:
            ref_xyz = ref_xyz[0]
        self.ref = np.asarray(ref_xyz[self.atom_indices], np.float32)

    def describe(self) -> list[str]:
        return ["MinRMSD to reference"]

    def transform(self, xyz, unitcell=None):
        sel = _take(xyz, self.atom_indices)
        ref = _const(self.ref, xyz).expand(sel.shape)
        return rmsd_op(sel, ref)[:, None]


class AlignFeature(SelectionFeature):
    """Superposed xyz of selected atoms (reference ``features.py:1721``)."""

    name = "AlignFeature"
    remappable = False  # reads align_indices + a fixed ref frame

    def __init__(
        self, top: Topology, ref_xyz: np.ndarray, indexes: Sequence[int],
        atom_indices: Optional[Sequence[int]] = None,
        ref_atom_indices: Optional[Sequence[int]] = None,
    ) -> None:
        super().__init__(top, indexes)
        ref_xyz = np.asarray(ref_xyz)
        if ref_xyz.ndim == 3:
            ref_xyz = ref_xyz[0]
        self.align_indices = (
            self._indices if atom_indices is None
            else np.asarray(atom_indices, np.int64)
        )
        # the reference structure may index its alignment atoms differently
        # (e.g. a stripped topology); defaults to the same indices
        # (reference ``features.py:1721`` / mdtraj superpose semantics)
        self.ref_align_indices = (
            self.align_indices if ref_atom_indices is None
            else np.asarray(ref_atom_indices, np.int64)
        )
        if len(self.ref_align_indices) != len(self.align_indices):
            raise ValueError(
                f"atom_indices ({len(self.align_indices)}) and "
                f"ref_atom_indices ({len(self.ref_align_indices)}) must "
                f"select the same number of atoms"
            )
        self.ref = np.asarray(ref_xyz, np.float32)

    def transform(self, xyz, unitcell=None):
        from ..ops.kabsch import align_frames

        dev = xyz.device
        aligned = align_frames(
            xyz, _const(self.ref, xyz),
            torch.as_tensor(self.align_indices, device=dev),
            torch.as_tensor(self.ref_align_indices, device=dev),
        )
        sel = _take(aligned, self._indices)
        return sel.reshape(sel.shape[0], -1)


# ----------------------------------------------------------------------------
# EncoderMap ADC features
# ----------------------------------------------------------------------------


def _central_chain(top: Topology) -> np.ndarray:
    """Flat N-CA-C atom index chain."""
    return top.central_atom_indices()


class CentralCartesians(Feature):
    """xyz of the central N-CA-C chain (reference ``features.py:3697``)."""

    name = "CentralCartesians"
    remappable = True

    def __init__(self, top: Topology, generic_labels: bool = False,
                 periodic: bool = True) -> None:
        super().__init__(top)
        self._indices = _central_chain(top)
        self.generic_labels = generic_labels

    def describe(self) -> list[str]:
        out = []
        for i in self._indices:
            for ax in "XYZ":
                out.append(f"CENTERPOS {ax} ATOM {self.top.atom(int(i))}")
        return out

    def generic_describe(self) -> list[str]:
        out = []
        for k in range(len(self._indices)):
            for ax in "XYZ":
                out.append(f"CENTERPOS {ax} {k}")
        return out

    def transform(self, xyz, unitcell=None):
        return _take(xyz, self._indices)  # (frames, n_central, 3)


class AllCartesians(CentralCartesians):
    """xyz of central chain + sidechain branch atoms, in the sidechain
    backmap layer's atom order: all backbone N-CA-C first, then each
    residue's chi-branch atoms (reference ``features.py:3566``)."""

    name = "AllCartesians"

    def __init__(self, top: Topology, generic_labels: bool = False,
                 periodic: bool = True) -> None:
        Feature.__init__(self, top)
        central = list(_central_chain(top))
        side = []
        # _protein_residues, NOT top.residues: the sidechain features
        # (SideChainCartesians/BondDistances/Angles) iterate protein
        # residues only, and the sidechain backmap layer's atom-order
        # contract requires all four to agree on the residue set
        for r in top._protein_residues():
            seq = _sidechain_sequence(r, top)
            side.extend(a.index for a in seq[2:])  # branch atoms (CB...)
        self._indices = np.asarray(central + side, np.int64)
        self.generic_labels = generic_labels

    def describe(self) -> list[str]:
        out = []
        for i in self._indices:
            for ax in "XYZ":
                out.append(f"ALLPOS {ax} ATOM {self.top.atom(int(i))}")
        return out

    def generic_describe(self) -> list[str]:
        out = []
        for k in range(len(self._indices)):
            for ax in "XYZ":
                out.append(f"ALLPOS {ax} {k}")
        return out


class CentralBondDistances(DistanceFeature):
    """Consecutive central-chain bond lengths (reference ``features.py:4068``)."""

    name = "CentralBondDistances"

    def __init__(
        self, top: Topology, generic_labels: bool = False, periodic: bool = True
    ) -> None:
        chain = _central_chain(top)
        pairs = np.stack([chain[:-1], chain[1:]], axis=1)
        super().__init__(top, pairs, periodic=periodic)
        self.generic_labels = generic_labels

    def describe(self) -> list[str]:
        return [
            f"CENTERDISTANCE: {self.top.atom(int(a))} - {self.top.atom(int(b))}"
            for a, b in self._indices
        ]

    def generic_describe(self) -> list[str]:
        return [f"CENTERDISTANCE {k}" for k in range(len(self._indices))]


class SideChainBondDistances(DistanceFeature):
    """Bond lengths along each sidechain, derived from the chi tables like
    the reference (``features.py:4148-4196``): chi1 contributes CA-CB and
    CB-CG, every further chi contributes its (index[2], index[3]) bond —
    v + 1 bonds for a residue with v sidechain dihedrals, starting at CA."""

    name = "SideChainBondDistances"

    def __init__(
        self, top: Topology, generic_labels: bool = False, periodic: bool = True
    ) -> None:
        pairs = []
        for r in top._protein_residues():  # same set as SideChainDihedrals
            seq = _sidechain_sequence(r, top)
            for a, b in zip(seq[1:-1], seq[2:]):  # skip N; CA->CB first
                pairs.append((a.index, b.index))
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        super().__init__(top, pairs, periodic=periodic)
        self.generic_labels = generic_labels

    def describe(self) -> list[str]:
        return [
            f"SIDECHDISTANCE: {self.top.atom(int(a))} - {self.top.atom(int(b))}"
            for a, b in self._indices
        ]

    def generic_describe(self) -> list[str]:
        return [f"SIDECHDISTANCE {k}" for k in range(len(self._indices))]


class SideChainCartesians(Feature):
    """xyz of sidechain branch atoms (chi-union minus backbone), grouped per
    residue in the order the sidechain backmap layer expects
    (reference ``features.py:3855``)."""

    remappable = True

    name = "SideChainCartesians"

    def __init__(self, top: Topology, generic_labels: bool = False,
                 periodic: bool = True) -> None:
        super().__init__(top)
        side = []
        for r in top._protein_residues():  # same set as SideChainDihedrals
            seq = _sidechain_sequence(r, top)
            side.extend(a.index for a in seq[2:])  # drop N, CA
        self._indices = np.asarray(side, np.int64)

    def describe(self) -> list[str]:
        out = []
        for i in self._indices:
            for ax in "XYZ":
                out.append(f"SIDECHPOS {ax} ATOM {self.top.atom(int(i))}")
        return out

    def generic_describe(self) -> list[str]:
        out = []
        for k in range(len(self._indices)):
            for ax in "XYZ":
                out.append(f"SIDECHPOS {ax} {k}")
        return out

    def transform(self, xyz, unitcell=None):
        return _take(xyz, self._indices)


class CentralAngles(AngleFeature):
    """Consecutive central-chain bond angles (reference ``features.py:4253``)."""

    name = "CentralAngles"

    def __init__(
        self, top: Topology, generic_labels: bool = False, periodic: bool = True,
        deg: bool = False,
    ) -> None:
        chain = _central_chain(top)
        triplets = np.stack([chain[:-2], chain[1:-1], chain[2:]], axis=1)
        super().__init__(top, triplets, deg=deg, periodic=periodic)
        self.generic_labels = generic_labels

    def describe(self) -> list[str]:
        return [
            "CENTERANGLE: " + " - ".join(
                str(self.top.atom(int(i))) for i in t
            )
            for t in self._indices
        ]

    def generic_describe(self) -> list[str]:
        return [f"CENTERANGLE {k}" for k in range(len(self._indices))]


class SideChainAngles(AngleFeature):
    """Angles over consecutive triples of each residue's chi-atom sequence
    (reference ``features.py:4400-4438``): N-CA-CB first, then CA-CB-CG, ...
    — v + 1 angles for a residue with v sidechain dihedrals."""

    name = "SideChainAngles"

    def __init__(
        self, top: Topology, generic_labels: bool = False, periodic: bool = True,
        deg: bool = False,
    ) -> None:
        triplets = []
        for r in top._protein_residues():  # same set as SideChainDihedrals
            seq = _sidechain_sequence(r, top)
            for a, b, c in zip(seq[:-2], seq[1:-1], seq[2:]):
                triplets.append((a.index, b.index, c.index))
        triplets = np.asarray(triplets, np.int64).reshape(-1, 3)
        super().__init__(top, triplets, deg=deg, periodic=periodic)

    def describe(self) -> list[str]:
        return [
            "SIDECHANGLE: " + " - ".join(
                str(self.top.atom(int(i))) for i in t
            )
            for t in self._indices
        ]

    def generic_describe(self) -> list[str]:
        return [f"SIDECHANGLE {k}" for k in range(len(self._indices))]


def _sidechain_sequence(residue, top: Optional[Topology] = None) -> list:
    """The residue's union of chi-participating atoms in index order
    (mirrors the reference's ``sidechain_indices_by_residue``,
    ``trajinfo_utils.py:1303-1318``): for ASP -> [N, CA, CB, CG, OD1].

    ``top`` supplies the chi tables, so CustomTopology-patched topologies
    with unnatural residues are honored; falls back to standard CHI_ATOMS."""
    from ..data.topology import chi_names_for_residue

    atoms = {}
    for n in range(1, 6):
        table = top.chi_table(n) if top is not None else CHI_ATOMS[f"chi{n}"]
        names = chi_names_for_residue(table, residue)
        if not names:
            continue
        found = [residue.atom(nm) for nm in names]
        if any(a is None for a in found):
            continue
        for a in found:
            atoms[a.index] = a
    return [atoms[i] for i in sorted(atoms)]


class CentralDihedrals(DihedralFeature):
    """Consecutive central-chain dihedrals: PSI, OMEGA, PHI per residue
    (reference ``features.py:3059``)."""

    name = "CentralDihedrals"

    def __init__(
        self, top: Topology, generic_labels: bool = False, periodic: bool = True,
        omega: bool = True, deg: bool = False,
    ) -> None:
        chain = _central_chain(top)
        quads = np.stack(
            [chain[:-3], chain[1:-2], chain[2:-1], chain[3:]], axis=1
        )
        if not omega:
            keep = [k for k in range(len(quads)) if k % 3 != 1]
            quads = quads[keep]
        self.omega = omega
        super().__init__(top, quads, deg=deg, periodic=periodic)

    def describe(self) -> list[str]:
        out = []
        for quad in self._indices:
            a1 = self.top.atom(int(quad[1]))
            res = a1.residue
            kind = {"N": "PSI", "CA": "OMEGA", "C": "PHI"}.get(
                self.top.atom(int(quad[0])).name, "DIH"
            )
            out.append(
                f"CENTERDIH {kind}   RESID  {res.name}: {res.resSeq:4d} CHAIN "
                f"{res.chain_index}"
            )
        return out

    def generic_describe(self) -> list[str]:
        out = []
        for k, quad in enumerate(self._indices):
            kind = {"N": "PSI", "CA": "OMEGA", "C": "PHI"}.get(
                self.top.atom(int(quad[0])).name, "DIH"
            )
            # map onto the FULL (PSI, OMEGA, PHI)-per-residue pattern so
            # omega=False datasets carry the same labels as omega=True
            # ones (k // 3 alone duplicated labels without omega, and the
            # ensemble aligner collapses duplicate labels into one column)
            full_k = k if self.omega else (k // 2) * 3 + (k % 2) * 2
            out.append(f"CENTERDIH {kind} {full_k // 3 + 1}")
        return out


class SideChainDihedrals(DihedralFeature):
    """chi1-5 per residue, ordered by (residue, chi)
    (reference ``features.py:3332``)."""

    name = "SideChainDihedrals"

    def __init__(
        self, top: Topology, generic_labels: bool = False, periodic: bool = True,
        deg: bool = False,
    ) -> None:
        quads = []
        labels = []
        generic = []
        from ..data.topology import chi_names_for_residue

        prot = top._protein_residues()
        for ri, r in enumerate(prot, start=1):
            for n in range(1, 6):
                # top.chi_table honors CustomTopology unnatural-AA entries
                # (incl. "ASP-2" resSeq-scoped keys); chi_names_for
                # resolves HSD/CYX/... variant names
                names = chi_names_for_residue(top.chi_table(n), r)
                if not names:
                    continue
                atoms = [r.atom(nm) for nm in names]
                if any(a is None for a in atoms):
                    continue
                quads.append([a.index for a in atoms])
                labels.append(
                    f"SIDECHDIH CHI{n}  RESID  {r.name}: {r.resSeq:4d} CHAIN "
                    f"{r.chain_index}"
                )
                generic.append(f"SIDECHDIH CHI{n} {ri}")
        self._labels = labels
        self._generic = generic
        quads = np.asarray(quads, np.int64).reshape(-1, 4)
        super().__init__(top, quads, deg=deg, periodic=periodic)

    def describe(self) -> list[str]:
        return list(self._labels)

    def generic_describe(self) -> list[str]:
        return list(self._generic)


class AllBondDistances(DistanceFeature):
    """Central + sidechain bond distances (reference ``features.py:3964``)."""

    name = "AllBondDistances"

    def __init__(
        self, top: Topology, generic_labels: bool = False, periodic: bool = True
    ) -> None:
        chain = _central_chain(top)
        pairs = np.stack([chain[:-1], chain[1:]], axis=1).tolist()
        side = SideChainBondDistances(top, periodic=periodic)
        pairs += side._indices.tolist()
        super().__init__(top, np.asarray(pairs, np.int64), periodic=periodic)

    def describe(self) -> list[str]:
        return [
            f"ALLDISTANCE: {self.top.atom(int(a))} - {self.top.atom(int(b))}"
            for a, b in self._indices
        ]

    def generic_describe(self) -> list[str]:
        return [f"ALLDISTANCE {k}" for k in range(len(self._indices))]


#: name -> class for the `add_list_of_feats` shortcuts; ADC set first
ADC_FEATURES = {
    "central_angles": CentralAngles,
    "central_dihedrals": CentralDihedrals,
    "central_cartesians": CentralCartesians,
    "central_distances": CentralBondDistances,
    "side_dihedrals": SideChainDihedrals,
    "all_cartesians": AllCartesians,
    "all_distances": AllBondDistances,
    "side_cartesians": SideChainCartesians,
    "side_distances": SideChainBondDistances,
    "side_angles": SideChainAngles,
}


def pair(*numbers: int) -> int:
    """Szudzik's elegant pairing function: maps non-negative integers to one
    unique non-negative integer, folding left for >2 inputs (the reference
    uses it to key feature index tuples, ``loading/features.py:219-261``).

    Example:
        >>> from encodermap_tpu_torch.loading.features import pair, unpair
        >>> unpair(pair(12, 35, 99), n=3)
        [12, 35, 99]
    """
    if len(numbers) < 2:
        raise ValueError(
            "Szudzik pairing function needs at least 2 numbers as input"
        )
    if any(n < 0 or not isinstance(n, (int, np.integer)) for n in numbers):
        raise ValueError(
            f"Szudzik pairing function maps only non-negative integers, "
            f"got {numbers=}"
        )
    acc, rest = int(numbers[0]), numbers[1:]
    for b in rest:
        b = int(b)
        acc = b * b + acc if acc < b else acc * acc + acc + b
    return acc


def unpair(number: int, n: int = 2) -> list[int]:
    """Inverse of :func:`pair`: recover the ``n`` non-negative integers
    whose pairing is ``number`` (reference ``loading/features.py:263-306``)."""
    if number < 0 or not isinstance(number, (int, np.integer)):
        raise ValueError(
            "Szudzik unpairing function requires a non-negative integer"
        )
    number = int(number)
    root = int(np.sqrt(number))
    # sqrt can land one off for huge ints; settle it exactly
    while root * root > number:
        root -= 1
    while (root + 1) * (root + 1) <= number:
        root += 1
    if number - root * root < root:
        a, b = number - root * root, root
    else:
        a, b = root, number - root * root - root
    if n > 2:
        return unpair(a, n - 1) + [b]
    return [a, b]


def describe_last_feats(feat, n: int = 5) -> None:
    """Print the labels of the last ``n`` features added to a featurizer
    (reference ``loading/features.py:323-351``)."""
    labels = feat.describe()
    for label in labels[-n:]:
        print(label)
