# encodermap_tpu_torch/data/custom_topology.py
"""CustomTopology: user-defined residues and dihedral overrides.

Re-design of the reference's ``CustomTopology``
(``encodermap/trajinfo/trajinfo_utils.py:583-1565``): lets
users teach the framework about non-standard residues — extra bonds
(including +1/-1 neighbor references), PHI/PSI/OMEGA overrides, chi-table
additions, and deletions — so featurization and offline backmapping handle
unnatural amino acids.

Usage::

    ct = CustomTopology(top)
    ct.add_residue("PEG", chi1=["N", "CA", "CB", "OG"], bonds=[("CA", "CB")])
    ct.override_dihedral("PHI", "PEG", ["-C", "N", "CA", "C"])
    top2 = ct.apply()   # a Topology whose index tables honor the overrides

Counterpart of ``encodermap_tpu/data/custom_topology.py``; host numpy, copied near verbatim.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from .topology import CHI_ATOMS, Topology

__all__ = ["CustomTopology", "CustomAAsDict"]

# The reference exports this typing alias at top level
# (``encodermap/__init__.py:257``, defined in
# ``encodermap/_typing.py:64-74``): the dict format accepted by
# ``load_custom_topology``/``from_custom_aas`` — resname, a
# ``(common_str, resname)`` tuple (scopes to trajs with that common_str),
# or the resSeq-scoped ``"ASP-2"`` form (one specific residue) -> None |
# (one_letter_code, None |
# {"bonds"/"PHI"/"PSI"/"OMEGA"/"CHI1".."CHI5"/"delete_bonds"/
# "optional_delete_bonds"/"not_..." : atom-name lists}).
CustomAAsDict = dict[
    Union[str, tuple[str, str]],
    Union[None, tuple[str, None], tuple[str, dict]],
]


class _PatchedTopology(Topology):
    """Topology whose dihedral tables honor custom residue definitions."""

    def __init__(self) -> None:
        super().__init__()
        self._custom_chi: dict[str, dict[str, list[str]]] = {}
        self._dihedral_overrides: dict[tuple[str, str], list[str]] = {}
        self._extra_bonds: list[tuple[int, int]] = []
        #: (lo, hi, strict) atom-index pairs the bond guesser must drop
        self._deleted_bonds: list[tuple[int, int, bool]] = []
        self._not_dihedrals: set[tuple[str, str]] = set()

    def chi_table(self, n: int) -> dict[str, list[str]]:
        base = dict(CHI_ATOMS[f"chi{n}"])
        base.update(self._custom_chi.get(f"chi{n}", {}))
        # not_CHIn deletions: accepted by from_custom_aas but previously
        # consumed only for PHI/PSI/OMEGA — chi deletions were silently
        # ignored (wave 32). A resSeq-scoped name ("ASP-2") inserts an
        # EMPTY scoped entry, which chi_names_for_residue treats as a
        # per-residue suppression
        import re as _re

        for kind, resname in self._not_dihedrals:
            if kind == f"CHI{n}":
                if _re.search(r"-\d+$", resname):
                    base[resname] = []
                else:
                    base.pop(resname, None)
        return base

    # NOTE: no indices_chi override — the base Topology.indices_chi already
    # goes through self.chi_table(n), which is THIS class's extension point
    # (a verbatim copy here would silently miss future base-class fixes)

    def _override_quad(
        self, kind: str, prev, cur, nxt
    ) -> Optional[list[int]]:
        # resSeq-scoped key ("ASP-2") wins over the residue-name key
        names = self._dihedral_overrides.get(
            (kind, f"{cur.name}-{cur.resSeq}")
        )
        if names is None:
            names = self._dihedral_overrides.get((kind, cur.name))
        if names is None:
            return None
        quad = []
        for nm in names:
            if nm.startswith("-"):
                res, nm = prev, nm[1:]
            elif nm.startswith("+"):
                res, nm = nxt, nm[1:]
            else:
                res = cur
            if res is None:
                return None
            atom = res.atom(nm)
            if atom is None:
                return None
            quad.append(atom.index)
        return quad

    def _torsion_indices(self, kind: str) -> np.ndarray:
        res = self._protein_residues()
        out = []
        for i, cur in enumerate(res):
            # neighbors only count when peptide-bonded (same chain AND
            # contiguous resSeq — the base class's gap guard): an
            # unresolved-loop gap or a chain break must not supply a
            # '-'/'+' override atom or a default torsion partner
            prev = res[i - 1] if i > 0 else None
            if prev is not None and not self._peptide_bonded(prev, cur):
                prev = None
            nxt = res[i + 1] if i + 1 < len(res) else None
            if nxt is not None and not self._peptide_bonded(cur, nxt):
                nxt = None
            if (kind, cur.name) in self._not_dihedrals or (
                kind, f"{cur.name}-{cur.resSeq}"
            ) in self._not_dihedrals:
                continue
            quad = self._override_quad(kind, prev, cur, nxt)
            if quad is not None:
                out.append(quad)
                continue
            # defaults
            if kind == "PHI" and prev is not None:
                out.append([prev.atom("C").index, cur.atom("N").index,
                            cur.atom("CA").index, cur.atom("C").index])
            elif kind == "PSI" and nxt is not None:
                out.append([cur.atom("N").index, cur.atom("CA").index,
                            cur.atom("C").index, nxt.atom("N").index])
            elif kind == "OMEGA" and nxt is not None:
                out.append([cur.atom("CA").index, cur.atom("C").index,
                            nxt.atom("N").index, nxt.atom("CA").index])
        return np.asarray(out, dtype=np.int64).reshape(-1, 4)

    @property
    def indices_phi(self) -> np.ndarray:
        return self._torsion_indices("PHI")

    @property
    def indices_psi(self) -> np.ndarray:
        return self._torsion_indices("PSI")

    @property
    def indices_omega(self) -> np.ndarray:
        return self._torsion_indices("OMEGA")


class CustomTopology:
    """Collects user residue definitions, then produces a patched Topology."""

    def __init__(self, top: Topology) -> None:
        self.top = top
        self._custom_chi: dict[str, dict[str, list[str]]] = {}
        self._dihedral_overrides: dict[tuple[str, str], list[str]] = {}
        self._extra_bonds: list[tuple[Union[int, str], Union[int, str]]] = []
        #: (resname, atom_a, atom_b, strict): bonds the distance-based
        #: guesser must NOT produce; strict ones raise when the bond was
        #: never guessed (reference 'delete_bonds' vs
        #: 'optional_delete_bonds', ``trajinfo_utils.py:980-991``)
        self._delete_bonds: list[tuple[str, str, str, bool]] = []
        self._not_dihedrals: set[tuple[str, str]] = set()
        self._protein_names: set[str] = set()
        #: resname -> one-letter code (CustomAAsDict tuples; drives FASTA)
        self._one_letter_codes: dict[str, str] = {}

    def add_residue(
        self,
        name: str,
        bonds: Sequence[tuple] = (),
        **chi_tables: Sequence[str],
    ) -> "CustomTopology":
        """Register a residue: mark it protein-like, optionally define chi
        dihedrals (chi1=..., chi2=...) and intra-residue bonds."""
        self._protein_names.add(name)
        for key, atoms in chi_tables.items():
            assert key.startswith("chi"), f"unknown table {key}"
            self._custom_chi.setdefault(key, {})[name] = list(atoms)
        for a, b in bonds:
            self._extra_bonds.append((name, a, b))
        return self

    @classmethod
    def from_custom_aas(
        cls, top: Topology, custom: dict,
        common_str: Optional[str] = None,
    ) -> "CustomTopology":
        """Build from the reference's ``CustomAAsDict`` format
        (``trajinfo_utils.py:600-770``): ``{resname: (one_letter_code,
        {tables...})}`` or the simpler ``{resname: {"chi1": [...]}}``.
        Recognized table keys (case-insensitive): ``bonds`` /
        ``optional_bonds`` (atom-name pairs, ``-``/``+`` prefixes reach
        the previous/next residue), ``PHI``/``PSI``/``OMEGA`` overrides,
        ``not_PHI``-style deletions, and ``CHI1``..``CHI5``.
        ``resname: None`` marks the residue as recognized without tables.

        A ``(common_str, resname)`` TUPLE key scopes its definition to
        trajectories with that ``common_str`` (reference
        ``trajinfo_utils.py:591-594``); pass the trajectory's
        ``common_str`` to filter — with ``common_str=None`` tuple-keyed
        entries apply unconditionally (no scoping context)."""
        ct = cls(top)
        for resname, val in dict(custom).items():
            if isinstance(resname, tuple):
                cs, resname = resname
                if common_str is not None and cs != common_str:
                    continue
            tables = val
            # yaml.safe_dump serializes the (code, tables) tuple as a
            # 2-element list; accept both spellings so to_yaml/from_yaml
            # round-trips residues that carry a one-letter code.
            if isinstance(val, tuple) or (
                isinstance(val, list)
                and len(val) == 2
                and (val[0] is None or isinstance(val[0], str))
                and (val[1] is None or isinstance(val[1], dict))
            ):
                one_letter, tables = val
                if one_letter:
                    ct._one_letter_codes[resname] = str(one_letter)
            if tables is None:
                ct.add_residue(resname)
                continue
            bonds: list[tuple] = []
            chi_kwargs: dict[str, list[str]] = {}
            for key, atoms in dict(tables).items():
                kl = key.lower()
                if kl in ("bonds", "optional_bonds"):
                    bonds.extend(tuple(b) for b in atoms)
                elif kl in ("delete_bonds", "optional_delete_bonds"):
                    strict = kl == "delete_bonds"
                    for a, b in atoms:
                        ct._delete_bonds.append((resname, a, b, strict))
                elif kl.startswith("not_"):
                    ct.remove_dihedral(kl[4:].upper(), resname)
                elif kl in ("phi", "psi", "omega"):
                    ct.override_dihedral(kl.upper(), resname, atoms)
                elif kl.startswith("chi"):
                    chi_kwargs[kl] = list(atoms)
                else:
                    raise ValueError(
                        f"unknown custom-residue table {key!r} for "
                        f"{resname!r}"
                    )
            ct.add_residue(resname, bonds=bonds, **chi_kwargs)
        return ct

    def override_dihedral(
        self, kind: str, residue_name: str, atom_names: Sequence[str]
    ) -> "CustomTopology":
        """Override PHI/PSI/OMEGA for one residue type; names may carry
        +/- prefixes for next/previous residue atoms."""
        assert kind in ("PHI", "PSI", "OMEGA")
        self._dihedral_overrides[(kind, residue_name)] = list(atom_names)
        return self

    def remove_dihedral(self, kind: str, residue_name: str) -> "CustomTopology":
        """A ``not_*`` deletion: drop this torsion for this residue type."""
        self._not_dihedrals.add((kind, residue_name))
        return self

    def to_json(self) -> str:
        """Serialize the residue definitions (NOT the topology) so custom
        amino acids survive HDF5 save/load round trips, mirroring the
        reference's persistence of CustomTopology alongside trajectories
        (``trajinfo_utils.py:583-1565``)."""
        import json

        return json.dumps({
            "custom_chi": self._custom_chi,
            "dihedral_overrides": [
                [k[0], k[1], v] for k, v in self._dihedral_overrides.items()
            ],
            "extra_bonds": [list(e) for e in self._extra_bonds],
            "delete_bonds": [list(e) for e in self._delete_bonds],
            "not_dihedrals": sorted(list(t) for t in self._not_dihedrals),
            "protein_names": sorted(self._protein_names),
            "one_letter_codes": dict(self._one_letter_codes),
        })

    @classmethod
    def from_json(cls, top: Topology, text: str) -> "CustomTopology":
        """Rebuild definitions from :meth:`to_json` onto ``top``."""
        import json

        data = json.loads(text)
        ct = cls(top)
        ct._custom_chi = {
            k: {r: list(v) for r, v in tbl.items()}
            for k, tbl in data.get("custom_chi", {}).items()
        }
        ct._dihedral_overrides = {
            (kind, res): list(names)
            for kind, res, names in data.get("dihedral_overrides", [])
        }
        ct._extra_bonds = [tuple(e) for e in data.get("extra_bonds", [])]
        ct._delete_bonds = [
            (r, a, b, bool(s)) for r, a, b, s in data.get("delete_bonds", [])
        ]
        ct._not_dihedrals = {
            tuple(t) for t in data.get("not_dihedrals", [])
        }
        ct._protein_names = set(data.get("protein_names", []))
        ct._one_letter_codes = dict(data.get("one_letter_codes", {}))
        return ct

    # ------------------------------------------------ reference conveniences
    def add_new_residue(self, name: str, bonds: Sequence[tuple] = (),
                        **chi_tables: Sequence[str]) -> "CustomTopology":
        """Reference-named alias of :meth:`add_residue`
        (``trajinfo_utils.py:827`` takes a ``NewResidue`` dataclass; this
        framework's residue definitions are plain tables)."""
        return self.add_residue(name, bonds=bonds, **chi_tables)

    def add_bonds(self) -> Topology:
        """Apply the collected bond additions/deletions and return the new
        topology (reference ``trajinfo_utils.py:848-860``) — an alias of
        :meth:`apply` here, where all patches land at once."""
        return self.apply()

    @property
    def new_residues(self) -> list[str]:
        """Names of the user-declared residues (the reference returns its
        ``NewResidue`` dataclasses; the tables live in :meth:`to_dict`)."""
        return sorted(self._protein_names)

    @property
    def amino_acid_codes(self) -> dict[str, str]:
        """resname -> one-letter code for the declared residues (reference
        ``trajinfo_utils.py:1352``); drives the patched topology's FASTA."""
        return dict(self._one_letter_codes)

    def add_amino_acid_codes(self) -> dict[str, str]:
        """Reference-named accessor of :attr:`amino_acid_codes` (there it
        merges into a mutable class attribute; here codes flow into
        ``apply()`` automatically)."""
        return self.amino_acid_codes

    def to_dict(self) -> dict:
        """The definitions as a ``CustomAAsDict`` — the same format
        :meth:`from_custom_aas`/:meth:`from_dict` consume (reference
        ``trajinfo_utils.py:1390-1421``)."""
        tables: dict[str, dict] = {n: {} for n in sorted(self._protein_names)}
        for chi_n, per_res in self._custom_chi.items():
            for res, atoms in per_res.items():
                tables.setdefault(res, {})[chi_n.upper()] = list(atoms)
        for (kind, res), names in self._dihedral_overrides.items():
            tables.setdefault(res, {})[kind] = list(names)
        for kind, res in sorted(self._not_dihedrals):
            tables.setdefault(res, {})[f"not_{kind}"] = True
        for res, a, b in self._extra_bonds:
            tables.setdefault(res, {}).setdefault("bonds", []).append([a, b])
        for res, a, b, strict in self._delete_bonds:
            key = "delete_bonds" if strict else "optional_delete_bonds"
            tables.setdefault(res, {}).setdefault(key, []).append([a, b])
        out = {}
        for res, tbl in tables.items():
            code = self._one_letter_codes.get(res)
            out[res] = (code, tbl or None) if code else (tbl or None)
        return out

    @classmethod
    def from_dict(cls, custom_aas: dict, top) -> "CustomTopology":
        """Build from a ``CustomAAsDict`` (reference
        ``trajinfo_utils.py:1464``); ``top`` may be a Topology or any
        traj-like with ``.top``."""
        top = getattr(top, "top", top)
        return cls.from_custom_aas(top, custom_aas)

    def to_yaml(self) -> str:
        """The :meth:`to_dict` definitions as YAML (reference
        ``trajinfo_utils.py:1423``)."""
        import yaml

        return yaml.safe_dump(self.to_dict())

    @classmethod
    def from_yaml(cls, text_or_path, top) -> "CustomTopology":
        """Build from :meth:`to_yaml` output (text or a file path)."""
        from pathlib import Path

        import yaml

        text = str(text_or_path)
        if "\n" not in text and Path(text).is_file():
            text = Path(text).read_text()
        data = yaml.safe_load(text)
        # yaml round-trips the not_* markers as True; from_custom_aas
        # expects their presence only.  A (code, tables) tuple comes back
        # as a 2-element list — normalize the nested tables dict too.
        for tbl in (data or {}).values():
            if isinstance(tbl, list) and len(tbl) == 2:
                tbl = tbl[1]
            if isinstance(tbl, dict):
                for k in [k for k, v in tbl.items()
                          if k.startswith("not_") and v is True]:
                    tbl[k] = []
        return cls.from_dict(data or {}, top)

    def to_hdf_file(self, fname) -> None:
        """Persist the definitions into an HDF5 file's attrs — the same
        ``custom_topology`` key ``SingleTraj.save`` writes, so
        :meth:`from_hdf5_file` and the h5 loaders agree (reference
        ``trajinfo_utils.py:1375``)."""
        import h5py

        with h5py.File(fname, "a") as f:
            f.attrs["custom_topology"] = self.to_json()

    @classmethod
    def from_hdf5_file(cls, fname, top) -> "CustomTopology":
        """Read definitions persisted by :meth:`to_hdf_file` /
        ``SingleTraj.save`` (reference ``trajinfo_utils.py:1428``)."""
        import h5py

        top = getattr(top, "top", top)
        with h5py.File(fname, "r") as f:
            if "custom_topology" not in f.attrs:
                raise KeyError(
                    f"{fname} carries no custom_topology definitions"
                )
            return cls.from_json(top, f.attrs["custom_topology"])

    def _patched(self) -> "_PatchedTopology":
        """:meth:`apply`, memoized on the current definitions: the five
        ``indices_chi1..5`` reads would otherwise rebuild the whole
        patched topology (full residue/atom reconstruction + json
        serialization) once each. The key is :meth:`to_json` plus a cheap
        fingerprint of the bound mdtraj topology, so any mutation
        (add_residue, override_dihedral, ... — or in-place edits of
        ``self.top`` itself) invalidates."""
        top = self.top
        # content fingerprint, not id(): ids are recycled by the
        # allocator, and in-place edits that keep counts (residue renames
        # like HIS->HID, atom renames, resSeq shifts) change chi matching
        # without changing n_atoms/n_residues. Hashing names/resSeqs/bond
        # endpoints is O(n_atoms) per read — microseconds against the
        # full rebuild apply() does on a miss.
        key = (
            self.to_json(),
            top.n_atoms,
            top.n_residues,
            hash(tuple(
                (r.name, r.resSeq, r.chain_index) for r in top.residues
            )),
            hash(tuple(a.name for a in top.atoms)),
        )
        cached = getattr(self, "_patched_cache", None)
        if cached is None or cached[0] != key:
            cached = (key, self.apply())
            self._patched_cache = cached
        return cached[1]

    @property
    def indices_phi(self) -> np.ndarray:
        """PHI quadruplets of the patched topology (reference delegates the
        same way, ``trajinfo_utils.py:1100-1170``)."""
        return self._patched().indices_phi

    @property
    def indices_psi(self) -> np.ndarray:
        return self._patched().indices_psi

    @property
    def indices_omega(self) -> np.ndarray:
        return self._patched().indices_omega

    def indices_chi(self, n: int) -> np.ndarray:
        """CHI-n quadruplets of the patched topology."""
        return self._patched().indices_chi(n)

    @property
    def indices_chi1(self) -> np.ndarray:
        return self.indices_chi(1)

    @property
    def indices_chi2(self) -> np.ndarray:
        return self.indices_chi(2)

    @property
    def indices_chi3(self) -> np.ndarray:
        return self.indices_chi(3)

    @property
    def indices_chi4(self) -> np.ndarray:
        return self.indices_chi(4)

    @property
    def indices_chi5(self) -> np.ndarray:
        return self.indices_chi(5)

    def apply(self) -> _PatchedTopology:
        """Build the patched Topology."""
        out = _PatchedTopology()

        def _matches(table_name: str, res) -> bool:
            # "ASP" matches every ASP; "ASP-2" (the reference's
            # resSeq-scoped key form, trajinfo_utils.py:598-602) matches
            # only the ASP with resSeq 2
            return table_name in (res.name, f"{res.name}-{res.resSeq}")

        for res in self.top.residues:
            new_res = out.add_residue(res.name, res.resSeq, res.chain_index)
            if any(_matches(n, res) for n in self._protein_names):
                # scoped to THIS topology's residues — never the global set
                new_res._force_protein = True
            for a in res.atoms:
                out.add_atom(a.name, a.element, new_res)
        out._custom_chi = self._custom_chi
        out._dihedral_overrides = self._dihedral_overrides
        out._not_dihedrals = self._not_dihedrals
        out._custom_def_json = self.to_json()
        if self._one_letter_codes:
            out._custom_one_letter = dict(self._one_letter_codes)
        def resolve(res_index: int, name):
            """Atom lookup honoring '-'/'+' previous/next-residue prefixes
            (the neighbor-reference syntax the class docstring promises).
            Integers are absolute atom indices, as the reference's bond
            tables also accept (``trajinfo_utils.py`` int branch)."""
            if isinstance(name, (int, np.integer)):
                return out.atom(int(name))
            if name.startswith("-"):
                if res_index == 0:
                    return None
                return out.residues[res_index - 1].atom(name[1:])
            if name.startswith("+"):
                if res_index + 1 >= len(out.residues):
                    return None
                return out.residues[res_index + 1].atom(name[1:])
            return out.residues[res_index].atom(name)

        for entry in self._extra_bonds:
            res_name, a_name, b_name = entry
            for ri, res in enumerate(out.residues):
                if not _matches(res_name, res):
                    continue
                a, b = resolve(ri, a_name), resolve(ri, b_name)
                if a is not None and b is not None:
                    out._extra_bonds.append((a.index, b.index))
        for res_name, a_name, b_name, strict in self._delete_bonds:
            for ri, res in enumerate(out.residues):
                if not _matches(res_name, res):
                    continue
                a, b = resolve(ri, a_name), resolve(ri, b_name)
                if a is not None and b is not None:
                    out._deleted_bonds.append(
                        (min(a.index, b.index), max(a.index, b.index),
                         strict)
                    )
        return out
