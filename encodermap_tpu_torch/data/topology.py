# encodermap_tpu_torch/data/topology.py
"""Lightweight molecular topology: atoms, residues, chains, dihedral tables.

The reference leans on mdtraj's Topology + compiled geometry kernels
(``encodermap/loading/features.py:153-157``) and exposes
dihedral index properties on its trajectory containers
(``trajinfo/info_single.py:737-785``). mdtraj is not available here, so this
module provides a self-contained topology with:

* atom records (name, element, residue, chain),
* backbone (N, CA, C) index extraction,
* PHI/PSI/OMEGA index quadruplets,
* CHI1-CHI5 sidechain dihedral quadruplets from standard residue templates,
* the ADC index tables: central atoms, central distances/angles/dihedrals,
  sidechain info per residue.

All tables are plain numpy int arrays, precomputed on host; device code only
ever sees gathered coordinates.

Counterpart of ``encodermap_tpu/data/topology.py``; host numpy, copied near verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["Atom", "Residue", "Topology", "CHI_ATOMS"]


# Standard sidechain dihedral definitions (same tables mdtraj/PyEMMA use;
# public knowledge from the IUPAC nomenclature).
CHI_ATOMS: dict[str, dict[str, list[str]]] = {
    "chi1": {
        "ARG": ["N", "CA", "CB", "CG"], "ASN": ["N", "CA", "CB", "CG"],
        "ASP": ["N", "CA", "CB", "CG"], "CYS": ["N", "CA", "CB", "SG"],
        "GLN": ["N", "CA", "CB", "CG"], "GLU": ["N", "CA", "CB", "CG"],
        "HIS": ["N", "CA", "CB", "CG"], "ILE": ["N", "CA", "CB", "CG1"],
        "LEU": ["N", "CA", "CB", "CG"], "LYS": ["N", "CA", "CB", "CG"],
        "MET": ["N", "CA", "CB", "CG"], "PHE": ["N", "CA", "CB", "CG"],
        "PRO": ["N", "CA", "CB", "CG"], "SER": ["N", "CA", "CB", "OG"],
        "THR": ["N", "CA", "CB", "OG1"], "TRP": ["N", "CA", "CB", "CG"],
        "TYR": ["N", "CA", "CB", "CG"], "VAL": ["N", "CA", "CB", "CG1"],
    },
    "chi2": {
        "ARG": ["CA", "CB", "CG", "CD"], "ASN": ["CA", "CB", "CG", "OD1"],
        "ASP": ["CA", "CB", "CG", "OD1"], "GLN": ["CA", "CB", "CG", "CD"],
        "GLU": ["CA", "CB", "CG", "CD"], "HIS": ["CA", "CB", "CG", "ND1"],
        "ILE": ["CA", "CB", "CG1", "CD1"], "LEU": ["CA", "CB", "CG", "CD1"],
        "LYS": ["CA", "CB", "CG", "CD"], "MET": ["CA", "CB", "CG", "SD"],
        "PHE": ["CA", "CB", "CG", "CD1"], "PRO": ["CA", "CB", "CG", "CD"],
        "TRP": ["CA", "CB", "CG", "CD1"], "TYR": ["CA", "CB", "CG", "CD1"],
    },
    "chi3": {
        "ARG": ["CB", "CG", "CD", "NE"], "GLN": ["CB", "CG", "CD", "OE1"],
        "GLU": ["CB", "CG", "CD", "OE1"], "LYS": ["CB", "CG", "CD", "CE"],
        "MET": ["CB", "CG", "SD", "CE"],
    },
    "chi4": {
        "ARG": ["CG", "CD", "NE", "CZ"], "LYS": ["CG", "CD", "CE", "NZ"],
    },
    "chi5": {
        "ARG": ["CD", "NE", "CZ", "NH1"],
    },
}

_PROTEIN_RESIDUES = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    # common variants (CHARMM/AMBER/GROMACS protonation-state naming)
    "HSD", "HSE", "HSP", "HID", "HIE", "HIP", "CYX", "CYM", "ASH", "GLH",
    "LYN", "ACE", "NME", "NMA",
    "LYSH", "ARGN", "HISA", "HISB", "HISH", "HIS1", "ASPH", "GLUH", "CYSH",
    "CYS2",
}

#: standard 3-letter -> 1-letter amino-acid codes (for FASTA export)
_AA_ONE_LETTER = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}

#: protonation/bond-state variant residue names -> parent residue, for chi
#: table lookups (CHARMM/AMBER/GROMACS naming)
RESIDUE_VARIANTS = {
    "HSD": "HIS", "HSE": "HIS", "HSP": "HIS", "HID": "HIS", "HIE": "HIS",
    "HIP": "HIS", "CYX": "CYS", "CYM": "CYS", "ASH": "ASP", "GLH": "GLU",
    "LYN": "LYS",
    # GROMACS force-field names
    "LYSH": "LYS", "ARGN": "ARG", "HISA": "HIS", "HISB": "HIS",
    "HISH": "HIS", "HIS1": "HIS", "ASPH": "ASP", "GLUH": "GLU",
    "CYSH": "CYS", "CYS2": "CYS",
}


def chi_names_for_residue(table: dict, res) -> "list[str] | None":
    """Chi atom names for a specific RESIDUE: an resSeq-scoped custom
    entry ("ASP-2" — the reference's per-residue CustomAAsDict key form,
    ``trajinfo_utils.py:598-602``) wins over the residue-name entry. An
    EMPTY scoped entry marks a scoped deletion (``not_CHIn`` on one
    residue) and suppresses the name-level chi."""
    scoped = f"{res.name}-{res.resSeq}"
    if scoped in table:
        return table[scoped] or None
    return chi_names_for(table, res.name)


def chi_names_for(table: dict, resname: str):
    """Chi atom-name list for a residue, resolving variant names
    (HSD -> HIS etc.) and 4-letter forms — the SINGLE lookup used by
    indices_chi, sidechain_info, the patched CustomTopology, and every
    chi-derived feature, so they can never disagree about which residues
    carry chis."""
    names = table.get(resname)
    if names is None:
        names = table.get(resname.upper()[:3])
    if names is None:
        base = RESIDUE_VARIANTS.get(resname.upper())
        names = table.get(base) if base else None
    return names

_ELEMENT_MASSES = {
    "H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999, "S": 32.06,
    "P": 30.974, "SE": 78.971, "FE": 55.845, "ZN": 65.38, "MG": 24.305,
    "NA": 22.990, "CL": 35.45, "K": 39.098, "CA": 40.078, "": 0.0,
}


@dataclass(eq=False)
class Atom:
    """One atom: name, element, and its residue.

    ``eq=False``: identity comparison/hash — the generated value ``__eq__``
    recurses Atom.residue -> Residue.atoms -> Atom... infinitely for
    equal-valued atoms of DIFFERENT topologies, and kills hashability
    (``set(res.atoms)``). Topology-level equality goes through
    ``Topology._fingerprint`` instead."""

    index: int
    name: str
    element: str
    residue: "Residue"

    @property
    def mass(self) -> float:
        return _ELEMENT_MASSES.get(self.element.upper(), 0.0)

    def __repr__(self) -> str:
        return f"{self.residue.name}{self.residue.resSeq}-{self.name}"


@dataclass(eq=False)
class Residue:
    """One residue: name, sequence number, chain, and its atoms
    (``eq=False`` for the same recursion/hashability reasons as Atom)."""

    index: int
    name: str
    resSeq: int
    chain_index: int
    atoms: list[Atom] = field(default_factory=list)

    @property
    def is_protein(self) -> bool:
        # _force_protein is set per-residue by CustomTopology.apply() for
        # user-declared residues — scoped to that topology instead of
        # mutating the module-global set (which would leak protein-ness
        # onto unrelated topologies in the same process)
        return getattr(self, "_force_protein", False) or (
            self.name in _PROTEIN_RESIDUES
        )

    def atom(self, name: str) -> Optional[Atom]:
        for a in self.atoms:
            if a.name == name:
                return a
        return None

    def __repr__(self) -> str:
        return f"{self.name}{self.resSeq}"


class Topology:
    """Atoms grouped into residues and chains, with dihedral index tables."""

    def __init__(self) -> None:
        self.atoms: list[Atom] = []
        self.residues: list[Residue] = []
        self.n_chains: int = 0

    # ------------------------------------------------------------------ build
    def add_residue(self, name: str, resSeq: int, chain_index: int) -> Residue:
        res = Residue(len(self.residues), name, resSeq, chain_index)
        self.residues.append(res)
        self.n_chains = max(self.n_chains, chain_index + 1)
        return res

    def add_atom(self, name: str, element: str, residue: Residue) -> Atom:
        atom = Atom(len(self.atoms), name, element, residue)
        self.atoms.append(atom)
        residue.atoms.append(atom)
        return atom

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)

    @property
    def n_residues(self) -> int:
        return len(self.residues)

    def atom(self, index: int) -> Atom:
        return self.atoms[index]

    def residue(self, index: int) -> Residue:
        return self.residues[index]

    def select(self, expr: str) -> np.ndarray:
        """Tiny selection language: "all", "protein", "backbone", "name CA",
        "not element H" — the subset the EncoderMap workflows need."""
        expr = expr.strip()
        if expr == "all":
            return np.arange(self.n_atoms)
        if expr == "protein":
            return np.array(
                [a.index for a in self.atoms if a.residue.is_protein], dtype=np.int64
            )
        if expr == "backbone":
            return np.array(
                [
                    a.index
                    for a in self.atoms
                    if a.residue.is_protein and a.name in ("N", "CA", "C", "O")
                ],
                dtype=np.int64,
            )
        if expr == "sidechain":
            # backbone names across conventions: CHARMM amide HN, AMBER
            # N-terminal H1-H3 / HT1-HT3, GLY's HA2/HA3, C-terminal
            # OXT/OT1/OT2/OC1/OC2 — classifying those as "sidechain"
            # put backbone protons into sidechain selections (wave 29)
            backbone = {
                "N", "CA", "C", "O", "H", "HA", "HN",
                "H1", "H2", "H3", "HT1", "HT2", "HT3",
                "HA2", "HA3",
                "OXT", "OT1", "OT2", "OC1", "OC2",
            }
            return np.array(
                [
                    a.index
                    for a in self.atoms
                    if a.residue.is_protein and a.name not in backbone
                ],
                dtype=np.int64,
            )
        if expr.startswith("name "):
            names = set(expr[5:].split())
            return np.array(
                [a.index for a in self.atoms if a.name in names], dtype=np.int64
            )
        if expr.startswith("resname "):
            resnames = set(expr[len("resname "):].split())
            return np.array(
                [a.index for a in self.atoms if a.residue.name in resnames],
                dtype=np.int64,
            )
        if expr.startswith("not element "):
            elements = {e.upper() for e in expr[len("not element "):].split()}
            return np.array(
                [a.index for a in self.atoms if a.element.upper() not in elements],
                dtype=np.int64,
            )
        if expr.startswith("element "):
            elements = {e.upper() for e in expr[len("element "):].split()}
            return np.array(
                [a.index for a in self.atoms if a.element.upper() in elements],
                dtype=np.int64,
            )
        raise ValueError(f"unsupported selection {expr!r}")

    # ------------------------------------------------------------------ backbone tables
    def _protein_residues(self) -> list[Residue]:
        return [
            r for r in self.residues
            if r.is_protein and r.atom("CA") is not None and r.atom("N") is not None
            and r.atom("C") is not None
        ]

    def backbone_indices(self) -> np.ndarray:
        """(n_residues, 3) indices of N, CA, C per protein residue."""
        out = []
        for r in self._protein_residues():
            out.append([r.atom("N").index, r.atom("CA").index, r.atom("C").index])
        return np.asarray(out, dtype=np.int64)

    def central_atom_indices(self) -> np.ndarray:
        """Flat N-CA-C chain indices (the ADC 'central cartesians')."""
        return self.backbone_indices().reshape(-1)

    # ------------------------------------------------------------------ dihedral tables
    @staticmethod
    def _peptide_bonded(prev: Residue, cur: Residue) -> bool:
        """Whether two filtered protein residues are plausibly
        peptide-bonded successors: same chain AND contiguous resSeq
        (diff 0 tolerates insertion codes; a crystal structure's
        unresolved loop — resSeq 40 then 48 — or a residue dropped for an
        incomplete backbone must NOT yield a torsion spanning the gap)."""
        return (
            cur.chain_index == prev.chain_index
            and 0 <= cur.resSeq - prev.resSeq <= 1
        )

    @property
    def indices_phi(self) -> np.ndarray:
        """(n-1, 4): C(i-1), N(i), CA(i), C(i)."""
        res = self._protein_residues()
        out = []
        for prev, cur in zip(res[:-1], res[1:]):
            if not self._peptide_bonded(prev, cur):
                continue
            out.append(
                [prev.atom("C").index, cur.atom("N").index,
                 cur.atom("CA").index, cur.atom("C").index]
            )
        return np.asarray(out, dtype=np.int64).reshape(-1, 4)

    @property
    def indices_psi(self) -> np.ndarray:
        """(n-1, 4): N(i), CA(i), C(i), N(i+1)."""
        res = self._protein_residues()
        out = []
        for cur, nxt in zip(res[:-1], res[1:]):
            if not self._peptide_bonded(cur, nxt):
                continue
            out.append(
                [cur.atom("N").index, cur.atom("CA").index,
                 cur.atom("C").index, nxt.atom("N").index]
            )
        return np.asarray(out, dtype=np.int64).reshape(-1, 4)

    @property
    def indices_omega(self) -> np.ndarray:
        """(n-1, 4): CA(i), C(i), N(i+1), CA(i+1)."""
        res = self._protein_residues()
        out = []
        for cur, nxt in zip(res[:-1], res[1:]):
            if not self._peptide_bonded(cur, nxt):
                continue
            out.append(
                [cur.atom("CA").index, cur.atom("C").index,
                 nxt.atom("N").index, nxt.atom("CA").index]
            )
        return np.asarray(out, dtype=np.int64).reshape(-1, 4)

    def chi_table(self, n: int) -> dict[str, list[str]]:
        """resname -> atom names for CHI-n. Subclasses (CustomTopology's
        patched topologies) merge user-defined residues here, which makes
        every chi-derived feature (side dihedrals/angles/distances/
        cartesians) honor unnatural amino acids."""
        return CHI_ATOMS[f"chi{n}"]

    def indices_chi(self, n: int) -> np.ndarray:
        """(m, 4) CHI-n quadruplets over all residues that define it."""
        table = self.chi_table(n)
        out = []
        for r in self._protein_residues():
            names = chi_names_for_residue(table, r)
            if names is None:
                continue
            atoms = [r.atom(nm) for nm in names]
            if any(a is None for a in atoms):
                continue
            out.append([a.index for a in atoms])
        return np.asarray(out, dtype=np.int64).reshape(-1, 4)

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

    def sidechain_info(self) -> dict[int, int]:
        """residue index (1-based, like the reference's sidechain_info) ->
        number of sidechain dihedrals."""
        out = {}
        for i, r in enumerate(self._protein_residues(), start=1):
            count = 0
            for n in range(1, 6):
                names = chi_names_for_residue(self.chi_table(n), r)
                if names and all(r.atom(nm) is not None for nm in names):
                    count += 1
            out[i] = count
        return out

    def to_fasta(self) -> list[str]:
        """One-letter sequence per chain (mdtraj's ``Topology.to_fasta``
        contract, used by the reference's alignment query,
        ``info_all.py:1555``): one record per chain, so a chain with no
        standard amino acids (ligand/solvent) yields an EMPTY string and
        chain numbering stays aligned. Unknown/capping residues become no
        letter; protonation-state variants resolve through their parent."""
        chains: list[list[str]] = [[] for _ in range(self.n_chains)]
        # user-declared one-letter codes (CustomAAsDict tuples) extend the
        # standard table on patched topologies
        custom = getattr(self, "_custom_one_letter", {})
        for r in self.residues:
            name = RESIDUE_VARIANTS.get(r.name, r.name)
            letter = custom.get(r.name) or _AA_ONE_LETTER.get(name)
            if letter:
                chains[r.chain_index].append(letter)
        return ["".join(c) for c in chains]

    def _fingerprint(self) -> tuple:
        """Primitive-only structural identity (used by __eq__/__hash__):
        atom names/elements/residue membership + residue records. Two
        independently parsed copies of one topology file compare equal."""
        return (
            tuple((a.name, a.element, a.residue.index) for a in self.atoms),
            tuple(
                (r.name, r.resSeq, r.chain_index,
                 getattr(r, "_force_protein", False))
                for r in self.residues
            ),
            # custom chi-table patches change dihedral tables without
            # touching atoms — patched and unpatched must NOT compare equal
            getattr(self, "_custom_def_json", None),
        )

    def __eq__(self, other: object) -> bool:
        if self is other:
            return True
        if not isinstance(other, Topology):
            return NotImplemented
        return self._fingerprint() == other._fingerprint()

    def __hash__(self) -> int:
        # computed on demand, NOT cached: CustomTopology.apply() mutates
        # topologies in place, and a stale cache would alias patched and
        # unpatched versions
        return hash(self._fingerprint())

    def __repr__(self) -> str:
        return (
            f"<Topology: {self.n_atoms} atoms, {self.n_residues} residues, "
            f"{self.n_chains} chains>"
        )
