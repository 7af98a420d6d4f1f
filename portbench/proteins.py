"""Proteins the traffic mixes name: sequences and sidechain dihedral counts.

Sequences are copied from the bring-up proof (``chip_smoke.py``: trp-cage
``NLYIQWLKDGGPSSGRPPPS``, ubiquitin 1UBQ); the count of sidechain dihedrals
per residue type follows mdtraj's chi1-chi5 definitions (chi1 on every
residue but ALA and GLY, chi2 on ARG ASN ASP GLN GLU HIS ILE LEU LYS MET
PHE PRO TRP TYR, chi3 on ARG GLN GLU LYS MET, chi4 on ARG LYS, chi5 on
ARG), which gives trp-cage's 37 (``TRP_CAGE_SIDECHAIN_INFO`` there) and
diubiquitin's 322.
"""

from __future__ import annotations

SEQUENCES = {
    "trp-cage": "NLYIQWLKDGGPSSGRPPPS",
    "ubiquitin": "MQIFVKTLTGKTITLEVEPSDTIENVKAKIQDKEGIPPDQQRLIFAGKQLEDGRTLSDYNIQKESTLHLVLRLRGG",
}

CHI_COUNT = {
    "A": 0, "G": 0, "C": 1, "S": 1, "T": 1, "V": 1, "D": 2, "F": 2, "H": 2,
    "I": 2, "L": 2, "N": 2, "P": 2, "W": 2, "Y": 2, "E": 3, "M": 3, "Q": 3,
    "K": 4, "R": 5,
}


def sequence(spec: dict) -> str:
    """The one-letter sequence of a traffic mix's ``protein``: the named
    chain repeated ``copies`` times (diubiquitin is ubiquitin twice, linked
    head to tail)."""
    return SEQUENCES[spec["name"]] * int(spec.get("copies", 1))


def widths(seq: str) -> dict:
    """The CV widths of a backbone of N, CA and C per residue."""
    n_atoms = 3 * len(seq)
    return {"n_atoms": n_atoms, "angles": n_atoms - 2, "dihedrals": n_atoms - 3,
            "distances": n_atoms - 1,
            "side_dihedrals": sum(CHI_COUNT[c] for c in seq)}
