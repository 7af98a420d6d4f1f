# encodermap_tpu_torch/loading/alignment.py
"""ClustalW alignment support for cross-topology ensemble featurization.

The reference lets a ClustalW multiple-sequence alignment drive the generic
feature labels so residues of *homologous* positions align across different
proteins (``TrajEnsemble.parse_clustal_w_alignment``,
``encodermap/trajinfo/info_all.py:1560``; label logic at
``loading/features.py:3170-3191``). Here: parse the alignment, build per-
sequence residue->alignment-column maps, and rewrite the residue numbers in
generic labels before the NaN-padded union alignment.

Counterpart of ``encodermap_tpu/loading/alignment.py``; host numpy, copied near verbatim.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Union

__all__ = ["parse_clustal_w", "residue_to_column_maps", "apply_alignment_to_labels"]


def parse_clustal_w(text_or_path: Union[str, Path]) -> dict[str, str]:
    """Parse a CLUSTAL-format alignment into {sequence_name: aligned_seq}.

    Accepts the alignment text itself or a path to a file.
    """
    text = str(text_or_path)
    if "\n" not in text:
        p = Path(text)
        if p.exists():
            text = p.read_text()
        elif isinstance(text_or_path, Path) or p.suffix.lower() in (
            ".aln", ".clustal", ".clustal_num", ".txt", ".fasta",
        ):
            # clearly a (typo'd) file path, not alignment text — parsing
            # it as text would yield an empty mapping and a confusing
            # downstream error
            raise FileNotFoundError(f"alignment file not found: {text}")
    seqs: dict[str, str] = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith(("CLUSTAL", "MUSCLE")):
            continue
        # conservation lines contain only  * : . and spaces
        if re.fullmatch(r"[\s*:.]+", line):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        name, chunk = parts[0], parts[1]
        if not re.fullmatch(r"[A-Za-z\-]+", chunk):
            continue
        seqs[name] = seqs.get(name, "") + chunk
    return seqs


def residue_to_column_maps(seqs: dict[str, str]) -> dict[str, dict[int, int]]:
    """Per sequence: 1-based residue index -> 1-based alignment column."""
    out: dict[str, dict[int, int]] = {}
    for name, seq in seqs.items():
        mapping: dict[int, int] = {}
        res_i = 0
        for col, ch in enumerate(seq, start=1):
            if ch != "-":
                res_i += 1
                mapping[res_i] = col
        out[name] = mapping
    return out


_RES_NUM_RE = re.compile(r"(\d+)\s*$")


def apply_alignment_to_labels(
    labels: list[str], res_to_col: dict[int, int]
) -> list[str]:
    """Rewrite the trailing residue number of each generic label to its
    alignment column, so homologous residues share labels across
    topologies."""
    # residues NOT covered by the alignment (e.g. a truncated construct)
    # must never collide with a real alignment column — a raw-number
    # fallback could equal another residue's column and the ensemble
    # aligner would silently MERGE two different dihedrals into one
    # NaN-padded column (review wave 26). Unmapped residues are shifted
    # past the last column instead, keeping them distinct.
    max_col = max(res_to_col.values(), default=0)
    out = []
    warned = False
    for lbl in labels:
        m = _RES_NUM_RE.search(lbl)
        if m:
            res_i = int(m.group(1))
            if " PHI " in lbl:
                # PHI ordinal i is the phi OF residue i+1 (the first
                # residue has no phi) — the reference maps phi labels to
                # the [1:] alignment columns (features.py:3178-3182);
                # using residue i's column was off by one at every
                # alignment gap boundary (wave 32)
                res_i += 1
            col = res_to_col.get(res_i)
            if col is None:
                col = max_col + res_i
                if not warned:
                    warned = True
                    import warnings

                    warnings.warn(
                        f"residue {res_i} is not covered by the ClustalW "
                        f"alignment; its labels are renumbered past the "
                        f"last alignment column ({max_col}) so they can't "
                        f"collide with aligned residues.",
                        stacklevel=2,
                    )
            lbl = lbl[: m.start(1)] + str(col)
        out.append(lbl)
    return out
