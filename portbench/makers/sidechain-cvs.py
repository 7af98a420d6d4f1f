"""The CVs of the ADC's sidechain-reconstruction mode: a protein's central
bond angles, dihedrals and bond lengths, and one bond angle and one bond
length per sidechain atom and one dihedral per sidechain dihedral (chi1 to
chi5, ``proteins.CHI_COUNT``), uniform on the mix's ranges and drawn on the
device from the seed, with every atom's coordinates (``all_cartesians``)
built from them in float64 by the plain sweep (``reference/sidechains.py``),
in blocks of ``generators.BLOCK`` frames; float32 host arrays keyed by the
program's CV names."""

from __future__ import annotations

import numpy as np
import torch

from portbench import generators, proteins
from portbench.reference import sidechains

#: (CV, width key, the mix's range key), in the order they are drawn
DRAWS = (("central_angles", "angles", "angles"),
         ("central_dihedrals", "dihedrals", "dihedrals"),
         ("central_distances", "distances", "distances"),
         ("side_angles", "side_atoms", "side_angles"),
         ("side_dihedrals", "side_dihedrals", "side_dihedrals"),
         ("side_distances", "side_atoms", "side_distances"))


def sidechain_info(seq: str) -> dict:
    """Residue (from 1) -> its sidechain dihedrals."""
    return {i + 1: proteins.CHI_COUNT[c] for i, c in enumerate(seq)}


def make(traffic: dict, seed: int, device, frames: int) -> dict:
    seq = proteins.sequence(traffic["protein"])
    info = sidechain_info(seq)
    w = proteins.widths(seq)
    w["side_atoms"] = sum(v + 1 for v in info.values() if v)
    n_atoms = w["n_atoms"] + w["side_atoms"]
    gen = torch.Generator(device=device).manual_seed(generators.stream_seed(seed, "data"))
    out = {k: np.empty((frames, w[col]), np.float32) for k, col, _ in DRAWS}
    out["all_cartesians"] = np.empty((frames, n_atoms, 3), np.float32)
    for s in range(0, frames, generators.BLOCK):
        n = min(generators.BLOCK, frames - s)
        parts = {k: generators._uniform(gen, (n, w[col]), *traffic[r], device)
                 for k, col, r in DRAWS}
        with torch.no_grad():
            xyz = sidechains.sweep(info, *(parts[k].to(torch.float64) for k in (
                "central_distances", "central_angles", "central_dihedrals",
                "side_distances", "side_angles", "side_dihedrals")))
        for k, v in parts.items():
            out[k][s:s + n] = v.cpu().numpy()
        out["all_cartesians"][s:s + n] = xyz.to(torch.float32).cpu().numpy()
        del xyz
    return out
