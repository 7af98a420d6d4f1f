"""The CVs of the ADC's multimer training on a homodimer: each chain's
bond angles, dihedrals, bond lengths and sidechain dihedrals uniform on
the mix's ranges, drawn on the device from the seed, each chain's backbone
(N, CA, C per residue) built from them in float64 by
``generators.nerf_chain``, and every chain after the first placed by a
rigid transform drawn per frame: a rotation uniform on SO(3) (the QR of a
Gaussian matrix, its columns' signs fixed by R's diagonal, a column turned
where the determinant is -1) and a shift uniform on the mix's ``shift``
range per axis, applied to row vectors as ``[xyz, 1] @ M`` with ``M[:3,
:3]`` the rotation's transpose and ``M[3, :3]`` the shift. Each CV is the
chains' columns one chain after the other, as the program's
``multimer_lengths`` reads them; float32 host arrays keyed by the
program's CV names, made in blocks of ``generators.BLOCK`` frames."""

from __future__ import annotations

import numpy as np
import torch

from portbench import generators, proteins

#: (CV, width key, the mix's range key), in the order each chain draws them
DRAWS = (("central_angles", "angles", "angles"),
         ("central_dihedrals", "dihedrals", "dihedrals"),
         ("central_distances", "distances", "distances"),
         ("side_dihedrals", "side_dihedrals", "side_dihedrals"))


def rigid(gen: torch.Generator, n: int, shift: list, device) -> torch.Tensor:
    """``(n, 4, 4)`` float64 transforms for row vectors, one a frame."""
    g = torch.randn((n, 3, 3), generator=gen, device=device, dtype=torch.float32)
    q, r = torch.linalg.qr(g.to(torch.float64))
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    q[:, :, 0] *= torch.sign(torch.linalg.det(q))[:, None]
    lo, hi = shift
    m = torch.eye(4, dtype=torch.float64, device=device).repeat(n, 1, 1)
    m[:, :3, :3] = q.transpose(1, 2)
    m[:, 3, :3] = generators._uniform(gen, (n, 3), lo, hi, device).to(torch.float64)
    return m


def chains(traffic: dict) -> list[str]:
    """The sequence of each chain: the mix's protein ``chains`` times."""
    return [proteins.sequence(traffic["protein"])] * int(traffic["chains"])


def block(traffic: dict, seqs: list, gen: torch.Generator, n: int,
          device) -> tuple[dict, torch.Tensor]:
    """``n`` frames of the chains ``seqs``: each CV's columns chain after
    chain (float32 on the device), the float64 coordinates of every chain
    placed, and the ``(n, chains - 1, 4, 4)`` transforms that placed chains
    2.. ."""
    parts: dict = {k: [] for k, _, _ in DRAWS}
    xyz, mats = [], []
    for c, seq in enumerate(seqs):
        w = proteins.widths(seq)
        drawn = {k: generators._uniform(gen, (n, w[col]), *traffic[r], device)
                 for k, col, r in DRAWS}
        chain = generators.nerf_chain(drawn["central_distances"], drawn["central_angles"],
                                      drawn["central_dihedrals"])
        if c:
            m = rigid(gen, n, traffic["shift"], device)
            chain = chain @ m[:, :3, :3] + m[:, None, 3, :3]
            mats.append(m)
        for k, v in drawn.items():
            parts[k].append(v)
        xyz.append(chain)
    out = {k: torch.cat(v, 1) for k, v in parts.items()}
    out["central_cartesians"] = torch.cat(xyz, 1)
    return out, torch.stack(mats, 1)


def make(traffic: dict, seed: int, device, frames: int) -> dict:
    gen = torch.Generator(device=device).manual_seed(generators.stream_seed(seed, "data"))
    out: dict = {}
    for s in range(0, frames, generators.BLOCK):
        n = min(generators.BLOCK, frames - s)
        with torch.no_grad():
            cvs, _ = block(traffic, chains(traffic), gen, n, device)
        for k, v in cvs.items():
            if k not in out:
                out[k] = np.empty((frames,) + tuple(v.shape[1:]), np.float32)
            out[k][s:s + n] = v.to(torch.float32).cpu().numpy()
        del cvs
    return out
