"""The general generators that turn a traffic mix's parameters and a seed
into training data, made on the device with a ``torch.Generator`` and
handed to the program (and later to the reference) as host arrays.

A traffic mix is a data file ``portbench/traffic/<name>.json`` whose
``generator`` key names one of :data:`GENERATORS`, or else a maker
``portbench/makers/<generator>.py`` that ``harness.make_data`` loads: a new
mix of a kind that exists is a new data file and no code, and a new kind
of data is a new maker file beside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import proteins

#: frames made in one device call; bounds the float64 chain's memory
BLOCK = 1 << 17


def stream_seed(seed: int, stream: str) -> int:
    """A generator seed per use (data, weights, check rows) from the run's
    seed, so the streams do not overlap; any whole number works."""
    h = 1469598103934665603
    for ch in f"{int(seed)}/{stream}":
        h = ((h ^ ord(ch)) * 1099511628211) & ((1 << 64) - 1)
    return h & ((1 << 63) - 1)


def _uniform(gen: torch.Generator, shape: tuple, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float32)


def dihedral_frames(traffic: dict, seed: int, device, frames: int) -> np.ndarray:
    """``(frames, columns)`` float32 angles uniform on ``[low, high)``; the
    columns are a protein's backbone dihedrals (3 n - 3) where the mix
    names a protein."""
    cols = traffic.get("columns")
    if cols is None:
        cols = proteins.widths(proteins.sequence(traffic["protein"]))["dihedrals"]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "data"))
    lo, hi = traffic["range"]
    out = np.empty((frames, int(cols)), np.float32)
    for s in range(0, frames, BLOCK):
        n = min(BLOCK, frames - s)
        out[s:s + n] = _uniform(gen, (n, int(cols)), lo, hi, device).cpu().numpy()
    return out


def nerf_chain(distances: torch.Tensor, angles: torch.Tensor,
               dihedrals: torch.Tensor) -> torch.Tensor:
    """Backbone coordinates from internal coordinates by NeRF, in float64:
    atom 0 at the origin, atom 1 on x, atom 2 in the xy-plane at bond
    angle ``angles[:, 0]``, then each atom k >= 3 at bond length
    ``distances[:, k - 1]``, bond angle ``angles[:, k - 2]`` at atom k - 1
    and torsion ``dihedrals[:, k - 3]`` about bond (k - 2, k - 1), in the
    IUPAC sense. ``(B, n - 1)``, ``(B, n - 2)``, ``(B, n - 3)`` in,
    ``(B, n, 3)`` out."""
    d, a, t = (x.to(torch.float64) for x in (distances, angles, dihedrals))
    B, n = d.shape[0], d.shape[1] + 1
    zeros = torch.zeros(B, dtype=torch.float64, device=d.device)
    xyz = [torch.stack([zeros, zeros, zeros], -1),
           torch.stack([d[:, 0], zeros, zeros], -1)]
    xyz.append(xyz[1] + d[:, 1, None] * torch.stack(
        [-torch.cos(a[:, 0]), torch.sin(a[:, 0]), zeros], -1))
    for k in range(3, n):
        pa, pb, pc = xyz[k - 3], xyz[k - 2], xyz[k - 1]
        bc = pc - pb
        bc = bc / torch.linalg.norm(bc, dim=-1, keepdim=True)
        nrm = torch.linalg.cross(pb - pa, bc, dim=-1)
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
        m = torch.linalg.cross(nrm, bc, dim=-1)
        ang, tor = a[:, k - 2, None], t[:, k - 3, None]
        xyz.append(pc + d[:, k - 1, None] * (-torch.cos(ang) * bc
                                             + torch.sin(ang) * torch.cos(tor) * m
                                             + torch.sin(ang) * torch.sin(tor) * nrm))
    return torch.stack(xyz, 1)


def protein_cvs(traffic: dict, seed: int, device, frames: int) -> dict:
    """The ADC's CVs of a backbone (N, CA, C per residue): bond angles,
    dihedrals, bond lengths and sidechain dihedrals uniform on the mix's
    ranges, and the coordinates built from them by :func:`nerf_chain`;
    float32 host arrays keyed by the program's CV names."""
    w = proteins.widths(proteins.sequence(traffic["protein"]))
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "data"))
    names = ("central_angles", "central_dihedrals", "central_distances",
             "side_dihedrals")
    cols = (w["angles"], w["dihedrals"], w["distances"], w["side_dihedrals"])
    ranges = (traffic["angles"], traffic["dihedrals"], traffic["distances"],
              traffic["side_dihedrals"])
    out = {k: np.empty((frames, c), np.float32) for k, c in zip(names, cols)}
    out["central_cartesians"] = np.empty((frames, w["n_atoms"], 3), np.float32)
    for s in range(0, frames, BLOCK):
        n = min(BLOCK, frames - s)
        parts = {k: _uniform(gen, (n, c), *r, device)
                 for k, c, r in zip(names, cols, ranges)}
        xyz = nerf_chain(parts["central_distances"], parts["central_angles"],
                         parts["central_dihedrals"])
        for k, v in parts.items():
            out[k][s:s + n] = v.cpu().numpy()
        out["central_cartesians"][s:s + n] = xyz.to(torch.float32).cpu().numpy()
    return out


GENERATORS = {"dihedral_frames": dihedral_frames, "protein_cvs": protein_cvs}


def make(traffic: dict, seed: int, device, frames: int | None = None):
    """The mix's data at its own frame count, or at ``frames`` (tests)."""
    return GENERATORS[traffic["generator"]](
        traffic, seed, device, int(frames if frames is not None else traffic["frames"]))


def frame_count(data) -> int:
    """The frames of a mix's data: the rows of its array, or of its CV
    dict's ``central_angles`` where it has them, else of its first CV."""
    if not isinstance(data, dict):
        return len(data)
    return len(data["central_angles"] if "central_angles" in data
               else next(iter(data.values())))


def check_rows(n_frames: int, steps: int, batch: int, seed: int, device) -> np.ndarray:
    """``(steps, batch)`` row indices, all different, drawn from the seed:
    the batches of the steps that the reference follows."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "check"))
    if n_frames < steps * batch:
        raise ValueError(f"{n_frames} frames cannot give {steps} batches of "
                         f"{batch} different rows")
    perm = torch.randperm(n_frames, generator=gen, device=device)[:steps * batch]
    return perm.reshape(steps, batch).cpu().numpy()


def weights(names_shapes: list, seed: int, device) -> dict:
    """float32 weights on the device, from the seed in one call: each
    kernel uniform with variance 1 / fan_in (Keras' VarianceScaling), each
    bias with the reference's RandomNormal(0.1, 0.05) mean and spread."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "weights"))
    total = sum(math.prod(s) for _, s in names_shapes)
    u = 2.0 * torch.rand(total, generator=gen, device=device, dtype=torch.float32) - 1.0
    out, i = {}, 0
    for name, shape in names_shapes:
        k = math.prod(shape)
        x = u[i:i + k].reshape(shape)
        i += k
        if name.endswith("kernel"):
            out[name] = x * math.sqrt(3.0 / shape[0])
        else:
            out[name] = 0.1 + 0.05 * math.sqrt(3.0) * x
    return out
