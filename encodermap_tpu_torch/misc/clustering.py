# encodermap_tpu_torch/misc/clustering.py
"""Cluster utilities: the pairwise-RMSD matrix, the RMSD centroid of a
cluster, cluster dictionaries.

Counterpart of ``encodermap_tpu/misc/clustering.py`` (after the reference's
``misc/clustering.py:93-292``). The JAX package takes all ``max_frames²``
pairs in one ``vmap``; at 500 frames of 1,066 atoms that is about 3.2 GB of
float32 per intermediate. Here the matrix is built on the device in blocks
of rows, each block a batch of Kabsch fits (``ops/kabsch.py``) whose
intermediates stay under ``RMSD_BLOCK_BYTES``. Each frame is centred once; every
pair then takes its covariance, SVD, rotation and RMSD exactly as
``kabsch_weighted`` does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["pairwise_rmsd_matrix", "rmsd_centroid_of_cluster", "cluster_to_dict"]

#: bytes of float32 intermediates a row block of the RMSD matrix may hold
RMSD_BLOCK_BYTES = 256 << 20


def _subsample(n: int, max_frames: int) -> np.ndarray:
    """The frames the matrix is computed on: all, or ``max_frames`` spread
    evenly (the JAX package's ``linspace``)."""
    if n > max_frames:
        return np.linspace(0, n - 1, max_frames).astype(int)
    return np.arange(n)


def pairwise_rmsd_matrix(xyz: np.ndarray, max_frames: int = 500,
                         device: Any = None) -> np.ndarray:
    """All-pairs minimal RMSD (nm) of ``(n_frames, n_atoms, 3)``
    coordinates, on ``device`` (the card unless ``device="cpu"``).

    ``out[i, j]`` is the RMSD of frame i fitted onto frame j. More than
    ``max_frames`` frames are subsampled evenly, as in the JAX package.
    """
    dev = resolve_device(device)
    xyz = np.asarray(xyz, np.float32)
    xyz = xyz[_subsample(len(xyz), max_frames)]
    n, n_atoms = xyz.shape[:2]
    x = torch.as_tensor(xyz, device=dev)
    w = torch.full((n_atoms, 1), 1.0 / n_atoms, dtype=x.dtype, device=dev)
    centre = torch.sum(x * w, dim=-2)                  # (n, 3)
    xc = x - centre[:, None, :]                        # (n, A, 3)
    # a pair holds about four (A, 3) float32 arrays at once
    rows = max(1, min(n, RMSD_BLOCK_BYTES // max(1, 4 * n * n_atoms * 3 * 4)))
    out = torch.empty((n, n), dtype=x.dtype, device=dev)
    with torch.no_grad():
        for i0 in range(0, n, rows):
            i1 = min(n, i0 + rows)
            pc = xc[i0:i1, None]                       # P: the block's frames
            qc = xc[None]                              # Q: every frame
            cov = (qc * w).transpose(-1, -2) @ pc      # (b, n, 3, 3)
            U, _, Vt = torch.linalg.svd(cov, full_matrices=False)
            det = torch.linalg.det(U) * torch.linalg.det(Vt)
            D = torch.diag_embed(torch.stack(
                [torch.ones_like(det), torch.ones_like(det), det], dim=-1))
            R = U @ D @ Vt
            q_bar = centre[None, :, None, :]
            aligned = pc @ R.transpose(-1, -2) + q_bar
            msd = torch.sum(w * torch.square(aligned - x[None]), dim=(-2, -1))
            out[i0:i1] = torch.sqrt(torch.clamp(msd, min=0.0))
    return out.cpu().numpy()


def rmsd_centroid_of_cluster(xyz: np.ndarray, max_frames: int = 500,
                             device: Any = None) -> tuple[int, np.ndarray]:
    """Frame index and pairwise-RMSD matrix of a cluster's centroid: the
    frame with the largest similarity ``sum_j exp(-D_ij / D.std())``
    (reference ``clustering.py:93-129``). The index refers to the frames of
    ``xyz`` also when the matrix was computed on a subsample."""
    xyz = np.asarray(xyz, np.float32)
    subsample = _subsample(len(xyz), max_frames)
    distances = pairwise_rmsd_matrix(xyz, max_frames, device=device)
    beta = 1.0
    std = distances.std()
    if std == 0.0:  # identical frames: any one is the centroid
        return int(subsample[0]), distances
    local = int(np.exp(-beta * distances / std).sum(axis=1).argmax())
    return int(subsample[local]), distances


def cluster_to_dict(trajs, align_string: str = "name CA",
                    ref_align_string: str = "name CA", base_traj=None):
    """Joined and stacked views of a cluster sub-ensemble, the reference's
    contract (``clustering.py:130-292``). Pass the ``TrajEnsemble`` that
    ``trajs.cluster(cluster_id)`` returns; the dict holds

    * ``"ensemble"``: the input ensemble,
    * ``"series"``: the per-frame values of the cluster's membership CV,
    * ``"joined_per_top"``: topology -> its members' frames superposed and
      joined along time,
    * ``"joined"``: all frames as one trajectory (when every member has the
      same atom count; on ``base_traj``'s topology when given), and
    * ``"stacked"``: every frame stacked along the atom axis into one frame.

    An integer membership array gives ``{cluster_id: frame_indices}``
    instead (ids of -1 left out).
    """
    if not hasattr(trajs, "trajs"):
        clusters = np.asarray(trajs)
        if clusters.dtype.kind not in "iu":
            raise TypeError(
                "cluster_to_dict takes the TrajEnsemble from "
                "trajs.cluster(...) (reference contract) or an integer "
                f"membership array; got {type(trajs).__name__} of dtype "
                f"{clusters.dtype}")
        return {int(cid): np.where(clusters == cid)[0]
                for cid in np.unique(clusters) if cid != -1}

    # the membership CV: integer-valued with one unique id
    # (reference clustering.py:180-211)
    col = None
    for name, values in trajs.CVs.items():
        x = np.asarray(values, np.float64).ravel()
        x = x[~np.isnan(x)]
        if x.size and np.all(np.mod(x, 1) == 0) and len(np.unique(x)) == 1:
            col = name
            break
    if col is None:
        raise Exception(
            "Could not find a CV with a single integer cluster id. Make "
            "sure to pass the sub-ensemble from trajs.cluster(cluster_id).")
    series = np.concatenate([np.asarray(t._CVs.entry(col).data).ravel()
                             for t in trajs.trajs])

    from ..data.trajectory import TrajEnsemble

    groups: dict = {}
    all_sup = []
    for t in trajs.trajs:
        grp = groups.get(t.top)
        ref = grp[0].get_single_frame(0) if grp else t.get_single_frame(0)
        sup = t.superpose(ref, frame=0, atom_indices=t.top.select(align_string),
                          ref_atom_indices=ref.top.select(ref_align_string))
        groups.setdefault(t.top, []).append(sup)
        all_sup.append(sup)
    # one ensemble per view, not pairwise joins: each of those re-copies
    # every frame joined so far
    joined_per_top = {top: (lst[0] if len(lst) == 1 else TrajEnsemble(lst).traj_joined)
                      for top, lst in groups.items()}
    out = {"ensemble": trajs, "series": series, "joined_per_top": joined_per_top}
    if all(t.n_atoms == trajs.trajs[0].n_atoms for t in trajs.trajs):
        joined = all_sup[0] if len(all_sup) == 1 else TrajEnsemble(all_sup).traj_joined
        if base_traj is not None:
            # the cluster's coordinates on the parent trajectory's topology
            # (reference clustering.py:245-275)
            if base_traj.n_atoms != joined.n_atoms:
                raise ValueError(
                    f"base_traj has {base_traj.n_atoms} atoms but the "
                    f"cluster frames have {joined.n_atoms}; coordinates "
                    f"cannot be applied")
            from ..data.cvstore import CVCollection

            host = base_traj._shallow_copy()
            host._CVs = CVCollection()
            host._xyz = joined.xyz
            host._time = joined.time
            host._unitcell = None
            host._materialized = True
            host._n_frames_file = len(joined.xyz)
            host.index = None
            joined = host
        out["joined"] = joined
        frames = [s.get_single_frame(i) for s in all_sup for i in range(s.n_frames)]
        out["stacked"] = frames[0] if len(frames) == 1 else TrajEnsemble(frames).stack()
    return out
