# encodermap_tpu_torch/ops/kabsch.py
"""Weighted Kabsch superposition and batched RMSD.

Counterpart of ``encodermap_tpu/ops/kabsch.py`` (after the reference's
``callbacks/metrics.py:71-246``): ``torch.linalg.svd`` of the weighted
covariance, the same reflection fix (``diag(1, 1, det(U) det(V^T))``),
batched over frames directly. Products run in full float32 (the port keeps
TF32 off), which is what the JAX package's ``Precision.HIGHEST`` asks for.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kabsch_weighted", "rmsd", "align_one", "align_frames"]


def kabsch_weighted(P: torch.Tensor, Q: torch.Tensor,
                    W: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation R and translation t that minimize the weighted RMSD of
    ``P`` onto ``Q``, and that RMSD.

    Args:
        P, Q: ``(..., n, 3)`` coordinates (any leading batch dims).
        W: optional ``(n,)`` weights (default uniform), normalized here.

    Returns:
        ``(rmsd (...,), R (..., 3, 3), t (..., 3))`` with
        ``P_aligned = P @ R^T + t``.
    """
    n = P.shape[-2]
    if W is None:
        W = torch.full((n,), 1.0 / n, dtype=P.dtype, device=P.device)
    else:
        W = W / torch.sum(W)
    w = W[:, None]
    p_bar = torch.sum(P * w, dim=-2)
    q_bar = torch.sum(Q * w, dim=-2)
    Pc = P - p_bar[..., None, :]
    Qc = Q - q_bar[..., None, :]
    C = (Qc * w).transpose(-1, -2) @ Pc
    U, _, Vt = torch.linalg.svd(C, full_matrices=False)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    R = U @ D @ Vt
    t = q_bar - (R @ p_bar[..., None])[..., 0]
    P_aligned = Pc @ R.transpose(-1, -2) + q_bar[..., None, :]
    msd = torch.sum(w * torch.square(P_aligned - Q), dim=(-2, -1))
    return torch.sqrt(torch.clamp(msd, min=0.0)), R, t


def rmsd(P: torch.Tensor, Q: torch.Tensor, W: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """``(batch,)`` minimal RMSD of ``(batch, n, 3)`` sets after optimal
    superposition, with optional ``(n,)`` weights."""
    return kabsch_weighted(P, Q, W)[0]


def align_one(frame: torch.Tensor, ref_sel: torch.Tensor,
              atom_indices=None) -> torch.Tensor:
    """Kabsch-fit one frame ``(n_atoms, 3)`` onto ``ref_sel`` on its
    selected fit atoms and move the whole frame (the per-frame function
    that the JAX package's ``align_frames`` maps over the frames)."""
    fit = frame if atom_indices is None else frame[atom_indices]
    _, R, t = kabsch_weighted(fit, ref_sel)
    return frame @ R.transpose(-1, -2) + t


def align_frames(xyz: torch.Tensor, ref: torch.Tensor,
                 atom_indices=None, ref_atom_indices=None) -> torch.Tensor:
    """Kabsch-fit every frame of ``xyz`` ``(n_frames, n_atoms, 3)`` onto
    ``ref`` ``(n_ref_atoms, 3)`` on the selected fit atoms, then move the
    WHOLE frame by that rotation and translation."""
    ref_sel = ref if ref_atom_indices is None else ref[ref_atom_indices]
    fit = xyz if atom_indices is None else xyz[:, atom_indices]
    _, R, t = kabsch_weighted(fit, ref_sel.expand(fit.shape))
    return xyz @ R.transpose(-1, -2) + t[:, None, :]
