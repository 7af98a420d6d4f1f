# encodermap_tpu_torch/ops/distances.py
"""Distance functions: Euclidean, periodic and pairwise, on torch tensors.

Counterpart of ``encodermap_tpu/ops/distances.py`` (itself after the
reference's ``misc/distances.py:66-255``), with the same guards:

* :func:`sqrt_guard` gives an exact zero value AND zero gradient where the
  squared distance is zero (+1e-16 under the mask, then re-zero).
* :func:`pairwise_dist_periodic` adds 1e-12 to exactly-zero component
  distances and 1e-12 after the sqrt; from 16 dimensions on it takes the
  min-image Gram split, which drops the per-component shift, exactly as the
  JAX package does.
* :func:`pairwise_dist` takes direct differences below 16 dimensions and the
  Gram identity from 16 on.

Matrix products here run in full float32 (the port turns TF32 off on the
card), which is what ``precision="highest"`` asks of XLA.
"""

from __future__ import annotations

from math import pi
from typing import Callable

import numpy as np
import torch

__all__ = [
    "sigmoid",
    "sig_value",
    "dsig_over_r",
    "periodic_distance",
    "periodic_distance_np",
    "pairwise_dist",
    "pairwise_dist_periodic",
    "sqrt_guard",
    "component_plane_dists",
    "triu_indices_mask",
]

#: feature dim at/above which the full-matrix paths switch to the Gram
#: identity, as in the JAX package
_GRAM_MIN_DIM = 16


def sqrt_guard(d2: torch.Tensor) -> torch.Tensor:
    """``sqrt(d2)`` with an exact zero value and zero gradient where
    ``d2 == 0``."""
    mask = (d2 == 0.0).to(d2.dtype)
    return torch.sqrt(d2 + mask * 1e-16) * (1.0 - mask)


def component_plane_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances ``(..., R, n)`` between the length-3 rows of
    ``a`` ``(..., R, 3)`` and ``b`` ``(..., n, 3)``, summed one coordinate
    at a time, with :func:`sqrt_guard`'s diagonal convention: the dense,
    analytic and blocked Cartesian losses give equal values only because
    they all guard the diagonal this one way."""
    d2 = None
    for c in range(3):
        diff = a[..., c][..., :, None] - b[..., c][..., None, :]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return sqrt_guard(d2)


def sigmoid(sig: float, a: float, b: float
            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Sketch-map's sigmoid ``1 - (1 + (2^(a/b)-1)(r/sig)^a)^(-b/a)`` with
    its parameters closed over.

    Example:
        >>> from encodermap_tpu_torch.ops.distances import sigmoid
        >>> round(float(sigmoid(1.0, 2, 2)(torch.tensor(1.0))), 6)
        0.5
    """
    def func(r):
        return sig_value(r, sig, a, b)

    return func


def sig_value(r, sig, a, b):
    """Sketch-map sigmoid on precomputed distances; the one definition the
    losses, the fused trainer and the kernels' plain versions share."""
    c = 2.0 ** (a / b) - 1.0
    return 1.0 - (1.0 + c * (r / sig) ** a) ** (-b / a)


def dsig_over_r(r2, r, sig, a, b):
    """``s'(r)/r``: the smooth form for ``a == 2`` (no singularity at r=0)
    and a guarded general form otherwise. ``r2`` is ``r**2``, exactly zero
    on the diagonal."""
    c = 2.0 ** (a / b) - 1.0
    if a == 2:
        base = 1.0 + c * r2 / sig**2
        return (b * c / sig**2) * base ** (-b / a - 1.0)
    zero = r2 == 0.0
    r_safe = torch.where(zero, torch.ones_like(r), r)
    t = (r_safe / sig) ** a
    out = b * c * t * (1.0 + c * t) ** (-b / a - 1.0) / torch.square(r_safe)
    return torch.where(zero, torch.zeros_like(out), out)


def periodic_distance_np(a: np.ndarray, b: np.ndarray,
                         periodicity: float = 2 * pi) -> np.ndarray:
    """NumPy min-image distance ``min(|b-a|, P-|b-a|)`` (reference
    ``misc/distances.py:91-110``).

    Example:
        >>> from encodermap_tpu_torch.ops.distances import periodic_distance_np
        >>> round(float(periodic_distance_np(3.0, -3.0)), 6)
        0.283185
    """
    d = np.abs(b - a)
    return np.minimum(d, periodicity - d)


def triu_indices_mask(n: int) -> np.ndarray:
    """Boolean ``(n, n)`` mask of the strict upper triangle, the
    reference's ``flat=True`` order (``misc/distances.py:235-242``)."""
    mask = np.ones((n, n), dtype=bool)
    mask[np.tril_indices(n)] = False
    return mask


def periodic_distance(a: torch.Tensor, b: torch.Tensor,
                      periodicity: float = 2 * pi) -> torch.Tensor:
    """Min-image distance ``min(|b-a|, P-|b-a|)``; ``float('inf')`` means no
    periodicity."""
    d = torch.abs(b - a)
    if periodicity == float("inf"):
        return d
    return torch.minimum(d, periodicity - d)


def pairwise_dist_periodic(positions: torch.Tensor, periodicity: float
                           ) -> torch.Tensor:
    """All-pairs distance ``(n, n)`` of periodic ``(n, d)`` data.

    From ``d >= 16`` on the squared min-image distance is split as
    ``delta^2 - 2P * relu(|delta| - P/2)``, whose ``delta^2`` term is a Gram
    product (the JAX package's choice, kept so both compute alike)."""
    if positions.ndim != 2:
        raise ValueError("positions must be (n_points, n_dims)")
    if positions.shape[-1] >= _GRAM_MIN_DIM and np.isfinite(periodicity):
        sq = torch.sum(torch.square(positions), dim=-1)
        gram = positions @ positions.T
        delta2 = sq[:, None] + sq[None, :] - 2.0 * gram
        corr = (2.0 * periodicity) * torch.relu(
            torch.abs(positions[:, None, :] - positions[None, :, :])
            - periodicity / 2
        ).sum(-1)
        d2 = torch.clamp(delta2 - corr, min=0.0)
        n = d2.shape[0]
        d2 = d2 * (1.0 - torch.eye(n, dtype=d2.dtype, device=d2.device))
        return sqrt_guard(d2) + 1e-12
    vecs = periodic_distance(
        positions[:, None, :], positions[None, :, :], periodicity
    )
    mask = (vecs == 0.0).to(positions.dtype)
    vecs = vecs + mask * 1e-12
    return torch.sqrt(torch.sum(torch.square(vecs), dim=2)) + 1.0e-12


def pairwise_dist(positions: torch.Tensor, squared: bool = False,
                  flat: bool = False, method: str = "auto") -> torch.Tensor:
    """All-pairs Euclidean distance of ``(n, d)`` or ``(b, n, d)`` points.

    ``method="auto"`` takes the Gram identity for ``d >= 16`` and direct
    differences below; ``"gram"``/``"direct"`` force a path. ``flat`` keeps
    only the strict upper triangle, row-major. A 2-D input gives a
    ``(1, n, n)`` result, as in the reference.
    """
    if positions.ndim == 2:
        positions = positions[None]
    use_gram = method == "gram" or (
        method == "auto" and positions.shape[-1] >= _GRAM_MIN_DIM
    )
    if flat:
        n = positions.shape[1]
        iu = torch.triu_indices(n, n, offset=1, device=positions.device)
        d2 = None
        for c in range(positions.shape[-1]):
            comp = positions[..., c]
            sq = torch.square(comp[:, iu[0]] - comp[:, iu[1]])
            d2 = sq if d2 is None else d2 + sq
    elif use_gram:
        sq = torch.sum(torch.square(positions), dim=-1)
        gram = positions @ positions.transpose(-1, -2)
        d2 = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * gram, min=0.0)
        n = d2.shape[-1]
        d2 = d2 * (1.0 - torch.eye(n, dtype=d2.dtype, device=d2.device))
    else:
        d2 = None
        for c in range(positions.shape[-1]):
            comp = positions[..., c]
            sq = torch.square(comp[:, :, None] - comp[:, None, :])
            d2 = sq if d2 is None else d2 + sq
    if squared:
        return d2
    return sqrt_guard(d2)
