# encodermap_tpu_torch/misc/misc.py
"""The hypercube toy dataset, the fallback training data of EncoderMap.

Counterpart of ``encodermap_tpu/misc/misc.py::create_n_cube``. It is numpy,
copied line for line, so the same seed gives bit-identical data in both
packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["create_n_cube"]


def create_n_cube(
    n: int = 3,
    points_along_edge: int = 500,
    sigma: float = 0.05,
    same_colored_edges: int = 3,
    seed: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Points along the edges of an n-dimensional unit hypercube with optional
    Gaussian noise; returns (coordinates, edge-color ids).

    Example:
        >>> from encodermap_tpu_torch.misc import create_n_cube
        >>> data, ids = create_n_cube(3, points_along_edge=10, seed=0)
        >>> data.shape[1], len(data) == len(ids)
        (3, True)
    """
    rng = np.random.default_rng(seed)
    # vertices of the hypercube: all binary n-tuples; edges connect vertices
    # at Hamming distance 1.
    n_vertices = 2**n
    vertices = np.array(
        [[(v >> k) & 1 for k in range(n)] for v in range(n_vertices)], dtype=float
    )
    edges = []
    for v in range(n_vertices):
        for k in range(n):
            w = v ^ (1 << k)
            if w > v:
                edges.append((v, w))
    edges = np.array(edges)

    coordinates = []
    colors = []
    lin = np.linspace(0, 1, points_along_edge)
    for i, (a, b) in enumerate(edges):
        A, B = vertices[a], vertices[b]
        points = A + (B - A)[None, :] * lin[:, None]
        if sigma:
            points = points + rng.normal(scale=sigma, size=points.shape)
        coordinates.append(points)
        colors.append(np.full(points_along_edge, i))

    coords = np.concatenate(coordinates, axis=0)
    cols = np.concatenate(colors, axis=0)

    # merge a few adjacent edge colors, as the reference does for nicer plots
    merged = 0
    for i, (a, b) in enumerate(edges):
        if merged >= same_colored_edges:
            break
        for j in range(i + 1, len(edges)):
            if edges[j][0] == a:
                cols[cols == i] = j
                merged += 1
                break
    return coords, cols
