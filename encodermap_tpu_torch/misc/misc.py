# encodermap_tpu_torch/misc/misc.py
"""The hypercube toy dataset, the fallback training data of EncoderMap,
and the file-matching helpers of the trajectory loaders.

Counterpart of ``encodermap_tpu/misc/misc.py`` (``create_n_cube``,
``get_full_common_str_and_ref``, ``match_files``, ``_session_tmpfile``). It
is numpy, copied line for line, so the same seed gives bit-identical data
in both packages.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["create_n_cube", "get_full_common_str_and_ref", "match_files"]


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


def get_full_common_str_and_ref(trajs, tops, common_str):
    """Match trajectory files, topology files, and common substrings into
    three aligned lists (reference ``misc/misc.py:264-420``).

    Every traj is assigned the common_str that appears in its filename and
    the topology sharing that substring (or the single provided topology).
    """
    trajs = [str(t) for t in trajs]
    tops = [str(t) for t in tops]
    assert isinstance(common_str, list)
    if len(trajs) != len(tops) and not common_str and len(tops) != 1:
        raise Exception(
            "When providing a list of trajs and a list of refs with "
            "different length you must provide a list of common_str to "
            "match them."
        )
    # branch structure mirrors the reference (misc.py:296-330); anything
    # that needs real matching delegates to match_files, which RAISES on
    # an unmatched traj or topology — a silent wrong-topology fallback
    # would featurize garbage (review wave 26)
    if len(trajs) == len(tops) == len(common_str):
        if all(
            cs is None or (cs in t and cs in p)
            for t, p, cs in zip(trajs, tops, common_str)
        ):
            return trajs, tops, common_str
        return (trajs, *match_files(trajs, tops, common_str))
    if len(trajs) == len(tops):
        # equal-length lists pair 1:1 (reference ``misc.py:304-310``):
        # no common_str means no grouping; a single one applies to all
        if not common_str:
            return trajs, tops, [None] * len(trajs)
        if len(common_str) == 1:
            return trajs, tops, [common_str[0]] * len(trajs)
        return (trajs, *match_files(trajs, tops, common_str))
    if len(tops) == 1:
        tops_rep = tops * len(trajs)
        if not common_str:
            # reference misc.py:320-321: per-traj file stems, NOT None —
            # downstream grouping keys on these
            return trajs, tops_rep, [Path(t).stem for t in trajs]
        if len(common_str) == len(trajs):
            return trajs, tops_rep, common_str
        return (trajs, *match_files(trajs, tops_rep, common_str))
    return (trajs, *match_files(trajs, tops, common_str))


def match_files(trajs, tops, common_str):
    """Assign a topology file and a common_str to every trajectory file.

    For each traj the common_str whose RIGHTMOST occurrence in the path is
    latest wins (so ``.../asp7/asp7_long.xtc`` matches ``asp7`` even when a
    parent directory contains another candidate); the matched topology is
    the one sharing that substring — or the traj itself for self-topologied
    ``.h5`` files. Same contract as the reference's ``match_files``
    (``misc/misc.py:176-301``): returns ``(tops_out, common_str_out)``,
    both aligned with ``trajs``.
    """
    trajs = [str(t) for t in trajs]
    tops = [str(t) for t in tops]
    if (
        all(t.endswith(".h5") for t in trajs)
        and len(trajs) == len(tops) == len(common_str)
    ):
        return tops, common_str

    tops_out, common_str_out = [], []
    for t in trajs:
        hits = [t.rfind(cs) for cs in common_str if cs in t]
        if not hits:
            raise Exception(
                f"The traj file {t} does not match any of the common_str "
                f"you provided: {common_str}"
            )
        # rightmost occurrence wins; ties resolve by common_str LIST ORDER
        # like the reference (misc.py:236-238: first cs found in the tail),
        # not lexicographically
        tail = t[max(hits):]
        cs = next(c for c in common_str if c in tail)
        if t.endswith(".h5"):
            tops_out.append(t)
        else:
            top_hits = [p for p in tops if cs in p]
            if not top_hits:
                raise Exception(
                    f"No topology among {tops} matches common_str {cs!r} "
                    f"of traj {t}."
                )
            tops_out.append(top_hits[0])
        common_str_out.append(cs)
    return tops_out, common_str_out


def _session_tmpfile(suffix: str) -> str:
    """Path to a fresh temp file that is removed at interpreter exit.

    ``NamedTemporaryFile(delete=False)`` alone leaks one file per call —
    in a long notebook session looping ``show_traj``/``plot_model`` over
    ensemble members that is unbounded growth of the temporary directory. The consumers only
    need the file for the current session (nglview reads it once; the
    image callback re-reads within the run), so exit-time cleanup bounds
    the leak without invalidating live paths."""
    import atexit
    import os
    import tempfile

    f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    f.close()

    def _cleanup(path=f.name):
        try:
            os.remove(path)
        except OSError:
            pass

    atexit.register(_cleanup)
    return f.name
