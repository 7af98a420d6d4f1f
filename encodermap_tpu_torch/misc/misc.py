# encodermap_tpu_torch/misc/misc.py
"""The hypercube toy dataset, the fallback training data of EncoderMap,
the file-matching helpers of the trajectory loaders, and the reference's
small host helpers (cube-edge points, run directories, text tables,
dihedrals of point quadruplets, a temporary numpy seed, a model's layer
diagram).

Counterpart of ``encodermap_tpu/misc/misc.py``. It is numpy, copied line
for line, so the same seed gives bit-identical data in both packages;
``plot_model`` draws with matplotlib, imported inside it.
"""

from __future__ import annotations

from contextlib import contextmanager as _contextmanager
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "create_n_cube",
    "random_on_cube_edges",
    "run_path",
    "all_equal",
    "get_full_common_str_and_ref",
    "match_files",
    "printTable",
    "arbitrary_dihedral",
    "backbone_hydrogen_oxygen_crossproduct",
    "temp_seed",
]


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


def plot_model(model, input_dim=None):
    """Draw a model's layer stack as a box diagram (the analog of the
    reference's keras-graphviz ``em.misc.plot_model``,
    ``misc/misc.py:492-520``); returns the saved PNG's path.

    Accepts a trainer (anything with a ``plot_network`` method) or a
    :class:`~encodermap_tpu_torch.models.sequential.SequentialModel`.
    """
    if hasattr(model, "plot_network"):
        return model.plot_network()
    p = getattr(model, "p", None) or getattr(model, "parameters", None)
    if p is None:
        raise TypeError(f"plot_model needs a trainer or SequentialModel, got {model!r}")
    out = _session_tmpfile(".png")
    draw_layer_stack(p.n_neurons, input_dim, f"{type(model).__name__} layer stack", out)
    return out


def draw_layer_stack(n_neurons, input_dim, title: str, path) -> None:
    """Save the box diagram of an autoencoder's layer widths (input, the
    encoder's ``n_neurons``, the mirrored decoder, output) to ``path``,
    offscreen, without touching matplotlib's process-global backend."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    from matplotlib.patches import Rectangle

    dims = list([input_dim] if input_dim is not None else [])
    dims += list(n_neurons) + list(n_neurons[-2::-1])
    if input_dim is not None:
        dims += [input_dim]
    fig = Figure(figsize=(max(6, len(dims)), 3))
    FigureCanvasAgg(fig)
    ax = fig.subplots()
    for i, d in enumerate(dims):
        ax.add_patch(Rectangle((i, -0.4), 0.6, 0.8, fc="#4878cf", ec="k"))
        ax.text(i + 0.3, 0, str(d), ha="center", va="center", color="w", fontsize=9)
        if i:
            ax.annotate("", xy=(i, 0), xytext=(i - 0.4, 0),
                        arrowprops=dict(arrowstyle="->"))
    ax.set_xlim(-0.5, len(dims))
    ax.set_ylim(-1, 1)
    ax.axis("off")
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")


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


def random_on_cube_edges(
    n_points: int, sigma: float = 0.0, seed: Optional[int] = None
) -> tuple[np.ndarray, np.ndarray]:
    """``n_points`` random 3-D points uniformly distributed on the 12 edges
    of the unit cube, with optional Gaussian noise — the toy dataset of the
    reference's cube examples (``encodermap_tf1/misc.py:246-283``,
    ``examples/cube_distance_analysis.py``). Returns ``(coordinates,
    edge_ids)``.

    Example:
        >>> from encodermap_tpu_torch.misc import random_on_cube_edges
        >>> data, ids = random_on_cube_edges(100, sigma=0.0, seed=0)
        >>> data.shape, ids.shape
        ((100, 3), (100,))
        >>> bool((ids < 12).all())
        True
    """
    rng = np.random.default_rng(seed) if seed is not None else np.random
    r = rng.uniform(size=n_points)
    x = y = z = 1
    a = np.array(
        [[0, 0, 0]] * 3 + [[x, y, 0]] * 3 + [[0, y, z]] * 3 + [[x, 0, z]] * 3,
        dtype=np.float64,
    )
    b = np.array(
        [
            [x, 0, 0], [0, y, 0], [0, 0, z],
            [-x, 0, 0], [0, -y, 0], [0, 0, z],
            [x, 0, 0], [0, -y, 0], [0, 0, -z],
            [-x, 0, 0], [0, y, 0], [0, 0, -z],
        ],
        dtype=np.float64,
    )
    ids = np.minimum((r * 12).astype(np.int64), 11)
    frac = (r - ids / 12.0) * 12.0
    coordinates = a[ids] + frac[:, None] * b[ids]
    if sigma:
        coordinates = coordinates + rng.normal(
            scale=sigma, size=(n_points, 3)
        )
    return coordinates, ids.astype(np.float64)


def run_path(base: str) -> str:
    """Create and return a unique runN directory under ``base``.

    Example:
        >>> import tempfile
        >>> from encodermap_tpu_torch.misc import run_path
        >>> base = tempfile.mkdtemp()
        >>> run_path(base).endswith("run0")
        True
        >>> run_path(base).endswith("run1")
        True
    """
    from pathlib import Path

    base_p = Path(base)
    i = 0
    while (base_p / f"run{i}").exists():
        i += 1
    p = base_p / f"run{i}"
    p.mkdir(parents=True, exist_ok=True)
    return str(p)


def all_equal(iterable) -> bool:
    """True when every element of ``iterable`` compares equal (and for the
    empty iterable; reference ``misc/misc.py:414-426``)."""
    it = iter(iterable)
    try:
        first = next(it)
    except StopIteration:
        return True
    return all(x == first for x in it)


def printTable(myDict, colList=None, sep: str = "￺") -> str:
    """Render a list of row-dicts as a fixed-width text table (the
    reference's ``printTable`` contract, ``misc/misc.py:354-392``: returns
    the table as a string, rows indented four spaces, ``sep`` splitting a
    cell into multiple lines with a dashed rule after the header)."""
    if not colList:
        colList = list(myDict[0].keys()) if myDict else []
    header = [str(c) for c in colList]
    # split every cell on `sep` into its line stack
    rows = [
        [str(item.get(c) or "").split(sep) for c in colList] for item in myDict
    ]
    widths = [
        max(
            [len(header[j])]
            + [len(line) for row in rows for line in row[j]]
        )
        for j in range(len(colList))
    ]
    fmt = " | ".join("{:<%d}" % w for w in widths)
    rule = "-+-".join("-" * w for w in widths)
    # rule placement mirrors the reference (misc.py:374-378): ALWAYS one
    # dashed rule after the header; with a custom sep the rule repeats at
    # every row boundary
    lines = [fmt.format(*header), rule]
    for r_i, row in enumerate(rows):
        if r_i and sep != "￺":
            lines.append(rule)
        depth = max(len(cell) for cell in row) if row else 0
        for k in range(depth):
            lines.append(
                fmt.format(*[cell[k] if k < len(cell) else "" for cell in row])
            )
    return "  \n".join("    " + ln for ln in lines)


def arbitrary_dihedral(pos, out=None) -> np.ndarray:
    """Signed dihedral angles (radians, IUPAC convention) of a
    ``(n, 4, 3)`` position array — the host-side numpy analog of
    :func:`encodermap_tpu_torch.ops.geometry.compute_dihedrals`.

    The reference's version (``misc/rotate.py:81-114``) returns values
    offset by pi from the mdtraj convention its own featurization uses
    (and is unused inside the reference); this one deliberately agrees
    with ``compute_dihedrals``/mdtraj instead.
    """
    pos = np.asarray(pos)
    b0 = pos[:, 0] - pos[:, 1]
    b1 = pos[:, 2] - pos[:, 1]
    b2 = pos[:, 3] - pos[:, 2]
    b1n = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
    v = b0 - (b0 * b1n).sum(-1, keepdims=True) * b1n
    w = b2 - (b2 * b1n).sum(-1, keepdims=True) * b1n
    x = (v * w).sum(-1)
    y = (np.cross(b1n, v) * w).sum(-1)
    return np.arctan2(y, x, out)


def backbone_hydrogen_oxygen_crossproduct(backbone_positions):
    """Import-parity stub. The reference exports this name from
    ``em.misc`` but its body is a dead stub (an assert followed by
    ``pass`` — ``misc/backmapping.py:1915-1917``); amide H/O placement
    actually happens in :func:`encodermap_tpu_torch.ops.backmap.guess_amide_H`
    / :func:`guess_amide_O`. Kept so migrating imports resolve; performs
    the same shape check and, like the reference, returns ``None``."""
    assert backbone_positions.shape[2] % 3 == 0  # C, CA, N: multiple of 3


@_contextmanager
def temp_seed(seed: int):
    """Temporarily set numpy's global RNG seed (reference
    ``trajinfo/info_all.py:206-225``), restoring the previous state on
    exit.

    Examples:
        >>> import numpy as np
        >>> from encodermap_tpu_torch.misc import temp_seed
        >>> with temp_seed(123456789):
        ...     print(np.random.randint(low=0, high=10, size=(5,)))
        [8 2 9 7 4]
    """
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)
