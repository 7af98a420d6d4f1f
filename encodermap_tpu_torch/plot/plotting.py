# encodermap_tpu_torch/plot/plotting.py
"""Static plotting: free-energy maps, Ramachandran, distance histograms with
the sketch-map sigmoid, latent scatter, clusters, DSSP maps, ball-and-stick
views, VMD scripts, and the numpy helpers behind them.

Counterpart of ``encodermap_tpu/plot/plotting.py`` (its 27 functions,
:45-1095; matplotlib re-implementations of the reference's
``plot/plotting.py:268-2342``). Host numpy and matplotlib, with matplotlib
imported inside each function (``_mpl``), so importing this module needs
neither. Three functions compute on the card unless ``device="cpu"`` is
passed, as every entry point of the port does: :func:`plot_ramachandran`
on a trajectory (``ops/geometry.py``), :func:`plot_dssp`
(``ops/dssp.py``) and :func:`plot_cluster`'s centroid
(``misc/clustering.py``). :func:`_subsampled_pdists` stays host float64, as
in the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Sequence, Union

import numpy as np

__all__ = [
    "plot_free_energy",
    "plot_ramachandran",
    "distance_histogram",
    "plot_latent_scatter",
    "plot_cluster",
    "plot_trajs_by_parameter",
    "plot_dssp",
    "plot_ball_and_stick",
    "render_vmd",
    "dssp_fractions",
    "digitize_dssp",
    "get_histogram",
    "get_density",
    "get_free_energy",
    "to_density",
    "to_free_energy",
    "plot_raw_data",
    "plot_end2end",
    "animate_lowd_trajectory",
    "dssp_to_text",
    "dssp_to_rgb",
    "distance_histogram_interactive",
    "hex_to_rgba",
]


def _mpl():
    # no matplotlib.use("Agg") here: that flips the process-global backend
    # and kills the caller's interactive figures (notebooks, the lasso UI).
    # Headless environments auto-select Agg on pyplot import anyway.
    import matplotlib.pyplot as plt

    return plt


def plot_free_energy(
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    bins: int = 100,
    kT: float = 1.0,
    ax: Any = None,
    cbar: bool = True,
    save_path: Optional[Union[str, Path]] = None,
):
    """-kT ln(p) free-energy surface over a 2D projection
    (reference ``plotting.py:1372-1448``)."""
    plt = _mpl()
    if y is None:
        x, y = np.asarray(x)[:, 0], np.asarray(x)[:, 1]
    H, xe, ye = np.histogram2d(x, y, bins=bins)
    H = H.T
    with np.errstate(divide="ignore"):
        F = -kT * np.log(H / H.max())
    F[~np.isfinite(F)] = np.nan
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    mesh = ax.pcolormesh(xe, ye, F, shading="auto", cmap="viridis")
    if cbar:
        fig.colorbar(mesh, ax=ax, label="free energy / kT")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return str(save_path)
    return ax


def plot_ramachandran(
    phi: Any,
    psi: Optional[np.ndarray] = None,
    bins: int = 72,
    ax: Any = None,
    save_path: Optional[Union[str, Path]] = None,
    subsample: Optional[Union[int, slice, np.ndarray]] = None,
    device: Any = None,
):
    """Ramachandran density plot (reference ``plotting.py:2258-2341``).

    The first argument follows the reference's flexible ``angles`` input:
    separate ``phi``/``psi`` arrays, a ``(psi, phi)`` tuple, one stacked
    ``(2, n_frames, n_angles)`` array (reference order: psi first), or a
    SingleTraj, whose phi/psi torsions are computed on the fly.
    ``subsample`` thins the frame axis the reference way: an int keeps
    every Nth frame (``psi[::subsample]``), a slice/index array selects
    frames. Degree-valued input is auto-detected by magnitude
    (``np.all(|psi| < 4)`` -> radians, else degrees; the reference's
    signed check at ``plotting.py:2298`` misreads all-negative degree
    data) and plotted on a ``[-180, 180]`` range. A trajectory's torsions
    are computed on ``device`` (the card unless ``device="cpu"``).
    """
    plt = _mpl()
    if psi is None:
        if hasattr(phi, "xyz") and hasattr(phi, "top"):  # SingleTraj
            import torch

            from ..device import resolve_device
            from ..ops.geometry import compute_dihedrals

            traj, top = phi, phi.top
            xyz = torch.as_tensor(np.asarray(traj.xyz), device=resolve_device(device))
            phi, psi = (compute_dihedrals(
                xyz, np.asarray(q, np.int64).reshape(-1, 4)).cpu().numpy()
                for q in (top.indices_phi, top.indices_psi))
        elif isinstance(phi, (tuple, list)) and len(phi) == 2:
            psi, phi = phi  # reference order: (psi, phi)
        else:
            arr = np.asarray(phi)
            if arr.ndim == 3 and arr.shape[0] == 2:
                psi, phi = arr[0], arr[1]
            elif arr.ndim == 2:
                # the reference's 2-D fallback (plotting.py:2282):
                # interleaved rows, psi = angles[::2], phi = angles[1::2]
                psi, phi = arr[::2], arr[1::2]
            else:
                raise ValueError(
                    "without psi, pass a SingleTraj, a (psi, phi) tuple, a "
                    "(2, n_frames, n_angles) array, or a 2-D "
                    "psi/phi-interleaved-row array — got shape "
                    f"{arr.shape}"
                )
    phi, psi = np.asarray(phi), np.asarray(psi)
    if subsample is not None:
        if isinstance(subsample, int):
            # every Nth frame, matching the reference's psi[::subsample]
            # and this module's plot_dssp convention
            subsample = slice(None, None, subsample)
        phi, psi = phi[subsample], psi[subsample]
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    # deg-vs-rad auto-detect: |radians| never exceed pi, degree data
    # essentially always does.  The reference (plotting.py:2298) tests
    # the SIGNED values (np.all(psi < 4)), which misreads all-negative
    # degree data (a pure alpha-helix, psi ~ -47 deg) as radians and
    # clips every point out of range — we use the magnitude instead.
    lim = np.pi if np.all(np.abs(psi) < 4) else 180.0
    unit = "rad" if lim == np.pi else "deg"
    ax.hist2d(
        np.asarray(phi).ravel(),
        np.asarray(psi).ravel(),
        bins=bins,
        range=[[-lim, lim], [-lim, lim]],
        cmap="viridis",
    )
    ax.set_xlabel(rf"$\phi$ / {unit}")
    ax.set_ylabel(rf"$\psi$ / {unit}")
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return str(save_path)
    return ax


def _subsampled_pdists(
    data: np.ndarray, periodicity: float, max_frames: int = 1000
) -> np.ndarray:
    """Condensed pairwise distances of an evenly-thinned frame sample —
    shared by the static (:func:`distance_histogram`) and interactive
    (``DistanceHistogramInteractive``) sigmoid-tuning histograms so both
    use THE same distance conventions (:mod:`..ops.distances`, incl. its
    zero-distance guards). The periodic branch materializes an ``(n, n)``
    matrix, so the sample is capped at ``max_frames`` (at routine
    trajectory sizes, 1e5 frames, the full matrix would be tens of GB).

    Computed in host numpy (float64), as in the JAX package, so both give
    the same distances. The min-image + 1e-12 zero-guard conventions below mirror
    :func:`..ops.distances.pairwise_dist_periodic` exactly; the
    dimension loop keeps peak memory at one ``(n_pairs,)`` buffer per
    dim instead of an ``(n, n, d)`` tensor."""
    data = np.asarray(data, np.float64)
    if data.ndim == 1:
        data = data[:, None]
    if len(data) > max_frames:
        data = data[np.linspace(0, len(data) - 1, max_frames).astype(int)]
    iu, ju = np.triu_indices(len(data), k=1)
    d2 = np.zeros(len(iu), np.float64)
    periodic = np.isfinite(periodicity)
    for k in range(data.shape[1]):
        delta = np.abs(data[iu, k] - data[ju, k])
        if periodic:
            delta = np.minimum(delta, periodicity - delta)
            # the reference's +1e-12 guard on exactly-zero components
            delta = delta + (delta == 0.0) * 1e-12
        d2 += np.square(delta)
    dists = np.sqrt(d2)
    return dists + 1e-12 if periodic else dists


def distance_histogram(
    data: np.ndarray,
    periodicity: float,
    sigmoid_parameters: Sequence[float],
    axes: Any = None,
    low_d_max: float = 5.0,
    bins: Union[int, str] = "auto",
    save_path: Optional[Union[str, Path]] = None,
):
    """High-D distance histogram with the sketch-map sigmoid overlaid, plus
    the implied low-D sigmoid — the tool for tuning ``dist_sig_parameters``
    (reference ``plotting.py:2024-2120``; same parameter order, ``axes``
    may be a 2-array of existing axes).

    Returns the reference's 3-tuple ``(high-d axis, its twinx axis carrying
    the sigmoid/derivative curves, low-d axis)`` — or the save path when
    ``save_path`` is given.
    """
    plt = _mpl()
    from ..ops.distances import sigmoid

    dists = _subsampled_pdists(data, periodicity)

    sig_h, a_h, b_h, sig_l, a_l, b_l = sigmoid_parameters
    if axes is None:
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    else:
        fig = axes[0].figure
    ax = axes[0]
    counts, edges, _ = ax.hist(dists, bins=bins, density=True, alpha=0.5)
    r = np.linspace(1e-3, edges[-1], 300)
    sig_vals = np.asarray(sigmoid(sig_h, a_h, b_h)(r))
    ax2 = ax.twinx()
    ax2.plot(r, sig_vals, "C1", label=f"sigmoid({sig_h}, {a_h}, {b_h})")
    # the differentiated sigmoid shows which distances the loss is sensitive to
    dsig = np.gradient(sig_vals, r)
    ax2.plot(r, dsig / dsig.max(), "C2--", label="d sigmoid (norm.)")
    ax2.legend(loc="upper right", fontsize=8)
    ax.set_xlabel("high-d distance")
    ax.set_ylabel("density")
    ax.set_title("high-dimensional")

    ax = axes[1]
    rl = np.linspace(1e-3, low_d_max, 300)
    ax.plot(rl, np.asarray(sigmoid(sig_l, a_l, b_l)(rl)), "C1")
    ax.set_xlabel("low-d distance")
    ax.set_title(f"low-dimensional sigmoid({sig_l}, {a_l}, {b_l})")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return str(save_path)
    # the reference's return contract (plotting.py:2120): high-d axis,
    # its twinx (the sigmoid + derivative curves live there), low-d axis
    return axes[0], ax2, axes[1]


def plot_latent_scatter(
    latent: np.ndarray,
    colors: Optional[np.ndarray] = None,
    ax: Any = None,
    save_path: Optional[Union[str, Path]] = None,
    s: float = 2.0,
):
    """Latent-space scatter, optionally colored (e.g. by cluster or edge id)."""
    plt = _mpl()
    latent = np.asarray(latent)
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    sc = ax.scatter(latent[:, 0], latent[:, 1], c=colors, s=s, cmap="tab20")
    if colors is not None:
        fig.colorbar(sc, ax=ax)
    ax.set_xlabel("latent 0")
    ax.set_ylabel("latent 1")
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return str(save_path)
    return ax


def _write_cluster_readme(
    out_dir: Path, cluster_id: int, idx: np.ndarray, files: dict,
) -> str:
    """Provenance record accompanying a cluster write — the reference
    renders a jinja template into ``README.md`` next to the cluster
    artifacts (``plot/utils.py:249::_create_readme`` +
    ``plot/jinja_template.py``); same record here without the jinja
    dependency: what was written, when, by which versions, on what
    system, and how to rebuild the selection."""
    import datetime
    import platform

    import torch

    from .. import __version__

    lines = [
        f"# Cluster {cluster_id} generated at "
        f"{datetime.datetime.now().isoformat(timespec='seconds')}",
        "",
        "## What just happened?",
        "",
        f"A cluster of {len(idx)} frames (cluster id {cluster_id}) was "
        "selected from the low-dimensional projection and written to this "
        "directory by encodermap_tpu_torch.",
        "",
        "## Files",
        "",
    ]
    descriptions = {
        "png": "latent-space scatter with the cluster highlighted",
        "csv": "flat frame indices of the cluster members, one per line",
        "indices_npy": "the same member indices as a .npy array",
        "lowd_npy": "low-dimensional coordinates of the cluster members",
        "pdb": "representative member structures (MODEL per frame)",
    }
    for key, path in files.items():
        for p in (path if isinstance(path, list) else [path]):
            lines.append(
                f"- `{Path(p).name}` — {descriptions.get(key, key)}"
            )
    lines += [
        "",
        "## Rebuilding this selection",
        "",
        "```python",
        "import numpy as np",
        "import encodermap_tpu_torch as em",
        "trajs = ...  # reload the ensemble this cluster came from",
        "cluster_membership = np.full(trajs.n_frames, -1)",
        f"indices = np.load('cluster_{cluster_id}_indices.npy')",
        f"cluster_membership[indices] = {cluster_id}",
        "trajs.load_CVs(cluster_membership, 'cluster_membership')",
        "```",
        "",
        "## System",
        "",
        f"- encodermap_tpu_torch {__version__}",
        f"- torch {torch.__version__}",
        f"- numpy {np.__version__}",
        f"- python {platform.python_version()} on {platform.platform()}",
        "",
    ]
    md = out_dir / "README.md"
    md.write_text("\n".join(lines))
    return str(md)


def plot_cluster(
    trajs: Any,
    cluster_id: int,
    cluster_membership: np.ndarray,
    latent: np.ndarray,
    out_dir: Union[str, Path],
    max_structures: int = 10,
    device: Any = None,
) -> dict:
    """Render one cluster: latent highlight plot + representative structures
    written as PDB (reference ``plotting.py:2922`` writes PDB + png + csv),
    plus a provenance README (reference ``plot/utils.py:249-330``). The
    centroid's RMSD matrix is computed on ``device`` (the card unless
    ``device="cpu"``)."""
    from ..misc.clustering import rmsd_centroid_of_cluster

    if trajs is not None and not hasattr(trajs, "trajs"):
        # accept a bare SingleTraj like every caller does — iterating one
        # yields per-frame SingleTrajs, which would break the (traj,
        # frame) mapping below
        from ..data.trajectory import TrajEnsemble

        trajs = TrajEnsemble([trajs])
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    idx = np.where(np.asarray(cluster_membership) == cluster_id)[0]

    plt = _mpl()
    fig, ax = plt.subplots()
    ax.scatter(latent[:, 0], latent[:, 1], s=1, c="lightgray")
    ax.scatter(latent[idx, 0], latent[idx, 1], s=3, c="C1")
    png = out_dir / f"cluster_{cluster_id}.png"
    fig.savefig(png, dpi=120)
    plt.close(fig)

    csv = out_dir / f"cluster_{cluster_id}_frames.csv"
    np.savetxt(csv, idx, fmt="%d")
    # the reference also persists the raw selection as npy next to the csv
    # (plot/utils.py:312-321: *_cluster_lowd_points.npy + *_indices.npy)
    indices_npy = out_dir / f"cluster_{cluster_id}_indices.npy"
    np.save(indices_npy, idx)
    lowd_npy = out_dir / f"cluster_{cluster_id}_lowd_points.npy"
    np.save(lowd_npy, np.asarray(latent)[idx])

    result = {
        "png": str(png), "csv": str(csv), "indices_npy": str(indices_npy),
        "lowd_npy": str(lowd_npy), "n_frames": len(idx),
    }
    if trajs is not None and len(idx):
        sub_idx = idx[:: max(1, len(idx) // max_structures)][:max_structures]
        # map flat frame indices back to (traj, frame), grouping frames by
        # the member's TOPOLOGY: a lasso selection can span a mixed-
        # topology ensemble, and every frame must be written under its own
        # atom names (one PDB per topology; single-topology ensembles keep
        # the bare cluster_N.pdb name)
        bounds = np.cumsum([0] + [t.n_frames for t in trajs])
        by_top: list[tuple[Any, list, list]] = []  # (top, xyz, frame ids)
        for fi in sub_idx:
            ti = int(np.searchsorted(bounds, fi, side="right") - 1)
            traj = trajs.trajs[ti]
            frame_xyz = traj.xyz[fi - bounds[ti]]
            for top, xs, fs in by_top:
                if top == traj.top:
                    xs.append(frame_xyz)
                    fs.append(int(fi))
                    break
            else:
                by_top.append((traj.top, [frame_xyz], [int(fi)]))
        from ..data.pdb import write_pdb

        pdbs = []
        for j, (top, xs, fs) in enumerate(by_top):
            name = (f"cluster_{cluster_id}.pdb" if len(by_top) == 1
                    else f"cluster_{cluster_id}_top{j}.pdb")
            pdb = out_dir / name
            write_pdb(pdb, top, np.stack(xs))
            pdbs.append(str(pdb))
        result["pdb"] = pdbs[0] if len(pdbs) == 1 else pdbs
        # centroid within the LARGEST topology group (RMSD across
        # different atom counts is undefined); heavy atoms only, like the
        # reference (clustering.py:117 filters element != H — mobile
        # hydrogens would otherwise dominate the RMSD and shift the pick)
        top, xs, fs = max(by_top, key=lambda g: len(g[1]))
        stacked = np.stack(xs)
        heavy = np.array(
            [a.index for a in top.atoms if a.element.upper() != "H"],
            np.int64,
        )
        if len(heavy):
            stacked = stacked[:, heavy]
        centroid_i, _ = rmsd_centroid_of_cluster(stacked, device=device)
        result["centroid_frame"] = int(fs[centroid_i])
    result["readme"] = _write_cluster_readme(
        out_dir, cluster_id, idx,
        {k: v for k, v in result.items()
         if k in ("png", "csv", "indices_npy", "lowd_npy", "pdb")},
    )
    return result


def plot_trajs_by_parameter(
    latent: np.ndarray,
    parameter: np.ndarray,
    ax: Any = None,
    save_path: Optional[Union[str, Path]] = None,
):
    """Color the projection by any per-frame parameter (reference
    ``plotting.py:654``-style view, matplotlib backend)."""
    return plot_latent_scatter(latent, colors=np.asarray(parameter), ax=ax,
                               save_path=save_path)


# THE dssp color convention (reference ``plotting.py:2462-2516``); also
# consumed by ``dssp_to_rgb`` below so the map figure and the rgb helper
# can never disagree on a code's color.
_DSSP_RGB = {
    " ": (1.0, 1.0, 1.0),
    "B": (0.0, 0.0, 0.0),
    "E": (1.0, 0.0, 0.0),
    "G": (0.5, 0.5, 0.5),
    "H": (0.0, 0.0, 1.0),
    "I": (0.0, 1.0, 1.0),
    "S": (0.0, 1.0, 0.0),
    "T": (1.0, 1.0, 0.0),
}
_DSSP_RGB_SIMPLIFIED = {
    "C": (1.0, 1.0, 1.0),
    "E": (1.0, 0.0, 0.0),
    "H": (0.0, 0.0, 1.0),
}
_DSSP_COLORS_SIMPLE = {**_DSSP_RGB_SIMPLIFIED, "NA": (0.8, 0.8, 0.8)}
_DSSP_COLORS_FULL = {**_DSSP_RGB, "NA": (0.8, 0.8, 0.8)}
# ONE code->name table (the reference's dssp_to_text values,
# ``plotting.py:2442-2460``); the legend tables derive from it so the map
# figure and dssp_to_text can never disagree — same rule the RGB tables
# follow above.
_DSSP_TEXT = {
    " ": "Coil",
    "B": "Isolated beta-bridge",
    "E": "Extended beta-ladder",
    "G": "3/10-helix",
    "H": "Alpha-helix",
    "I": "Pi-helix",
    "S": "Bend",
    "T": "Hydrogen bonded Turn",
}
_DSSP_TEXT_SIMPLIFIED = {"C": "Coil", "E": "Extended", "H": "Helical"}
_DSSP_NAMES_SIMPLE = _DSSP_TEXT_SIMPLIFIED
_DSSP_NAMES_FULL = _DSSP_TEXT


def plot_dssp(
    traj,
    simplified: bool = True,
    subsample: Optional[Union[int, slice, np.ndarray]] = None,
    residue_subsample: int = 25,
    save_path: Optional[Union[str, Path]] = None,
    device: Any = None,
):
    """Residue-vs-time secondary-structure map (reference
    ``plotting.py:2342-2440``, which delegates the assignment to mdtraj;
    here the native Kabsch-Sander DSSP in :mod:`..ops.dssp` is used, on
    ``device`` (the card unless ``device="cpu"``), and the figure is
    matplotlib instead of plotly).

    Coloring follows the reference: coil white, extended red, helical blue.
    """
    from ..ops.dssp import compute_dssp

    plt = _mpl()
    dssp = compute_dssp(traj, simplified=simplified, device=device)
    if subsample is not None:
        if isinstance(subsample, int):
            subsample = slice(None, None, subsample)
        dssp = dssp[subsample]

    colors = _DSSP_COLORS_SIMPLE if simplified else _DSSP_COLORS_FULL
    names = _DSSP_NAMES_SIMPLE if simplified else _DSSP_NAMES_FULL
    img = np.empty((dssp.shape[1], dssp.shape[0], 3), np.float32)
    for code, rgb in colors.items():
        img[(dssp == code).T] = rgb

    fig, ax = plt.subplots(figsize=(10, 7))
    ax.imshow(img, aspect="auto", interpolation="nearest", origin="lower")
    ax.set_xlabel("time / frame")
    ax.set_ylabel("residue")
    ax.set_title("DSSP plot")
    residues = np.arange(dssp.shape[1])
    labels = np.array(
        [f"{r.name}{r.resSeq}" for r in traj.top.residues], dtype=object
    )
    # <= 0 keeps every label (0 used to divide by zero)
    if residue_subsample > 0 and len(residues) > residue_subsample:
        step = max(1, len(residues) // residue_subsample)
        residues, labels = residues[::step], labels[::step]
    ax.set_yticks(residues)
    ax.set_yticklabels(labels, fontsize=6)
    present = np.unique(dssp)
    from matplotlib.patches import Patch

    handles = [Patch(facecolor=colors[c], edgecolor="k", label=names[c])
               for c in present if c in names]
    ax.legend(handles=handles, loc="upper center",
              bbox_to_anchor=(0.5, -0.08), ncol=max(1, len(handles)))
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return str(save_path)
    return ax


_ELEMENT_COLORS = {
    "C": (0.33, 0.33, 0.33), "N": (0.0, 0.0, 1.0), "O": (1.0, 0.0, 0.0),
    "H": (0.8, 0.8, 0.8), "S": (1.0, 0.8, 0.0), "P": (1.0, 0.5, 0.0),
}


def plot_ball_and_stick(
    traj,
    frame: int = 0,
    highlight: Union[str, Sequence[int], None] = "atoms",
    atom_indices: Optional[Sequence[int]] = None,
    ax: Any = None,
    save_path: Optional[Union[str, Path]] = None,
):
    """3D ball-and-stick rendering of one frame (reference
    ``plotting.py:654, 2233`` draws this with plotly; this is the
    matplotlib-3D backend so it works without optional packages).

    ``highlight`` follows the reference's string modes: ``"atoms"``
    (emphasize ``atom_indices`` if given), ``"bonds"`` (accent every
    guessed bond), ``"angles"`` (accent the backbone N-CA-C atoms whose
    angles the ADC features use), ``"dihedrals"`` (accent every atom in
    the central + sidechain dihedral quadruples). A plain index sequence
    is also accepted and behaves like ``highlight="atoms"`` with those
    ``atom_indices``. Bonds are guessed from covalent radii via
    :func:`..misc.backmapping_offline.guess_bonds`.
    """
    from ..misc.backmapping_offline import guess_bonds

    plt = _mpl()
    xyz = np.asarray(traj.xyz[frame], np.float64)
    top = traj.top
    bonds = guess_bonds(top, xyz)
    if highlight is not None and not isinstance(highlight, str):
        atom_indices, highlight = np.asarray(highlight, int), "atoms"
    elif highlight is None:
        highlight = "atoms"
    if highlight not in ("atoms", "bonds", "angles", "dihedrals"):
        raise ValueError(
            f"highlight must be 'atoms', 'bonds', 'angles', 'dihedrals' "
            f"or an index sequence, got {highlight!r}"
        )
    accent_atoms = np.zeros(top.n_atoms, bool)
    if highlight == "atoms" and atom_indices is not None:
        accent_atoms[np.asarray(atom_indices, int)] = True
    elif highlight == "angles":
        accent_atoms[top.backbone_indices().reshape(-1)] = True
    elif highlight == "dihedrals":
        from ..loading.features import CentralDihedrals, SideChainDihedrals

        for feat in (CentralDihedrals(top), SideChainDihedrals(top)):
            if feat._indices is not None and len(feat._indices):
                accent_atoms[np.asarray(feat._indices, int).reshape(-1)] = True
    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
    else:
        fig = ax.figure
    # two batched Line3DCollections (plain + accented) instead of one
    # Line3D artist per bond: a 2000-bond protein renders in one draw call
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    bonds = np.asarray(list(bonds), int).reshape(-1, 2)
    if len(bonds):
        if highlight == "bonds":
            accent_mask = np.ones(len(bonds), bool)
        else:
            accent_mask = (accent_atoms[bonds[:, 0]]
                           & accent_atoms[bonds[:, 1]])
        segs = xyz[bonds]  # (n_bonds, 2, 3)
        for mask, color, lw in ((~accent_mask, "0.5", 1.2),
                                (accent_mask, "C1", 2.4)):
            if mask.any():
                ax.add_collection3d(Line3DCollection(
                    segs[mask], colors=color, linewidths=lw, zorder=1))
    colors = [
        _ELEMENT_COLORS.get(a.element.upper(), (0.6, 0.2, 0.6))
        for a in top.atoms
    ]
    sizes = np.where(accent_atoms, 140.0, 40.0)
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], c=colors, s=sizes,
               depthshade=True, zorder=2, edgecolors="k", linewidths=0.3)
    ax.set_axis_off()
    ax.set_box_aspect(np.ptp(xyz, axis=0) + 1e-9)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return str(save_path)
    return ax


def render_vmd(
    filepath: Union[str, Path],
    rotation: Sequence[float] = (0, 0, 0),
    scale: float = 1.0,
    script_location: Union[str, Path] = "auto",
    image_location: Union[str, Path] = "auto",
    image_name: str = "",
    drawframes: bool = False,
    ssupdate: bool = True,
    renderer: str = "tachyon",
    additional_lines: Sequence[str] = (),
    surf: Optional[str] = None,
    custom_script: Optional[str] = None,
    script_only: bool = False,
):
    """Render a PDB with VMD (reference ``plotting.py:2604-2800``: writes a
    standardized tcl script, runs vmd -> tachyon -> png).

    The script is always generated; the external binaries are only invoked
    when present on PATH. With ``script_only=True`` (or when vmd is not
    installed and ``script_only`` is left False, which raises), the path of
    the generated script is returned instead of pixel data.
    """
    import shutil
    import subprocess

    filepath = Path(filepath)
    cwd = Path.cwd()
    script_path = (
        cwd / "render_vmd.tcl" if script_location == "auto"
        else Path(script_location)
    )
    image_base = (
        cwd / (image_name or filepath.stem) if image_location == "auto"
        else Path(image_location)
    )

    if custom_script:
        # a custom script REPLACES the generated scene entirely (the
        # reference's "completely custom script" contract,
        # plotting.py:2777) — surf/ssupdate/additional_lines are the
        # knobs of the generated scene and must not mutate a user's
        lines = [custom_script]
    else:
        lines = [
            f"mol new {filepath} waitfor all",
            "mol delrep 0 top",
            "mol representation NewCartoon 0.3 50",
            "mol color Structure",
            "mol addrep top",
            f"rotate x by {rotation[0]}",
            f"rotate y by {rotation[1]}",
            f"rotate z by {rotation[2]}",
            f"scale by {scale}",
            "display projection Orthographic",
            "display ambientocclusion on",
            "axes location Off",
            "color Display Background white",
        ]
        if surf in ("quicksurf", "surf"):
            lines += [
                f"mol representation {surf.capitalize()}", "mol addrep top"
            ]
        if drawframes:
            # actually draw every loaded frame (reference
            # ``plotting.py:2717-2718``) — without this directive VMD
            # renders only the current frame
            lines.append("mol drawframes 0 0 0:1:999")
        if ssupdate and drawframes:
            lines.append(
                "for {set i 0} {$i < [molinfo top get numframes]} {incr i} "
                "{animate goto $i; mol ssrecalc top}"
            )
        lines += list(additional_lines)
    # renderer mapping follows the reference (plotting.py:2780-2795):
    # 'snapshot' must use TachyonInternal — a literal 'render snapshot'
    # grabs the OpenGL window, which does not exist under the headless
    # `vmd -dispdev text` invocation below
    if renderer == "tachyon":
        lines.append(f"render Tachyon {image_base}.dat")
    elif renderer == "snapshot":
        lines.append("render aasamples TachyonInternal 6")
        lines.append(f"render TachyonInternal {image_base}.tga")
    elif renderer == "STL":
        lines.append("axes location off")
        lines.append(f"render STL {image_base}.stl")
    elif renderer == "Wavefront":
        lines.append("axes location off")
        lines.append(f"render Wavefront {image_base}.obj")
    else:
        raise NotImplementedError(
            f"renderer must be one of 'tachyon', 'snapshot', 'STL', "
            f"'Wavefront'; got {renderer!r}"
        )
    lines.append("exit")
    script_path.write_text("\n".join(filter(None, lines)) + "\n")

    vmd = shutil.which("vmd")
    if script_only or vmd is None:
        if vmd is None and not script_only:
            raise FileNotFoundError(
                "vmd is not on PATH; pass script_only=True to just generate "
                f"the tcl script (written to {script_path})"
            )
        return str(script_path)

    subprocess.run([vmd, "-dispdev", "text", "-e", str(script_path)],
                   check=True, capture_output=True)
    if renderer == "STL":
        return str(Path(f"{image_base}.stl"))
    if renderer == "Wavefront":
        return str(Path(f"{image_base}.obj"))
    if renderer == "tachyon":
        tachyon = shutil.which("tachyon")
        if tachyon is None:
            raise FileNotFoundError("tachyon renderer not on PATH")
        subprocess.run(
            [tachyon, "-aasamples", "12", f"{image_base}.dat", "-format",
             "TARGA", "-o", f"{image_base}.tga", "-res", "2000", "2000"],
            check=True, capture_output=True,
        )
    plt = _mpl()
    image = plt.imread(f"{image_base}.tga")
    if image_name:
        plt.imsave(f"{Path(image_name).with_suffix('.png')}", image)
    return image


def dssp_fractions(dssp: np.ndarray) -> np.ndarray:
    """Per-frame (helix, extended, coil) content fractions from a
    ``compute_dssp`` array (protein residues only)."""
    dssp = np.asarray(dssp)
    valid = (dssp != "NA").sum(axis=1).astype(np.float64)
    valid = np.maximum(valid, 1.0)
    out = np.stack(
        [
            np.isin(dssp, ("H", "G", "I")).sum(axis=1) / valid,
            np.isin(dssp, ("E", "B")).sum(axis=1) / valid,
            np.isin(dssp, ("C", " ", "T", "S")).sum(axis=1) / valid,
        ],
        axis=1,
    )
    return out


def digitize_dssp(
    lowd: np.ndarray,
    dssp: np.ndarray,
    bins: int = 100,
    imshow: bool = True,
):
    """Color the 2D projection by secondary-structure content (reference
    ``plot/utils.py:115-164``, vectorized: bincount instead of the per-bin
    double loop).

    Args:
        lowd: ``(n_frames, 2)`` latent projection.
        dssp: ``(n_frames, n_residues)`` from :func:`..ops.dssp.compute_dssp`.
        bins: histogram resolution.
        imshow: return a ``(bins, bins, 3)`` RGB image of per-bin mean
            (helix, extended, coil) fractions; otherwise the per-frame RGB
            colors.

    RGB encoding is the reference's ``abc_to_rgb`` complement mixing
    (``plot/utils.py:109-112``): with per-bin mean fractions (A=helix,
    B=extended, C=coil), ``rgb = (min(B+C,1), min(A+C,1), min(A+B,1))`` —
    a pure-helix bin renders cyan, pure-extended magenta, pure-coil
    yellow; unpopulated bins stay white, and the image is x-major like the
    reference's ``digitized[i, j]`` fill (NOTE this differs from
    :func:`plot_free_energy`'s ``H.T`` row-major-display convention —
    ``plt.imshow(img.transpose(1, 0, 2), origin="lower")`` puts x
    horizontal).
    """
    fr = dssp_fractions(dssp)
    if not imshow:
        # the reference's non-imshow branch returns per-frame abc_to_rgb
        # colors (utils.py:163-164), not raw fractions
        return _abc_to_rgb(fr)
    lowd = np.asarray(lowd)[:, :2]
    xe = np.linspace(lowd[:, 0].min(), lowd[:, 0].max(), bins + 1)
    ye = np.linspace(lowd[:, 1].min(), lowd[:, 1].max(), bins + 1)
    xi = np.clip(np.digitize(lowd[:, 0], xe) - 1, 0, bins - 1)
    yi = np.clip(np.digitize(lowd[:, 1], ye) - 1, 0, bins - 1)
    flat = xi * bins + yi
    counts = np.bincount(flat, minlength=bins * bins).astype(np.float64)
    img = np.ones((bins * bins, 3))
    for c in range(3):
        sums = np.bincount(flat, weights=fr[:, c], minlength=bins * bins)
        np.divide(sums, counts, out=img[:, c], where=counts > 0)
    rgb = _abc_to_rgb(img)
    rgb[counts == 0] = 1.0
    return rgb.reshape(bins, bins, 3)


def _abc_to_rgb(fractions: np.ndarray) -> np.ndarray:
    """Vectorized reference ``abc_to_rgb`` (``plot/utils.py:109-112``):
    (..., 3) [helix, extended, coil] fractions -> (..., 3) rgb via
    complement mixing."""
    a, b, c = (fractions[..., 0], fractions[..., 1], fractions[..., 2])
    return np.stack(
        [np.minimum(b + c, 1.0), np.minimum(a + c, 1.0),
         np.minimum(a + b, 1.0)],
        axis=-1,
    )


def get_histogram(
    x: np.ndarray,
    y: np.ndarray,
    bins: int = 100,
    weights: Optional[np.ndarray] = None,
    avoid_zero_count: bool = False,
    transpose: bool = False,
    return_edges: bool = False,
):
    """2D histogram with 1-D bin-center arrays, exactly the reference's
    return contract (``plotting.py:115-194``): ``(xcenters, ycenters, H)``,
    or ``(xcenters, ycenters, xedges, yedges, H)`` with ``return_edges``.

    Examples:
        >>> import numpy as np
        >>> from encodermap_tpu_torch.plot import get_histogram
        >>> x, y = np.random.uniform(size=(2, 500))
        >>> xcenters, ycenters, H = get_histogram(x, y)
        >>> xcenters.shape
        (100,)
        >>> H.shape
        (100, 100)
    """
    H, xedges, yedges = np.histogram2d(x, y, bins=bins, weights=weights)
    if avoid_zero_count:
        H = np.maximum(H, np.min(H[H.nonzero()]))
    xcenters = (xedges[:-1] + xedges[1:]) / 2
    ycenters = (yedges[:-1] + yedges[1:]) / 2
    if transpose:
        H = H.T
    if return_edges:
        return xcenters, ycenters, xedges, yedges, H
    return xcenters, ycenters, H


def to_density(H: np.ndarray) -> np.ndarray:
    """Normalize histogram counts to a density (reference
    ``plotting.py:227-239``)."""
    return H / H.sum()


def to_free_energy(
    D: np.ndarray, kT: float = 1.0, minener_zero: bool = False
) -> np.ndarray:
    """-kT ln(density); empty bins become inf. ``minener_zero`` shifts the
    minimum to zero BEFORE the kT scaling, exactly like the reference —
    and like it, defaults to False (unshifted)
    (reference ``plotting.py:240-267``)."""
    F = np.full(D.shape, np.inf)
    nz = D.nonzero()
    with np.errstate(divide="ignore"):
        F[nz] = -np.log(D[nz])
    if minener_zero and len(F[nz]):
        F[nz] -= np.min(F[nz])
    return F * kT


def get_density(x, y, bins: int = 100, weights=None,
                avoid_zero_count: bool = False, transpose: bool = False):
    """2D density (reference ``plotting.py:195-226``)."""
    xc, yc, H = get_histogram(x, y, bins, weights, avoid_zero_count,
                              transpose)
    return xc, yc, to_density(H)


def get_free_energy(x, y, bins: int = 100, weights=None, kT: float = 1.0,
                    avoid_zero_count: bool = False,
                    minener_zero: bool = False, transpose: bool = True):
    """2D free-energy surface (reference ``plotting.py:268-310``; same
    parameter set and defaults)."""
    xc, yc, D = get_density(x, y, bins, weights, avoid_zero_count,
                            transpose)
    return xc, yc, to_free_energy(D, kT, minener_zero)


def plot_raw_data(
    data: np.ndarray,
    labels: Optional[Sequence[str]] = None,
    ax: Any = None,
    save_path: Optional[Union[str, Path]] = None,
):
    """Heatmap of a (frames, features) CV array (reference
    ``plotting.py:2123-2232``)."""
    plt = _mpl()
    data = np.asarray(data)
    if ax is None:
        fig, ax = plt.subplots(figsize=(10, 6))
    else:
        fig = ax.figure
    mesh = ax.imshow(data.T, aspect="auto", interpolation="nearest",
                     cmap="viridis", origin="lower")
    fig.colorbar(mesh, ax=ax, label="value")
    ax.set_xlabel("frame")
    ax.set_ylabel("feature")
    if labels is not None:
        step = max(1, len(labels) // 25)
        ax.set_yticks(np.arange(len(labels))[::step])
        ax.set_yticklabels(np.asarray(labels, object)[::step], fontsize=6)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return str(save_path)
    return ax


def plot_end2end(
    traj,
    selstr: str = "name CA",
    subsample: Optional[Union[int, slice, np.ndarray]] = None,
    rolling_avg_window: int = 5,
    ax: Any = None,
    save_path: Optional[Union[str, Path]] = None,
    selection: Optional[str] = None,
):
    """End-to-end distance timeseries of a trajectory (reference
    ``plotting.py:2504-2536``; same ``selstr``/``subsample``/
    ``rolling_avg_window`` parameters — an int ``subsample`` keeps every
    Nth frame, the rolling average is overlaid like the reference's
    plotly trendline. ``selection`` is kept as an alias from earlier
    releases of this package)."""
    plt = _mpl()
    if selection is not None:
        selstr = selection
    idx = traj.top.select(selstr)
    xyz = np.asarray(traj.xyz)
    d = np.linalg.norm(xyz[:, idx[-1]] - xyz[:, idx[0]], axis=-1)
    if subsample is not None:
        if isinstance(subsample, int):
            subsample = slice(None, None, subsample)
        d = d[subsample]
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    ax.plot(d, alpha=0.4, label="per frame")
    if rolling_avg_window and rolling_avg_window > 1 and len(d) >= rolling_avg_window:
        kernel = np.full(rolling_avg_window, 1.0 / rolling_avg_window)
        avg = np.convolve(d, kernel, mode="valid")
        xs = np.arange(len(avg)) + (rolling_avg_window - 1) / 2
        ax.plot(xs, avg, "C1", label=f"rolling avg ({rolling_avg_window})")
        ax.legend(fontsize=8)
    ax.set_xlabel("frame")
    ax.set_ylabel("end-to-end distance / nm")
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return str(save_path)
    return ax


def animate_lowd_trajectory(
    lowd: np.ndarray,
    save_path: Union[str, Path],
    trail: int = 50,
    stride: int = 1,
    fps: int = 25,
    bins: int = 100,
):
    """Animate a trajectory's path through the 2D projection over a density
    background (reference ``plotting.py:1103-1184``; matplotlib
    FuncAnimation; saved as .gif or .mp4 by extension)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    lowd = np.asarray(lowd)[:, :2]
    frames = np.arange(0, len(lowd), stride)
    fig, ax = plt.subplots()
    ax.hist2d(lowd[:, 0], lowd[:, 1], bins=bins, cmap="Greys")
    (line,) = ax.plot([], [], "-", color="tab:red", lw=1.5)
    (dot,) = ax.plot([], [], "o", color="tab:red", ms=6)

    def update(i):
        k = frames[i]
        lo = max(0, k - trail)
        line.set_data(lowd[lo:k + 1, 0], lowd[lo:k + 1, 1])
        dot.set_data(lowd[k:k + 1, 0], lowd[k:k + 1, 1])
        return line, dot

    anim = FuncAnimation(fig, update, frames=len(frames), blit=True)
    save_path = Path(save_path)
    if save_path.suffix == ".gif":
        anim.save(save_path, writer=PillowWriter(fps=fps))
    else:
        anim.save(save_path, fps=fps)
    plt.close(fig)
    return str(save_path)


#: DSSP code -> human-readable name (full mdtraj/DSSP alphabet; the
#: simplified 3-letter scheme uses C/E/H). Reference
#: ``plot/plotting.py:2442-2459``.
def dssp_to_text(val: str, simplified: bool = False) -> str:
    """Human-readable name of one DSSP code (simplified: C/E/H)."""
    return (_DSSP_TEXT_SIMPLIFIED if simplified else _DSSP_TEXT)[val]


def dssp_to_rgb(val: str, simplified: bool = False) -> tuple:
    """Display color (r, g, b in 0-1) of one DSSP code."""
    return (_DSSP_RGB_SIMPLIFIED if simplified else _DSSP_RGB)[val]


def distance_histogram_interactive(
    data,
    periodicity: float,
    low_d_max: float = 5.0,
    bins="auto",
    initial_guess=None,
):
    """Interactive sigmoid-parameter tuner over the pairwise-distance
    histogram — returns a :class:`~encodermap_tpu_torch.plot.interactive.
    DistanceHistogramInteractive` (call ``.show()`` in a notebook, or use
    ``.update(...)``/``.apply(parameters)`` headlessly). Functional analog
    of the reference's plotly version (``plot/plotting.py:1650``)."""
    from .interactive import DistanceHistogramInteractive

    return DistanceHistogramInteractive(
        data,
        periodicity=periodicity,
        initial_guess=initial_guess,
        low_d_max=low_d_max,
        bins=bins,
    )


def hex_to_rgba(h: str, alpha: float = 0.8) -> str:
    """``"#rrggbb"`` -> ``"rgba(r, g, b, alpha)"`` (reference
    ``plot/plotting.py:311-314``)."""
    h = h.lstrip("#")
    r, g, b = (int(h[i:i + 2], 16) for i in (0, 2, 4))
    return f"rgba({r}, {g}, {b}, {alpha})"
