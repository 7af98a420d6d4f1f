# encodermap_tpu_torch/plot/interactive.py
"""InteractivePlotting: select latent-space regions -> cluster -> generate.

Counterpart of ``encodermap_tpu/plot/interactive.py``
(``InteractivePlotting`` :35, ``DistanceHistogramInteractive`` :266,
``interactive_path_visualization`` :417). The reference builds a
Jupyter/nglview lasso UI (``plot/interactive_plotting.py:521``); this
design separates the logic (polygon and rectangle selection, cluster
writing, linear and Bézier paths, writing tuned sigmoid parameters back)
from the widget, so it works headless, and shows the widget with
matplotlib's ``LassoSelector`` and ``Slider`` or, inside a notebook
kernel, ``ipywidgets``. matplotlib, ``ipywidgets`` and ``IPython`` are
imported inside the functions that use them. Encoding and generation run
where the autoencoder lives.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Sequence, Union

import numpy as np

__all__ = ["InteractivePlotting", "DistanceHistogramInteractive",
           "interactive_path_visualization"]


def _in_ipython_kernel() -> bool:
    """True only inside a live Jupyter/IPython *kernel* (where ipywidgets
    actually render). Merely being importable is not enough: in a plain
    ``python script.py`` ``display(VBox)`` just prints a repr and no event
    loop serves the sliders, while the matplotlib-Slider fallback works."""
    try:
        from IPython import get_ipython
    except ImportError:
        return False
    ip = get_ipython()
    return ip is not None and type(ip).__name__ == "ZMQInteractiveShell"


class InteractivePlotting:
    """Latent-space selection + generation sessions.

    Follows the reference's instantiation contract
    (``plot/interactive_plotting.py``, exercised by
    ``tests/test_interactive_plotting.py:141-305``): every input can come
    from the autoencoder, from explicit arrays, or from CVs named
    ``lowd``/``highd`` on the trajs — with an AssertionError when neither
    an autoencoder nor both data sources are available.

    Args:
        autoencoder: an EncoderMap/ADC instance (needs encode/generate);
            may be None when both lowd and highd data are supplied.
        trajs: optional SingleTraj/TrajEnsemble for structure output and
            as a CV source (``trajs.lowd``/``trajs.highd``).
        lowd_data: explicit latent coordinates (n_frames, 2).
        highd_data: explicit high-dimensional data.
        data: alias for highd_data (this framework's round-1 name).
        device: where the cluster centroid's RMSD matrix is computed; None
            takes the autoencoder's device, or the card without one.
    """

    def __init__(
        self,
        autoencoder: Any = None,
        trajs: Any = None,
        lowd_data: Optional[np.ndarray] = None,
        highd_data: Optional[np.ndarray] = None,
        data: Optional[np.ndarray] = None,
        main_path: Optional[Union[str, Path]] = None,
        device: Any = None,
    ) -> None:
        self.autoencoder = autoencoder
        self.device = device if device is not None else getattr(autoencoder, "device", None)
        if trajs is not None and not hasattr(trajs, "trajs"):
            # a bare SingleTraj: wrap so cluster()/plot_cluster's
            # ensemble-shaped access works (same normalization as the
            # dashboard's UploadPage.load_trajs)
            from ..data import TrajEnsemble

            trajs = TrajEnsemble([trajs])
        self.trajs = trajs
        self.main_path = Path(
            main_path
            or getattr(getattr(autoencoder, "p", None), "main_path", ".")
        )
        if highd_data is None:
            highd_data = data

        def _cv(name):
            # trajs is always a TrajEnsemble here (bare SingleTrajs are
            # wrapped above), so ensemble .CVs is the only lookup needed
            if trajs is None:
                return None
            try:
                return np.asarray(trajs.CVs[name])
            except (KeyError, AttributeError, TypeError):
                return None

        highd = highd_data if highd_data is not None else _cv("highd")
        if highd is None and autoencoder is not None:
            highd = getattr(autoencoder, "train_data", None)
            if isinstance(highd, (tuple, list)):
                # ADC train data is a tuple of CV arrays; keep the trained
                # dihedral-family groups as the session's high-D data (the
                # encoder-input concatenation — ADC encode() accepts this
                # stacked matrix and splits it back into slots)
                ap = getattr(autoencoder, "p", None)
                groups = []
                if getattr(ap, "use_backbone_angles", False):
                    groups.append(np.asarray(highd[0]))
                groups.append(np.asarray(highd[1]))
                if getattr(ap, "use_sidechains", False) and len(highd) >= 5:
                    groups.append(np.asarray(highd[4]))
                if getattr(ap, "multimer_training", None) is not None or \
                        getattr(ap, "reconstruct_sidechains", False):
                    # these modes need the full tuple (cartesians included)
                    # — encode(None) projects the model's own train data
                    highd = None
                else:
                    highd = np.concatenate(groups, axis=1)
        lowd = lowd_data if lowd_data is not None else _cv("lowd")
        assert autoencoder is not None or (
            lowd is not None and highd is not None
        ), (
            "Without an autoencoder, both lowd_data and highd_data (or "
            "trajs CVs named 'lowd'/'highd') must be provided."
        )
        if lowd is None:
            # encode(None) projects the autoencoder's own train data
            lowd = autoencoder.encode(highd)
        self.data = highd
        self.latent = np.asarray(lowd)
        assert self.latent.ndim == 2, (
            f"lowd data must be 2-D (n_frames, n_latent), got "
            f"{self.latent.shape}"
        )
        self._selection: Optional[np.ndarray] = None

    @classmethod
    def from_project(cls, project_name: str) -> "InteractivePlotting":
        """Build a session from a kondata project (reference
        ``interactive_plotting.py:606-615``): download/load the project's
        trajectories + trained autoencoder and wire them together."""
        from ..kondata import load_project

        trajs, autoencoder = load_project(
            project_name, traj=-1, load_autoencoder=True
        )
        return cls(autoencoder=autoencoder, trajs=trajs)

    def help(self, n: Optional[int] = None) -> str:
        """Print usage instructions for the session (reference
        ``interactive_plotting.py:1759``). Returns the text too, so
        notebooks can render it."""
        text = (
            "InteractivePlotting usage:\n"
            "  sess.select(polygon)        lasso-select latent points\n"
            "  sess.cluster(name)          save the selection as a cluster\n"
            "  sess.path(points)           Bezier path through the latent "
            "space\n"
            "  sess.generate(path)         decode/backmap along the path\n"
            "  sess.write_cluster(name)    persist the active selection\n"
            "More: https://github.com/AG-Peter/encodermap"
        )
        print(text)
        return text

    def generate(self, path: np.ndarray) -> Any:
        """Backmap/decode along explicit latent points (the reference's
        ``sess.generate(path)``)."""
        if self.autoencoder is None:
            raise RuntimeError("generate() needs an autoencoder")
        return self.autoencoder.generate(np.asarray(path, np.float32))

    def write_cluster(self, name: str = "cluster") -> dict:
        """Persist the current selection (the reference's
        ``write_cluster``); same artifacts as :meth:`cluster`."""
        return self.cluster(name)

    # ------------------------------------------------------------------ selection
    def select(self, polygon: Sequence[tuple[float, float]]) -> np.ndarray:
        """Select latent points inside a polygon (the lasso). Returns frame
        indices and stores them as the active selection."""
        from matplotlib.path import Path as MplPath

        path = MplPath(np.asarray(polygon))
        mask = path.contains_points(self.latent[:, :2])
        self._selection = np.where(mask)[0]
        return self._selection

    def select_rectangle(self, x0, y0, x1, y1) -> np.ndarray:
        return self.select([(x0, y0), (x1, y0), (x1, y1), (x0, y1)])

    @property
    def selection(self) -> np.ndarray:
        if self._selection is None:
            raise RuntimeError("nothing selected yet — call select() first")
        return self._selection

    # ------------------------------------------------------------------ actions
    def cluster(self, name: str = "cluster") -> dict:
        """Write the selected frames as a cluster: csv of indices, latent
        highlight png, and (with trajs) a PDB of representative structures."""
        from .plotting import plot_cluster

        membership = np.full(len(self.latent), -1)
        membership[self.selection] = 0
        out = plot_cluster(
            self.trajs, 0, membership, self.latent,
            self.main_path / "clusters" / name, device=self.device,
        )
        return out

    def path(self, points: Sequence[tuple[float, float]], n: int = 50,
             mode: str = "linear") -> np.ndarray:
        """Interpolate a path through latent space and decode/generate along
        it (the reference's bezier/path tools,
        ``plot/utils.py:582-663``).

        Args:
            points: control points in latent space.
            n: samples along the path.
            mode: "linear" (piecewise-linear through the points) or "bezier"
                (Bernstein-polynomial curve with the points as control
                polygon, like the reference's BezierBuilder).
        """
        if self.autoencoder is None:
            raise RuntimeError("path() needs an autoencoder to generate "
                               "along the path")
        pts = np.asarray(points, np.float32)
        if pts.ndim != 2 or len(pts) < 2:
            raise ValueError(
                f"a path needs at least 2 control points, got {pts.shape}"
            )
        ts = np.linspace(0, 1, n)
        if mode == "bezier":
            from math import comb

            k = len(pts) - 1
            bern = np.stack(
                [comb(k, i) * ts**i * (1 - ts) ** (k - i)
                 for i in range(k + 1)], axis=1,
            )  # (n, k+1)
            path = bern @ pts
        elif mode == "linear":
            seg_lengths = np.linalg.norm(np.diff(pts, axis=0), axis=1)
            t = np.concatenate([[0], np.cumsum(seg_lengths)])
            if t[-1] == 0.0:  # all control points coincide
                return self.autoencoder.generate(
                    np.broadcast_to(pts[:1], (n, pts.shape[1])).copy()
                )
            t = t / t[-1]
            path = np.stack(
                [np.interp(ts, t, pts[:, i]) for i in range(pts.shape[1])],
                axis=1,
            )
        else:
            raise ValueError(f"unknown path mode {mode!r}")
        return self.autoencoder.generate(path)

    # ------------------------------------------------------------------ widget
    def show(self):
        """Open the matplotlib lasso UI (interactive backends only)."""
        import matplotlib.pyplot as plt
        from matplotlib.widgets import LassoSelector

        fig, ax = plt.subplots()
        ax.scatter(self.latent[:, 0], self.latent[:, 1], s=2)
        selector = LassoSelector(ax, onselect=lambda verts: self.select(verts))
        ax.set_title("lasso-select latent points; then call .cluster()")
        plt.show()
        return selector


class DistanceHistogramInteractive:
    """Interactive sigmoid-parameter tuning over the pairwise-distance
    histogram (reference ``plotting.py:1650-2023``, plotly sliders; here an
    ipywidgets + matplotlib version whose logic is callable headless).

    In a notebook: ``DistanceHistogramInteractive(data, periodicity).show()``
    renders sliders for the six sketch-map parameters. The current values
    are always in ``.params`` and can be written back to a Parameters
    instance with ``.apply(p)``.
    """

    def __init__(
        self,
        data: np.ndarray,
        periodicity: float,
        initial_guess: Optional[tuple] = None,
        low_d_max: float = 5.0,
        bins: Union[int, str] = "auto",
    ) -> None:
        from .plotting import _subsampled_pdists

        data = np.asarray(data, np.float32)
        assert not np.any(np.isnan(data)), "You provided some nans."
        self.distances = _subsampled_pdists(data, periodicity)
        self.low_d_max = low_d_max
        self.bins = bins
        self.params = tuple(initial_guess or (4.5, 12, 6, 1, 2, 6))

    def update(self, sig_h=None, a_h=None, b_h=None, sig_l=None, a_l=None,
               b_l=None):
        """Set any subset of the six parameters; returns the sigmoid curves
        evaluated for plotting: (x_h, y_h, x_l, y_l)."""
        from ..ops.distances import sigmoid

        p = list(self.params)
        for i, v in enumerate((sig_h, a_h, b_h, sig_l, a_l, b_l)):
            if v is not None:
                p[i] = v
        self.params = tuple(p)
        x_h = np.linspace(0, float(self.distances.max()), 250)
        x_l = np.linspace(0, self.low_d_max, 250)
        y_h = sigmoid(*self.params[:3])(x_h)
        y_l = sigmoid(*self.params[3:])(x_l)
        return x_h, np.asarray(y_h), x_l, np.asarray(y_l)

    def apply(self, parameters, attribute: Optional[str] = None) -> None:
        """Write the tuned values into a Parameters/ADCParameters object.

        ADCParameters carries TWO independent sigmoid sets —
        ``dist_sig_parameters`` (dihedral-space sketch-map loss) and
        ``cartesian_dist_sig_parameters`` (CA-pair loss). Only ONE is
        written: ``attribute`` when given, else the cartesian set on
        ADCParameters (the quantity this histogram is usually tuned on)
        and ``dist_sig_parameters`` on plain Parameters.
        """
        if attribute is None:
            attribute = (
                "cartesian_dist_sig_parameters"
                if hasattr(parameters, "cartesian_dist_sig_parameters")
                else "dist_sig_parameters"
            )
        if not hasattr(parameters, attribute):
            raise AttributeError(
                f"{type(parameters).__name__} has no attribute {attribute!r}"
            )
        setattr(parameters, attribute, self.params)

    def show(self):
        """Render the tuning UI. In a notebook with ipywidgets installed
        this uses FloatSliders; otherwise it falls back to matplotlib's own
        ``Slider`` widgets (which also work headlessly — moving a slider
        with ``set_val`` updates ``.params`` and the curves). Returns the
        slider dict either way."""
        if not _in_ipython_kernel():
            return self._show_mpl()
        try:
            import ipywidgets as widgets  # noqa: F401
        except ImportError:
            return self._show_mpl()
        return self._show_ipywidgets()

    def _show_ipywidgets(self):  # pragma: no cover - notebook UI
        import ipywidgets as widgets
        import matplotlib.pyplot as plt
        from IPython.display import display

        fig, ax = plt.subplots()
        ax.hist(self.distances, bins=self.bins, density=True, alpha=0.5)
        ax2 = ax.twinx()
        x_h, y_h, x_l, y_l = self.update()
        (lh,) = ax2.plot(x_h, y_h, label="high-d sigmoid")
        (ll,) = ax2.plot(x_l, y_l, label="low-d sigmoid")
        ax2.legend()
        names = ("sig_h", "a_h", "b_h", "sig_l", "a_l", "b_l")
        sliders = {
            n: widgets.FloatSlider(value=v, min=0.1, max=max(4 * v, 20),
                                   step=0.1, description=n)
            for n, v in zip(names, self.params)
        }

        def on_change(_):
            x_h, y_h, x_l, y_l = self.update(
                **{n: s.value for n, s in sliders.items()}
            )
            lh.set_data(x_h, y_h)
            ll.set_data(x_l, y_l)
            fig.canvas.draw_idle()

        for s in sliders.values():
            s.observe(on_change, "value")
        display(widgets.VBox(list(sliders.values())))
        plt.show()
        return sliders

    def _show_mpl(self):
        """ipywidgets-free tuning UI on matplotlib's native ``Slider``
        widgets (``matplotlib.widgets.Slider`` responds to ``set_val``
        even on the Agg backend, so this path is headless-testable)."""
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        names = ("sig_h", "a_h", "b_h", "sig_l", "a_l", "b_l")
        fig = plt.figure(figsize=(8, 7))
        # histogram + curves on top, six slider rows below
        ax = fig.add_axes([0.1, 0.45, 0.85, 0.5])
        ax.hist(self.distances, bins=self.bins, density=True, alpha=0.5)
        ax2 = ax.twinx()
        x_h, y_h, x_l, y_l = self.update()
        (lh,) = ax2.plot(x_h, y_h, label="high-d sigmoid")
        (ll,) = ax2.plot(x_l, y_l, label="low-d sigmoid")
        ax2.legend()
        sliders = {}
        for k, (n, v) in enumerate(zip(names, self.params)):
            sax = fig.add_axes([0.15, 0.32 - 0.05 * k, 0.7, 0.03])
            sliders[n] = Slider(sax, n, valmin=0.1,
                                valmax=max(4 * v, 20), valinit=v)

        def on_change(_val):
            x_h, y_h, x_l, y_l = self.update(
                **{n: s.val for n, s in sliders.items()}
            )
            lh.set_data(x_h, y_h)
            ll.set_data(x_l, y_l)
            fig.canvas.draw_idle()

        for s in sliders.values():
            s.on_changed(on_change)
        plt.show(block=False)
        return sliders


def interactive_path_visualization(traj, lowd, path):
    """Scrub through a generated path: density background + path line +
    current-position marker, with a frame slider (reference
    ``plotting.py:1517-1649``; ipywidgets when available, else
    matplotlib's native ``Slider`` — both instead of plotly/nglview)."""
    lowd = np.asarray(lowd)[:, :2]
    path = np.asarray(path)
    n = len(path)
    assert len(traj.xyz) == n, (
        f"Path has {n} points, trajectory has {len(traj.xyz)} frames."
    )

    # never force a backend here: flipping to Agg would kill the very
    # scrubber this builds AND leak into the caller's later figures —
    # headless tests set MPLBACKEND themselves
    import matplotlib.pyplot as plt

    if _in_ipython_kernel():
        try:
            import ipywidgets as widgets
        except ImportError:
            widgets = None
    else:
        # outside a notebook kernel the ipywidgets UI is inert (no event
        # loop); the matplotlib Slider works everywhere
        widgets = None

    if widgets is None:
        from matplotlib.widgets import Slider

        fig = plt.figure()
        ax = fig.add_axes([0.1, 0.25, 0.85, 0.7])
    else:
        fig, ax = plt.subplots()
    ax.hist2d(lowd[:, 0], lowd[:, 1], bins=100, cmap="Greys")
    ax.plot(path[:, 0], path[:, 1], "-", color="tab:blue")
    (dot,) = ax.plot([path[0, 0]], [path[0, 1]], "o", color="tab:red", ms=8)

    def on_change(change):
        if isinstance(change, dict):
            k = int(change["new"])
        else:
            k = int(change)
        # the mpl slider's valmax is max(n-1, 1) (a zero-length slider is
        # not constructible), so clamp: a 1-point path must keep showing
        # frame 0 instead of an empty marker
        k = min(max(k, 0), n - 1)
        dot.set_data(path[k:k + 1, 0], path[k:k + 1, 1])
        fig.canvas.draw_idle()

    if widgets is None:
        sax = fig.add_axes([0.15, 0.1, 0.7, 0.04])
        slider = Slider(sax, "frame", valmin=0, valmax=max(n - 1, 1),
                        valinit=0, valstep=1)
        slider.on_changed(on_change)

        class _Box:
            """Minimal stand-in for the ipywidgets VBox return value."""

        box = _Box()
        box.children = (slider,)
    else:
        slider = widgets.IntSlider(value=0, min=0, max=n - 1,
                                   description="frame")
        slider.observe(on_change, "value")
        box = widgets.VBox([slider])
    box._figure = fig  # keep alive; tests reach in
    box._on_change = on_change
    return box
