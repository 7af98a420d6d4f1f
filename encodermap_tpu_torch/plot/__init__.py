# encodermap_tpu_torch/plot/__init__.py
"""Plotting and visualization of the port (counterpart of
``encodermap_tpu/plot``, :1-86): matplotlib figures, the headless
interactive selector and the dashboard pages. matplotlib, ``ipywidgets``,
``IPython`` and ``dash`` are imported inside the functions that use them,
so importing this package needs none of them; the dashboard's names
resolve lazily, as in the JAX package."""

from .interactive import (
    DistanceHistogramInteractive,
    InteractivePlotting,
    interactive_path_visualization,
)
from .plotting import (
    animate_lowd_trajectory,
    digitize_dssp,
    distance_histogram,
    distance_histogram_interactive,
    dssp_fractions,
    dssp_to_rgb,
    dssp_to_text,
    get_density,
    get_free_energy,
    get_histogram,
    hex_to_rgba,
    plot_ball_and_stick,
    plot_cluster,
    plot_dssp,
    plot_end2end,
    plot_free_energy,
    plot_latent_scatter,
    plot_ramachandran,
    plot_raw_data,
    plot_trajs_by_parameter,
    render_vmd,
    to_density,
    to_free_energy,
)

__all__ = [
    "Dashboard",
    "DashboardSession",
    "HomePage",
    "UploadPage",
    "TrajPage",
    "TopPage",
    "ProjectionPage",
    "InteractivePlotting",
    "DistanceHistogramInteractive",
    "interactive_path_visualization",
    "distance_histogram",
    "distance_histogram_interactive",
    "dssp_to_text",
    "dssp_to_rgb",
    "hex_to_rgba",
    "plot_dssp",
    "plot_ball_and_stick",
    "render_vmd",
    "dssp_fractions",
    "digitize_dssp",
    "animate_lowd_trajectory",
    "get_density",
    "get_free_energy",
    "get_histogram",
    "plot_end2end",
    "plot_raw_data",
    "to_density",
    "to_free_energy",
    "plot_cluster",
    "plot_free_energy",
    "plot_latent_scatter",
    "plot_ramachandran",
    "plot_trajs_by_parameter",
]

#: dashboard members, resolved on first use
_DASHBOARD_NAMES = ("Dashboard", "DashboardSession", "HomePage", "UploadPage",
                    "TrajPage", "TopPage", "ProjectionPage")


def __getattr__(name):
    """The dashboard's names, imported on first use."""
    if name in _DASHBOARD_NAMES:
        from . import dashboard

        return getattr(dashboard, name)
    raise AttributeError(name)
