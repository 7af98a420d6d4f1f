# encodermap_tpu_torch/plot/dashboard.py
"""Multi-page Dash web dashboard: traj upload, topology/trajectory views,
latent projection with lasso-cluster and path generation.

Counterpart of ``encodermap_tpu/plot/dashboard.py`` (:33-432), itself the
page-for-page equivalent of the reference's app
(``plot/dashboard.py:1135`` there — pages registered at
``:456`` upload, ``:721`` top, ``:866`` traj, ``:1020`` projection):

* Home       — project status.
* Upload     — load trajectories from paths / fetch a kondata project.
* Traj       — per-trajectory table (frames, topology, loaded CVs).
* Top        — residue/atom listing per topology.
* Projection — latent scatter, lasso -> cluster writing, path -> generate.

Design: every page is a class whose *callback logic* is plain Python over a
shared :class:`DashboardSession` (testable headless, no dash needed); only
``layout()``/``register()`` and :meth:`Dashboard.run` require the optional
``dash`` package. The selection/cluster/path math is shared with
:class:`encodermap_tpu_torch.plot.interactive.InteractivePlotting`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

__all__ = ["Dashboard", "DashboardSession", "HomePage", "UploadPage",
           "TrajPage", "TopPage", "ProjectionPage"]


class DashboardSession:
    """Shared headless state: trajectories, autoencoder, latent projection."""

    def __init__(self, autoencoder: Any = None, trajs: Any = None,
                 data: Optional[np.ndarray] = None,
                 main_path: Optional[str] = None) -> None:
        self.autoencoder = autoencoder
        self.trajs = trajs
        self.data = data
        self.main_path = Path(
            main_path
            or getattr(getattr(autoencoder, "p", None), "main_path", ".")
        )
        self._interactive = None

    @property
    def interactive(self):
        """Lazy InteractivePlotting over the current autoencoder + data."""
        if self._interactive is None:
            if self.autoencoder is None:
                raise RuntimeError(
                    "no autoencoder in this session — train or load one "
                    "before using the projection page"
                )
            from .interactive import InteractivePlotting

            # `data` is HIGH-dimensional training data — it must not land in
            # the third positional slot, which is lowd_data
            self._interactive = InteractivePlotting(
                self.autoencoder, self.trajs, data=self.data,
                main_path=self.main_path,
            )
        return self._interactive

    def set_trajs(self, trajs: Any) -> None:
        self.trajs = trajs
        self._interactive = None


class HomePage:
    """Project overview (reference home page, ``dashboard.py:1202``)."""

    name, path = "home", "/"

    def __init__(self, session: DashboardSession) -> None:
        self.session = session

    def status(self) -> dict:
        s = self.session
        out = {
            "n_trajs": 0 if s.trajs is None else len(list(s.trajs)),
            "model": type(s.autoencoder).__name__ if s.autoencoder else None,
            "main_path": str(s.main_path),
        }
        if s.autoencoder is not None:
            out["trained_steps"] = int(s.autoencoder.state.step)
        return out

    def layout(self):
        from dash import html

        rows = [html.Li(f"{k}: {v}") for k, v in self.status().items()]
        return html.Div([html.H3("EncoderMap-TPU"), html.Ul(rows)])


class UploadPage:
    """Load trajectories (reference LocalUploadTraj, ``dashboard.py:266`` —
    there via browser upload; here via server-side paths, the natural
    equivalent for a local app)."""

    name, path = "upload", "/upload"

    def __init__(self, session: DashboardSession) -> None:
        self.session = session

    def load_trajs(self, traj_paths: Sequence[str],
                   top_paths: Optional[Sequence[str]] = None,
                   common_str: Optional[Sequence[str]] = None) -> str:
        from ..data import load

        trajs = load(list(traj_paths), top_paths, common_str=common_str)
        if not hasattr(trajs, "trajs"):  # single traj -> ensemble
            from ..data.trajectory import TrajEnsemble

            trajs = TrajEnsemble([trajs])
        self.session.set_trajs(trajs)
        return (
            f"Loaded {len(list(trajs))} trajectorie(s). Go to the 'Traj' "
            f"page to look at your data."
        )

    def load_project(self, project: str) -> str:
        from ..kondata import get_from_kondata

        out = get_from_kondata(project, silence_overwrite_message=True)
        return f"Fetched project {project!r} to {out}."

    def layout(self):
        from dash import dcc, html

        return html.Div([
            html.H3("Load trajectories"),
            dcc.Input(id="upload-traj-paths",
                      placeholder="comma-separated traj paths",
                      style={"width": "60%"}),
            dcc.Input(id="upload-top-paths",
                      placeholder="comma-separated topology paths",
                      style={"width": "60%"}),
            html.Button("load", id="upload-load-btn"),
            html.Div(id="upload-out"),
        ])

    def register(self, app) -> None:
        import dash

        dash.register_page(self.name, path=self.path, layout=self.layout)

        @app.callback(
            dash.Output("upload-out", "children"),
            dash.Input("upload-load-btn", "n_clicks"),
            dash.State("upload-traj-paths", "value"),
            dash.State("upload-top-paths", "value"),
            prevent_initial_call=True,
        )
        def _load(n_clicks, traj_value, top_value):
            if not traj_value:
                return "enter trajectory paths first"
            trajs = [p.strip() for p in traj_value.split(",") if p.strip()]
            tops = (
                [p.strip() for p in top_value.split(",") if p.strip()]
                if top_value else None
            )
            try:
                return self.load_trajs(trajs, tops)
            except Exception as e:  # surface errors in the UI
                return f"error: {e}"


class TrajPage:
    """Trajectory table (reference TrajPage, ``dashboard.py:860``)."""

    name, path = "traj", "/traj"

    def __init__(self, session: DashboardSession) -> None:
        self.session = session

    def table_rows(self) -> list[dict]:
        trajs = self.session.trajs
        if trajs is None:
            return []
        rows = []
        for t in trajs:
            rows.append({
                "traj_num": t.traj_num,
                "traj_file": str(t.traj_file),
                "top_file": str(t.top_file),
                "n_frames": t.n_frames,
                "n_atoms": t.top.n_atoms,
                "common_str": t.common_str,
                "CVs": ", ".join(sorted(t._CVs)) or "-",
            })
        return rows

    def layout(self):
        from dash import dash_table, html

        rows = self.table_rows()
        if not rows:
            return html.Div([html.H3("Trajectories"),
                             html.P("nothing loaded — use the Upload page")])
        return html.Div([
            html.H3("Trajectories"),
            dash_table.DataTable(
                data=rows,
                columns=[{"name": k, "id": k} for k in rows[0]],
            ),
        ])


class TopPage:
    """Topology viewer (reference TopPage, ``dashboard.py:566``)."""

    name, path = "top", "/top"

    def __init__(self, session: DashboardSession) -> None:
        self.session = session

    def options(self) -> list[str]:
        trajs = self.session.trajs
        if trajs is None:
            return []
        seen, out = set(), []
        for t in trajs:
            if str(t.top_file) not in seen:
                seen.add(str(t.top_file))
                out.append(str(t.top_file))
        return out

    def describe_top(self, index: int = 0) -> list[str]:
        """Residue listing of the selected topology."""
        trajs = self.session.trajs
        if trajs is None:
            return []
        tops = self.options()
        if not (0 <= int(index) < len(tops)):
            # a still-mounted dropdown can fire with a stale value after
            # an upload swapped the ensemble
            return ["(topology selection out of date — re-select above)"]
        target = tops[int(index)]
        for t in trajs:
            if str(t.top_file) == target:
                return [
                    f"{r.name}{r.resSeq}: "
                    + " ".join(a.name for a in r.atoms)
                    for r in t.top.residues
                ]
        return []

    def layout(self):
        from dash import dcc, html

        opts = self.options()
        return html.Div([
            html.H3("Topologies"),
            dcc.Dropdown(id="top-select",
                         options=[{"label": o, "value": i}
                                  for i, o in enumerate(opts)],
                         value=0 if opts else None),
            html.Pre(id="top-out"),
        ])

    def register(self, app) -> None:
        import dash

        dash.register_page(self.name, path=self.path, layout=self.layout)

        # initial call must fire: the dropdown pre-selects value=0, and
        # with a single topology there is no other option to toggle
        # through to trigger a change event
        @app.callback(
            dash.Output("top-out", "children"),
            dash.Input("top-select", "value"),
        )
        def _show(value):
            if value is None:
                return "upload a trajectory first"
            return "\n".join(self.describe_top(int(value)))


class ProjectionPage:
    """Latent projection with lasso-cluster + path generation (reference
    ProjectionPage, ``dashboard.py:949``)."""

    name, path = "projection", "/projection"

    def __init__(self, session: DashboardSession) -> None:
        self.session = session

    def figure_data(self) -> dict:
        latent = self.session.interactive.latent
        return {"x": latent[:, 0].tolist(), "y": latent[:, 1].tolist()}

    def select_lasso(self, lasso_points: dict) -> int:
        """Dash lasso payload -> active selection; returns #selected."""
        polygon = list(zip(lasso_points["x"], lasso_points["y"]))
        return int(len(self.session.interactive.select(polygon)))

    def write_cluster(self, name: str) -> str:
        out = self.session.interactive.cluster(name)
        return f"wrote cluster: {out}"

    def generate_path(self, points: Sequence[tuple[float, float]],
                      n: int = 50, mode: str = "linear") -> str:
        """Decode a latent path into conformations; saves xyz npy (plus PDB
        when a topology is around) under main_path/generated/."""
        xyz = np.asarray(self.session.interactive.path(points, n, mode))
        out_dir = self.session.main_path / "generated"
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = out_dir / f"path_{mode}_{n}"
        np.save(f"{stem}.npy", xyz)
        msg = f"generated {len(xyz)} conformations -> {stem}.npy"
        trajs = getattr(self.session.interactive, "trajs", None)
        if (
            trajs is not None
            and len(trajs) > 0
            and xyz.ndim == 3
            and xyz.shape[1] == trajs.trajs[0].top.n_atoms
        ):
            from ..data.pdb import write_pdb

            write_pdb(f"{stem}.pdb", trajs.trajs[0].top, xyz)
            msg += f" and {stem}.pdb"
        return msg

    def layout(self):
        from dash import dcc, html

        import plotly.graph_objects as go

        d = self.figure_data()
        fig = go.Figure(go.Scattergl(x=d["x"], y=d["y"], mode="markers",
                                     marker={"size": 3}))
        fig.update_layout(dragmode="lasso", title="latent projection")
        return html.Div([
            html.H3("Projection"),
            dcc.Graph(id="projection", figure=fig),
            html.Button("write cluster", id="cluster-btn"),
            html.Button("generate path through selection", id="path-btn"),
            html.Div(id="projection-out"),
        ])

    def register(self, app) -> None:
        import dash

        dash.register_page(self.name, path=self.path, layout=self.layout)

        @app.callback(
            dash.Output("projection-out", "children"),
            dash.Input("cluster-btn", "n_clicks"),
            dash.Input("path-btn", "n_clicks"),
            dash.State("projection", "selectedData"),
            prevent_initial_call=True,
        )
        def _act(cluster_clicks, path_clicks, selected):
            if not selected or "lassoPoints" not in selected:
                return "lasso-select points first"
            n_sel = self.select_lasso(selected["lassoPoints"])
            trigger = dash.ctx.triggered_id
            if trigger == "path-btn":
                if n_sel < 2:
                    return (
                        f"{n_sel} point(s) selected — a path needs at "
                        f"least 2; widen the lasso"
                    )
                sel = self.session.interactive.selection
                latent = self.session.interactive.latent[sel]
                # path through the selection: sweep along its first axis
                order = np.argsort(latent[:, 0])
                ctrl = latent[order][:: max(1, len(order) // 8)]
                if len(ctrl) < 2:
                    ctrl = latent[order][[0, -1]]
                return self.generate_path(ctrl, mode="linear")
            return f"{n_sel} selected; " + self.write_cluster(
                f"dash_{cluster_clicks}"
            )


class Dashboard:
    """Multi-page interactive web dashboard around a trained autoencoder.

    Usage::

        board = Dashboard(autoencoder, trajs)
        board.run(port=8050)
    """

    def __init__(self, autoencoder: Any, trajs: Any = None,
                 data: Optional[np.ndarray] = None) -> None:
        try:
            import dash  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "the Dashboard needs the optional 'dash' package "
                "(pip install dash plotly); for a dependency-free UI use "
                "encodermap_tpu_torch.plot.InteractivePlotting"
            ) from e
        self.session = DashboardSession(autoencoder, trajs, data)
        self.pages = {
            "home": HomePage(self.session),
            "upload": UploadPage(self.session),
            "traj": TrajPage(self.session),
            "top": TopPage(self.session),
            "projection": ProjectionPage(self.session),
        }
        self._app = None

    def _build(self):
        import dash
        from dash import dcc, html

        app = dash.Dash("encodermap_tpu_torch", use_pages=True,
                        pages_folder="")
        for page in self.pages.values():
            if hasattr(page, "register"):
                page.register(app)
            else:
                dash.register_page(page.name, path=page.path,
                                   layout=page.layout)
        nav = html.Div([
            dcc.Link(p.name, href=p.path, style={"margin": "0 8px"})
            for p in self.pages.values()
        ])
        app.layout = html.Div([nav, dash.page_container])
        return app

    def run(self, port: int = 8050, **kwargs: Any) -> None:
        """Build and serve the app (blocking)."""
        if self._app is None:
            self._app = self._build()
        self._app.run(port=port, **kwargs)
