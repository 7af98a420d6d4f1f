# tests/test_torch_plot.py
"""Slice 6b's plotting, interactive selection and dashboard pages against
the JAX package, under matplotlib's Agg backend (chosen by ``MPLBACKEND``,
not by ``matplotlib.use``).

* The data functions (``get_histogram``, ``get_density``, ``to_density``,
  ``to_free_energy``, ``get_free_energy``, ``dssp_fractions``,
  ``digitize_dssp``, ``dssp_to_text``, ``dssp_to_rgb``, ``hex_to_rgba``,
  ``_subsampled_pdists``) give equal arrays on seeded inputs (host numpy in
  both packages).
* Each figure function draws the same artists: lines, collections,
  patches, texts, axes and labels. The VMD script is the same text.
* On one small trained model (the JAX EncoderMap, loaded in the port from
  its checkpoint) and a ``synthetic_protein`` trajectory, the headless
  ``InteractivePlotting`` (polygon and rectangle selection, ``cluster``,
  linear and Bézier ``path``) and the five dashboard pages give the same
  indices and files; decoded paths agree to 1e-5.
* ``plot.__all__`` equals the JAX package's, and ``encodermap_tpu_torch``
  and its ``plot`` import, and train with ``tensorboard=True``, with
  matplotlib, tensorboard, tensorflow and dash hidden.
"""

import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("MPLBACKEND", "Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import encodermap_tpu as emj  # noqa: E402
import encodermap_tpu.plot as PJ  # noqa: E402
import encodermap_tpu_torch as emt  # noqa: E402
import encodermap_tpu_torch.plot as PT  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).parent.parent


def test_plot_names_match_jax():
    assert PT.__all__ == PJ.__all__
    for name in PJ.__all__:
        assert getattr(PT, name).__name__ == getattr(PJ, name).__name__


# ------------------------------------------------------------ data functions
def _xy():
    rng = np.random.default_rng(0)
    return rng.normal(size=400), rng.normal(0.5, 2.0, size=400), rng.random(400)


def _dssp(simplified=True):
    codes = ["H", "E", "C", "NA"] if simplified else [" ", "B", "E", "G", "H", "I", "S",
                                                       "T", "NA"]
    return np.random.default_rng(1).choice(codes, size=(60, 9))


DATA_CASES = {
    "get_histogram": lambda P: P.get_histogram(*_xy()[:2], bins=15),
    "get_histogram_edges": lambda P: P.get_histogram(
        *_xy()[:2], bins=12, weights=_xy()[2], avoid_zero_count=True, transpose=True,
        return_edges=True),
    "get_density": lambda P: P.get_density(*_xy()[:2], bins=10, transpose=True),
    "to_density": lambda P: P.to_density(np.arange(12.0).reshape(3, 4)),
    "to_free_energy": lambda P: P.to_free_energy(
        P.to_density(np.arange(12.0).reshape(3, 4)), kT=2.5, minener_zero=True),
    "get_free_energy": lambda P: P.get_free_energy(*_xy()[:2], bins=20,
                                                   avoid_zero_count=True),
    "dssp_fractions": lambda P: P.dssp_fractions(_dssp()),
    "digitize_dssp": lambda P: P.digitize_dssp(np.stack(_xy()[:2], 1)[:60], _dssp(), bins=8),
    "digitize_dssp_frames": lambda P: P.digitize_dssp(np.stack(_xy()[:2], 1)[:60],
                                                      _dssp(False), imshow=False),
    "dssp_to_text": lambda P: [P.dssp_to_text(c) for c in " BEGHIST"]
    + [P.dssp_to_text(c, simplified=True) for c in "CEH"],
    "dssp_to_rgb": lambda P: [P.dssp_to_rgb(c) for c in " BEGHIST"]
    + [P.dssp_to_rgb(c, simplified=True) for c in "CEH"],
    "hex_to_rgba": lambda P: [P.hex_to_rgba("#1f77b4"), P.hex_to_rgba("ff7f0e", 0.3)],
    "pdists_euclid": lambda P: P.plotting._subsampled_pdists(
        np.random.default_rng(2).normal(size=(50, 4)), float("inf")),
    "pdists_periodic": lambda P: P.plotting._subsampled_pdists(
        np.random.default_rng(2).uniform(-3, 3, (120, 3)), 2 * np.pi, max_frames=40),
}


@pytest.mark.parametrize("case", DATA_CASES)
def test_data_functions_match_jax(case):
    import encodermap_tpu.plot.plotting  # noqa: F401
    import encodermap_tpu_torch.plot.plotting  # noqa: F401

    got, ref = DATA_CASES[case](PT), DATA_CASES[case](PJ)
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


# ---------------------------------------------------------- figure functions
def _artists(obj):
    """What a figure function drew: per axes of its figure, the counts of
    lines, collections, patches, texts and images, and the labels."""
    import matplotlib.pyplot as plt

    if isinstance(obj, tuple):
        obj = obj[0]
    fig = obj.figure if hasattr(obj, "figure") else obj
    out = [(len(ax.lines), len(ax.collections), len(ax.patches), len(ax.texts),
            len(ax.images), ax.get_xlabel(), ax.get_ylabel(), ax.get_title())
           for ax in fig.axes]
    plt.close(fig)
    return out


@pytest.fixture(scope="module")
def protein(tmp_path_factory):
    """A 6-residue synthetic protein, 40 frames, as PDB + DCD, loaded by
    both packages."""
    from chip_smoke import synthetic_protein
    from encodermap_tpu_torch.data.formats import write_dcd
    from encodermap_tpu_torch.data.pdb import write_pdb

    d = tmp_path_factory.mktemp("protein")
    top, xyz = synthetic_protein("MKHAEL", 40, seed=0)
    write_pdb(d / "p.pdb", top, xyz[:1])
    write_dcd(d / "p.dcd", xyz)
    return d, emt.load(str(d / "p.dcd"), str(d / "p.pdb")), \
        emj.load(str(d / "p.dcd"), str(d / "p.pdb"))


def _lowd():
    return np.random.default_rng(3).normal(size=(200, 2))


FIGURES = {
    "free_energy": lambda P, t, kw: P.plot_free_energy(_lowd(), bins=20),
    "free_energy_xy": lambda P, t, kw: P.plot_free_energy(*_lowd().T, cbar=False),
    "ramachandran": lambda P, t, kw: P.plot_ramachandran(
        np.random.default_rng(0).uniform(-3, 3, (30, 5)),
        np.random.default_rng(1).uniform(-3, 3, (30, 5)), subsample=2),
    "ramachandran_degrees": lambda P, t, kw: P.plot_ramachandran(
        np.random.default_rng(0).uniform(-170, 170, (2, 30, 5))),
    "ramachandran_traj": lambda P, t, kw: P.plot_ramachandran(t, **kw),
    "distance_histogram": lambda P, t, kw: P.distance_histogram(
        np.random.default_rng(0).normal(size=(80, 5)), float("inf"), (4.5, 12, 6, 1, 2, 6)),
    "latent_scatter": lambda P, t, kw: P.plot_latent_scatter(
        _lowd(), colors=np.arange(200) % 3),
    "trajs_by_parameter": lambda P, t, kw: P.plot_trajs_by_parameter(_lowd(), _lowd()[:, 0]),
    "dssp": lambda P, t, kw: P.plot_dssp(t, residue_subsample=3, **kw),
    "dssp_full": lambda P, t, kw: P.plot_dssp(t, simplified=False, subsample=4, **kw),
    "ball_and_stick": lambda P, t, kw: P.plot_ball_and_stick(t, frame=3),
    "ball_and_stick_bonds": lambda P, t, kw: P.plot_ball_and_stick(t, highlight="bonds"),
    "ball_and_stick_angles": lambda P, t, kw: P.plot_ball_and_stick(t, highlight="angles"),
    "ball_and_stick_dihedrals": lambda P, t, kw: P.plot_ball_and_stick(
        t, highlight="dihedrals"),
    "ball_and_stick_indices": lambda P, t, kw: P.plot_ball_and_stick(t, highlight=[0, 1, 2]),
    "raw_data": lambda P, t, kw: P.plot_raw_data(_lowd()[:50], labels=["a", "b"]),
    "end2end": lambda P, t, kw: P.plot_end2end(t, subsample=2, rolling_avg_window=3),
    "interactive_histogram": lambda P, t, kw: _slider_figure(
        P.distance_histogram_interactive(np.random.default_rng(0).normal(size=(60, 3)),
                                         float("inf")).show()),
    "path_visualization": lambda P, t, kw: P.interactive_path_visualization(
        t, _lowd(), _lowd()[:40])._figure,
}


def _slider_figure(sliders):
    return next(iter(sliders.values())).ax.figure


@pytest.mark.parametrize("case", FIGURES)
def test_figures_draw_the_same_artists(case, protein):
    _, tt, tj = protein
    got = _artists(FIGURES[case](PT, tt, {"device": "cpu"}))
    assert got == _artists(FIGURES[case](PJ, tj, {}))


def test_saved_figures_animation_and_vmd_script(tmp_path, protein):
    d, tt, tj = protein
    for name, P in (("torch", PT), ("jax", PJ)):
        assert P.plot_free_energy(_lowd(), save_path=tmp_path / f"fe_{name}.png") == \
            str(tmp_path / f"fe_{name}.png")
        P.animate_lowd_trajectory(_lowd()[:12], tmp_path / f"anim_{name}.gif", bins=10)
        P.render_vmd(d / "p.pdb", rotation=(10, 0, 5), script_location=tmp_path / f"{name}.tcl",
                     image_location=tmp_path / "img", drawframes=True, surf="quicksurf",
                     script_only=True)
    assert (tmp_path / "torch.tcl").read_text() == (tmp_path / "jax.tcl").read_text()
    from PIL import Image

    for stem in ("fe", "anim"):
        ext = "png" if stem == "fe" else "gif"
        sizes = {Image.open(tmp_path / f"{stem}_{n}.{ext}").size for n in ("torch", "jax")}
        assert len(sizes) == 1


def test_plot_model_and_network_match_jax(tmp_path):
    from PIL import Image

    import encodermap_tpu.misc as MJ
    import encodermap_tpu_torch.misc as MT

    data = np.random.default_rng(0).random((64, 5)).astype(np.float32)
    kw = dict(n_neurons=[8, 8, 2], batch_size=8, periodicity=float("inf"))
    ej = emj.EncoderMap(emj.Parameters(main_path=str(tmp_path / "jax"), **kw), data)
    et = emt.EncoderMap(emt.Parameters(main_path=str(tmp_path / "torch"), **kw), data,
                        device="cpu")
    assert Path(et.plot_network()).name == Path(ej.plot_network()).name == "network.png"
    got, ref = (Image.open(tmp_path / n / "network.png").size for n in ("torch", "jax"))
    assert got == ref
    seq_t = emt.SequentialModel(5, emt.Parameters(**kw), device="cpu")
    seq_j = emj.models.SequentialModel(5, emj.Parameters(**kw))
    assert Image.open(MT.plot_model(seq_t, input_dim=5)).size == \
        Image.open(MJ.plot_model(seq_j, input_dim=5)).size
    assert MT.plot_model(et) == str(tmp_path / "torch" / "network.png")


# -------------------------------------------- interactive plotting, dashboard
@pytest.fixture(scope="module")
def session_pair(protein, tmp_path_factory):
    """The JAX EncoderMap trained 20 steps on the protein's first ten atoms'
    coordinates, the port loaded from its checkpoint, and both packages'
    trajectories."""
    d, tt, tj = protein
    run = tmp_path_factory.mktemp("model")
    highd = tj.xyz[:, :10].reshape(len(tj.xyz), -1).astype(np.float32)
    kw = dict(n_neurons=[16, 16, 2], batch_size=16, steps_per_scan=10, n_steps=20, seed=0,
              periodicity=float("inf"))
    ej = emj.EncoderMap(emj.Parameters(main_path=str(run / "jax"), **kw), highd)
    ej.train()
    et = emt.EncoderMap.from_checkpoint(run / "jax", train_data=highd, device="cpu")
    et.p.main_path = str(run / "torch")
    ej.p.main_path = str(run / "jax_out")
    return highd, (et, tt), (ej, tj)


def _polygon(latent):
    lo, hi = np.percentile(latent, [20, 70], axis=0)
    return [(lo[0], lo[1]), (hi[0], lo[1]), ((lo[0] + hi[0]) / 2, hi[1])]


def test_interactive_plotting_matches_jax(session_pair):
    highd, (et, tt), (ej, tj) = session_pair
    st = PT.InteractivePlotting(et, tt, highd_data=highd)
    sj = PJ.InteractivePlotting(ej, tj, highd_data=highd)
    np.testing.assert_allclose(st.latent, sj.latent, atol=1e-5)
    poly = _polygon(sj.latent)
    np.testing.assert_array_equal(st.select(poly), sj.select(poly))
    assert 0 < len(sj.selection) < len(highd)
    box = (*np.percentile(sj.latent, 10, axis=0), *np.percentile(sj.latent, 60, axis=0))
    np.testing.assert_array_equal(st.select_rectangle(*box), sj.select_rectangle(*box))
    ct, cj = st.cluster("c"), sj.cluster("c")
    assert ct.keys() == cj.keys() and ct["n_frames"] == cj["n_frames"]
    assert ct["centroid_frame"] == cj["centroid_frame"]
    for key in ("png", "csv", "indices_npy", "lowd_npy", "pdb", "readme"):
        assert Path(ct[key]).name == Path(cj[key]).name
    assert Path(ct["csv"]).read_text() == Path(cj["csv"]).read_text()
    assert "torch " in Path(ct["readme"]).read_text()
    for mode in ("linear", "bezier"):
        np.testing.assert_allclose(st.path(poly, n=7, mode=mode), sj.path(poly, n=7, mode=mode),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="2 control points"):
        st.path(poly[:1])
    lowd_only = PT.InteractivePlotting(lowd_data=sj.latent, highd_data=highd)
    with pytest.raises(RuntimeError, match="autoencoder"):
        lowd_only.generate(poly)
    with pytest.raises(AssertionError):
        PT.InteractivePlotting(lowd_data=sj.latent)


def test_distance_histogram_interactive_applies_like_jax():
    data = np.random.default_rng(0).normal(size=(60, 3))
    ht = PT.distance_histogram_interactive(data, float("inf"))
    hj = PJ.distance_histogram_interactive(data, float("inf"))
    np.testing.assert_array_equal(ht.distances, hj.distances)
    for a, b in zip(ht.update(sig_h=3.0, b_l=4), hj.update(sig_h=3.0, b_l=4)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    pt, pj = emt.ADCParameters(), emj.ADCParameters()
    ht.apply(pt)
    hj.apply(pj)
    assert tuple(pt.cartesian_dist_sig_parameters) == tuple(pj.cartesian_dist_sig_parameters)
    ht.apply(pt, attribute="dist_sig_parameters")
    assert tuple(pt.dist_sig_parameters) == ht.params


def test_dashboard_pages_match_jax(session_pair, protein, tmp_path):
    d, _, _ = protein
    highd, (et, _), (ej, _) = session_pair
    out = {}
    for name, P, e in (("torch", PT, et), ("jax", PJ, ej)):
        sess = P.DashboardSession(e, data=highd, main_path=str(tmp_path / name))
        pages = {cls.name: cls(sess) for cls in (P.HomePage, P.UploadPage, P.TrajPage,
                                                  P.TopPage, P.ProjectionPage)}
        status = pages["home"].status()
        msg = pages["upload"].load_trajs([str(d / "p.dcd")], [str(d / "p.pdb")])
        rows = pages["traj"].table_rows()
        lasso = _polygon(pages["projection"].session.interactive.latent)
        n_sel = pages["projection"].select_lasso(
            {"x": [p[0] for p in lasso], "y": [p[1] for p in lasso]})
        cluster = pages["projection"].write_cluster("dash_1")
        path = pages["projection"].generate_path(lasso, n=5)
        out[name] = dict(
            status={k: v for k, v in status.items() if k != "main_path"}, msg=msg, rows=rows,
            options=pages["top"].options(), top=pages["top"].describe_top(0),
            stale=pages["top"].describe_top(5), n_sel=n_sel,
            cluster=cluster.replace(str(tmp_path / name), ""),
            path=path.replace(str(tmp_path / name), ""),
            files=sorted(str(p.relative_to(tmp_path / name))
                         for p in (tmp_path / name).rglob("*") if p.is_file()),
            figure=pages["projection"].figure_data())
    ft, fj = out["torch"].pop("figure"), out["jax"].pop("figure")
    np.testing.assert_allclose(ft["x"], fj["x"], atol=1e-5)
    np.testing.assert_allclose(np.load(tmp_path / "torch" / "generated" / "path_linear_5.npy"),
                               np.load(tmp_path / "jax" / "generated" / "path_linear_5.npy"),
                               atol=1e-5)
    # the cluster dicts' reprs name the same files; the README differs in its
    # time stamp and versions only
    assert out["torch"] == out["jax"]
    assert out["torch"]["status"]["trained_steps"] == 20
    with pytest.raises(ImportError, match="dash"):
        PT.Dashboard(et)


# ------------------------------------------------------- optional packages
HIDDEN = """
import sys
for name in ("matplotlib", "tensorboard", "tensorflow", "dash", "ipywidgets", "IPython"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
import encodermap_tpu_torch as em
import encodermap_tpu_torch.plot as P
from encodermap_tpu_torch.misc.summaries import image_summary
data, _ = em.create_n_cube(3, points_along_edge=10, seed=0)
p = em.Parameters(main_path=sys.argv[1], n_neurons=[8, 8, 2], batch_size=16,
                  steps_per_scan=5, n_steps=10, summary_step=5, tensorboard=True,
                  periodicity=float("inf"))
em.EncoderMap(p, data, device="cpu").train()
assert P.get_histogram(*np.random.default_rng(0).random((2, 50)), bins=5)[2].sum() == 50
try:
    image_summary(np.zeros((4, 2)), 1, sys.argv[1])
except ImportError:
    print("image_summary needs matplotlib")
"""


def test_import_and_tensorboard_training_without_optional_packages(tmp_path):
    out = subprocess.run([sys.executable, "-c", HIDDEN, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "image_summary needs matplotlib" in out.stdout
    assert len(list((tmp_path / "train").glob("events.out.tfevents.*"))) == 1
    assert (tmp_path / "complete_model_summary.txt").is_file()
