# encodermap_tpu_torch/train/adc_autoencoder.py
"""AngleDihedralCartesianEncoderMap: training on internal coordinates with
backmapping inside the step.

Counterpart of ``encodermap_tpu/train/adc_autoencoder.py`` (after the
reference's ``autoencoder/autoencoder.py:1403-2576``): the CVs
(central_angles, central_dihedrals, central_cartesians, central_distances
[, side_dihedrals]) from a dict, a ``dataset=`` tuple or any object with a
``.CVs`` mapping; the loss stack of ``models.py:2260-2459`` with the
soft-started Cartesian cost; ``train_for_references``; the clash and RMSD
tracking; ``encode`` / ``decode`` / ``generate(backend="scan")`` / ``save``
/ ``from_checkpoint``, with checkpoints that load in both packages.

Two further modes. ``reconstruct_sidechains=True`` trains on seven CVs
(central_angles, central_dihedrals, all_cartesians, central_distances,
side_angles, side_dihedrals, side_distances) with ``p.sidechain_info``
(residue -> sidechain dihedrals) and backmaps every atom inside the step.
``multimer_training="homogeneous_transformation"`` with
``p.multimer_lengths`` rebuilds each protein and places the others by
decoded 4x4 transforms.

The Cartesian costs take one of three routes by the selected-atom count,
with the JAX package's TPU-measured thresholds (kept for parity until the
H100's are measured): dense ``(B, n, n)`` matrices below
``MIN_ANALYTIC_ATOMS`` (the flat CA pairs feed the sigmoid below 64 atoms,
the matrix rows from 64), the hand-written backward of
``ops/cartesian_analytic.py`` up to ``MIN_BLOCKED_ATOMS``, the row blocks of
``ops/blocked_cartesian.py`` from there. On the card the sketch-map losses
of the encoder input and of the flat or matrix CA pairs run on the
sigmoid-loss kernels: twice forward and twice backward per step.

``generate`` onto a topology (``backend="topology"``, ``"mdtraj"``,
``"mdanalysis"``) rotates a real structure's bonds into the decoded
dihedrals (``misc/backmapping_offline.py``), on the trainer's device.

Out-of-core training: ``train_streaming`` takes a batch source of CV
superbatches or the path of an HDF5 file (a flat ``CVs/`` group or an
ensemble file written by ``TrajEnsemble.save``), and ``from_ensemble_h5``
builds a model from a few frames of such a file, so the CVs never live in
memory whole. With ``p.mesh_shape={"dp": N}`` each rank runs the per-row
forward (encoder, decoder, backmapping) on its share of the batch and the
losses see every rank's rows (``Autoencoder._gather_rows``), as in
``train/autoencoder.py``; with a ``tp`` axis too, a state passed through
``parallel.shard_params_tp`` runs its MLP tensor-parallel (the densifiers
stay replicated) and the MeanAngles batch mean is gathered over ``dp``
only.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from .. import losses as L
from ..models import adc
from ..misc.profiling import span
from ..ops.backmap import backmap as backmap_op
from ..ops.backmap import backmap_multimer
from ..ops.backmap_sidechains import backmap_sidechains_fast, make_spec
from ..ops.blocked_cartesian import MIN_BLOCKED_ATOMS
from ..ops.cartesian_analytic import MIN_ANALYTIC_ATOMS
from ..ops.distances import pairwise_dist
from ..ops.kabsch import rmsd as rmsd_op
from ..parameters import ADCParameters
from .autoencoder import Autoencoder
from .core import tree_map

__all__ = ["AngleDihedralCartesianEncoderMap"]

CV_ORDER = ("central_angles", "central_dihedrals", "central_cartesians",
            "central_distances", "side_dihedrals")

#: selected-atom count from which the CA-pair sigmoid takes the matrix
#: rows instead of the flat pairs (the JAX package's choice)
MIN_MATRIX_ATOMS = 64

#: rows per call of encode(), as in the JAX package
ENCODE_CHUNK = 8192


SIDECHAIN_CVS = ("central_angles", "central_dihedrals", "all_cartesians",
                 "central_distances", "side_angles", "side_dihedrals",
                 "side_distances")


def _needed_cv_names(p: ADCParameters) -> list[str]:
    """The CV names this parameter set trains on, in model input order."""
    if p.reconstruct_sidechains:
        return list(SIDECHAIN_CVS)
    return list(CV_ORDER[:4]) + (["side_dihedrals"] if p.use_sidechains else [])


def _extract_cvs(trajs: Any, p: ADCParameters) -> tuple[np.ndarray, ...]:
    """The CV arrays, in model input order, of a mapping or of any object
    with a ``.CVs`` mapping."""
    if isinstance(trajs, Mapping):
        cvs = trajs
    elif hasattr(trajs, "CVs"):
        cvs = trajs.CVs
    else:
        raise TypeError(f"Expected a dict of CV arrays or an object with .CVs, "
                        f"got {type(trajs)}")
    needed = _needed_cv_names(p)
    missing = [k for k in needed if k not in cvs]
    if missing:
        raise ValueError(f"CVs {missing} not found; provide them in the dict")
    out = []
    for k in needed:
        arr = np.asarray(cvs[k], np.float32)
        if k in ("central_cartesians", "all_cartesians") and arr.ndim == 2:
            arr = arr.reshape(len(arr), -1, 3)
        out.append(arr)
    return tuple(out)


class AngleDihedralCartesianEncoderMap(Autoencoder):
    """Train on backbone internal coordinates; generate conformations by
    decoding and backmapping.

    Args:
        trajs: a :class:`TrajEnsemble` (or any object with ``.CVs``) or a
            dict of CV arrays.
        parameters: :class:`ADCParameters` (defaults if None).
        model_params: initial parameters (numpy arrays or tensors), e.g. a
            JAX model's, carried over with ``convert.params_from_numpy``.
        read_only: write nothing to ``main_path``.
        dataset: the CV tuple itself, in place of ``trajs``.
        learning_rate_schedule: callable ``step -> lr``.
        device: where to train; None means ``"cuda"`` and raises without a
            card (pass ``device="cpu"`` to train on the CPU).
    """

    _metrics_only = ("cartesian_cost_scale",)

    def __init__(self, trajs: Any = None,
                 parameters: Optional[ADCParameters] = None,
                 model_params: Optional[dict] = None, read_only: bool = False,
                 dataset: Optional[tuple] = None,
                 learning_rate_schedule=None, device: Any = None) -> None:
        p = parameters if parameters is not None else ADCParameters()
        if p.multimer_training is not None and p.reconstruct_sidechains:
            # before the CVs: the reconstruct path would ask for 7 of them
            raise ValueError("multimer training and reconstruct_sidechains are "
                             "mutually exclusive (reference models.py:1108-1111)")
        self._init_run(p, "functional", read_only, learning_rate_schedule, device)
        self.trajs = trajs
        if dataset is not None:
            self.train_data = tuple(np.asarray(d, np.float32) for d in dataset)
        else:
            self.train_data = _extract_cvs(trajs, self.p)
        if self.p.reconstruct_sidechains:
            self.shapes = adc.ADCSidechainShapes.from_data(*self.train_data)
            info = self.p.sidechain_info
            if info is None and hasattr(trajs, "trajs"):
                info = trajs.trajs[0].top.sidechain_info()
                self.p.sidechain_info = info
            if info is None:
                raise ValueError(
                    "reconstruct_sidechains=True needs p.sidechain_info "
                    "(residue -> n sidechain dihedrals) or a TrajEnsemble "
                    "with topologies")
            self.sidechain_spec = make_spec({int(k): int(v) for k, v in info.items()})
        else:
            side = self.train_data[4] if len(self.train_data) == 5 else None
            self.shapes = adc.ADCShapes.from_data(*self.train_data[:4], side)
        # NaNs mark values missing after a mixed-topology alignment: the
        # masked-dense "sparse" mode with per-input densifiers
        # (reference autoencoder.py:796-800)
        self.sparse = any(np.isnan(a).any() for a in self.train_data)
        if self.p.multimer_training is not None:
            adc.validate_multimer(self.p, self.shapes, sparse=self.sparse)
        if self.sparse and self.p.reconstruct_sidechains:
            raise ValueError(
                "reconstruct_sidechains=True does not support NaN-padded "
                "(mixed-topology sparse) CVs: the sidechain model has no "
                "densifier layers. Train per-topology, or drop "
                "reconstruct_sidechains.")
        self._init_state(model_params, lambda gen: (
            adc.init_sidechain_params(gen, self.p, self.shapes)
            if self.p.reconstruct_sidechains else
            adc.init_params(gen, self.p, self.shapes, sparse=self.sparse)))

    @classmethod
    def _parameters_class(cls):
        return ADCParameters

    @classmethod
    def from_ensemble_h5(cls, path: Union[str, Path],
                         parameters: Optional[ADCParameters] = None,
                         prototype_frames: int = 4, **kwargs: Any
                         ) -> "AngleDihedralCartesianEncoderMap":
        """A model whose input shapes come from an on-disk ensemble HDF5
        file (written by ``TrajEnsemble.save``) without loading its CVs:
        only ``prototype_frames`` frames of each member trajectory are read,
        for the shapes and the sparse-mode test
        (``encodermap_tpu/train/adc_autoencoder.py:937-960``). Pair it with
        ``train_streaming(path)``. Needs ``h5py``."""
        from .core import HDF5BatchSource

        p = parameters if parameters is not None else ADCParameters()
        src = HDF5BatchSource(path, _needed_cv_names(p), batch_size=prototype_frames,
                              steps_per_scan=1, seed=0)
        try:
            proto = src.read_prototype(prototype_frames)
        finally:
            src.close()
        return cls(parameters=p, dataset=proto, **kwargs)

    # ---------------------------------------------------------------- losses
    def _loss_terms(self, params: dict, batch: tuple, step: int = 0) -> dict:
        """The reference's loss assembly (``models.py:2260-2459``)."""
        return self._loss_and_aux(params, batch, step)[0]

    def _loss_and_aux(self, params: dict, batch: tuple, step: int
                      ) -> tuple[dict, tuple]:
        """Loss terms, and ``(back_cartesians, input_cartesians)`` for the
        clash and RMSD tracking."""
        p = self.p
        if p.reconstruct_sidechains:
            return self._loss_terms_sidechains(params, batch, step)
        if self.sparse:
            dens_params = params
            if not p.trainable_dense_to_sparse:
                dens_params = dict(params, densifiers=tree_map(
                    torch.Tensor.detach, params["densifiers"]))
            batch = adc.densify_inputs(dens_params, batch)
        inp_side = batch[4] if len(batch) == 5 else None
        gather = (lambda x: self._gather_rows(x)[0]) if self._dp is not None else None
        out_angles, out_dihedrals, out_side, back, _, _, latent = adc.forward(
            params, p, batch, self.shapes, with_pairs=False, gather=gather)
        with span("adc.losses"):
            # the losses see the global batch
            (inp_angles, inp_dihedrals, inp_cartesians, out_angles, out_dihedrals, back,
             latent, inp_side, out_side) = self._gather_some(
                *batch[:3], out_angles, out_dihedrals, back, latent, inp_side, out_side)

            # the distance and center costs see the raw trained groups
            # (loss_functions.py:279-281)
            groups = [inp_angles, inp_dihedrals] if p.use_backbone_angles \
                else [inp_dihedrals]
            if p.use_sidechains:
                groups.append(inp_side)
            enc_inp = torch.cat(groups, dim=1) if len(groups) > 1 else groups[0]

            scale = L.soft_start_scale(p, step, device=latent.device)
            cart_loss, cdist_loss = self._cartesian_terms(
                adc._ca_slice(p, inp_cartesians), adc._ca_slice(p, back), latent, scale)
            terms = {
                "dihedral_loss": L.dihedral_loss(inp_dihedrals, out_dihedrals, p),
                "angle_loss": L.angle_loss(inp_angles, out_angles, p),
                "cartesian_loss": cart_loss,
                "distance_loss": L.distance_loss(enc_inp, latent, p),
                "cartesian_distance_loss": cdist_loss,
                "center_loss": L.center_loss(latent, p),
                "regularization_loss": L.regularization_loss(
                    adc.regularization_sum(params), p),
            }
            if p.use_sidechains:
                terms["side_dihedral_loss"] = L.side_dihedral_loss(inp_side,
                                                                   out_side, p)
            terms["cartesian_cost_scale"] = scale
        return terms, (back, inp_cartesians)

    def _cartesian_terms(self, inp_sel: torch.Tensor, out_sel: torch.Tensor,
                         latent: torch.Tensor, scale: torch.Tensor) -> tuple:
        """The Cartesian and Cartesian-distance costs of the selected atoms,
        by the route their count takes."""
        p = self.p
        n_sel = inp_sel.shape[1]
        if n_sel >= MIN_BLOCKED_ATOMS:
            return L.cartesian_losses_blocked(inp_sel, out_sel, latent, p, scale=scale)
        if n_sel >= MIN_ANALYTIC_ATOMS:
            return L.cartesian_losses_analytic(inp_sel, out_sel, latent, p, scale=scale)
        inp_mat = pairwise_dist(inp_sel)
        cart_loss = L.cartesian_loss_matrix(inp_mat, pairwise_dist(out_sel), p,
                                            scale=scale)
        cdist_loss = (
            L.cartesian_distance_loss_matrix(inp_mat, latent, p)
            if n_sel >= MIN_MATRIX_ATOMS else
            L.cartesian_distance_loss(pairwise_dist(inp_sel, flat=True), latent, p))
        return cart_loss, cdist_loss

    def _loss_terms_sidechains(self, params: dict, batch: tuple, step: int
                               ) -> tuple[dict, tuple]:
        """The reconstruct mode's terms (reference ``models.py:2306-2459``):
        the side angles join the angle cost, and the sketch-map cost sees
        all four encoder inputs, the JAX package's recorded divergence (the
        reference truncates them to three, ``loss_functions.py:279-281``)."""
        p = self.p
        out_ca, out_cdi, out_sa, out_sdi, back, _, _, latent = adc.forward_sidechains(
            params, p, batch, self.shapes, self.sidechain_spec, with_pairs=False)
        with span("adc.losses"):
            # the losses see the global batch
            (inp_ca, inp_cdi, inp_all_cart, inp_sa, inp_sdi, out_ca, out_cdi, out_sa,
             out_sdi, back, latent) = self._gather_some(
                *batch[:3], *batch[4:6], out_ca, out_cdi, out_sa, out_sdi, back, latent)
            enc_inp = torch.cat([inp_ca, inp_cdi, inp_sa, inp_sdi], dim=1)
            scale = L.soft_start_scale(p, step, device=latent.device)
            idx = torch.as_tensor(adc.sidechain_pwd_indices(p, self.sidechain_spec),
                                  device=latent.device)
            cart_loss, cdist_loss = self._cartesian_terms(inp_all_cart[:, idx], back[:, idx],
                                                          latent, scale)
            terms = {
                "dihedral_loss": L.dihedral_loss(inp_cdi, out_cdi, p),
                "angle_loss": L.angle_loss(inp_ca, out_ca, p) + L.angle_loss(inp_sa, out_sa, p),
                "side_dihedral_loss": L.side_dihedral_loss(inp_sdi, out_sdi, p),
                "cartesian_loss": cart_loss,
                "distance_loss": L.distance_loss(enc_inp, latent, p),
                "cartesian_distance_loss": cdist_loss,
                "center_loss": L.center_loss(latent, p),
                "regularization_loss": L.regularization_loss(adc.regularization_sum(params), p),
                "cartesian_cost_scale": scale,
            }
        return terms, (back, inp_all_cart)

    def _gather_some(self, *xs: Optional[torch.Tensor]) -> tuple:
        """:meth:`_gather_rows` of the tensors among ``xs``; None stays."""
        got = iter(self._gather_rows(*(x for x in xs if x is not None)))
        return tuple(None if x is None else next(got) for x in xs)

    def _metric_io(self, params: dict, batch: tuple) -> tuple:
        """``(y_true, y_pred)`` for metric objects: the (densified) input
        tuple and ``(out_angles, out_dihedrals, back_cartesians, inp_pair,
        out_pair[, out_side])``, the coordinates at index 2; in reconstruct
        mode ``(out_central_angles, out_central_dihedrals, back_cartesians,
        out_side_angles, out_side_dihedrals, inp_pair, out_pair)``."""
        if self.p.reconstruct_sidechains:
            out_ca, out_cdi, out_sa, out_sdi, back, inp_pair, out_pair, _ = \
                adc.forward_sidechains(params, self.p, batch, self.shapes,
                                       self.sidechain_spec)
            return batch, (out_ca, out_cdi, back, out_sa, out_sdi, inp_pair, out_pair)
        if self.sparse:
            batch = adc.densify_inputs(params, batch)
        out_angles, out_dihedrals, out_side, back, inp_pair, out_pair, _ = \
            adc.forward(params, self.p, batch, self.shapes)
        y_pred = (out_angles, out_dihedrals, back, inp_pair, out_pair)
        return batch, y_pred if out_side is None else y_pred + (out_side,)

    def _aux_metric_terms(self, aux: tuple, batch: tuple) -> dict:
        """Clash count and RMSD (``callbacks/metrics.py:470-581``) from the
        loss forward's backmapped coordinates, when tracked."""
        out = {}
        back, target = aux
        if self.p.track_clashes:
            # nm coordinates: a clash is a pair closer than 0.1 nm
            d = pairwise_dist(back, flat=True)
            out["clashes"] = torch.mean(torch.sum(d < 0.1, dim=-1).to(torch.float32))
        if self.p.track_RMSD:
            out["rmsd"] = torch.mean(rmsd_op(back, target))
        return out

    # -------------------------------------------------------------- training
    def _device_data(self) -> tuple:
        # NaNs stay: the densifiers zero-fill them inside the step
        return tuple(torch.as_tensor(d, dtype=torch.float32, device=self.device)
                     for d in self.train_data)

    def train_streaming(self, source: Any, n_steps: Optional[int] = None) -> dict:
        """Out-of-core ADC training from a host superbatch source (tuples of
        the 5 or 7 CV stacks, ``(steps, B, ...)`` each), the reference's
        HDF5-generator streaming (``info_all.py:3080-3154``;
        ``encodermap_tpu/train/adc_autoencoder.py:477-515``).

        ``source`` may be the path of an HDF5 file, a flat ``CVs/`` group
        or an ensemble file written by ``TrajEnsemble.save``: batches are
        then sampled from disk (``HDF5BatchSource``, seeded by ``p.seed``)
        and the CVs never live in memory whole::

            trajs.load_CVs("all", ensemble=True); trajs.save("ens.h5")
            emap = AngleDihedralCartesianEncoderMap.from_ensemble_h5("ens.h5", p)
            emap.train_streaming("ens.h5")
        """
        from .core import HDF5BatchSource, run_streaming

        owned = None
        if isinstance(source, (str, Path)):
            source = owned = HDF5BatchSource(
                source, _needed_cv_names(self.p), self.p.batch_size,
                self.p.steps_per_scan,
                seed=self.p.seed if self.p.seed is not None else 0)
        n = self._streaming_budget(n_steps)
        if n <= 0:
            if owned is not None:
                owned.close()
            return self.history
        try:
            history = run_streaming(self, source, n, sharding=self._streaming_sharding())
        finally:
            if owned is not None:
                owned.close()
        return self._finish_streaming(history)

    def set_train_data(self, trajs: Any) -> None:
        """Replace the training data by a CV dict, tuple or ``.CVs`` object
        of the same widths (reference ``autoencoder.py:1973``)."""
        if isinstance(trajs, (tuple, list)):
            new = tuple(np.asarray(d, np.float32) for d in trajs)
        else:
            new = _extract_cvs(trajs, self.p)
        if len(new) != len(self.train_data):
            raise ValueError(f"new data has {len(new)} CV arrays, the model "
                             f"trains on {len(self.train_data)}")
        for name, old, arr in zip(_needed_cv_names(self.p), self.train_data, new):
            if old.shape[1:] != arr.shape[1:]:
                raise ValueError(f"new {name} shape {arr.shape[1:]} does not "
                                 f"match the model's {old.shape[1:]}")
        new_sparse = any(np.isnan(a).any() for a in new)
        if new_sparse and "densifiers" not in self.state.params:
            raise ValueError("the new data holds NaNs (sparse mode) but this "
                             "model was built dense (no densifiers); rebuild "
                             "it on the NaN-padded data")
        self.sparse = new_sparse
        if not isinstance(trajs, (tuple, list)):
            self.trajs = trajs
        self.train_data = new

    @staticmethod
    def get_train_data_from_trajs(trajs: Any, p: ADCParameters) -> tuple:
        """The CV tuple the model trains on (angles, dihedrals, cartesians,
        distances[, side_dihedrals ...]) from a ``TrajEnsemble``, CV dict or
        ``.CVs`` object (reference ``autoencoder.py:2032``)."""
        return _extract_cvs(trajs, p)

    def train_for_references(self, subsample: int = 100, maxiter: int = 500
                             ) -> dict[str, float]:
        """Set the angle, dihedral and Cartesian cost references to the
        costs of a model that always predicts the dataset mean (reference
        ``autoencoder.py:1816-1938``); batches drawn by numpy from the seed,
        as in the JAX package."""
        p_ref = ADCParameters(cartesian_cost_scale=1, angle_cost_scale=1,
                              dihedral_cost_scale=1)
        angles, dihedrals, cartesians, distances = self.train_data[:4]
        if self.p.reconstruct_sidechains:
            # the dummy model backmaps the central chain only, so the
            # reference normalizes on central_cartesians (autoencoder.py:1835)
            cvs = self.trajs if isinstance(self.trajs, Mapping) \
                else getattr(self.trajs, "CVs", None)
            if cvs is None or "central_cartesians" not in cvs:
                raise ValueError(
                    "train_for_references with reconstruct_sidechains needs the "
                    "'central_cartesians' CV (the reference normalizes on the "
                    "central chain, autoencoder.py:1835)")
            cartesians = np.asarray(cvs["central_cartesians"], np.float32)
            if cartesians.ndim == 2:
                cartesians = cartesians.reshape(len(cartesians), -1, 3)
        n = len(angles)
        nsteps = min(maxiter, max(1, n // self.p.batch_size))

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        # nanmean: sparse ensembles NaN-pad missing columns
        mean_angles = dev(np.nanmean(angles, 0, keepdims=True))
        mean_dihedrals = dev(np.nanmean(dihedrals, 0, keepdims=True))
        mean_lengths = dev(np.nanmean(distances, 0, keepdims=True))
        lengths = adc.multimer_lengths_list(self.p)
        with torch.no_grad():
            if lengths:
                # each protein rebuilt, the others at identity: the dummy
                # model predicts no transforms
                eye = torch.eye(4, device=self.device).expand(1, len(lengths) - 1, 4, 4)
                gen = backmap_multimer(lengths, mean_lengths, mean_angles,
                                       mean_dihedrals, eye)
            else:
                gen = backmap_op(mean_lengths, mean_angles, mean_dihedrals)
            gen_pd = adc.cartesian_pwd_slice(self.p, gen)
        rng = np.random.default_rng(self.p.seed if self.p.seed is not None else 0)
        acc = {"angle_cost": [], "dihedral_cost": [], "cartesian_cost": []}
        if self.sparse:
            # missing entries take the dataset mean, so they add zero cost
            stride = max(1, int(subsample))
            fills = [np.nanmean(x[::stride], 0)
                     for x in (angles, dihedrals, cartesians)]
        for _ in range(nsteps):
            idx = rng.integers(0, n, self.p.batch_size)
            batch = (angles[idx], dihedrals[idx], cartesians[idx])
            if self.sparse:
                batch = tuple(np.where(np.isnan(b), f, b)
                              for b, f in zip(batch, fills))
            b_ang, b_dih, b_cart = (dev(b) for b in batch)
            B = b_ang.shape[0]
            with torch.no_grad():
                acc["angle_cost"].append(float(L.angle_loss(
                    b_ang, mean_angles.expand(B, -1), p_ref)))
                acc["dihedral_cost"].append(float(L.dihedral_loss(
                    b_dih, mean_dihedrals.expand(B, -1), p_ref)))
                acc["cartesian_cost"].append(float(L.cartesian_loss(
                    adc.cartesian_pwd_slice(self.p, b_cart),
                    gen_pd.expand(B, -1), p_ref, scale=1.0)))
        means = {k: float(np.mean(v)) for k, v in acc.items()}
        print(f"After {nsteps} steps setting cost references: {means}.")
        self.p.angle_cost_reference = means["angle_cost"]
        self.p.dihedral_cost_reference = means["dihedral_cost"]
        self.p.cartesian_cost_reference = means["cartesian_cost"]
        if not self.read_only:
            self.p.save(Path(self.p.main_path) / "parameters.json")
        return means

    # ------------------------------------------------------------- inference
    def encode(self, data: Optional[Any] = None) -> np.ndarray:
        """Latent projection of ``(angles, dihedrals[, side_dihedrals])``,
        the full CV tuple, a CV dict, a stacked (angles | dihedrals | side)
        matrix, or the training CVs; ``ENCODE_CHUNK`` rows per call. A
        reconstruct model takes ``(central_angles, central_dihedrals,
        side_angles, side_dihedrals)`` or its seven CVs; a multimer model
        needs the coordinates, so the full CV tuple or a dict."""
        if data is None:
            data = self.train_data
        if isinstance(data, Mapping):
            data = _extract_cvs(data, self.p)
        if isinstance(data, np.ndarray):
            data = self._split_stacked(data)
        arrs = self._as_model_inputs(tuple(np.asarray(d, np.float32)
                                           for d in data))
        params = self.state.params
        outs = []
        with torch.no_grad():
            for i in range(0, max(len(arrs[0]), 1), ENCODE_CHUNK):
                chunk = tuple(torch.tensor(a[i:i + ENCODE_CHUNK], device=self.device)
                              for a in arrs)
                if self.p.reconstruct_sidechains:
                    latent = adc.encode_sidechains(params, self.p, chunk)
                else:
                    if self.sparse:
                        chunk = adc.densify_inputs(params, chunk)
                    latent = adc.encode(params, self.p, chunk)
                outs.append(latent.cpu().numpy())
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _as_model_inputs(self, arrs: tuple) -> tuple:
        """Place a user tuple in the model's input slots: the side
        dihedrals sit in slot 4, after cartesians and distances (slots 4
        and 5 with the side angles in reconstruct mode, of seven)."""
        full = 7 if self.p.reconstruct_sidechains else 5
        if self.p.multimer_training is not None and (
                len(arrs) != full or arrs[2].shape[1] == 0):
            raise ValueError(
                "multimer models build the encoder's pairwise-distance "
                "block from the input cartesians; encode() needs the full "
                "5-CV tuple (angles, dihedrals, cartesians, distances, "
                "side_dihedrals) or a CV dict with central_cartesians")
        if len(arrs) == full:
            return arrs
        z = np.zeros((len(arrs[0]), 0), np.float32)
        if self.p.reconstruct_sidechains:
            if len(arrs) == 4:
                ca, cdi, sa, sdi = arrs
                return ca, cdi, z, z, sa, sdi, z
            raise ValueError(
                f"encode() for reconstruct_sidechains models takes the 4-tuple "
                f"(central_angles, central_dihedrals, side_angles, "
                f"side_dihedrals) or the full 7-CV tuple; got {len(arrs)} arrays")
        if len(arrs) == 4:
            if self.p.use_sidechains:
                raise ValueError(
                    "this model trains on side_dihedrals: pass the 5-CV tuple "
                    "(angles, dihedrals, cartesians, distances, "
                    "side_dihedrals) or (angles, dihedrals, side_dihedrals)")
            return arrs + (z,)
        if len(arrs) == 3:
            return arrs[0], arrs[1], z, z, arrs[2]
        if len(arrs) == 2:
            if self.p.use_sidechains:
                raise ValueError("this model trains on side_dihedrals: pass "
                                 "(angles, dihedrals, side_dihedrals)")
            return arrs[0], arrs[1], z, z, z
        raise ValueError(f"encode() takes (angles, dihedrals[, "
                         f"side_dihedrals]) or the 5-CV tuple; got "
                         f"{len(arrs)} arrays")

    def _split_stacked(self, data: np.ndarray) -> tuple:
        """Split a stacked (angles | dihedrals | side) matrix by the model's
        widths; untrained angles get a zero placeholder."""
        if self.p.reconstruct_sidechains:
            raise ValueError("a reconstruct_sidechains model takes (central_angles, "
                             "central_dihedrals, side_angles, side_dihedrals), "
                             "not a stacked matrix")
        s = self.shapes
        cols = [s.n_angles] if self.p.use_backbone_angles else []
        cols.append(s.n_dihedrals)
        if self.p.use_sidechains:
            cols.append(s.n_side_dihedrals)
        if data.shape[1] != sum(cols):
            raise ValueError(f"stacked input has {data.shape[1]} columns, the "
                             f"model takes {sum(cols)} ({cols})")
        parts = list(np.split(data, np.cumsum(cols)[:-1], axis=1))
        if not self.p.use_backbone_angles:
            parts.insert(0, np.zeros((len(data), s.n_angles), np.float32))
        if self.p.use_sidechains:
            return parts[0], parts[1], parts[2]
        return parts[0], parts[1]

    def _mean_cv(self, i: int) -> torch.Tensor:
        # nanmean: sparse ensembles NaN-pad missing columns, and one NaN
        # bond length would reach every backmapped atom
        return torch.as_tensor(np.nanmean(self.train_data[i], 0, keepdims=True),
                               dtype=torch.float32, device=self.device)

    def decode(self, latent: np.ndarray) -> tuple:
        """Latent points to ``(angles, dihedrals[, side_dihedrals])``; the
        training set's mean angles stand in when angles are not trained
        (``autoencoder.py:2502``). A multimer model adds the ``(n, n_proteins
        - 1, 4, 4)`` transforms; a reconstruct model gives ``(central_angles,
        central_dihedrals, side_angles, side_dihedrals)``."""
        with torch.no_grad():
            z = torch.tensor(np.asarray(latent, np.float32), device=self.device)
            if self.p.reconstruct_sidechains:
                return tuple(x.cpu().numpy() for x in adc.decode_sidechains(
                    self.state.params, self.p, z, self.shapes))
            decoded = adc.decode(self.state.params, self.p, z, self.shapes)
            out_angles, out_dihedrals, out_side = decoded[:3]
            if out_angles is None:
                out_angles = self._mean_cv(0).expand(len(z), -1)
        outs = (out_angles.cpu().numpy(), out_dihedrals.cpu().numpy())
        if out_side is not None:
            outs += (out_side.cpu().numpy(),)
        return outs + tuple(x.cpu().numpy() for x in decoded[3:])

    def generate(self, points: np.ndarray, backend: str = "scan",
                 top: Any = None, progbar: Any = None) -> np.ndarray:
        """Decode latent points and backmap them to ``(n_points, n_atoms,
        3)`` coordinates.

        ``backend="scan"`` is the in-graph backmapping with the training
        set's mean bond lengths (and mean angles when angles are not
        trained): the mean central and side bond lengths and every atom in
        reconstruct mode, each protein placed by its decoded transform in
        multimer mode.

        ``backend="topology"`` rotates a real topology's central-chain
        bonds to the decoded central dihedrals (psi, omega, phi per
        residue); pass ``top`` as a :class:`SingleTraj`, whose first frame
        seeds the rotation. ``backend="mdtraj"`` and ``"mdanalysis"`` (the
        reference's names, ``autoencoder/autoencoder.py:2466-2571``) both
        run :func:`~encodermap_tpu_torch.misc.backmapping_offline.
        mdtraj_backmapping`, the decoded side dihedrals included, with the
        reference's ``top`` resolution (None → the ensemble's single
        topology, int → the ``top``-th trajectory, str → a topology file
        or a ``common_str`` of the ensemble); they return coordinates, not
        an mdtraj or MDAnalysis object. The topology backends give the
        full topology's atoms; their rotation sweep runs on this model's
        device.
        """
        del progbar  # the reference's signature
        if backend not in ("scan", "topology", "mdtraj", "mdanalysis"):
            raise TypeError(f"backend must be 'scan', 'topology', 'mdtraj' or "
                            f"'mdanalysis', but you provided {backend!r}")
        if backend in ("mdtraj", "mdanalysis"):
            return self._generate_mdtraj(points, backend, top)
        if backend == "topology":
            assert top is not None, 'backend="topology" needs a `top` traj'
            from ..misc.backmapping_offline import backmap_topology

            out_dihedrals = self.decode(np.asarray(points, np.float32))[1]
            t = top.top if hasattr(top, "top") else top
            chain = t.central_atom_indices()
            quads = np.stack([chain[:-3], chain[1:-2], chain[2:-1], chain[3:]],
                             axis=1)
            base = top.xyz[0] if hasattr(top, "xyz") else None
            return backmap_topology(t, base, out_dihedrals, dihedral_indices=quads,
                                    device=self.device)
        with torch.no_grad():
            z = torch.tensor(np.asarray(points, np.float32), device=self.device)
            lengths = self._mean_cv(3).expand(len(z), -1)
            if self.p.reconstruct_sidechains:
                out_ca, out_cdi, out_sa, out_sdi = adc.decode_sidechains(
                    self.state.params, self.p, z, self.shapes)
                return backmap_sidechains_fast(
                    self.sidechain_spec, lengths, out_ca, out_cdi,
                    self._mean_cv(6).expand(len(z), -1), out_sa, out_sdi).cpu().numpy()
            decoded = adc.decode(self.state.params, self.p, z, self.shapes)
            out_angles, out_dihedrals = decoded[:2]
            if out_angles is None:
                out_angles = self._mean_cv(0).expand(len(z), -1)
            if self.p.multimer_training is not None:
                return backmap_multimer(adc.multimer_lengths_list(self.p), lengths,
                                        out_angles, out_dihedrals,
                                        decoded[3]).cpu().numpy()
            return backmap_op(lengths, out_angles, out_dihedrals).cpu().numpy()

    def _generate_mdtraj(self, points: np.ndarray, backend: str, top: Any
                         ) -> np.ndarray:
        """The ``"mdtraj"`` / ``"mdanalysis"`` backends of :meth:`generate`."""
        from ..misc.backmapping_offline import mdtraj_backmapping

        trajs = getattr(self, "trajs", None)
        if trajs is not None and not hasattr(trajs, "top"):
            # a model built from a CV dict has no topology to rebuild
            trajs = None
        if trajs is None and top is None:
            raise ValueError(
                f"backend={backend!r} rebuilds against a real topology, but "
                "this model was constructed from CV arrays (no TrajEnsemble); "
                "pass `top` as a topology file path or a SingleTraj.")
        if top is None and trajs is not None and len(trajs.top) > 1:
            raise ValueError(
                f"The ensemble has {len(trajs.top)} topologies; pass `top` as "
                "an int (trajectory index), a topology file path, or one of "
                "the ensemble's common_str to pick which to rebuild.")
        if (isinstance(top, str) and trajs is not None
                and top in getattr(trajs, "common_str", ())):
            # the reference resolves common_str before file paths
            # (autoencoder.py:2546-2548): seed from that sub-ensemble
            trajs = trajs.trajs_by_common_str[top][0]
            top = None
        decoded = self.decode(np.asarray(points, np.float32))
        if len(decoded) == 2:
            dihedrals, side = decoded[1], None
        elif self.p.reconstruct_sidechains:
            # (central_angles, central_dihedrals, side_angles, side_dihedrals)
            dihedrals, side = decoded[1], decoded[3]
        else:
            dihedrals, side = decoded[1], decoded[2]
        return mdtraj_backmapping(top=top, dihedrals=dihedrals,
                                  sidechain_dihedrals=side, trajs=trajs,
                                  device=self.device)

    # ----------------------------------------------------------- persistence
    @classmethod
    def from_checkpoint(cls, trajs: Any, checkpoint_path: Union[str, Path],
                        use_previous_model: bool = False,
                        dataset: Optional[tuple] = None,
                        **kwargs: Any) -> "AngleDihedralCartesianEncoderMap":
        """Rebuild from a checkpoint directory or file written by either
        package; ``trajs`` or ``dataset`` give the CVs, ``kwargs`` go to the
        constructor (e.g. ``device``)."""
        ckpt_path = Path(checkpoint_path)
        p, model_params, opt_npz, step, _ = cls._load_checkpoint_checked(
            ckpt_path, use_previous_model)
        out = cls(trajs, parameters=p, model_params=model_params,
                  dataset=dataset, **kwargs)
        out._restore_checkpoint_state(step, opt_npz, ckpt_path)
        return out
