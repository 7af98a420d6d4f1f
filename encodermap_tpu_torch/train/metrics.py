# encodermap_tpu_torch/train/metrics.py
"""User-facing metric classes for ``add_metric``.

Counterpart of ``encodermap_tpu/train/metrics.py`` (after the reference's
``callbacks/metrics.py:250-581``). A metric implements
``update(y_true, y_pred) -> 0-d tensor``; ``emap.add_metric(MyMetric)``
logs it every step under ``"<ClassName> Metric"``. The trainer's
``_metric_io`` gives the pair, on the parameters just updated:

* EncoderMap family: ``y_true`` the (densified) batch, ``y_pred`` its
  reconstruction;
* ADC family: ``y_true`` the input tuple ``(angles, dihedrals, cartesians,
  distances[, side_dihedrals])`` and ``y_pred`` ``(out_angles,
  out_dihedrals, back_cartesians, inp_pair, out_pair[, out_side])``, the
  backmapped coordinates always at index 2 (reconstruct mode: the seven
  inputs, and ``(out_central_angles, out_central_dihedrals,
  back_cartesians, out_side_angles, out_side_dihedrals, inp_pair,
  out_pair)``).

A metric object runs a second forward per step; for clashes and RMSD,
``ADCParameters.track_clashes`` / ``track_RMSD`` reuse the loss forward.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..ops.distances import pairwise_dist
from ..ops.kabsch import rmsd as rmsd_op
from ..parameters import ADCParameters, Parameters

__all__ = [
    "EncoderMapBaseMetric",
    "AngleDihedralCartesianEncoderMapBaseMetric",
    "OmegaAngleBaseMetric",
    "SidechainVsBackboneFrequencyBaseMetric",
    "ADCClashMetric",
    "ADCRMSDMetric",
    "rmsd_numpy",
    "backbone_weights",
]

#: N, CA, C masses of the reference's weighted Kabsch RMSD
#: (``callbacks/metrics.py:63``; 24.305, magnesium, for both CA and C,
#: kept so that the numbers match)
WEIGHTS: tuple[float, float, float] = (14.0067, 24.305, 24.305)


def backbone_weights(n_atoms: int) -> np.ndarray:
    """The N, CA, C mass triplet tiled over ``n_atoms`` backbone atoms."""
    return np.tile(np.asarray(WEIGHTS, np.float32), -(-n_atoms // 3))[:n_atoms]


def rmsd_numpy(a: np.ndarray, b: np.ndarray, translate: bool = True) -> np.ndarray:
    """Batched backbone-weighted Kabsch RMSD of ``(batch, n_atoms, 3)`` sets
    as numpy (reference ``callbacks/metrics.py:155-172``). ``translate`` is
    the reference's argument: the fit removes the centroids either way, so
    the answer does not depend on it."""
    a = torch.as_tensor(np.asarray(a, np.float32))
    b = torch.as_tensor(np.asarray(b, np.float32))
    w = torch.as_tensor(backbone_weights(a.shape[1]))
    return rmsd_op(a, b, w).numpy()


class EncoderMapBaseMetric:
    """Base class of user metrics (reference ``callbacks/metrics.py:250``):
    subclass, implement ``update(y_true, y_pred)`` with torch operations and
    attach with ``emap.add_metric(MyMetric)``. ``current_training_step``, if
    given with ``parameters``, must equal theirs."""

    #: the reference's flag for its check that ``update`` is implemented
    custom_update_state: bool = True

    def __init__(self, parameters: Optional[Parameters] = None,
                 name: Optional[str] = None,
                 current_training_step: Optional[int] = None,
                 **kwargs: Any) -> None:
        self.name = name if name is not None else f"{type(self).__name__} Metric"
        self.p = parameters if parameters is not None else self._default_parameters()
        if (current_training_step is not None and parameters is not None
                and current_training_step != parameters.current_training_step):
            raise ValueError(
                f"Instantiation of {type(self).__name__} got different values "
                f"for current training steps. In parameters, the training step "
                f"is {parameters.current_training_step}, in the arguments, I got "
                f"{current_training_step}")
        if type(self).update is EncoderMapBaseMetric.update:
            raise TypeError(f"{type(self).__name__} must implement update(), "
                            f"returning a scalar")

    @staticmethod
    def _default_parameters() -> Parameters:
        return Parameters()

    def update(self, y_true: Any, y_pred: Any) -> torch.Tensor:
        """Override: a 0-d tensor from the batch's inputs and outputs."""
        raise NotImplementedError

    def __call__(self, y_true: Any, y_pred: Any) -> torch.Tensor:
        return self.update(y_true, y_pred)

    def get_config(self) -> dict[str, Any]:
        """The metric's name and parameters (the reference's metrics are
        Keras-serializable)."""
        return {"name": self.name, "parameters": self.p.to_dict()}

    @classmethod
    def from_config(cls, config: dict[str, Any], custom_objects: Any = None):
        config = dict(config)
        p = config.pop("parameters")
        if isinstance(p, dict):
            p = (ADCParameters if "cartesian_pwd_start" in p else Parameters)(**p)
        return cls(parameters=p, **config)


class AngleDihedralCartesianEncoderMapBaseMetric(EncoderMapBaseMetric):
    """Base metric of the ADC family, defaulting to :class:`ADCParameters`
    (reference ``callbacks/metrics.py:374``)."""

    @staticmethod
    def _default_parameters() -> ADCParameters:
        return ADCParameters()


class OmegaAngleBaseMetric(AngleDihedralCartesianEncoderMapBaseMetric):
    """Subclass hook for omega-angle tracking (reference
    ``callbacks/metrics.py:460``, an empty base there too)."""


class SidechainVsBackboneFrequencyBaseMetric(AngleDihedralCartesianEncoderMapBaseMetric):
    """Subclass hook for sidechain-against-backbone frequency tracking in
    reconstruct mode (reference ``callbacks/metrics.py:464``)."""


def _pred_cartesians(y_pred: Any) -> torch.Tensor:
    return y_pred[2] if isinstance(y_pred, (tuple, list)) else y_pred


class ADCClashMetric(AngleDihedralCartesianEncoderMapBaseMetric):
    """Mean number of atom pairs closer than 1 Å in the backmapped
    coordinates (reference ``callbacks/metrics.py:470-530``);
    ``distance_unit`` "nm" (clash below 0.1) or "ang" (below 1.0)."""

    def __init__(self, distance_unit: str = "nm", name: str = "ADCClashMetric",
                 parameters: Optional[ADCParameters] = None, **kwargs: Any) -> None:
        super().__init__(parameters=parameters, name=name, **kwargs)
        if distance_unit not in ("nm", "ang"):
            raise ValueError(f"distance_unit must be 'nm' or 'ang', got "
                             f"{distance_unit!r}")
        self.distance_unit = distance_unit
        self.clash_distance = 0.1 if distance_unit == "nm" else 1.0

    def update(self, y_true: Any, y_pred: Any) -> torch.Tensor:
        d = pairwise_dist(_pred_cartesians(y_pred), flat=True)
        return torch.mean(torch.sum((d < self.clash_distance).to(torch.float32),
                                    dim=-1))

    def get_config(self) -> dict[str, Any]:
        # the unit too, so that from_config rebuilds the metric (the
        # reference's get_config drops it)
        return dict(super().get_config(), distance_unit=self.distance_unit)


class ADCRMSDMetric(AngleDihedralCartesianEncoderMapBaseMetric):
    """Batch mean of the backbone-weighted Kabsch RMSD (nm) of the
    backmapped coordinates against the input (reference
    ``callbacks/metrics.py:533-581``, which keeps the per-frame vector). In
    reconstruct mode every atom is backmapped, so the N-CA-C masses would
    land on the wrong atoms: the weights are uniform there, as in the JAX
    package."""

    def __init__(self, name: str = "ADCRMSDMetric",
                 parameters: Optional[ADCParameters] = None, **kwargs: Any) -> None:
        super().__init__(parameters=parameters, name=name, **kwargs)

    def update(self, y_true: Any, y_pred: Any) -> torch.Tensor:
        pred = _pred_cartesians(y_pred)
        true = y_true[2] if isinstance(y_true, (tuple, list)) else y_true
        w = None
        if not getattr(self.p, "reconstruct_sidechains", False):
            w = torch.as_tensor(backbone_weights(pred.shape[1]), device=pred.device)
        return torch.mean(rmsd_op(true, pred, w))
