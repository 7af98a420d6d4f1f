# encodermap_tpu_torch/loss_classes.py
"""Experimental serializable loss classes and the ``@testing`` gate.

Counterpart of ``encodermap_tpu/loss_classes.py`` (after the reference's
``loss_functions/loss_classes.py:75-349``, whose keras-serializable
``tf.keras.losses.Loss`` subclasses ``EncoderMapBaseLoss`` ->
``ADCBaseLoss`` -> ``DihedralLoss`` / ``AngleLoss`` / ``SideDihedralLoss``
wrap the loss functions so users can subclass them with the Parameters at
hand). A loss class here is a small JSON-serializable object whose
``call(y_true, y_pred)`` runs the port's loss functions (:mod:`.losses`) on
tensors, and whose :meth:`attach` registers it on an autoencoder through
``add_loss``: the train step evaluates it beside the built-in terms and
logs it as a metric.

Every class is gated behind ``ENCODERMAP_TESTING=True``, as in the
reference: they mirror an actively developed, unstable surface.
"""

from __future__ import annotations

import functools
import inspect
import os
from typing import Any, Optional, Union

from . import losses as L
from .parameters import ADCParameters, Parameters

__all__ = [
    "testing",
    "EncoderMapBaseLoss",
    "ADCBaseLoss",
    "DihedralLoss",
    "AngleLoss",
    "SideDihedralLoss",
]


def testing(cls_or_func):
    """Gate a class/function behind ``ENCODERMAP_TESTING=True`` — the
    reference's marker for actively-developed, unstable surfaces
    (``loss_classes.py:75-105``)."""
    if inspect.isclass(cls_or_func):
        orig_init = cls_or_func.__init__

        @functools.wraps(orig_init)
        def __init__(self, *args, **kwargs):
            if os.getenv("ENCODERMAP_TESTING", "False") != "True":
                raise Exception(
                    f"You are instantiating a testing class "
                    f"({cls_or_func.__name__}). These classes are actively "
                    f"developed and not stable. If you know what you are "
                    f"doing, set the environment variable "
                    f"'ENCODERMAP_TESTING' to 'True'."
                )
            return orig_init(self, *args, **kwargs)

        cls_or_func.__init__ = __init__
        return cls_or_func

    @functools.wraps(cls_or_func)
    def newfunc(*args, **kwargs):
        if os.getenv("ENCODERMAP_TESTING", "False") != "True":
            raise Exception(
                f"You are calling a testing function "
                f"({cls_or_func.__name__}). These functions are actively "
                f"developed and not stable. If you know what you are doing, "
                f"set the environment variable 'ENCODERMAP_TESTING' to "
                f"'True'."
            )
        return cls_or_func(*args, **kwargs)

    return newfunc


@testing
class EncoderMapBaseLoss:
    """Base loss: holds Parameters, JSON round-trips, and defines the
    ``call(y_true, y_pred) -> scalar`` contract for subclasses
    (reference ``loss_classes.py:133-216``)."""

    #: metric name under which :meth:`attach` registers the term
    name = "custom_loss"

    def __init__(
        self,
        parameters: Optional[Union[Parameters, ADCParameters]] = None,
    ) -> None:
        self.p = parameters if parameters is not None else Parameters()

    def call(self, y_true: Any, y_pred: Any):
        raise NotImplementedError("subclass and implement call()")

    def __call__(self, y_true: Any, y_pred: Any):
        return self.call(y_true, y_pred)

    # ------------------------------------------------------------------ config
    def get_config(self) -> dict:
        return {"p": self.p.to_dict()}

    @classmethod
    def from_config(cls, config: dict) -> "EncoderMapBaseLoss":
        config = dict(config)  # never mutate the caller's dict
        p = config.pop("p")
        # same dispatch as the reference: ADC-only keys mark ADCParameters
        if "cartesian_pwd_start" in p:
            p = ADCParameters(**p)
        else:
            p = Parameters(**p)
        return cls(parameters=p, **config)

    # ------------------------------------------------------------------ attach
    def attach(self, autoencoder) -> None:
        """Register on an (ADC) autoencoder: the train step evaluates
        ``call`` on this loss's input/output pair each step and reports it
        under ``self.name``."""
        raise NotImplementedError("subclass and implement attach()")


@testing
class ADCBaseLoss(EncoderMapBaseLoss):
    """Base for AngleDihedralCartesianEncoderMap losses (reference
    ``loss_classes.py:216-236``): defaults to ADCParameters and provides
    the forward-pass plumbing for attach()."""

    #: index of this loss's ground-truth array in the ADC batch tuple
    _batch_index = 1
    #: index of the prediction in the decode output (angles, dihedrals, side)
    _decode_index = 1

    def __init__(
        self, parameters: Optional[ADCParameters] = None
    ) -> None:
        super().__init__(
            parameters if parameters is not None else ADCParameters()
        )

    #: parameters flag the model must have enabled for this loss's arrays
    #: to exist in the batch/decode tuples (None = always available)
    _requires: Optional[str] = None

    def attach(self, autoencoder) -> None:
        p = autoencoder.p
        if getattr(p, "reconstruct_sidechains", False):
            raise ValueError(
                f"{type(self).__name__}.attach() supports the standard ADC "
                f"model only — reconstruct_sidechains=True models use the "
                f"7-input batch ordering and forward_sidechains; subclass "
                f"attach() for that family."
            )
        if self._requires and not getattr(p, self._requires, False):
            raise ValueError(
                f"{type(self).__name__} needs a model trained with "
                f"{self._requires}=True (its input/output arrays are absent "
                f"otherwise)."
            )
        from .models import adc

        def term(params, batch):
            if getattr(autoencoder, "sparse", False):
                # the trainer densifies NaN-padded ensemble batches before
                # its forward pass; without it here NaNs would reach the
                # loss
                batch = adc.densify_inputs(params, batch)
            out = adc.forward(params, autoencoder.p, batch, autoencoder.shapes,
                              with_pairs=False)
            return self.call(batch[self._batch_index], out[self._decode_index])

        autoencoder.add_loss(term, name=self.name)


@testing
class DihedralLoss(ADCBaseLoss):
    """Periodic dihedral cost as a class (reference
    ``loss_classes.py:237-299``)."""

    name = "dihedral_loss_class"
    _batch_index = 1
    _decode_index = 1

    def call(self, y_true, y_pred):
        return L.dihedral_loss(y_true, y_pred, self.p)


@testing
class AngleLoss(ADCBaseLoss):
    """Periodic backbone-angle cost as a class (reference
    ``loss_classes.py:300-349``)."""

    name = "angle_loss_class"
    _batch_index = 0
    _decode_index = 0

    def call(self, y_true, y_pred):
        return L.angle_loss(y_true, y_pred, self.p)


@testing
class SideDihedralLoss(ADCBaseLoss):
    """Periodic sidechain-dihedral cost as a class (same family as the
    reference's Angle/Dihedral classes)."""

    name = "side_dihedral_loss_class"
    _batch_index = 4
    _decode_index = 2
    _requires = "use_sidechains"

    def call(self, y_true, y_pred):
        return L.side_dihedral_loss(y_true, y_pred, self.p)
