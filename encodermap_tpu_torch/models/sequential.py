# encodermap_tpu_torch/models/sequential.py
"""The plain MLP autoencoder of :class:`EncoderMap`.

Counterpart of ``encodermap_tpu/models/sequential.py`` (after the
reference's ``SequentialModel``, ``models/models.py:3099-3401``):

* layer stack ``n_neurons + n_neurons[-2::-1]`` plus a final layer back to
  the input dim, activations ``act[1:] + act[-2::-1]`` and a linear output;
* periodic inputs are rescaled to 2*pi and doubled via (sin, cos); periodic
  outputs are halved via atan2 and rescaled back
  (``models/models.py:3331-3359``);
* the bottleneck is the smallest layer; everything up to it is the encoder.

Parameters are the dictionary ``{"encoder": [...], "decoder": [...]}`` of
:mod:`encodermap_tpu_torch.nn` layers.
"""

from __future__ import annotations

from math import pi
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn import ACTIVATIONS, dense_apply, dense_init, l2_sum, mlp_apply, mlp_init
from ..parameters import ADCParameters, Parameters

__all__ = [
    "layer_stack",
    "init_params",
    "densify",
    "encode",
    "decode",
    "forward",
    "regularization_sum",
    "SequentialModel",
    "gen_sequential_model",
]


def layer_stack(p: Parameters, input_dim: int) -> tuple[list, list, int]:
    """``(encoder_layer_data, decoder_layer_data, effective_input_dim)``;
    each layer datum is ``(n_units, activation_name)``."""
    eff_input_dim = input_dim * 2 if p.periodicity < float("inf") else input_dim
    acts = list(p.activation_functions)
    layer_data = list(zip(list(p.n_neurons) + list(p.n_neurons[-2::-1]),
                          acts[1:] + acts[-2::-1]))
    layer_data.append((eff_input_dim, ""))
    neurons = [d[0] for d in layer_data]
    bottleneck_index = neurons.index(min(neurons)) + 1
    return (layer_data[:bottleneck_index], layer_data[bottleneck_index:],
            eff_input_dim)


def init_params(generator: torch.Generator, p: Parameters, input_dim: int,
                dtype: torch.dtype = torch.float32, sparse: bool = False,
                device: Any = "cpu") -> dict:
    """Initialize the ``{"encoder": [...], "decoder": [...]}`` parameters;
    ``sparse=True`` adds the square densifier applied to zero-filled
    NaN-padded inputs (``models.py:3165-3177``)."""
    enc_layers, dec_layers, eff_in = layer_stack(p, input_dim)
    enc_dims = [eff_in] + [d[0] for d in enc_layers]
    dec_dims = [enc_dims[-1]] + [d[0] for d in dec_layers]
    params = {
        "encoder": mlp_init(generator, enc_dims, dtype, device=device),
        "decoder": mlp_init(generator, dec_dims, dtype, device=device),
    }
    if sparse:
        params["densifier"] = dense_init(generator, input_dim, input_dim,
                                         dtype, device=device)
    return params


def densify(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Zero-fill NaNs and apply the densifier when the model has one (else
    identity)."""
    if "densifier" not in params:
        return x
    return dense_apply(params["densifier"], torch.nan_to_num(x))


def _acts(layer_data: list) -> list:
    return [ACTIVATIONS[name] for _, name in layer_data]


def _compute_dtype(p: Parameters) -> Optional[torch.dtype]:
    return torch.bfloat16 if p.compute_dtype == "bfloat16" else None


def encode(params: dict, p: Parameters, x: torch.Tensor) -> torch.Tensor:
    """Periodic fold-in (scale to 2*pi, sin/cos doubling) + encoder MLP."""
    enc_layers, _, _ = layer_stack(p, _orig_input_dim(params, p))
    if p.periodicity < float("inf"):
        if p.periodicity != 2 * pi:
            x = x / p.periodicity * 2 * pi
        x = torch.cat([torch.sin(x), torch.cos(x)], dim=1)
    return mlp_apply(params["encoder"], x, _acts(enc_layers), _compute_dtype(p))


def decode(params: dict, p: Parameters, z: torch.Tensor) -> torch.Tensor:
    """Decoder MLP + periodic fold-out (atan2 halving, rescale)."""
    _, dec_layers, _ = layer_stack(p, _orig_input_dim(params, p))
    x = mlp_apply(params["decoder"], z, _acts(dec_layers), _compute_dtype(p))
    if p.periodicity < float("inf"):
        s, c = torch.chunk(x, 2, dim=1)
        x = torch.atan2(s, c)
        if p.periodicity != 2 * pi:
            x = x / (2 * pi) * p.periodicity
    return x


def forward(params: dict, p: Parameters, x: torch.Tensor) -> torch.Tensor:
    """Full autoencoder pass: encode then decode."""
    return decode(params, p, encode(params, p, x))


def regularization_sum(params: dict) -> torch.Tensor:
    """Sum of squared kernels over encoder and decoder (densifiers carry no
    regularizer)."""
    return l2_sum({"encoder": params["encoder"], "decoder": params["decoder"]})


def _orig_input_dim(params: dict, p: Parameters) -> int:
    eff = params["encoder"][0]["kernel"].shape[0]
    return eff // 2 if p.periodicity < float("inf") else eff


def _as_f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class SequentialModel(nn.Module):
    """The autoencoder as an ``nn.Module`` for custom training loops:
    ``model(x)``, ``model.encoder(x)``, ``model.decoder(z)``.

    Each kernel and bias is a registered ``nn.Parameter`` (so
    ``model.parameters()`` feeds any torch optimizer); :attr:`params` is the
    dictionary view the functional API takes, holding the same tensors.
    """

    def __init__(self, input_shape: int, parameters: Parameters = None,
                 sparse: bool = False, seed: int = None,
                 device: Any = None) -> None:
        super().__init__()
        self.p = parameters if parameters is not None else Parameters()
        self.input_shape = int(input_shape)
        self.sparse = bool(sparse)
        self.device = resolve_device(device)
        if seed is None:
            seed = self.p.seed if self.p.seed is not None else 0
        gen = torch.Generator().manual_seed(int(seed))
        params = init_params(gen, self.p, self.input_shape, sparse=sparse,
                             device=self.device)
        self._store = nn.ParameterDict()
        self.params: dict = {}
        for part, layers in params.items():
            if part == "densifier":
                layers = [layers]
            stored = []
            for i, layer in enumerate(layers):
                entry = {}
                for name, t in layer.items():
                    prm = nn.Parameter(t)
                    self._store[f"{part}_{i}_{name}"] = prm
                    entry[name] = prm
                stored.append(entry)
            self.params[part] = stored[0] if part == "densifier" else stored

    def encoder(self, x) -> torch.Tensor:
        """Encode ``x`` (array or tensor) to the latent space."""
        x = _as_f32(x, self.device)
        if self.sparse:
            x = densify(self.params, x)
        return encode(self.params, self.p, x)

    def decoder(self, z) -> torch.Tensor:
        """Decode latent points ``z`` back to input space."""
        return decode(self.params, self.p, _as_f32(z, self.device))

    def forward(self, x) -> torch.Tensor:
        """Encode then decode."""
        return self.decoder(self.encoder(x))


def gen_sequential_model(input_shape: int, parameters=None,
                         sparse: bool = False, device: Any = None
                         ) -> SequentialModel:
    """Model factory with the reference's signature
    (``models/models.py:256-288``). ``ADCParameters`` belong to the ADC
    model (``models/adc.py``, trained by ``AngleDihedralCartesianEncoderMap``)."""
    if parameters is None:
        parameters = Parameters()
    if isinstance(parameters, ADCParameters):
        raise TypeError(
            "For ADCParameters use the functional ADC model: "
            "encodermap_tpu_torch.AngleDihedralCartesianEncoderMap "
            "(models/adc.py)."
        )
    if not isinstance(parameters, Parameters):
        raise TypeError(
            f"parameters must be encodermap Parameters or ADCParameters, "
            f"got {type(parameters)}"
        )
    return SequentialModel(input_shape, parameters, sparse=sparse,
                           device=device)
