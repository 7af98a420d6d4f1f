# encodermap_tpu_torch/nn.py
"""Dense layers as plain dictionaries of tensors and functions over them.

Counterpart of ``encodermap_tpu/nn.py`` (itself after the reference's Keras
``Dense`` stacks, ``models/models.py:3189-3220``). A layer is
``{"kernel": (din, dout), "bias": (dout,)}``: kernels are stored
``(din, dout)`` exactly as the JAX package stores them, so weights copy
across without a transpose and checkpoints interchange.

Tensor parallelism: a :class:`TPLayer` is a layer whose tensors are one
rank's slices over the ``tp`` axis (``parallel/mesh.py::shard_params_tp``
makes them). A column-parallel layer holds a slice of the kernel's output
width and of the bias; a row-parallel layer a slice of the kernel's input
width and the whole bias. :func:`mlp_apply` runs them with Megatron's
collectives (``parallel/distributed.py``): the input of a column-parallel
layer enters the tp region (identity forward, all-reduce backward), a
row-parallel layer's partial product is all-reduced before its bias, and a
column-parallel output that feeds a replicated layer is all-gathered.
:func:`l2_sum` adds each sharded kernel's square sum once across the tp
group. A plain ``dict`` layer is computed as on one device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "ACTIVATIONS",
    "TPLayer",
    "has_tp_layers",
    "dense_init",
    "dense_apply",
    "mlp_init",
    "mlp_apply",
    "l2_sum",
]

Params = dict[str, Any]


def _leaky_relu(x):
    # jax.nn.leaky_relu's default slope
    return F.leaky_relu(x, 0.01)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Optional[Callable[[torch.Tensor], torch.Tensor]]] = {
    "": None,
    "linear": None,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "elu": F.elu,
    "gelu": _gelu,
    "swish": F.silu,
    "leaky_relu": _leaky_relu,
}

#: std of a unit normal truncated to [-2, 2]; VarianceScaling divides by it
#: so that the truncated draw has the requested variance
_TRUNC_STD = 0.87962566103423978


class TPLayer(dict):
    """A dense layer's ``{"kernel", "bias"}`` as one rank's slices over the
    tp axis: ``kind`` is ``"column"`` (kernel split on its output width,
    bias split) or ``"row"`` (kernel split on its input width, bias whole),
    ``group`` the tp process group. Tree maps keep the kind and the group
    (``train/core.py::tree_unflatten``)."""

    #: the JAX package's PartitionSpecs of (kernel, bias) by kind
    SPECS = {"column": ((None, "tp"), ("tp",)), "row": (("tp", None), ())}

    def __init__(self, items: dict, kind: str, group: Any) -> None:
        if kind not in self.SPECS:
            raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")
        super().__init__(items)
        self.kind = kind
        self.group = group

    def like(self, items: dict) -> "TPLayer":
        """Another layer of this kind and group holding ``items``."""
        return TPLayer(items, self.kind, self.group)

    @property
    def specs(self) -> dict:
        """``{"kernel": spec, "bias": spec}`` as tuples of axis names."""
        k, b = self.SPECS[self.kind]
        return {"kernel": k, "bias": b}


def has_tp_layers(tree: Any) -> bool:
    """Whether a parameter tree holds a tp-sharded layer."""
    if isinstance(tree, TPLayer):
        return True
    if isinstance(tree, dict):
        return any(has_tp_layers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_tp_layers(v) for v in tree)
    return False


def dense_init(
    generator: torch.Generator,
    in_dim: int,
    out_dim: int,
    dtype: torch.dtype = torch.float32,
    kernel_initializer: str = "VarianceScaling",
    bias_initializer: str = "RandomNormal",
    device: Any = "cpu",
) -> Params:
    """One dense layer's parameters: ``VarianceScaling()`` kernels (scale
    1, fan_in, truncated normal) and ``RandomNormal(0.1, 0.05)`` biases,
    the reference's choices (``models/models.py:3182-3186``). The draws come
    from ``generator``; they follow the same distributions as the JAX
    package's, not the same numbers."""
    if kernel_initializer == "VarianceScaling":
        std = math.sqrt(1.0 / in_dim) / _TRUNC_STD
        kernel = torch.empty((in_dim, out_dim), dtype=dtype)
        torch.nn.init.trunc_normal_(kernel, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
    elif kernel_initializer == "ones":
        kernel = torch.ones((in_dim, out_dim), dtype=dtype)
    elif kernel_initializer == "glorot_uniform":
        lim = math.sqrt(6.0 / (in_dim + out_dim))
        kernel = torch.empty((in_dim, out_dim), dtype=dtype)
        kernel.uniform_(-lim, lim, generator=generator)
    else:
        raise ValueError(f"unknown kernel initializer {kernel_initializer!r}")
    if bias_initializer == "RandomNormal":
        bias = 0.1 + 0.05 * torch.randn((out_dim,), dtype=dtype,
                                        generator=generator)
    elif bias_initializer == "ones":
        bias = torch.ones((out_dim,), dtype=dtype)
    elif bias_initializer == "zeros":
        bias = torch.zeros((out_dim,), dtype=dtype)
    else:
        raise ValueError(f"unknown bias initializer {bias_initializer!r}")
    return {"kernel": kernel.to(device), "bias": bias.to(device)}


def dense_apply(
    params: Params,
    x: torch.Tensor,
    activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``act(x @ kernel + bias)``. With ``compute_dtype=torch.bfloat16`` the
    operands are rounded to bf16 and the product accumulates in float32,
    as the JAX package's ``preferred_element_type=float32`` does: a product
    of two bf16 values is exact in float32, so rounding the operands and
    multiplying in float32 is that computation. A column-parallel
    :class:`TPLayer` takes the whole input and gives its slice of the
    output; a row-parallel one takes its slice of the input and gives the
    whole output, all-reduced before the bias."""
    kernel = params["kernel"]
    kind = getattr(params, "kind", None)
    if kind == "column":
        from .parallel.distributed import enter_tp

        x = enter_tp(x, params.group)
    if compute_dtype is not None and compute_dtype != kernel.dtype:
        x = x.to(compute_dtype).float()
        kernel = kernel.to(compute_dtype).float()
    y = x.float() @ kernel.float()
    if kind == "row":
        from .parallel.distributed import reduce_tp

        y = reduce_tp(y, params.group)
    y = y + params["bias"].float()
    if activation is not None:
        y = activation(y)
    return y


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32, device: Any = "cpu",
             **kwargs: Any) -> list[Params]:
    """A stack of dense layers: ``dims = [in, h1, h2, ..., out]``."""
    return [
        dense_init(generator, d_in, d_out, dtype, device=device, **kwargs)
        for d_in, d_out in zip(dims[:-1], dims[1:])
    ]


def mlp_apply(layers: Sequence[Params], x: torch.Tensor,
              activations: Sequence[Optional[Callable]],
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply a dense stack with one activation per layer. Between
    tp-sharded layers the activations stay sliced; a column-parallel
    output is all-gathered where a replicated layer or the stack's end
    needs it whole."""
    if len(layers) != len(activations):
        raise ValueError(f"{len(layers)} layers, {len(activations)} activations")
    sliced = None  # the tp group while x is a column-parallel output slice
    for lp, act in zip(layers, activations):
        kind = getattr(lp, "kind", None)
        if sliced is not None and kind != "row":
            from .parallel.distributed import gather_tp

            x, sliced = gather_tp(x, sliced), None
        elif sliced is None and kind == "row":
            raise ValueError("a row-parallel layer needs the output slice of a "
                             "column-parallel layer before it (shard_params_tp's layout)")
        x = dense_apply(lp, x, act, compute_dtype)
        if kind == "column":
            sliced = lp.group
        elif kind == "row":
            sliced = None
    if sliced is not None:
        from .parallel.distributed import gather_tp

        x = gather_tp(x, sliced)
    return x


def l2_sum(layers_tree: Any) -> torch.Tensor:
    """Sum of squared kernel weights (biases excluded), Keras'
    ``regularizers.l2`` before its constant. The square sums of tp-sharded
    kernels are all-reduced over their tp group (each counted once), the
    replicated ones added once."""
    leaves = []
    sharded: list = []

    def visit(node):
        if isinstance(node, TPLayer):
            sharded.append((node.group, torch.sum(torch.square(node["kernel"]))))
        elif isinstance(node, dict) and "kernel" in node:
            leaves.append(torch.sum(torch.square(node["kernel"])))
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(layers_tree)
    if sharded:
        from .parallel.distributed import reduce_tp

        part = sharded[0][1]
        for _, leaf in sharded[1:]:
            part = part + leaf
        leaves.append(reduce_tp(part, sharded[0][0]))
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].device if leaves else "cpu")
    for leaf in leaves:
        total = total + leaf
    return total
