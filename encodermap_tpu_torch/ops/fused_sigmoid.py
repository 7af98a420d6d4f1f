# encodermap_tpu_torch/ops/fused_sigmoid.py
"""The sketch-map sigmoid loss over all pairs, as hand-written CUDA kernels.

Counterpart of ``encodermap_tpu/ops/pallas_sigmoid.py``. The loss is

    loss = mean_{ij} ( s_h(||h_i - h_j||_per) - s_l(||l_i - l_j||) )^2

and only the latent side ``l`` gets a gradient (the high-dimensional side is
the input batch; the JAX kernel's custom VJP returns exact zeros for ``h``
too):

    d loss / d l_k = (4 / B^2) sum_j (s_l - s_h)_kj s_l'(d_kj) (l_k - l_j) / d_kj

Kernels (``csrc/sigmoid_loss.cu``): the forward pass replaces
``pallas_sigmoid.py::_fwd_kernel``, the backward pass ``::_bwd_kernel``.
Both evaluate each unordered pair once, in upper-triangular tiles of the
pair matrix, take distances by direct per-component differences, keep the
periodic guards (1e-12 per exactly-zero component and after the sqrt) and
work for any batch size, input width and latent width. Each sum is taken in
a fixed order, so a kernel gives the same bits on every launch. Their plain
versions, :func:`sigmoid_loss_fwd_plain` and :func:`sigmoid_loss_bwd_plain`,
compute the same formulas densely.

:func:`fused_sigmoid_loss` launches the kernels for CUDA tensors and runs the
plain versions only for CPU tensors. :func:`fused_or_reference` routes every
batch on the card to it and CPU tensors to the general path of
``ops/distances.py`` (:func:`sigmoid_loss_general`). The JAX package routes
by size instead, from B = 16384 on (its TPU timings); on the H100 the kernels'
forward + backward beat the general path at every batch size
``chip_smoke.py`` measures (PERF.md).

One intended deviation from the JAX router: an ``h`` that needs a gradient
(a sparse model's densified batch) keeps the general path on the card, since
the kernels give ``h`` no gradient. Below B = 16384 the JAX router gives it
the same true gradient; from there on it gives zeros.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .distances import (
    dsig_over_r,
    pairwise_dist,
    pairwise_dist_periodic,
    sig_value,
    sigmoid,
    sqrt_guard,
)

__all__ = [
    "fused_sigmoid_loss",
    "fused_or_reference",
    "sigmoid_loss_fwd",
    "sigmoid_loss_bwd",
    "sigmoid_loss_fwd_plain",
    "sigmoid_loss_bwd_plain",
    "sigmoid_loss_general",
]

_LIB = "sigmoid_loss"
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_build.register(_LIB, [
    ("em_sigmoid_occupancy", [_I, _I, _I, _I, _I]),
    ("em_sigmoid_fwd_workspace", [_I]),
    ("em_sigmoid_bwd_workspace", [_I, _I], ctypes.c_longlong),
    ("em_sigmoid_fwd", [_P, _P, _I, _I, _I, _D, _D, _D, _D, _D, _D, _D, _I,
                        _P, _P, _P]),
    ("em_sigmoid_bwd", [_P, _P, _I, _I, _I, _D, _D, _D, _D, _D, _D, _D, _I,
                        _P, _P, _P, _P]),
])


def _kernel_route(h: torch.Tensor, l: torch.Tensor) -> bool:
    """Check the shapes, then whether ``h`` and ``l`` go to the kernels
    (``_build.kernel_route``)."""
    if h.ndim != 2 or l.ndim != 2 or h.shape[0] != l.shape[0]:
        raise ValueError(f"h (B, D) and l (B, d) expected, got "
                         f"{tuple(h.shape)} and {tuple(l.shape)}")
    return _build.kernel_route((h, l), "the sigmoid-loss kernels", (torch.float32,))


def _cuda_args(h, l, params, periodicity):
    if not (h.is_contiguous() and l.is_contiguous()):
        raise ValueError("the sigmoid-loss kernels take contiguous tensors")
    periodic = math.isfinite(periodicity)
    return ([h.data_ptr(), l.data_ptr(), h.shape[0], h.shape[1], l.shape[1],
             *[float(x) for x in params],
             float(periodicity) if periodic else 0.0, int(periodic)])


def _dist_h_plain(h: torch.Tensor, periodicity: float) -> torch.Tensor:
    """(B, B) high-D distances, one (B, B) plane per feature column."""
    if not math.isfinite(periodicity):
        return sqrt_guard(pairwise_dist(h, squared=True, method="direct")[0])
    d2 = None
    for k in range(h.shape[1]):
        col = h[:, k]
        d = torch.abs(col[:, None] - col[None, :])
        d = torch.minimum(d, periodicity - d)
        d = torch.where(d == 0.0, torch.full_like(d, 1e-12), d)
        d2 = d * d if d2 is None else d2 + d * d
    return torch.sqrt(d2) + 1e-12


def _latent_d2(l: torch.Tensor) -> torch.Tensor:
    return pairwise_dist(l, squared=True, method="direct")[0]


def sigmoid_loss_fwd_plain(h, l, params, periodicity) -> torch.Tensor:
    """Plain version of the forward kernel: the loss as a 0-d tensor."""
    sig_h, a_h, b_h, sig_l, a_l, b_l = params
    diff = (sig_value(_dist_h_plain(h, periodicity), sig_h, a_h, b_h)
            - sig_value(sqrt_guard(_latent_d2(l)), sig_l, a_l, b_l))
    return torch.mean(diff * diff)


def sigmoid_loss_bwd_plain(h, l, params, periodicity) -> torch.Tensor:
    """Plain version of the backward kernel: d loss / d l, shape (B, d)."""
    sig_h, a_h, b_h, sig_l, a_l, b_l = params
    n = l.shape[0]
    d2 = _latent_d2(l)
    zero = d2 == 0.0
    d_l = sqrt_guard(d2)
    s_h = sig_value(_dist_h_plain(h, periodicity), sig_h, a_h, b_h)
    s_l = sig_value(d_l, sig_l, a_l, b_l)
    f = (s_l - s_h) * dsig_over_r(d2, d_l, sig_l, a_l, b_l)
    f = torch.where(zero, torch.zeros_like(f), f)
    grad = f.sum(dim=1, keepdim=True) * l - f @ l
    return grad * (4.0 / (n * n))


def sigmoid_loss_fwd(h, l, params, periodicity) -> torch.Tensor:
    """The forward kernel for CUDA tensors, its plain version for CPU
    tensors; a 0-d float32 tensor."""
    if not _kernel_route(h, l):
        return sigmoid_loss_fwd_plain(h, l, params, periodicity)
    lib = _build.load_library(_LIB)
    args = _cuda_args(h, l, params, periodicity)
    partials = torch.empty(lib.em_sigmoid_fwd_workspace(h.shape[0]),
                           dtype=torch.float32, device=h.device)
    out = torch.empty((), dtype=torch.float32, device=h.device)
    _build.launch(_LIB, "em_sigmoid_fwd", *args, partials.data_ptr(), out.data_ptr())
    return out


def sigmoid_loss_bwd(h, l, params, periodicity, grad_output=None
                     ) -> torch.Tensor:
    """``grad_output * d loss / d l``: the backward kernel for CUDA tensors,
    its plain version for CPU tensors."""
    if not _kernel_route(h, l):
        grad = sigmoid_loss_bwd_plain(h, l, params, periodicity)
        return grad if grad_output is None else grad * grad_output
    lib = _build.load_library(_LIB)
    args = _cuda_args(h, l, params, periodicity)
    if grad_output is None:
        grad_output = torch.ones((), dtype=torch.float32, device=h.device)
    gout = grad_output.to(torch.float32).reshape(1).contiguous()
    grad = torch.empty_like(l)
    ws = torch.empty(lib.em_sigmoid_bwd_workspace(h.shape[0], l.shape[1]),
                     dtype=torch.float32, device=h.device)
    _build.launch(_LIB, "em_sigmoid_bwd", *args, gout.data_ptr(), ws.data_ptr(),
                  grad.data_ptr())
    return grad


class _SigmoidLoss(torch.autograd.Function):
    """Forward and backward both through the kernels (or, for CPU tensors,
    their plain versions); ``h`` gets no gradient."""

    @staticmethod
    def forward(ctx, h, l, params, periodicity):
        ctx.save_for_backward(h, l)
        ctx.params, ctx.periodicity = params, periodicity
        return sigmoid_loss_fwd(h, l, params, periodicity)

    @staticmethod
    def backward(ctx, grad_output):
        h, l = ctx.saved_tensors
        grad_l = sigmoid_loss_bwd(h, l, ctx.params, ctx.periodicity,
                                  grad_output)
        return None, grad_l, None, None


def fused_sigmoid_loss(h, l, params, periodicity) -> torch.Tensor:
    """Sketch-map sigmoid loss through the kernels.

    WARNING: ``h`` gets NO GRADIENT (the JAX kernel gives it exact zeros).
    The high-dimensional side is the input batch, which training never
    differentiates; do not route an ``h`` that depends on trainable
    parameters here.

    Args:
        h: ``(B, D)`` high-dimensional batch.
        l: ``(B, d)`` latent batch (gradients flow here).
        params: ``(sig_h, a_h, b_h, sig_l, a_l, b_l)``.
        periodicity: of ``h``; ``float('inf')`` for none.
    """
    h = h.detach().contiguous()
    l = l.contiguous()
    return _SigmoidLoss.apply(h, l, tuple(params), float(periodicity))


def sigmoid_loss_general(h, l, params, periodicity) -> torch.Tensor:
    """The general path: ``pairwise_dist`` / ``pairwise_dist_periodic`` and
    the sigmoid, differentiable in both ``h`` and ``l`` by autograd."""
    sig_h, a_h, b_h, sig_l, a_l, b_l = params
    if periodicity == float("inf"):
        dist_h = pairwise_dist(h)
    else:
        dist_h = pairwise_dist_periodic(h, periodicity)
    dist_l = pairwise_dist(l)
    return torch.mean(torch.square(sigmoid(sig_h, a_h, b_h)(dist_h)
                                   - sigmoid(sig_l, a_l, b_l)(dist_l)))


def fused_or_reference(h, l, params, periodicity,
                       h_precision: str = "highest") -> torch.Tensor:
    """The kernels for tensors on the card, at every batch size; the general
    path on the CPU and where ``h`` itself needs a gradient (see the module
    docstring).

    ``h_precision`` is the JAX package's matrix-product precision of the
    high-D side ("high" lets the TPU take 3-pass bf16 products for wide
    ``h``). The port computes in full float32 on every route and TF32 stays
    off, so every value means float32 here."""
    if h_precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown h_precision {h_precision!r}")
    if h.device.type == "cuda" and not h.requires_grad:
        return fused_sigmoid_loss(h, l, params, periodicity)
    return sigmoid_loss_general(h, l, params, periodicity)
