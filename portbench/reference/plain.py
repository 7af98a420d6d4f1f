"""Plain PyTorch pieces of the references: the dense stack, the periodic
difference, the sketch-map loss, the backmap of a backbone and the clipped
Adam step, after the reference EncoderMap's definitions
(``loss_functions.py``, ``models/layers.py``, ``misc/backmapping.py``).

No kernels, no batching tricks and nothing of the program: each quantity is
computed in the most direct form, in the dtype the caller asks for
(float64 for the reference, float32 with TF32 on for the control).
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

ACTS = {"": None, "linear": None, "tanh": torch.tanh}


@contextmanager
def tf32(enabled: bool):
    """TF32 in float32 matrix products on (the control) or off."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def stack_acts(activation_functions: list) -> tuple[list, list]:
    """Encoder and decoder activations: the encoder takes entries 1.., the
    decoder mirrors them (the last entry, linear, is the latent's)."""
    acts = list(activation_functions)
    for a in acts:
        if a not in ACTS:
            raise ValueError(f"the reference has no activation {a!r}")
    return [ACTS[a] for a in acts[1:]], [ACTS[a] for a in acts[-2::-1]]


def layer_names(part: str, n: int) -> list[tuple[str, str]]:
    return [(f"{part}.{i}.kernel", f"{part}.{i}.bias") for i in range(n)]


def weight_shapes(in_dim: int, n_neurons: list, out_dim: int) -> list:
    """``(name, shape)`` of every kernel and bias, encoder then decoder."""
    enc = [in_dim] + list(n_neurons)
    dec = [n_neurons[-1]] + list(n_neurons[-2::-1]) + [out_dim]
    out = []
    for part, dims in (("encoder", enc), ("decoder", dec)):
        for (kn, bn), a, b in zip(layer_names(part, len(dims) - 1), dims[:-1], dims[1:]):
            out += [(kn, (a, b)), (bn, (b,))]
    return out


def mlp(W: dict, part: str, x: torch.Tensor, acts: list) -> torch.Tensor:
    for (kn, bn), act in zip(layer_names(part, len(acts)), acts):
        x = x @ W[kn] + W[bn]
        if act is not None:
            x = act(x)
    return x


def periodic_abs(a: torch.Tensor, b: torch.Tensor, period: float) -> torch.Tensor:
    """``|a - b|`` on a circle of ``period`` (inf: on the line): the
    absolute value of ``min(|a - b|, period - |a - b|)``, as the reference's
    ``mean_abs`` costs take it, so that sides more than a period apart (the
    sparse mode's densified inputs) read as the program reads them."""
    d = torch.abs(a - b)
    return d if math.isinf(period) else torch.abs(torch.minimum(d, period - d))


def pair_d2(h: torch.Tensor, period: float, block: int = 32) -> torch.Tensor:
    """Squared distances of all row pairs of ``h``: per-column min-image
    differences on a circle; on the line the Gram identity."""
    B = h.shape[0]
    if math.isinf(period):
        sq = (h * h).sum(1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (h @ h.T), min=0.0)
        return d2 * (1.0 - torch.eye(B, dtype=h.dtype, device=h.device))
    d2 = torch.zeros((B, B), dtype=h.dtype, device=h.device)
    for s in range(0, h.shape[1], block):
        hb = h[:, s:s + block]
        d2 = d2 + torch.square(periodic_abs(hb[:, None, :], hb[None, :, :], period)).sum(-1)
    return d2


def sigmoid_of_d2(d2: torch.Tensor, sig: float, a: float, b: float) -> torch.Tensor:
    """Sketch-map's sigmoid ``1 - (1 + (2^(a/b) - 1) (r/sig)^a)^(-b/a)`` of
    ``r = sqrt(d2)``, written in ``d2`` so that ``r = 0`` has a gradient."""
    c = 2.0 ** (a / b) - 1.0
    return 1.0 - (1.0 + c * (d2 / sig ** 2) ** (a / 2.0)) ** (-b / a)


def sketchmap(h: torch.Tensor, latent: torch.Tensor, params, period: float) -> torch.Tensor:
    """Mean over all ordered pairs (the diagonal too) of the squared
    difference of the two sides' sigmoids. ``h`` carries a gradient only
    where it depends on the weights (the sparse mode's trainable
    densifiers), as in the reference's graph; data has none."""
    sh, ah, bh, sl, al, bl = (float(x) for x in params)
    s_h = sigmoid_of_d2(pair_d2(h, period), sh, ah, bh)
    diff = latent[:, None, :] - latent[None, :, :]
    s_l = sigmoid_of_d2((diff * diff).sum(-1), sl, al, bl)
    return torch.mean(torch.square(s_h - s_l))


def l2(W: dict) -> torch.Tensor:
    return sum(torch.sum(w * w) for k, w in W.items() if k.endswith("kernel"))


def unit_circle(x: torch.Tensor, period: float) -> torch.Tensor:
    x = x * (2 * math.pi / period)
    return torch.cat([torch.sin(x), torch.cos(x)], 1)


def from_unit_circle(y: torch.Tensor, period: float) -> torch.Tensor:
    s, c = torch.chunk(y, 2, dim=1)
    return torch.atan2(s, c) * (period / (2 * math.pi))


def chain_in_plane(lengths: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """A zig-zag chain in the xy-plane, atom by atom: bond i leaves at
    heading psi_i, and each bond angle turns the next bond by its
    supplement, to the right and to the left in turn."""
    B, n_bonds = lengths.shape
    psi = torch.zeros(B, dtype=lengths.dtype, device=lengths.device)
    pos = [torch.zeros((B, 3), dtype=lengths.dtype, device=lengths.device)]
    zero = torch.zeros_like(psi)
    for i in range(n_bonds):
        step = torch.stack([torch.cos(psi), torch.sin(psi), zero], -1)
        pos.append(pos[-1] + lengths[:, i, None] * step)
        if i < n_bonds - 1:
            psi = psi + (1.0 if i % 2 else -1.0) * (math.pi - angles[:, i])
    return torch.stack(pos, 1)


def rotate(v: torch.Tensor, axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: ``(B, m, 3)`` vectors about ``(B, 3)`` unit axes by
    ``(B,)`` angles, right-handed."""
    axis = axis[:, None, :]
    c, s = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    return (v * c + torch.linalg.cross(axis.expand_as(v), v, dim=-1) * s
            + axis * (axis * v).sum(-1, keepdim=True) * (1.0 - c))


def curl_one_way(dihedrals: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Set ``n`` dihedrals in turn on ``(B, n + 3, 3)`` coordinates: the
    i-th turns every atom past i + 2 about the current bond (i + 1, i + 2)."""
    for i in range(dihedrals.shape[1]):
        axis = xyz[:, i + 2] - xyz[:, i + 1]
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        pivot = xyz[:, i + 2:i + 3]
        tail = rotate(xyz[:, i + 3:] - pivot, axis, dihedrals[:, i]) + pivot
        xyz = torch.cat([xyz[:, :i + 3], tail], 1)
    return xyz


def backmap(distances: torch.Tensor, angles: torch.Tensor,
            dihedrals: torch.Tensor) -> torch.Tensor:
    """The reference's BackMapLayer: the batch's mean bond lengths, the
    planar chain of the angles, then the dihedrals plus pi set from the
    chain's middle towards both ends (the centre stays planar)."""
    mean = distances.mean(0, keepdim=True).expand(angles.shape[0], -1)
    xyz = chain_in_plane(mean, angles)
    dih = dihedrals + math.pi
    n_at, n_di = xyz.shape[1], dih.shape[1]
    split, mid = n_at // 2, n_di // 2
    cut = mid if n_di % 2 == 0 else mid + 1
    left = curl_one_way(dih[:, :cut].flip(1), xyz[:, :split + 2].flip(1))
    right = curl_one_way(dih[:, cut:], xyz[:, split - 1:])
    return torch.cat([left.flip(1), right[:, 3:]], 1)


def flat_pair_dists(xyz: torch.Tensor) -> torch.Tensor:
    """``(B, n (n - 1) / 2)`` distances of the atom pairs i < j, row-major."""
    n = xyz.shape[1]
    i, j = torch.triu_indices(n, n, offset=1, device=xyz.device)
    return torch.linalg.norm(xyz[:, i] - xyz[:, j], dim=-1)


def adam(W: dict, g: dict, m: dict, v: dict, t: int, lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7) -> None:
    """One Adam step in place, on gradients already clipped, with bias
    correction and eps after the square root (Keras' Adam)."""
    for k in W:
        m[k] = b1 * m[k] + (1 - b1) * g[k]
        v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
        mhat = m[k] / (1 - b1 ** t)
        vhat = v[k] / (1 - b2 ** t)
        W[k] = W[k] - lr * mhat / (torch.sqrt(vhat) + eps)


def follow(loss_fn, weights: dict, batches, lr: float, clip: float,
           dtype: torch.dtype, device) -> dict:
    """Train from ``weights`` on each batch in turn (a list of callables
    giving the batch's tensors in ``dtype``): the loss before each step,
    the first step's clipped gradient, and each leaf's change after the
    first step and after all steps."""
    W = {k: w.detach().to(device=device, dtype=dtype).clone() for k, w in weights.items()}
    W0 = {k: w.clone() for k, w in W.items()}
    m = {k: torch.zeros_like(w) for k, w in W.items()}
    v = {k: torch.zeros_like(w) for k, w in W.items()}
    losses, grad1, delta1 = [], None, None
    for t, batch in enumerate(batches, start=1):
        leaves = {k: w.requires_grad_(True) for k, w in W.items()}
        loss = loss_fn(leaves, batch())
        grads = torch.autograd.grad(loss, list(leaves.values()))
        g = {k: torch.clamp(gr, -clip, clip) for k, gr in zip(leaves, grads)}
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = g
        with torch.no_grad():
            W = {k: w.detach() for k, w in W.items()}
            adam(W, g, m, v, t, lr)
        if delta1 is None:
            delta1 = {k: W[k] - W0[k] for k in W}
    return {"losses": losses, "grad1": grad1, "delta1": delta1,
            "delta": {k: W[k].detach() - W0[k] for k in W}}
