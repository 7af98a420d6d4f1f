# encodermap_tpu_torch/ops/fused_train.py
"""A chunk of EncoderMap optimizer steps in one hand-written CUDA kernel.

Counterpart of ``encodermap_tpu/ops/pallas_train.py``. Two kernels replace
``pallas_train.py::_fused_kernel``; each of their steps gathers a batch from
the device-resident dataset, runs the tanh MLP autoencoder forward, the four
EncoderMap losses (auto mean_abs, center, L2, sketch-map sigmoid over all
B x B pairs; min-image where periodic), the hand-derived backward pass of
:func:`hand_step`, the clip to +-1 and Adam, and writes one metrics row:

- ``csrc/fused_train_cluster.cu``: one thread-block cluster of
  :data:`CLUSTER` CTAs with the batch rows split across them and the
  activations in shared memory;
- ``csrc/fused_train.cu``: one cooperative launch over the whole card: the
  batch in row groups of :data:`GRID_CLUSTER`-CTA clusters, tiled
  products, four grid-wide barriers a step (:func:`grid_plan` sizes it).

:func:`fused_route` picks one by shape before the launch: the grid kernel
from :data:`GRID_MIN_BATCH` rows on, and wherever the cluster kernel's
per-CTA footprint (:func:`cluster_footprint`) exceeds the 227 KB of shared
memory a block may use. Both evaluate each sketch-map pair with
``csrc/sigmoid_pairs.cuh`` (s = 1 - u^e without the cancellation of
1 - u^e near u = 1), as the sigmoid-loss kernels do. Their plain version
is :func:`fused_chunk_plain`: :func:`hand_step` plus :func:`_adam_update`,
looped over the steps, with the JAX package's 1 - (1 + c t)^e.
:func:`fused_chunk` launches a kernel for CUDA tensors and runs the plain
version only for CPU tensors.

Unlike the TPU kernel, the fold-out uses the native ``atan2``: the TPU needed
the polynomial ``_poly_atan2`` only because Mosaic has no atan2.
"""

from __future__ import annotations

import ctypes
from math import pi
from typing import Optional

import torch

from .._tracing import span
from . import _build
from .clip_adam import _adam_update
from .distances import dsig_over_r, pairwise_dist, sig_value

__all__ = [
    "hand_step",
    "fused_chunk",
    "fused_chunk_plain",
    "fused_trainer_available",
    "config_covered",
    "cluster_footprint",
    "fused_route",
    "grid_plan",
    "grid_launch_plan",
    "split_params",
    "join_params",
    "make_fused_trainer",
]

_LIB = "fused_train"
_CLUSTER_LIB = "fused_train_cluster"
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_build.register(_LIB, [
    ("em_fused_train_max_clusters", [_I, _P]),
    ("em_fused_train", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _D, _P,
                        _P, _P, _P, _P, _P]),
])
_build.register(_CLUSTER_LIB, [
    ("em_fused_train_cluster", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                _D, _P, _P, _P, _P]),
])

#: CTAs per cluster of the cluster kernel, ``kCluster`` in its source: 16
#: (a non-portable size Hopper allows) ran faster than 8 at the main
#: configuration (PERF.md)
CLUSTER = 16
#: shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
#: layers (encoder + decoder) the kernels' layer tables hold
MAX_LAYERS = 16
#: phases of the cluster kernel's cycle trace (``Phase`` in its source)
CLUSTER_PHASES = ("gather", "stage weights", "forward", "wait: losses",
                  "losses", "pair gradients", "backward: delta",
                  "backward: partial", "wait: reduce", "reduce + Adam",
                  "wait: update")
_THREADS, _METRICS = 256, 4
#: phases of the grid kernel's cycle trace (``Phase`` in its source)
GRID_PHASES = ("gather", "forward", "losses", "wait: latents", "pairs",
               "wait: pair slots", "pair gradients", "backward",
               "wait: gradients", "Adam", "wait: update")
#: batch from which :func:`fused_route` takes the grid kernel where the
#: cluster kernel could run too: on the H100 the grid kernel's step is
#: nearly flat in the batch (latency and barriers), the cluster kernel's
#: grows with its rows per CTA. At [128,128,2] the grid kernel took 99.3
#: against 121.7 us a step at B=288 and 98.8 against 95.6 at B=256; at
#: [64,64,2] 68.2 against 70.0 at B=256, which one threshold leaves to the
#: cluster kernel (PERF.md, ``scripts/fused_chunk_time.py``)
GRID_MIN_BATCH = 288
#: CTAs per row group of the grid kernel, ``kCluster`` in its source (the
#: kernel refuses a plan made with other tile constants than its own)
GRID_CLUSTER = 8
#: output tile edge of the grid kernel's products (``kTile``): a row
#: group's rows are a whole number of tiles
GRID_TILE = 32
#: pair tile edge of the grid kernel's sketch-map phase (``kPair``)
PAIR_TILE = 64

METRIC_NAMES = ("auto_loss", "center_loss", "regularization_loss",
                "distance_loss", "loss")


def _pairdist2(x: torch.Tensor) -> torch.Tensor:
    """(B, B) squared distances, one (B, B) plane per column."""
    return pairwise_dist(x, squared=True, method="direct")[0]


def hand_step(enc_w: list, enc_b: list, dec_w: list, dec_b: list,
              batch: torch.Tensor, *, dist_sig_parameters: tuple,
              auto_cost_scale: float, center_cost_scale: float,
              l2_reg_constant: float, distance_cost_scale: float,
              periodicity: float = float("inf")):
    """Forward pass and hand-derived gradients of the fused configuration.

    ``periodicity < inf`` adds the dihedral handling: sin/cos fold-in, atan2
    fold-out, min-image auto loss and min-image pairwise distances on the
    high-D side of the sigmoid loss.

    Returns ``(grads_enc_w, grads_enc_b, grads_dec_w, grads_dec_b,
    metrics)`` with ``metrics = (auto, center, reg, dist, total)``.
    """
    B, d0 = batch.shape
    periodic = periodicity != float("inf")

    if periodic:
        xs = batch if periodicity == 2 * pi else batch / periodicity * 2 * pi
        x0 = torch.cat([torch.sin(xs), torch.cos(xs)], dim=1)
    else:
        x0 = batch
    acts_e = [x0]
    n_enc = len(enc_w)
    for i in range(n_enc):
        z = acts_e[-1] @ enc_w[i] + enc_b[i]
        acts_e.append(torch.tanh(z) if i < n_enc - 1 else z)
    lat = acts_e[-1]
    acts_d = [lat]
    n_dec = len(dec_w)
    for i in range(n_dec):
        z = acts_d[-1] @ dec_w[i] + dec_b[i]
        acts_d.append(torch.tanh(z) if i < n_dec - 1 else z)
    dec_out = acts_d[-1]
    if periodic:
        s_half, c_half = dec_out[:, :d0], dec_out[:, d0:]
        norm2 = s_half * s_half + c_half * c_half
        out = torch.atan2(s_half, c_half)
        if periodicity != 2 * pi:
            out = out / (2 * pi) * periodicity
    else:
        out = dec_out

    # losses
    if periodic:
        ad = torch.abs(batch - out)
        one = torch.ones_like(ad)
        flip = torch.where(ad <= periodicity - ad, one, -one)
        auto = auto_cost_scale * torch.mean(torch.minimum(ad, periodicity - ad))
    else:
        diff = batch - out
        auto = auto_cost_scale * torch.mean(torch.abs(diff))
    center = center_cost_scale * torch.mean(torch.square(lat))
    reg = l2_reg_constant * (sum(torch.sum(torch.square(w)) for w in enc_w)
                             + sum(torch.sum(torch.square(w)) for w in dec_w))
    sig_h, a_h, b_h, sig_l, a_l, b_l = dist_sig_parameters
    if periodic:
        dh2 = torch.zeros((B, B), dtype=batch.dtype, device=batch.device)
        for k in range(d0):
            col = batch[:, k]
            dd = torch.abs(col[:, None] - col[None, :])
            dd = torch.minimum(dd, periodicity - dd)
            dh2 = dh2 + dd * dd
    else:
        dh2 = _pairdist2(batch)
    dl2 = _pairdist2(lat)
    mask_h = (dh2 == 0.0).to(batch.dtype)
    dh = torch.sqrt(dh2 + mask_h * 1e-16) * (1.0 - mask_h)
    mask_l = (dl2 == 0.0).to(lat.dtype)
    dl = torch.sqrt(dl2 + mask_l * 1e-16) * (1.0 - mask_l)
    sdiff = sig_value(dl, sig_l, a_l, b_l) - sig_value(dh, sig_h, a_h, b_h)
    dist = distance_cost_scale * torch.mean(torch.square(sdiff))
    total = auto + center + reg + dist

    # backward: auto (mean_abs)
    if periodic:
        g_out = (auto_cost_scale / (B * d0)) * flip * torch.sign(out - batch)
        if periodicity != 2 * pi:
            g_out = g_out / (2 * pi) * periodicity
        g_out = torch.cat([g_out * c_half / norm2, -g_out * s_half / norm2],
                          dim=1)
    else:
        g_out = (-auto_cost_scale / (B * d0)) * torch.sign(diff)

    g_dec_w, g_dec_b = [None] * n_dec, [None] * n_dec
    delta = g_out
    for i in range(n_dec - 1, -1, -1):
        if i < n_dec - 1:
            a = acts_d[i + 1]
            delta = delta * (1.0 - a * a)
        g_dec_w[i] = acts_d[i].T @ delta
        g_dec_b[i] = torch.sum(delta, dim=0)
        delta = delta @ dec_w[i].T
    g_lat = delta + (2.0 * center_cost_scale / lat.numel()) * lat

    # sigmoid distance: dL/dlat_k = (4*scale/B^2) sum_j sdiff_kj
    #   * s_l'(D_kj)/D_kj * (lat_k - lat_j)
    M = (4.0 * distance_cost_scale / (B * B)) * sdiff * dsig_over_r(
        dl2, dl, sig_l, a_l, b_l)
    g_lat = g_lat + torch.sum(M, dim=1)[:, None] * lat - M @ lat

    g_enc_w, g_enc_b = [None] * n_enc, [None] * n_enc
    delta = g_lat
    for i in range(n_enc - 1, -1, -1):
        if i < n_enc - 1:
            a = acts_e[i + 1]
            delta = delta * (1.0 - a * a)
        g_enc_w[i] = acts_e[i].T @ delta
        g_enc_b[i] = torch.sum(delta, dim=0)
        if i > 0:
            delta = delta @ enc_w[i].T

    for i in range(n_enc):
        g_enc_w[i] = g_enc_w[i] + 2.0 * l2_reg_constant * enc_w[i]
    for i in range(n_dec):
        g_dec_w[i] = g_dec_w[i] + 2.0 * l2_reg_constant * dec_w[i]
    metrics = torch.stack([auto, center, reg, dist, total])
    return g_enc_w, g_enc_b, g_dec_w, g_dec_b, metrics


def fused_trainer_available(p, params, input_dim: int = 0) -> bool:
    """Whether the fused kernel covers this configuration: parameters on the
    card (where the JAX package asks for the TPU backend) and
    :func:`config_covered`."""
    if params is None or params["encoder"][0]["kernel"].device.type != "cuda":
        return False
    return config_covered(p, params, input_dim)


def config_covered(p, params, input_dim: int = 0) -> bool:
    """The kernel's configuration gates, whatever the device: no densifier,
    a decoder (the output layer may be the narrowest, and then the whole
    stack is the encoder), at most 32 input columns, tanh hidden layers with
    linear ends, mean_abs auto cost, float32, and every loss scale set."""
    if params is not None and ("densifier" in params or not params["decoder"]):
        return False
    if input_dim > 32:
        return False
    acts = list(p.activation_functions)
    if acts[0] != "" or any(a != "tanh" for a in acts[1:-1]) or acts[-1] != "":
        return False
    if p.auto_cost_variant != "mean_abs":
        return False
    if p.compute_dtype != "float32":
        return False
    return all(scale is not None for scale in
               (p.auto_cost_scale, p.center_cost_scale, p.distance_cost_scale))


def split_params(params: dict) -> tuple[list, int]:
    """Flatten ``{"encoder": [...], "decoder": [...]}`` into the kernel
    layout ``[enc_w..., dec_w..., enc_b(1,d)..., dec_b(1,d)...]``."""
    enc, dec = params["encoder"], params["decoder"]
    flat = ([l["kernel"] for l in enc] + [l["kernel"] for l in dec]
            + [l["bias"][None, :] for l in enc]
            + [l["bias"][None, :] for l in dec])
    return flat, len(enc)


def join_params(flat: list, n_enc: int, n_dec: int) -> dict:
    """Inverse of :func:`split_params`."""
    n_w = n_enc + n_dec
    ws, bs = flat[:n_w], flat[n_w:]
    enc = [{"kernel": ws[i], "bias": bs[i][0]} for i in range(n_enc)]
    dec = [{"kernel": ws[n_enc + i], "bias": bs[n_enc + i][0]}
           for i in range(n_dec)]
    return {"encoder": enc, "decoder": dec}


def _hand_step_args(flat: list, n_enc: int):
    n_w = len(flat) // 2
    ws, bs = flat[:n_w], [b[0] for b in flat[n_w:]]
    return ws[:n_enc], bs[:n_enc], ws[n_enc:], bs[n_enc:]


def fused_chunk_plain(params_flat: list, mu_flat: list, nu_flat: list,
                      step0: float, data: torch.Tensor, idx: torch.Tensor, *,
                      n_enc: int, hyper: dict):
    """Plain version of the kernel: ``steps = idx.shape[0]`` steps of
    :func:`hand_step` and :func:`_adam_update` on batches ``data[idx[s]]``.
    Returns ``(params_flat, mu_flat, nu_flat, metrics (steps, 5))``."""
    p, m, v = list(params_flat), list(mu_flat), list(nu_flat)
    rows = []
    for s in range(idx.shape[0]):
        gew, geb, gdw, gdb, met = hand_step(
            *_hand_step_args(p, n_enc), data[idx[s]], **hyper["losses"])
        grads = (list(gew) + list(gdw) + [g[None, :] for g in geb]
                 + [g[None, :] for g in gdb])
        t = float(step0) + s + 1.0
        for i in range(len(p)):
            p[i], m[i], v[i] = _adam_update(p[i], m[i], v[i], grads[i], t,
                                            hyper["learning_rate"])
        rows.append(met)
    return p, m, v, torch.stack(rows)


def _pack(tensors: list) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors]).to(torch.float32)


def _unpack(flat: torch.Tensor, like: list) -> list:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def cluster_footprint(dims: list, n_enc: int, B: int, d0: int) -> dict:
    """Shared-memory bytes one CTA of the cluster kernel needs, by item, and
    their ``"total"``: the formula of ``layout()`` in
    ``csrc/fused_train_cluster.cu``. ``dims = [d_in, widths of the L
    layers]``; each CTA holds ``R = ceil(B / CLUSTER)`` batch rows."""
    if len(dims) - 1 > MAX_LAYERS:
        raise ValueError(f"{len(dims) - 1} layers exceed the kernels' layer "
                         f"table of {MAX_LAYERS}")
    R = -(-B // CLUSTER)
    maxw, dl = max(dims), dims[n_enc]
    # two buffers of whole float4s, each one layer's weights, rows of
    # dout + 4 where they are whole float4s in the flat parameters (else
    # dout + 1), then its (din + 1) x dout partial weight and bias gradients
    weights, w_off = 0, 0
    for din, dout in zip(dims[:-1], dims[1:]):
        ld = dout + 4 if w_off % 4 == 0 and dout % 4 == 0 else dout + 1
        weights = max(weights, din * ld, (din + 1) * dout)
        w_off += din * dout
    floats = dict(
        weights=2 * (-(-weights // 4) * 4),
        activations=R * sum(dims),       # every layer's input and output
        deltas=2 * R * maxw,             # this layer's delta and the next
        gathered=B * (d0 + dl),          # every row's raw input and latent
        rows=R * (d0 + dl),              # own raw rows, their pair gradient
        pairs=2 * R * (B // 2),          # own rows' pair terms, both halves
        other=maxw + _THREADS + 2 * _METRICS,  # bias, block sums, metrics
    )
    out = {k: 4 * v for k, v in floats.items()}
    out["total"] = sum(out.values())
    return out


def grid_plan(dims: list, n_enc: int, B: int, d0: int,
              max_clusters: int) -> dict:
    """How the grid kernel (``csrc/fused_train.cu``) cuts a step: the batch
    in ``groups`` row groups of ``rows`` rows (a whole number of
    :data:`GRID_TILE`-row tiles, the last group ragged), each one cluster
    of :data:`GRID_CLUSTER` CTAs, as many groups as the tiles give up to the
    ``max_clusters`` the card holds at once; ``pair_tiles`` tiles of
    :data:`PAIR_TILE` x :data:`PAIR_TILE` pairs over the upper triangle;
    and its global scratch by item in floats, in the order the items lie
    in scratch, with their ``"total"``. The kernel takes the groups, the
    rows and the items' sizes from this plan (:func:`_plan_array`).
    ``dims = [d_in, widths of the L layers]``."""
    if len(dims) - 1 > MAX_LAYERS:
        raise ValueError(f"{len(dims) - 1} layers exceed the kernels' layer "
                         f"table of {MAX_LAYERS}")
    if max_clusters < 1:
        raise ValueError("the card holds no cluster of the grid kernel")
    tiles = -(-B // GRID_TILE)
    per = -(-tiles // max_clusters)       # tiles per group
    groups = -(-tiles // per)
    rows = GRID_TILE * -(-tiles // groups)
    dl = dims[n_enc]
    ctas = groups * GRID_CLUSTER
    nt = -(-B // PAIR_TILE)
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    floats = dict(
        batch=B * d0,                    # the raw rows
        activations=B * sum(dims),       # every layer's input and output
        deltas=2 * groups * rows * max(dims),  # this layer's and the next
        pair_grad=B * dl,                # the sketch-map latent gradient
        pair_slots=nt * dl * B,          # per row and partner tile
        partials=2 * ctas * _METRICS,    # metric sums per CTA, two steps
        grad_slots=groups * n_params,    # weight gradients per row group
    )
    floats["total"] = sum(floats.values())
    return dict(cluster=GRID_CLUSTER, groups=groups, rows=rows, ctas=ctas,
                tile=GRID_TILE, pair_tile=PAIR_TILE,
                pair_tiles=nt * (nt + 1) // 2, floats=floats)


def _plan_array(plan: dict):
    """The plan as the grid kernel's C entry takes it (``Plan`` in its
    source): groups, rows, the tile constants, the scratch items' sizes."""
    items = [v for k, v in plan["floats"].items() if k != "total"]
    return (ctypes.c_longlong * (5 + len(items)))(
        plan["groups"], plan["rows"], GRID_CLUSTER, GRID_TILE, PAIR_TILE, *items)


_max_clusters: dict = {}


def _grid_clusters(lib, periodic: bool) -> int:
    """Clusters of the grid kernel the card holds at once (cached)."""
    if periodic not in _max_clusters:
        out = ctypes.c_int(0)
        _build.check_cuda(lib, lib.em_fused_train_max_clusters(
            int(periodic), ctypes.byref(out)), "fused_train occupancy")
        _max_clusters[periodic] = out.value
    return _max_clusters[periodic]


def fused_route(dims: list, n_enc: int, B: int, d0: int) -> str:
    """The kernel that trains this shape: ``"fused_train_cluster"`` below
    :data:`GRID_MIN_BATCH` rows where one CTA's :func:`cluster_footprint`
    fits in :data:`MAX_SMEM_BYTES`, else ``"fused_train"``. Raises past
    the layer table."""
    fits = cluster_footprint(dims, n_enc, B, d0)["total"] <= MAX_SMEM_BYTES
    return _CLUSTER_LIB if fits and B < GRID_MIN_BATCH else _LIB


def grid_launch_plan(dims: list, n_enc: int, B: int, d0: int,
                     periodic: bool) -> dict:
    """:func:`grid_plan` with the clusters this card holds (builds the
    grid kernel first if needed)."""
    lib = _build.load_library(_LIB)
    return grid_plan(dims, n_enc, B, d0, _grid_clusters(lib, periodic))


def _check_clocks(clocks: Optional[torch.Tensor], shape: tuple,
                  device: torch.device) -> None:
    if clocks is not None and (clocks.dtype != torch.int64
                               or tuple(clocks.shape) != shape
                               or clocks.device != device):
        raise ValueError(f"clocks must be an int64 {shape} tensor on {device}")


def fused_chunk(params_flat: list, mu_flat: list, nu_flat: list,
                step0: float, data: torch.Tensor, idx: torch.Tensor, *,
                n_enc: int, hyper: dict, kernel: Optional[str] = None,
                clocks: Optional[torch.Tensor] = None):
    """Run ``steps = idx.shape[0]`` optimizer steps in one kernel launch.

    Args:
        params_flat: ``[enc_w..., dec_w..., enc_b(1,d)..., dec_b(1,d)...]``.
        mu_flat / nu_flat: Adam moments, same layout.
        step0: optimizer steps taken before this chunk.
        data: ``(n, d0)`` float32 dataset on the device.
        idx: ``(steps, B)`` int64 batch indices into ``data``.
        n_enc: number of encoder layers.
        hyper: ``{"learning_rate": float, "losses": {hand_step kwargs}}``.
        kernel: ``"fused_train_cluster"`` or ``"fused_train"``; by default
            :func:`fused_route` picks one by shape. A cluster kernel that
            does not fit raises.
        clocks: an int64 tensor on the device that receives the kernel's
            cycles per phase, summed over the steps, as thread 0 of each
            CTA sees them: ``(CLUSTER, len(CLUSTER_PHASES))`` for the
            cluster kernel, ``(ctas, len(GRID_PHASES))`` for the grid
            kernel, ``ctas`` from :func:`grid_launch_plan`.

    Returns:
        ``(params_flat, mu_flat, nu_flat, metrics (steps, 5))``.
    """
    if not _build.kernel_route([data], "the fused-train kernels", (torch.float32,)):
        return fused_chunk_plain(params_flat, mu_flat, nu_flat, step0, data,
                                 idx, n_enc=n_enc, hyper=hyper)
    if data.ndim != 2:
        raise TypeError("fused_chunk takes a float32 (n, d0) dataset")
    if idx.ndim != 2:
        raise ValueError(f"idx must be (steps, B), got {tuple(idx.shape)}")
    tensors = list(params_flat) + list(mu_flat) + list(nu_flat)
    if any(t.device != data.device or t.dtype != torch.float32
           for t in tensors):
        raise ValueError("parameters and moments must be float32 on "
                         f"{data.device}")
    steps, B = idx.shape
    n_w = len(params_flat) // 2
    dims = [params_flat[0].shape[0]] + [w.shape[1] for w in params_flat[:n_w]]
    n_dec = n_w - n_enc
    periodic = hyper["losses"].get("periodicity", float("inf")) != float("inf")
    d_in = 2 * data.shape[1] if periodic else data.shape[1]
    if dims[0] != d_in or dims[-1] != d_in or not 0 < n_enc < n_w:
        raise ValueError(f"layer widths {dims} (n_enc={n_enc}) do not fit "
                         f"{data.shape[1]}-column {'periodic ' * periodic}data")
    d0 = data.shape[1]
    route = kernel or fused_route(dims, n_enc, B, d0)
    if route not in (_LIB, _CLUSTER_LIB):
        raise ValueError(f"unknown kernel {route!r}")
    dims_c = (ctypes.c_int * len(dims))(*dims)
    losses = hyper["losses"]
    hyper_c = (ctypes.c_double * 12)(
        losses["auto_cost_scale"], losses["center_cost_scale"],
        losses["l2_reg_constant"], losses["distance_cost_scale"],
        *[float(x) for x in losses["dist_sig_parameters"]],
        losses.get("periodicity", float("inf")), hyper["learning_rate"])
    params = _pack(params_flat)
    mu = _pack(mu_flat)
    nu = _pack(nu_flat)
    data = data.contiguous()
    idx = idx.to(device=data.device, dtype=torch.int64).contiguous()
    metrics = torch.empty((steps, 5), dtype=torch.float32, device=data.device)
    args = (params.data_ptr(), mu.data_ptr(), nu.data_ptr(), data.data_ptr(),
            idx.data_ptr(), steps, B, d0, n_enc, n_dec, dims_c, float(step0),
            hyper_c, metrics.data_ptr())
    if route == _CLUSTER_LIB:
        need = cluster_footprint(dims, n_enc, B, d0)["total"]
        if need > MAX_SMEM_BYTES:
            raise ValueError(f"B={B} at widths {dims} needs {need} bytes of "
                             f"shared memory per CTA of a {CLUSTER}-CTA "
                             f"cluster; a block may use {MAX_SMEM_BYTES}")
        _check_clocks(clocks, (CLUSTER, len(CLUSTER_PHASES)), data.device)
        _build.launch(_CLUSTER_LIB, "em_fused_train_cluster", *args,
                      None if clocks is None else clocks.data_ptr())
    else:
        plan = grid_launch_plan(dims, n_enc, B, d0, periodic)
        _check_clocks(clocks, (plan["ctas"], len(GRID_PHASES)), data.device)
        scratch = torch.empty(plan["floats"]["total"], dtype=torch.float32,
                              device=data.device)
        _build.launch(_LIB, "em_fused_train", *args, scratch.data_ptr(),
                      _plan_array(plan), None if clocks is None else clocks.data_ptr())
    return (_unpack(params, params_flat), _unpack(mu, mu_flat),
            _unpack(nu, nu_flat), metrics)


def hyper_from(p) -> dict:
    """The kernel's hyper-parameters from a :class:`Parameters`."""
    return dict(
        learning_rate=p.learning_rate,
        losses=dict(
            dist_sig_parameters=tuple(p.dist_sig_parameters),
            auto_cost_scale=float(p.auto_cost_scale),
            center_cost_scale=float(p.center_cost_scale),
            l2_reg_constant=float(p.l2_reg_constant),
            distance_cost_scale=float(p.distance_cost_scale),
            periodicity=float(p.periodicity),
        ),
    )


def make_fused_trainer(p, steps_per_scan: int, batch_size: int):
    """A drop-in replacement for ``make_scan_trainer`` for the fused
    configuration: ``(state, data, idx=None) -> (state, metrics)`` running
    the whole chunk in one kernel launch. ``idx`` injects the ``(steps, B)``
    batch indices; without it they are drawn from ``state.rng`` as the
    general trainer draws them. The Adam state keeps the general route's
    ``{"count", "mu", "nu"}`` layout, so checkpoints interchange."""
    from ..train.core import draw_indices

    hyper = hyper_from(p)

    def chunk(state, data, idx: Optional[torch.Tensor] = None):
        with span("trainer.draw", state.step):
            if idx is None:
                idx, rng = draw_indices(state.rng, data.shape[0],
                                        (steps_per_scan, batch_size), data.device)
            else:
                rng = state.rng
        with span("trainer.launch", state.step):
            flat, n_enc = split_params(state.params)
            n_dec = len(state.params["decoder"])
            opt = state.opt_state
            new_flat, new_mu, new_nu, metrics = fused_chunk(
                flat, split_params(opt["mu"])[0], split_params(opt["nu"])[0],
                float(opt["count"]), data, idx, n_enc=n_enc, hyper=hyper)
            steps = idx.shape[0]
            new_opt = {"count": opt["count"] + steps,
                       "mu": join_params(new_mu, n_enc, n_dec),
                       "nu": join_params(new_nu, n_enc, n_dec)}
            new_state = state.replace(params=join_params(new_flat, n_enc, n_dec),
                                      opt_state=new_opt, rng=rng,
                                      step=state.step + steps)
            return new_state, {k: metrics[:, i] for i, k in enumerate(METRIC_NAMES)}

    return chunk
