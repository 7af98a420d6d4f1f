# encodermap_tpu_torch/ops/adc_adjoint.py
"""Hand-derived analytic adjoint of the full ADC training step: a float64
gradient oracle.

Counterpart of ``encodermap_tpu/ops/adc_adjoint.py``. ``hand_adc_step`` is
the forward pass and the closed-form backward pass of the ADC step in plain
PyTorch, on the device of the tensors it is given: the encoder and decoder
MLP with the unit-circle fold-in and the atan2 fold-out, the batch-mean-bond
planar chain, the two-way quaternion dihedral curl, the CA pair distances,
and the loss stack of ``train/adc_autoencoder.py::_loss_terms`` (reference
``models.py:2260-2459``).

Every pullback is closed-form:

* periodic mean-abs losses: the min-image branch flips the sign of the
  subgradient past P/2;
* atan2 fold-out: d atan2(s, c) = (c, -s) / (s^2 + c^2);
* Cartesian loss -> CA positions: signed unit pair vectors scattered to
  the two endpoints;
* dihedral curl: the suffix-sum adjoint of the one-way rotation sweep,
  applied per half-chain with the reversal bookkeeping of the split;
* chain-in-plane: three more suffix sums through the alternating-sign
  heading cumsum.

It is an oracle because it shares no code with what it checks: it calls
neither ``ops/backmap.py`` (whose ``_one_way`` has its own
``autograd.Function``), nor ``ops/fused_sigmoid.py`` (the sigmoid-loss
kernels), nor ``losses.py``. The quaternion products, the sketch-map
sigmoid and its derivative are written out here. The prefix product of the
quaternions is a plain loop, where the JAX package takes an associative
scan: the same product, rounded in another order. Call it with float64
tensors to hold a float32 step to it (``tests/test_torch_adc_adjoint.py``,
``chip_smoke.py::phase_adc``).
"""

from __future__ import annotations

from math import pi
from typing import Optional

import torch

__all__ = ["hand_adc_step"]


def _mm_t1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T @ b``."""
    return a.transpose(0, 1) @ b


def _mm_t2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b^T``."""
    return a @ b.transpose(0, 1)


# --------------------------------------------------------------------------
# quaternions as 4-tuples of component tensors (w, x, y, z)
# --------------------------------------------------------------------------


def _quat_mul(f: tuple, g: tuple) -> tuple:
    """Hamilton product ``f ⊗ g``: the rotation of ``g`` first, then ``f``'s."""
    fw, fx, fy, fz = f
    gw, gx, gy, gz = g
    return (
        fw * gw - fx * gx - fy * gy - fz * gz,
        fw * gx + fx * gw + fy * gz - fz * gy,
        fw * gy - fx * gz + fy * gw + fz * gx,
        fw * gz + fx * gy - fy * gx + fz * gw,
    )


def _quat_conj(q: tuple) -> tuple:
    w, x, y, z = q
    return (w, -x, -y, -z)


def _quat_rot(q: tuple, v: tuple) -> tuple:
    """Rotate the vectors ``v`` (3 component tensors) by ``q``:
    ``v' = v + w t + r x t`` with ``t = 2 r x v``, ``q = (w, r)``."""
    w, x, y, z = q
    vx, vy, vz = v
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    return (
        vx + w * tx + (y * tz - z * ty),
        vy + w * ty + (z * tx - x * tz),
        vz + w * tz + (x * ty - y * tx),
    )


def _quat_prefix(q: tuple) -> tuple:
    """``q_0 ⊗ q_1 ⊗ ... ⊗ q_i`` for every i along dim 1."""
    acc = tuple(c[:, 0] for c in q)
    out = [acc]
    for i in range(1, q[0].shape[1]):
        acc = _quat_mul(acc, tuple(c[:, i] for c in q))
        out.append(acc)
    return tuple(torch.stack([o[k] for o in out], dim=1) for k in range(4))


def _rev_cumsum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def _comps(v: torch.Tensor) -> tuple:
    return v[..., 0], v[..., 1], v[..., 2]


# --------------------------------------------------------------------------
# the backmap: one-way rotation sweep, chain in plane, both halves
# --------------------------------------------------------------------------


def _one_way_fwd(d: torch.Tensor, x: torch.Tensor) -> tuple:
    """Rotate the chain ``x`` ``(B, n + 3, 3)`` about its bonds into the
    dihedrals ``d`` ``(B, n)``, keeping every intermediate."""
    u = x[:, 2:-1, :] - x[:, 1:-2, :]
    ulen = torch.sqrt(torch.sum(torch.square(u), dim=-1, keepdim=True))
    axis = u / ulen
    half = 0.5 * d
    s = torch.sin(half)
    q = (torch.cos(half), s * axis[..., 0], s * axis[..., 1], s * axis[..., 2])
    q_scan = _quat_prefix(q)
    q_ext = tuple(torch.cat([c, c[:, -1:]], dim=1) for c in q_scan)
    bonds = x[:, 2:, :] - x[:, 1:-1, :]
    r = torch.stack(_quat_rot(q_ext, _comps(bonds)), dim=-1)
    out = torch.cat([x[:, :2, :], x[:, 1:2, :] + torch.cumsum(r, dim=1)], dim=1)
    return out, (q_scan, q_ext, r, axis, ulen, d)


def _rot_cols(q: tuple, m: torch.Tensor) -> torch.Tensor:
    """``R(q) @ m`` for ``(..., 3, 3)`` matrices: each column rotated."""
    cols = [_quat_rot(q, (m[..., 0, c], m[..., 1, c], m[..., 2, c])) for c in range(3)]
    return torch.stack([torch.stack([cols[c][rr] for c in range(3)], dim=-1)
                        for rr in range(3)], dim=-2)


def _one_way_bwd(res: tuple, g: torch.Tensor) -> tuple:
    """The analytic adjoint of :func:`_one_way_fwd`: ``(d_bar, x_bar)``."""
    q_scan, q_ext, r, axis, ulen, d = res
    B, n = d.shape
    G = _rev_cumsum(g[:, 2:, :])
    b_bar = torch.stack(_quat_rot(_quat_conj(q_ext), _comps(G)), dim=-1)
    t = torch.linalg.cross(r, G, dim=-1)
    T = _rev_cumsum(t)
    a_fin = r[:, :n, :] / ulen
    d_bar = torch.sum(a_fin * T[:, :n, :], dim=-1)

    outer = r[..., :, None] * G[..., None, :]
    M = _rev_cumsum(outer)[:, :n]
    q_i = tuple(c[:, :n] for c in q_scan)

    def shifted(c: torch.Tensor, v: float) -> torch.Tensor:
        return torch.cat([torch.full((B, 1), v, dtype=c.dtype, device=c.device),
                          c[:, :n - 1]], dim=1)

    q_im1 = (shifted(q_scan[0], 1.0),) + tuple(shifted(c, 0.0) for c in q_scan[1:])
    half_n = _rot_cols(_quat_conj(q_i), M)
    N = _rot_cols(_quat_conj(q_im1), half_n.transpose(-1, -2)).transpose(-1, -2)
    vee = torch.stack([N[..., 1, 2] - N[..., 2, 1], N[..., 2, 0] - N[..., 0, 2],
                       N[..., 0, 1] - N[..., 1, 0]], dim=-1)
    sin_d = torch.sin(d)[..., None]
    cos_d = torch.cos(d)[..., None]
    Na = torch.einsum("...ij,...j->...i", N, axis)
    NTa = torch.einsum("...ji,...j->...i", N, axis)
    a_bar = sin_d * vee + (1.0 - cos_d) * (Na + NTa)
    u_bar = (a_bar - axis * torch.sum(axis * a_bar, dim=-1, keepdim=True)) / ulen

    x_bar = torch.zeros((B, n + 3, 3), dtype=g.dtype, device=g.device)
    x_bar[:, 0] = g[:, 0]
    x_bar[:, 1] = g[:, 1] + torch.sum(g[:, 2:], dim=1)
    x_bar[:, 2:] += b_bar
    x_bar[:, 1:-1] -= b_bar
    x_bar[:, 2:-1] += u_bar
    x_bar[:, 1:-2] -= u_bar
    return d_bar, x_bar


def _alternating(n: int, first: float, like: torch.Tensor, start: int = 0) -> torch.Tensor:
    """``first`` at the even and ``-first`` at the odd indices of
    ``start, ..., start + n - 1``."""
    idx = torch.arange(start, start + n, device=like.device)
    return torch.where(idx % 2 == 0, first, -first).to(like.dtype)


def _chain_in_plane_fwd(lengths: torch.Tensor, angles: torch.Tensor) -> tuple:
    """The planar zig-zag chain of ``lengths`` and ``angles``, with the
    intermediates kept."""
    n_bonds = lengths.shape[-1]
    n_angles = angles.shape[-1]
    signs_a = _alternating(n_angles, -1.0, angles)
    csum = torch.cumsum(signs_a[None, :] * (pi - angles), dim=-1)
    sign_i = _alternating(n_bonds - 1, 1.0, angles, start=1)
    zeros = torch.zeros((angles.shape[0], 1), dtype=angles.dtype, device=angles.device)
    heading = torch.cat([zeros, sign_i[None, :] * csum], dim=-1)
    y_sign = _alternating(n_bonds, 1.0, angles)
    dx = lengths * torch.cos(heading)
    dy = lengths * torch.sin(heading) * y_sign[None, :]
    xs = torch.cat([zeros, torch.cumsum(dx, dim=-1)], dim=-1)
    ys = torch.cat([zeros, torch.cumsum(dy, dim=-1)], dim=-1)
    chain = torch.stack([xs, ys, torch.zeros_like(xs)], dim=-1)
    return chain, (lengths, heading, signs_a, sign_i, y_sign)


def _chain_in_plane_bwd(res: tuple, g: torch.Tensor) -> torch.Tensor:
    """Angle pullback of the planar chain (the lengths carry no parameter
    gradient: they come from the input distances)."""
    lengths, heading, signs_a, sign_i, y_sign = res
    # positions are prefix sums of the bond steps
    dxb = _rev_cumsum(g[:, 1:, 0])
    dyb = _rev_cumsum(g[:, 1:, 1])
    h_bar = lengths * (-torch.sin(heading) * dxb
                       + torch.cos(heading) * y_sign[None, :] * dyb)
    # heading_i = sign_i * csum_{i-1} for i >= 1
    s_bar = _rev_cumsum(sign_i[None, :] * h_bar[:, 1:])
    return -signs_a[None, :] * s_bar


def _split_dihedrals(d: torch.Tensor) -> tuple:
    """The left half-chain's dihedrals (reversed) and the right's."""
    n = d.shape[1]
    middle = n // 2
    left = middle if n % 2 == 0 else middle + 1
    return torch.flip(d[:, :left], (1,)), d[:, left:], left


def _backmap_fwd(distances: torch.Tensor, angles: torch.Tensor,
                 dihedrals: torch.Tensor) -> tuple:
    """Backbone coordinates from internal coordinates: the raw-distance
    batch mean of the bond lengths (the reference's negative-distance guard
    is dead code), the planar chain, then each half rotated outward from
    the middle."""
    mean_lengths = torch.mean(distances, dim=0, keepdim=True).expand(
        angles.shape[0], distances.shape[1])
    chain, cres = _chain_in_plane_fwd(mean_lengths, angles)
    d_left, d_right, left = _split_dihedrals(dihedrals + pi)
    split = chain.shape[1] // 2
    c_left = torch.flip(chain[:, :split + 2], (1,))
    c_right = chain[:, split - 1:]
    new_left, res_l = _one_way_fwd(d_left, c_left)
    new_right, res_r = _one_way_fwd(d_right, c_right)
    out = torch.cat([torch.flip(new_left, (1,)), new_right[:, 3:]], dim=1)
    return out, (cres, res_l, res_r, split, left, dihedrals.shape[1])


def _backmap_bwd(res: tuple, g: torch.Tensor) -> tuple:
    """``(d_bar, angle_bar)`` of :func:`_backmap_fwd` for the coordinate
    cotangent ``g``."""
    cres, res_l, res_r, split, left, n = res
    B, n_atoms = g.shape[:2]
    g_left = torch.flip(g[:, :split + 2], (1,))
    g_right = torch.cat([torch.zeros((B, 3, 3), dtype=g.dtype, device=g.device),
                         g[:, split + 2:]], dim=1)
    dl_bar, xl_bar = _one_way_bwd(res_l, g_left)
    dr_bar, xr_bar = _one_way_bwd(res_r, g_right)
    chain_bar = torch.zeros((B, n_atoms, 3), dtype=g.dtype, device=g.device)
    chain_bar[:, :split + 2] += torch.flip(xl_bar, (1,))
    chain_bar[:, split - 1:] += xr_bar
    ang_bar = _chain_in_plane_bwd(cres, chain_bar)
    d_bar = torch.cat([torch.flip(dl_bar, (1,)), dr_bar], dim=1)
    return d_bar, ang_bar


# --------------------------------------------------------------------------
# periodic mean-abs costs and the sketch-map sigmoid cost
# --------------------------------------------------------------------------


def _periodic_mean_abs_and_grad(y_true: torch.Tensor, y_pred: torch.Tensor,
                                periodicity: float, scale: float) -> tuple:
    """``cost = scale * mean(min(|d|, P - |d|))``, ``d = y_pred - y_true``,
    and its gradient with respect to ``y_pred``."""
    d = torch.abs(y_pred - y_true)
    if periodicity == float("inf"):
        md = d
        flip = torch.ones_like(d)
    else:
        flip = torch.where(d <= periodicity - d, 1.0, -1.0).to(d.dtype)
        md = torch.minimum(d, periodicity - d)
    cost = scale * torch.mean(md)
    g = (scale / d.numel()) * flip * torch.sign(y_pred - y_true)
    return cost, g


def _sig(r: torch.Tensor, sig: float, a: float, b: float) -> torch.Tensor:
    """The sketch-map sigmoid ``1 - (1 + c (r / sig)^a)^(-b / a)``,
    ``c = 2^(a / b) - 1``."""
    c = 2.0 ** (a / b) - 1.0
    return 1.0 - (1.0 + c * (r / sig) ** a) ** (-b / a)


def _dsig_over_r(r2: torch.Tensor, r: torch.Tensor, sig: float, a: float,
                 b: float) -> torch.Tensor:
    """``s'(r) / r``: the smooth form for ``a == 2``, else a form guarded
    at ``r = 0`` (``r2`` is exactly 0 there)."""
    c = 2.0 ** (a / b) - 1.0
    if a == 2:
        base = 1.0 + c * r2 / sig ** 2
        return (b * c / sig ** 2) * base ** (-b / a - 1.0)
    r_safe = torch.where(r2 == 0.0, torch.ones_like(r), r)
    t = (r_safe / sig) ** a
    out = b * c * t * (1.0 + c * t) ** (-b / a - 1.0) / torch.square(r_safe)
    return torch.where(r2 == 0.0, torch.zeros_like(out), out)


def _batch_pairdist2_gram(x: torch.Tensor) -> torch.Tensor:
    """``(B, B)`` squared distances between the rows of ``x`` (Gram form)."""
    sq = torch.sum(torch.square(x), dim=1)
    d2 = sq[:, None] - 2.0 * _mm_t2(x, x) + sq[None, :]
    return torch.clamp(d2, min=0.0)


def _batch_pairdist2_periodic(x: torch.Tensor, periodicity: float) -> torch.Tensor:
    """``(B, B)`` squared min-image distances between the rows of ``x``
    (the whole ``(B, B, F)`` difference tensor: transparent, not fast)."""
    d = torch.abs(x[:, None, :] - x[None, :, :])
    d = torch.minimum(d, periodicity - d)
    return torch.sum(d * d, dim=-1)


def _sigmoid_loss_and_latgrad(feats: torch.Tensor, lat: torch.Tensor, params: tuple,
                              scale: float, periodicity: float = float("inf")) -> tuple:
    """The sketch-map cost ``scale * mean((s_l(D_l) - s_h(D_h))^2)`` over
    all row pairs of ``feats`` and ``lat``, min-image on the high-D side
    when ``periodicity`` is finite; returns ``(loss, d loss / d lat)``.
    Only ``lat`` gets a gradient."""
    sig_h, a_h, b_h, sig_l, a_l, b_l = params
    B = feats.shape[0]
    if periodicity == float("inf"):
        dh2 = _batch_pairdist2_gram(feats)
    else:
        dh2 = _batch_pairdist2_periodic(feats, periodicity)
    notdiag = 1.0 - torch.eye(B, dtype=dh2.dtype, device=dh2.device)
    dh2 = dh2 * notdiag
    mask_h = (dh2 == 0.0).to(feats.dtype)
    dh = torch.sqrt(dh2 + mask_h * 1e-16) * (1.0 - mask_h)
    dl2 = torch.zeros((B, B), dtype=lat.dtype, device=lat.device)
    for k in range(lat.shape[1]):
        col = lat[:, k]
        diff = col[:, None] - col[None, :]
        dl2 = dl2 + diff * diff
    mask_l = (dl2 == 0.0).to(lat.dtype)
    dl = torch.sqrt(dl2 + mask_l * 1e-16) * (1.0 - mask_l)
    sdiff = _sig(dl, sig_l, a_l, b_l) - _sig(dh, sig_h, a_h, b_h)
    loss = scale * torch.mean(torch.square(sdiff))
    M = (4.0 * scale / (B * B)) * sdiff * _dsig_over_r(dl2, dl, sig_l, a_l, b_l)
    row = torch.sum(M, dim=1)
    g_lat = row[:, None] * lat - M @ lat
    return loss, g_lat


# --------------------------------------------------------------------------
# the full step
# --------------------------------------------------------------------------


def hand_adc_step(enc_w: list, enc_b: list, dec_w: list, dec_b: list,
                  angles: torch.Tensor, dihedrals: torch.Tensor, ca_xyz: torch.Tensor,
                  distances: torch.Tensor, side: Optional[torch.Tensor],
                  step, *, hyper: dict) -> tuple:
    """Forward pass and hand-derived parameter gradients of the ADC step.

    Args:
        enc_w/enc_b/dec_w/dec_b: the MLP's kernels ``(din, dout)`` and
            biases ``(dout,)``, tanh between the layers, linear ends.
        angles/dihedrals/distances/side: the CV batch; ``side`` may be None.
        ca_xyz: ``(B, n_ca, 3)`` input positions of the pair-cost atoms
            (sliced from the Cartesians already).
        step: the global step (a number or 0-d tensor), for the
            soft-started Cartesian scale.
        hyper: periodicity, the cost scales and references,
            ``cartesian_dist_sig_parameters``, ``dist_sig_parameters``,
            ``soft_start`` (``(a, b)`` or None), ``center_cost_scale``,
            ``l2_reg_constant``, ``ca_start``, ``ca_step`` and ``pair_iu``
            (the two index arrays of the upper-triangle pairs).

    Returns:
        ``(g_enc_w, g_enc_b, g_dec_w, g_dec_b, metrics)``: lists of
        gradients like the parameters, and the loss terms with ``"loss"``
        (their sum) and ``"cartesian_cost_scale"``.
    """
    h = hyper
    P = h["periodicity"]
    dev = angles.device

    # ---------------- encoder
    def unit_circle(x):
        xs = x if P == 2 * pi else x / P * 2 * pi
        return torch.cat([torch.sin(xs), torch.cos(xs)], dim=1)

    groups = [unit_circle(angles), unit_circle(dihedrals)]
    raw_groups = [angles, dihedrals]
    if side is not None:
        groups.append(unit_circle(side))
        raw_groups.append(side)
    x0 = torch.cat(groups, dim=1)

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

    # ---------------- periodic fold-out per group
    widths = [angles.shape[1], dihedrals.shape[1]] + (
        [side.shape[1]] if side is not None else [])
    outs, trig = [], []
    off = 0
    for nk in widths:
        s_ = dec_out[:, off:off + nk]
        c_ = dec_out[:, off + nk:off + 2 * nk]
        off += 2 * nk
        o = torch.atan2(s_, c_)
        if P != 2 * pi:
            o = o / (2 * pi) * P
        outs.append(o)
        trig.append((s_, c_, s_ * s_ + c_ * c_))
    out_angles, out_dihedrals = outs[0], outs[1]
    out_side = outs[2] if side is not None else None

    # ---------------- geometry
    back, bres = _backmap_fwd(distances, out_angles, out_dihedrals)
    ca_back = back[:, h["ca_start"]::h["ca_step"], :]
    i0 = torch.as_tensor(h["pair_iu"][0], dtype=torch.long, device=dev)
    i1 = torch.as_tensor(h["pair_iu"][1], dtype=torch.long, device=dev)

    def flat_pairs(pos):
        diff = pos[:, i0, :] - pos[:, i1, :]
        d2 = torch.sum(torch.square(diff), dim=-1)
        mask = (d2 == 0.0).to(pos.dtype)
        return torch.sqrt(d2 + mask * 1e-16) * (1.0 - mask), diff

    inp_pair, _ = flat_pairs(ca_xyz)
    out_pair, out_diff = flat_pairs(ca_back)

    # ---------------- losses
    metrics = {}
    dih_cost, g_out_dih = _periodic_mean_abs_and_grad(
        dihedrals, out_dihedrals, P,
        h["dihedral_cost_scale"] / h["dihedral_cost_reference"])
    ang_cost, g_out_ang = _periodic_mean_abs_and_grad(
        angles, out_angles, P, h["angle_cost_scale"] / h["angle_cost_reference"])
    metrics["dihedral_loss"] = dih_cost
    metrics["angle_loss"] = ang_cost
    if side is not None:
        side_cost, g_out_side = _periodic_mean_abs_and_grad(
            side, out_side, P,
            h["side_dihedral_cost_scale"] / h["side_dihedral_cost_reference"])
        metrics["side_dihedral_loss"] = side_cost

    # the soft-started Cartesian scale, in the inputs' dtype: the JAX
    # package's oracle makes the constant scale and the instant switch-on
    # float32, which leaves its Cartesian gradient ~1e-8 off its own loss's
    if h["soft_start"] is None:
        cscale = torch.tensor(h["cartesian_cost_scale"], dtype=angles.dtype, device=dev)
    else:
        a, b = h["soft_start"]
        step_t = torch.as_tensor(step, device=dev).to(angles.dtype)
        if a == b:
            # an instant switch-on: (step - a) / 0 would give NaN at step == a
            frac = (step_t >= a).to(angles.dtype)
        else:
            frac = torch.clamp((step_t - a) / float(b - a), 0.0, 1.0)
        cscale = h["cartesian_cost_scale"] * frac
    pair_n = inp_pair.numel()
    metrics["cartesian_loss"] = cscale / h["cartesian_cost_reference"] * torch.mean(
        torch.abs(inp_pair - out_pair))

    cd_loss, g_lat_cd = _sigmoid_loss_and_latgrad(
        inp_pair, lat, h["cartesian_dist_sig_parameters"],
        h["cartesian_distance_cost_scale"])
    metrics["cartesian_distance_loss"] = cd_loss

    if h["distance_cost_scale"] is not None:
        d_loss, g_lat_d = _sigmoid_loss_and_latgrad(
            torch.cat(raw_groups, dim=1), lat, h["dist_sig_parameters"],
            h["distance_cost_scale"], periodicity=P)
    else:
        d_loss, g_lat_d = torch.zeros((), dtype=angles.dtype, device=dev), 0.0
    metrics["distance_loss"] = d_loss

    metrics["center_loss"] = h["center_cost_scale"] * torch.mean(torch.square(lat))
    metrics["regularization_loss"] = h["l2_reg_constant"] * (
        sum(torch.sum(torch.square(w)) for w in enc_w)
        + sum(torch.sum(torch.square(w)) for w in dec_w))
    metrics["loss"] = sum(v for v in metrics.values())
    metrics["cartesian_cost_scale"] = cscale

    # ---------------- backward
    # Cartesian loss -> CA positions
    g_pair = (cscale / h["cartesian_cost_reference"] / pair_n) * torch.sign(
        out_pair - inp_pair)
    safe = torch.where(out_pair == 0.0, torch.ones_like(out_pair), out_pair)
    w_pair = (g_pair / safe)[..., None] * out_diff
    g_ca = torch.zeros_like(ca_back)
    g_ca.index_add_(1, i0, w_pair)
    g_ca.index_add_(1, i1, -w_pair)

    # the CA gradients into the full chain's positions
    g_back = torch.zeros_like(back)
    g_back[:, h["ca_start"]::h["ca_step"], :] = g_ca

    d_bar, a_bar = _backmap_bwd(bres, g_back)
    g_out_dih = g_out_dih + d_bar
    g_out_ang = g_out_ang + a_bar

    # the periodic outputs' pullbacks into the decoder's cotangent
    g_blocks = []
    outs_g = [g_out_ang, g_out_dih] + ([g_out_side] if side is not None else [])
    for (s_, c_, n2), go in zip(trig, outs_g):
        if P != 2 * pi:
            go = go / (2 * pi) * P
        g_blocks.append(torch.cat([go * c_ / n2, -go * s_ / n2], dim=1))
    g_dec_out = torch.cat(g_blocks, dim=1)

    # decoder backprop
    g_dec_w = [None] * n_dec
    g_dec_b = [None] * n_dec
    delta = g_dec_out
    for i in range(n_dec - 1, -1, -1):
        if i < n_dec - 1:
            act = acts_d[i + 1]
            delta = delta * (1.0 - act * act)
        g_dec_w[i] = _mm_t1(acts_d[i], delta)
        g_dec_b[i] = torch.sum(delta, dim=0)
        delta = _mm_t2(delta, dec_w[i])
    g_lat = delta + g_lat_cd + g_lat_d
    g_lat = g_lat + (2.0 * h["center_cost_scale"] / lat.numel()) * lat

    # encoder backprop
    g_enc_w = [None] * n_enc
    g_enc_b = [None] * n_enc
    delta = g_lat
    for i in range(n_enc - 1, -1, -1):
        if i < n_enc - 1:
            act = acts_e[i + 1]
            delta = delta * (1.0 - act * act)
        g_enc_w[i] = _mm_t1(acts_e[i], delta)
        g_enc_b[i] = torch.sum(delta, dim=0)
        if i > 0:
            delta = _mm_t2(delta, enc_w[i])

    g_enc_w = [g + 2.0 * h["l2_reg_constant"] * w for g, w in zip(g_enc_w, enc_w)]
    g_dec_w = [g + 2.0 * h["l2_reg_constant"] * w for g, w in zip(g_dec_w, dec_w)]
    return g_enc_w, g_enc_b, g_dec_w, g_dec_b, metrics
