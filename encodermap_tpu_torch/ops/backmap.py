# encodermap_tpu_torch/ops/backmap.py
"""Backmapping: internal coordinates (bond lengths, angles, dihedrals) -> xyz.

Counterpart of the training and generation part of
``encodermap_tpu/ops/backmap.py``:

* :func:`chain_in_plane` places a planar zig-zag chain in closed form: the
  heading recurrence ``a_{i+1} = pi - angle_i - a_i`` is a cumsum with
  alternating signs, and the positions are cumsums of the rotated bonds.
* :func:`dihedrals_to_cartesian` curls both halves of the chain out of the
  plane. A rotation about an axis that earlier rotations moved telescopes
  into ``C_i = B_0 ∘ B_1 ∘ ... ∘ B_i`` of rotations ``B_i`` about the FIXED
  planar axes, so each half-chain is one cumulative quaternion product
  (``_one_way``), the rotated planar bonds and their cumsum. Rotations
  only are composed: an affine scan cancels badly on long chains.
* ``_one_way`` is a :class:`torch.autograd.Function` whose backward is the
  hand-derived adjoint of the JAX package's ``_one_way_bwd``: suffix sums
  give the bond, torsion and axis pullbacks. On the card it launches one
  kernel each way (``csrc/backmap_one_way.cu``); CPU tensors run the plain
  versions :func:`_one_way_fwd_plain` and :func:`_one_way_bwd_plain`.

In the plain version the cumulative product, which has no
``associative_scan`` in PyTorch, runs as ``ceil(log2 n)`` doubling rounds
over the whole chain, keeping the JAX package's operand order (the earlier
product on the left). The JAX
package's TPU-only layouts (the MXU suffix sums, stacked against
per-component planes, both halves in one padded call) are not ported: the
port takes the forms the JAX package takes on the CPU. Quaternions are
``(4, B, n)`` tensors ``(w, x, y, z)``, vectors ``(3, B, n)``.

* :func:`backmap_multimer` rebuilds each protein of a multimer with
  :func:`backmap` and places proteins 2..N by ``(B, 4, 4)`` homogeneous
  transforms, a plain full-float32 product (TF32 stays off). Wherever a
  gradient is taken its whole backward runs under the span
  ``adc.backmap_backward`` (``_tracing.backward_in_span``), on either
  device and with the spans on or off.
* :func:`guess_amide_H`, :func:`guess_amide_O` and :func:`merge_cartesians`
  add the sp2 hydrogens and oxygens; :func:`rotation_matrices` and
  :func:`straight_tetrahedral_chain` are the JAX package's helpers.
"""

from __future__ import annotations

import ctypes
import functools
from math import pi
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .._tracing import backward_in_span
from . import _build

__all__ = [
    "chain_in_plane",
    "dihedrals_to_cartesian",
    "dihedral_to_cartesian_one_way",
    "split_and_reverse_dihedrals",
    "split_and_reverse_cartesians",
    "backmap",
    "backmap_multimer",
    "straight_tetrahedral_chain",
    "rotation_matrices",
    "guess_sp2_atom",
    "guess_amide_H",
    "guess_amide_O",
    "merge_cartesians",
]

_LIB = "backmap_one_way"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_build.register(_LIB, [
    ("em_one_way_fwd", [_I, _P, _L, _L, _P, _L, _L, _L, _I, _I, _P, _P, _P]),
    ("em_one_way_bwd", [_I, _P, _L, _L, _P, _L, _L, _L, _P, _P, _L, _L, _L, _I, _I, _P,
                        _P, _P]),
])


def _signs(pattern_even: float, start: int, stop: int, like: torch.Tensor
           ) -> torch.Tensor:
    """``pattern_even`` at even indices of ``start..stop-1``, its negative
    at odd ones; made on ``like``'s device (no host-to-device copy)."""
    idx = torch.arange(start, stop, device=like.device)
    return (1 - 2 * (idx % 2)).to(like.dtype) * pattern_even


def chain_in_plane(lengths: torch.Tensor, angles: torch.Tensor
                   ) -> torch.Tensor:
    """Place a zig-zag chain in the xy-plane.

    Args:
        lengths: ``(batch, n_atoms - 1)`` bond lengths.
        angles: ``(batch, n_atoms - 2)`` bond angles.

    Returns:
        ``(batch, n_atoms, 3)`` coordinates with z == 0. With
        ``s_j = (-1)^(j+1) (pi - angles_j)`` the heading before bond i is
        ``(-1)^i sum_{j<i} s_j`` and bond i's y-step carries ``(-1)^i``.
    """
    n_bonds, n_angles = lengths.shape[-1], angles.shape[-1]
    if n_bonds != n_angles + 1:
        raise ValueError(f"{n_bonds} bond lengths need {n_bonds - 1} angles, "
                         f"got {n_angles}")
    s = _signs(-1.0, 0, n_angles, angles)[None, :] * (pi - angles)
    csum = torch.cumsum(s, dim=-1)
    zeros = torch.zeros((angles.shape[0], 1), dtype=angles.dtype,
                        device=angles.device)
    heading = torch.cat([zeros, _signs(1.0, 1, n_bonds, angles)[None, :] * csum],
                        dim=-1)
    dx = lengths * torch.cos(heading)
    dy = lengths * torch.sin(heading) * _signs(1.0, 0, n_bonds, angles)[None, :]
    xs = torch.cat([zeros, torch.cumsum(dx, dim=-1)], dim=-1)
    ys = torch.cat([zeros, torch.cumsum(dy, dim=-1)], dim=-1)
    return torch.stack([xs, ys, torch.zeros_like(xs)], dim=-1)


def _quat_compose(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``f ⊗ g`` of ``(4, ...)`` quaternions:
    ``R(f ⊗ g) = R(f) R(g)``, so g's rotation applies first."""
    fw, fv, gw, gv = f[0], f[1:], g[0], g[1:]
    w = fw * gw - (fv * gv).sum(0)
    v = fw * gv + gw * fv + torch.linalg.cross(fv, gv, dim=0)
    return torch.cat([w[None], v], dim=0)


def _quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[:1], -q[1:]], dim=0)


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``(3, ...)`` vectors by ``(4, ...)`` quaternions (broadcast):
    ``v + 2w (r x v) + 2 r x (r x v)`` with ``q = (w, r)``."""
    w, r = q[0], q[1:]
    t = 2.0 * torch.linalg.cross(r, v, dim=0)
    return v + w * t + torch.linalg.cross(r, t, dim=0)


def _cumulative_quats(q: torch.Tensor) -> torch.Tensor:
    """``C_i = q_0 ⊗ q_1 ⊗ ... ⊗ q_i`` along the last axis, in
    ``ceil(log2 n)`` doubling rounds: at offset k, element i >= k becomes
    ``C[i-k] ⊗ C[i]`` (earlier product on the left, as in the JAX scan)."""
    n, k = q.shape[-1], 1
    while k < n:
        q = torch.cat([q[..., :k], _quat_compose(q[..., :-k], q[..., k:])],
                      dim=-1)
        k *= 2
    return q


def _suffix_sums(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = sum_{m >= i} x[..., m]`` (flip, cumsum, flip)."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), dim=-1), (-1,))


def _one_way_fwd_plain(dihedrals: torch.Tensor, cartesian: torch.Tensor
                      ) -> tuple[torch.Tensor, tuple]:
    """Plain version of the forward kernel: the curled ``(B, n + 3, 3)``
    coordinates of one half-chain, and the tensors
    :func:`_one_way_bwd_plain` takes."""
    c = cartesian.permute(2, 0, 1)                  # (3, B, n + 3)
    u = c[:, :, 2:-1] - c[:, :, 1:-2]               # axes, (3, B, n)
    ulen = torch.sqrt((u * u).sum(0))
    a = u / ulen
    # the reference's x @ R_rodrigues(axis, -d) is a column rotation by
    # +d: q = (cos(d/2), sin(d/2) a)
    half = 0.5 * dihedrals
    q = torch.cat([torch.cos(half)[None], torch.sin(half)[None] * a], 0)
    q_scan = _cumulative_quats(q)
    # the last atom shares C_{n-1} with the one before it
    q_cum = torch.cat([q_scan, q_scan[..., -1:]], dim=-1)
    r = _quat_rotate(q_cum, c[:, :, 2:] - c[:, :, 1:-1])  # (3, B, n + 1)
    moved = c[:, :, 1:2] + torch.cumsum(r, dim=-1)
    out = torch.cat([c[:, :, :2], moved], -1).permute(1, 2, 0).contiguous()
    return out, (dihedrals, q_scan, q_cum, r, a, ulen)


def _one_way_bwd_plain(saved: tuple, grad: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the cotangents of the
    dihedrals and the planar coordinates, from what
    :func:`_one_way_fwd_plain` saved and the output's cotangent ``grad``."""
    dihedrals, q_scan, q_cum, r, a, ulen = saved
    B, n = dihedrals.shape
    g = grad.permute(2, 0, 1)                       # (3, B, n + 3)
    G = _suffix_sums(g[:, :, 2:])                   # (3, B, n + 1)
    b_bar = _quat_rotate(_quat_conj(q_cum), G)
    # torsion and moment sums; bond m sits at index m - 2, so
    # "m >= i + 2" starts at index i
    sums = _suffix_sums(torch.cat(
        [torch.linalg.cross(r, G, dim=0),
         (r[:, None] * G[None]).reshape(9, B, n + 1)], dim=0))
    d_bar = (r[..., :n] * sums[:3, :, :n]).sum(0) / ulen
    M = sums[3:].reshape(3, 3, B, n + 1)[..., :n]
    ident = torch.zeros_like(q_scan[..., :1])
    ident[0] = 1.0
    q_im1 = torch.cat([ident, q_scan[..., :n - 1]], dim=-1)
    half_n = _quat_rotate(_quat_conj(q_scan)[:, None], M)   # R_i^T M_i
    N = _quat_rotate(_quat_conj(q_im1)[:, None],
                     half_n.transpose(0, 1)).transpose(0, 1)
    vee = torch.stack([N[1, 2] - N[2, 1], N[2, 0] - N[0, 2],
                       N[0, 1] - N[1, 0]])
    sym_a = ((N + N.transpose(0, 1)) * a[None]).sum(1)
    a_bar = torch.sin(dihedrals) * vee + (1.0 - torch.cos(dihedrals)) * sym_a
    u_bar = (a_bar - a * (a * a_bar).sum(0)) / ulen
    # planar-coordinate cotangent: bonds b_m = q_m - q_{m-1}
    # (m = 2..n+2) and axes u_i = q_{i+2} - q_{i+1}
    v = torch.zeros_like(g)
    v[:, :, 0] = g[:, :, 0]
    v[:, :, 1] = g[:, :, 1] + g[:, :, 2:].sum(-1)
    v[:, :, 2:] += b_bar
    v[:, :, 1:-1] -= b_bar
    v[:, :, 2:-1] += u_bar
    v[:, :, 1:-2] -= u_bar
    return d_bar, v.permute(1, 2, 0)


def _one_way_fwd(dihedrals: torch.Tensor, cartesian: torch.Tensor
                ) -> tuple[torch.Tensor, tuple]:
    """The forward kernel for CUDA tensors, its plain version for CPU
    tensors: the curled coordinates and the tensors :func:`_one_way_bwd`
    takes (for the kernel: the inputs and ``C_0..C_{n-1}``, ``(B, n, 4)``)."""
    if not _build.kernel_route((dihedrals, cartesian), "the one-way kernels"):
        return _one_way_fwd_plain(dihedrals, cartesian)
    B, n = dihedrals.shape
    if n < 1 or cartesian.shape != (B, n + 3, 3):
        raise ValueError(f"(B, n >= 1) dihedrals and (B, n + 3, 3) coordinates "
                         f"expected, got {tuple(dihedrals.shape)} and "
                         f"{tuple(cartesian.shape)}")
    out = torch.empty((B, n + 3, 3), dtype=dihedrals.dtype, device=dihedrals.device)
    cum = torch.empty((B, n, 4), dtype=dihedrals.dtype, device=dihedrals.device)
    _build.launch(_LIB, "em_one_way_fwd", int(dihedrals.dtype == torch.float64),
                  dihedrals.data_ptr(), *dihedrals.stride(), cartesian.data_ptr(),
                  *cartesian.stride(), B, n, out.data_ptr(), cum.data_ptr())
    return out, (dihedrals, cartesian, cum)


def _one_way_bwd(saved: tuple, grad: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel for CUDA tensors, its plain version for CPU
    tensors: the cotangents of the dihedrals and the planar coordinates."""
    if not _build.kernel_route((saved[0], grad), "the one-way kernels"):
        return _one_way_bwd_plain(saved, grad)
    dihedrals, cartesian, cum = saved
    if grad.shape != cartesian.shape:
        raise ValueError(f"a {tuple(cartesian.shape)} cotangent expected, got "
                         f"{tuple(grad.shape)}")
    B, n = dihedrals.shape
    d_bar = torch.empty_like(dihedrals, memory_format=torch.contiguous_format)
    v = torch.empty((B, n + 3, 3), dtype=grad.dtype, device=grad.device)
    _build.launch(_LIB, "em_one_way_bwd", int(dihedrals.dtype == torch.float64),
                  dihedrals.data_ptr(), *dihedrals.stride(), cartesian.data_ptr(),
                  *cartesian.stride(), cum.data_ptr(), grad.data_ptr(), *grad.stride(),
                  B, n, d_bar.data_ptr(), v.data_ptr())
    return d_bar, v


class _OneWay(torch.autograd.Function):
    """One half-chain: ``(B, n)`` dihedrals and ``(B, n + 3, 3)`` planar
    coordinates in, curled ``(B, n + 3, 3)`` coordinates out.

    With ``y_k = q_1 + sum_{m<=k} R_{c(m)} b_m`` (``b_m`` planar bonds, R the
    cumulative rotations, ``c(m) = min(m-2, n-1)``) the backward is:

    * bond pullback ``b_bar_m = R_{c(m)}^T G_m``, ``G_m = sum_{k>=m} g_k``;
    * torsion pullback ``d_bar_i = a_i^fin . sum_{m>=i+2} r_m x G_m``
      (``a^fin = r_{i+2} / |u_i|``, r the rotated bonds);
    * axis pullback through ``N_i = R_i^T M_i R_{i-1}``,
      ``M_i = sum_{m>=i+2} r_m G_m^T``:
      ``a_bar_i = sin(d_i) vee(N_i) + (1 - cos d_i)(N_i + N_i^T) a_i``,
      then ``u_bar = (I - a a^T) a_bar / |u|``.

    CUDA tensors (float32 or float64) go through one hand-written kernel
    each way (``csrc/backmap_one_way.cu``), CPU tensors through the plain
    versions :func:`_one_way_fwd_plain` and :func:`_one_way_bwd_plain`; any
    other type or device raises. The kernels replace no Pallas kernel (the
    JAX package's ``_one_way`` is plain jnp under a ``custom_vjp``): they
    take the plain version's ~140 launches of a few microseconds each down
    to one. What bounds them is the latency of the scan chain, not bytes or
    operations. One warp per sample walks the chain in tiles of 32 bonds:
    a warp scan of the quaternions (the earlier product on the left, so up
    to 32 dihedrals associate as :func:`_cumulative_quats` does) and of the
    rotated bonds, each carried into the next tile; the backward walks the
    tiles from the end with reversed scans and carries, and writes each
    atom's cotangent without atomics, so it is bit-reproducible. Each
    launch counts in ``_build.launch_counts`` under ``one_way_fwd`` and
    ``one_way_bwd``.
    """

    @staticmethod
    def forward(ctx, dihedrals, cartesian):
        out, saved = _one_way_fwd(dihedrals, cartesian)
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _one_way_bwd(ctx.saved_tensors, grad)


def dihedral_to_cartesian_one_way(dihedrals: torch.Tensor,
                                  cartesian: torch.Tensor) -> torch.Tensor:
    """Curl one half-chain out of the plane, setting its dihedrals in turn
    (reference ``misc/backmapping.py:1873-1912``), through ``_one_way``.

    Args:
        dihedrals: ``(batch, n)`` dihedral angles.
        cartesian: ``(batch, n + 3, 3)`` planar chain coordinates.
    """
    if dihedrals.ndim != 2:
        raise ValueError(f"dihedrals must be (batch, n), got {dihedrals.shape}")
    n = dihedrals.shape[-1]
    if n == 0:
        return cartesian
    if cartesian.shape[-2] != n + 3:
        raise ValueError(f"{n} dihedrals need {n + 3} atoms, got "
                         f"{cartesian.shape[-2]}")
    return _OneWay.apply(dihedrals, cartesian)


def split_and_reverse_dihedrals(x: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Left half (reversed) and right half of the dihedrals (reference
    ``misc/backmapping.py:179-214``)."""
    middle = x.shape[1] // 2
    if x.shape[1] % 2 == 0:
        return x[:, :middle].flip(1), x[:, middle:]
    return x[:, :middle + 1].flip(1), x[:, middle + 1:]


def split_and_reverse_cartesians(x: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Left half (reversed) and right half of the atoms, sharing three
    atoms (reference ``misc/backmapping.py:217-256``)."""
    split = x.shape[1] // 2
    return x[:, :split + 2].flip(1), x[:, split - 1:]


def dihedrals_to_cartesian(dihedrals: torch.Tensor, cartesians: torch.Tensor
                           ) -> torch.Tensor:
    """Both-ways dihedral application: the chain centre stays planar and
    both tails curl into 3-D (reference ``misc/backmapping.py:259-307``),
    one ``_one_way`` call per half."""
    cart_left, cart_right = split_and_reverse_cartesians(cartesians)
    dih_left, dih_right = split_and_reverse_dihedrals(dihedrals)
    new_left = dihedral_to_cartesian_one_way(dih_left, cart_left)
    new_right = dihedral_to_cartesian_one_way(dih_right, cart_right)
    return torch.cat([new_left.flip(1), new_right[:, 3:]], dim=1)


def backmap(distances: torch.Tensor, angles: torch.Tensor,
            dihedrals: torch.Tensor, gather: Optional[Callable] = None) -> torch.Tensor:
    """The BackMapLayer (reference ``models/layers.py:913-987``): the batch
    mean of the RAW bond lengths (the reference's negative-distance guard
    never reaches its mean), ``chain_in_plane``, then ``dihedrals + pi``
    curled in both ways.

    Args:
        distances: ``(batch, n_atoms - 1)``.
        angles: ``(batch, n_atoms - 2)``.
        dihedrals: ``(batch, n_atoms - 3)``.
        gather: in a data-parallel step, the function that gathers every
            rank's rows, so the mean is the global batch's.

    Returns:
        ``(batch, n_atoms, 3)``.

    Example:
        >>> import torch
        >>> from encodermap_tpu_torch.ops.backmap import backmap
        >>> xyz = backmap(torch.full((2, 4), 0.15), torch.full((2, 3), 2.0),
        ...               torch.zeros((2, 2)))
        >>> tuple(xyz.shape)
        (2, 5, 3)
        >>> round(float(torch.linalg.norm(xyz[0, 1] - xyz[0, 0])), 5)
        0.15
    """
    rows = gather(distances) if gather is not None else distances
    mean_lengths = torch.mean(rows, dim=0, keepdim=True).expand(angles.shape[0], -1)
    chain = chain_in_plane(mean_lengths, angles)
    return dihedrals_to_cartesian(dihedrals + pi, chain)


def straight_tetrahedral_chain(n_atoms: Optional[int] = None,
                               bond_lengths: Optional[np.ndarray] = None
                               ) -> np.ndarray:
    """A straight chain with tetrahedral-ish geometry, in numpy (reference
    ``encodermap_tf1/backmapping.py:71-94``)."""
    dx = np.cos(70.63 / 180 * np.pi)
    dy = np.sin(70.63 / 180 * np.pi)
    if n_atoms is not None and bond_lengths is None:
        coordinates = np.zeros((n_atoms, 3), dtype=np.float32)
        indices = np.repeat(np.arange(int(n_atoms / 2) + 1), 2)
        coordinates[:, 0] = indices[1:n_atoms + 1] + dx * indices[0:n_atoms]
        coordinates[:, 1] = dy * indices[0:n_atoms]
        return coordinates
    if bond_lengths is not None:
        bond_lengths = np.asarray(bond_lengths)
        n_bonds = len(bond_lengths)
        n_atoms = n_atoms or n_bonds + 1
        dxs = bond_lengths * np.tile([1, dx], int(n_atoms / 2))[:n_bonds]
        dys = bond_lengths * np.tile([0, dy], int(n_atoms / 2))[:n_bonds]
        coordinates = np.zeros((n_atoms, 3), dtype=np.float32)
        coordinates[1:, 0] = np.cumsum(dxs)
        coordinates[1:, 1] = np.cumsum(dys)
        return coordinates
    raise ValueError("provide n_atoms or bond_lengths")


def rotation_matrices(axis_unit: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` Rodrigues matrices for row vectors, ``x @ R`` (the
    reference's convention, ``misc/backmapping.py:1950-1970``): a column
    rotation by ``-angle`` about the ``(..., 3)`` unit axes."""
    x, y, z = axis_unit[..., 0], axis_unit[..., 1], axis_unit[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([torch.stack([zeros, -z, y], dim=-1),
                     torch.stack([z, zeros, -x], dim=-1),
                     torch.stack([-y, x, zeros], dim=-1)], dim=-2)
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis_unit.dtype, device=axis_unit.device)
    outer = axis_unit[..., :, None] * axis_unit[..., None, :]
    return c * eye + s * K + (1.0 - c) * outer


def guess_sp2_atom(cartesians: torch.Tensor, indices: Sequence[int],
                   angle_to_previous: float, bond_length: float) -> torch.Tensor:
    """sp2-bonded atoms (H on N, O on C): the previous bond, rotated about
    the local plane's normal and scaled to ``bond_length`` (reference
    ``misc/backmapping.py:1920-1941``), for every index at once."""
    idx = np.asarray(indices, dtype=np.int64)
    prev_vec = cartesians[:, idx - 1] - cartesians[:, idx]
    next_idx = np.where(idx + 1 < cartesians.shape[1], idx + 1, idx - 2)
    next_vec = cartesians[:, next_idx] - cartesians[:, idx]
    normal = torch.linalg.cross(prev_vec, next_vec, dim=-1)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    R = rotation_matrices(normal, torch.full(prev_vec.shape[:-1], angle_to_previous,
                                             dtype=cartesians.dtype,
                                             device=cartesians.device))
    bond_vec = (prev_vec[..., None, :] @ R)[..., 0, :]
    bond_vec = bond_vec * (bond_length / torch.linalg.norm(bond_vec, dim=-1, keepdim=True))
    return cartesians[:, idx] + bond_vec


def guess_amide_H(cartesians: torch.Tensor, N_indices: Sequence[int]) -> torch.Tensor:
    """Amide H at 123 deg and 1.10 from each backbone N but the first
    (reference ``misc/backmapping.py:1944-1945``)."""
    return guess_sp2_atom(cartesians, list(N_indices)[1:], 123 / 180 * pi, 1.10)


def guess_amide_O(cartesians: torch.Tensor, C_indices: Sequence[int]) -> torch.Tensor:
    """Carbonyl O at 121 deg and 1.24 from each backbone C (reference
    ``misc/backmapping.py:1948-1949``)."""
    return guess_sp2_atom(cartesians, list(C_indices), 121 / 180 * pi, 1.24)


def merge_cartesians(central_cartesians: torch.Tensor, N_indices: Sequence[int],
                     O_indices: Sequence[int], H_cartesians: torch.Tensor,
                     O_cartesians: torch.Tensor) -> torch.Tensor:
    """The guessed H and O atoms interleaved into the backbone chain
    (reference ``misc/backmapping.py:1973-1990``), as one gather whose
    order is fixed on the host."""
    n_central = central_cartesians.shape[1]
    N_set, O_set = set(list(N_indices)[1:]), set(O_indices)
    source, h_i, o_i = [(0, 0)], 0, 0
    for i in range(1, n_central):
        source.append((0, i))
        if i in N_set:
            source.append((1, h_i))
            h_i += 1
        elif i in O_set:
            source.append((2, o_i))
            o_i += 1
    arrays = [central_cartesians, H_cartesians, O_cartesians]
    out = torch.cat([arrays[a][:, j:j + 1] for a, j in source], dim=1)
    if out.shape[1] != n_central + H_cartesians.shape[1] + O_cartesians.shape[1]:
        raise ValueError("the N and O indices do not match the guessed atoms")
    return out


def backmap_multimer(protein_lengths: Sequence[int], distances: torch.Tensor,
                     angles: torch.Tensor, dihedrals: torch.Tensor,
                     matrices: torch.Tensor, gather: Optional[Callable] = None
                     ) -> torch.Tensor:
    """Backmap a multimer: each protein's chain rebuilt on its own, proteins
    2..N placed by homogeneous transforms (the documented intent of the
    reference's ``BackMapLayerTransformations``, ``models/layers.py:
    990-1092``).

    Args:
        protein_lengths: residues per protein.
        distances: ``(B, sum 3L_i - 1)``, protein by protein; each
            protein's bond lengths are its batch means, as in :func:`backmap`.
        angles: ``(B, sum 3L_i - 2)``.
        dihedrals: ``(B, sum 3L_i - 3)``.
        matrices: ``(B, n_proteins - 1, 4, 4)`` transforms for row vectors,
            ``[xyz, 1] @ M``, applied as a full-float32 product.
        gather: as :func:`backmap` takes it.

    Returns:
        ``(B, sum 3L_i, 3)``.

    Wherever a gradient is taken, the call goes through
    ``_tracing.backward_in_span``: its backward (both ways of every chain's
    ``_OneWay``, ``chain_in_plane``'s and the placement product's) runs
    inside the span ``adc.backmap_backward``, as autograd through
    :func:`_backmap_multimer_plain` runs it, and while the spans are on the
    counter ``multimer_backmap`` counts its calls, rows and proteins.
    """
    inputs = (distances, angles, dihedrals, matrices)
    fn = functools.partial(_backmap_multimer_plain, list(protein_lengths), gather=gather)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return backward_in_span("adc.backmap_backward", "multimer_backmap", fn, *inputs,
                                proteins=len(protein_lengths))
    return fn(*inputs)


def _backmap_multimer_plain(protein_lengths: Sequence[int], distances: torch.Tensor,
                            angles: torch.Tensor, dihedrals: torch.Tensor,
                            matrices: torch.Tensor, gather: Optional[Callable] = None
                            ) -> torch.Tensor:
    """:func:`backmap_multimer`'s operations, differentiated by autograd."""
    outs = []
    d0 = a0 = di0 = 0
    for i, L in enumerate(protein_lengths):
        nd, na, ndi = 3 * L - 1, 3 * L - 2, 3 * L - 3
        xyz = backmap(distances[:, d0:d0 + nd], angles[:, a0:a0 + na],
                      dihedrals[:, di0:di0 + ndi], gather)
        if i != 0:
            homo = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)
            xyz = (homo @ matrices[:, i - 1])[..., :3]
        outs.append(xyz)
        d0, a0, di0 = d0 + nd, a0 + na, di0 + ndi
    return torch.cat(outs, dim=1)
