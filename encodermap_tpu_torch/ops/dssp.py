# encodermap_tpu_torch/ops/dssp.py
"""Secondary-structure assignment (DSSP, Kabsch & Sander 1983) on the
device.

Counterpart of ``encodermap_tpu/ops/dssp.py``, which is float64 numpy; this
is the same algorithm in float64 PyTorch, on the card unless the caller
asks for the CPU. Float64 stays: the hydrogen-bond test is the hard cut
``E < -0.5`` kcal/mol, and float32 rounding would flip bonds near it.

Hydrogen bonds follow the Kabsch–Sander electrostatic model: for the C=O
of residue *i* and the N-H of residue *j*,

    E = 0.084 * 332 * (1/r_ON + 1/r_CH - 1/r_OH - 1/r_CN)   [kcal/mol]

with a bond when ``E < -0.5``. Explicit amide H atoms of the topology are
used when present (MD trajectories carry real protons); otherwise H is
rebuilt from the preceding carbonyl as ``H = N + 1.01 * (C_prev -
O_prev)/|.|`` (1.01 Angstrom). Prolines donate nothing. A chain-initial
residue (no preceding carbonyl) donates only with an explicit H. Chain
breaks (C(i)-N(i+1) longer than 2.5 Angstrom) are found per frame.

From the ``(frames, res, res)`` bond matrix the patterns are assigned with
priority H > B > E > G > I > T > S, later assignments overwriting earlier
ones: n-turns (n = 3, 4, 5), alpha/3-10/pi helices (two consecutive
turns), parallel and antiparallel bridges (a bridged residue with a
bridged neighbour on its chain is a ladder, 'E'; alone it is 'B'),
hydrogen-bonded turns ('T') and bends ('S', kappa > 70 deg).

Where each part runs: the energy matrix, the bond matrix and the pattern
assignment all run on ``device``, frames in blocks whose float64
intermediates stay under ``DSSP_BLOCK_BYTES`` (at 152 residues and 4,096
frames one ``(F, R, R)`` float64 array is 757 MB); the assignment leaves the
device as one byte per residue and frame, and the host turns those codes
into letters. The residue table is read from the topology on the host.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["compute_dssp", "kabsch_sander_hbonds", "kabsch_sander_energy",
           "dssp_backbone"]

_Q1Q2_F = 0.084 * 332.0  # kcal/mol * Angstrom (27.888)
_HBOND_CUTOFF = -0.5  # kcal/mol
_CHAIN_BREAK = 2.5  # Angstrom, longest peptide C(i)-N(i+1)
_MINDIST = 0.5  # Angstrom, guard against overlapping atoms
#: bytes of float64 intermediates one block of frames may hold
DSSP_BLOCK_BYTES = 512 << 20
#: the 8-state letters of the assignment codes, in code order
_LETTERS = np.array([" ", "S", "T", "I", "G", "B", "E", "H"])
_CODE = {c: i for i, c in enumerate(_LETTERS)}
#: 3-state letters of each code: H, G, I -> H; E, B -> E; the rest C
_SIMPLE = np.array(["C", "C", "C", "H", "H", "E", "E", "H"])


def _backbone_table(top):
    """Per-residue (N, CA, C, O) atom indices of the complete protein
    residues, rows dropped for others.

    Returns (table (R, 4), residue_index (R,), is_pro (R,), h_idx (R,)).
    """
    rows, res_idx, is_pro, h_idx = [], [], [], []
    for r in top.residues:
        if not r.is_protein:
            continue
        names = [r.atom(n) for n in ("N", "CA", "C", "O")]
        if names[3] is None:
            # terminal oxygen naming variants
            for alt in ("O1", "OT1", "OC1", "OXT"):
                a = r.atom(alt)
                if a is not None:
                    names[3] = a
                    break
        if any(a is None for a in names):
            continue
        rows.append([a.index for a in names])
        res_idx.append(r.index)
        is_pro.append(r.name == "PRO")
        h = r.atom("H") or r.atom("HN") or r.atom("H1")
        h_idx.append(h.index if h is not None else -1)
    if not rows:
        return (np.zeros((0, 4), np.int64), np.zeros(0, np.int64),
                np.zeros(0, bool), np.zeros(0, np.int64))
    return (np.asarray(rows, np.int64), np.asarray(res_idx, np.int64),
            np.asarray(is_pro, bool), np.asarray(h_idx, np.int64))


def _norm(d: torch.Tensor) -> torch.Tensor:
    """Length over the last axis of 3, summed in numpy's order."""
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])


def _rdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(F, R, R)`` distances between the rows of ``a`` and ``b``, at
    least ``_MINDIST``."""
    return torch.clamp(_norm(a[:, :, None, :] - b[:, None, :, :]), min=_MINDIST)


def kabsch_sander_energy(n: torch.Tensor, ca: torch.Tensor, c: torch.Tensor,
                         o: torch.Tensor, *, is_proline: Optional[Any] = None,
                         h: Optional[torch.Tensor] = None,
                         chain_break: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Kabsch–Sander energies and the pairs that may bond.

    Args:
        n, ca, c, o: ``(F, R, 3)`` float64 backbone coordinates in
            **Angstrom**, on one device.
        is_proline: ``(R,)`` bool, residues that cannot donate.
        h: optional ``(F, R, 3)`` explicit amide H positions (NaN rows where
            there is none: those are rebuilt from the previous carbonyl).
        chain_break: ``(F, R-1)`` or ``(R-1,)`` bool, True where residues i
            and i+1 are not peptide-bonded; found from the C(i)-N(i+1)
            distance when omitted.

    Returns:
        ``(E (F, R, R) kcal/mol, allowed (F, R, R) bool)``: ``E[f, i, j]``
        is the energy of the CO of residue *i* accepting from the NH of *j*;
        ``allowed`` is False where *j* has no H, for i == j, for the
        peptide-bonded successor and where the CAs are 9 Angstrom or more
        apart. The bonds are ``(E < -0.5) & allowed``.
    """
    F, R, _ = n.shape
    dev = n.device
    if chain_break is None:
        chain_break = _norm(c[:, :-1] - n[:, 1:]) > _CHAIN_BREAK
    chain_break = torch.as_tensor(chain_break, dtype=torch.bool,
                                  device=dev).expand(F, R - 1)
    # rebuilt amide H: 1.01 A from N, anti-parallel to the previous carbonyl
    co = c[:, :-1] - o[:, :-1]
    co = co / torch.clamp(_norm(co)[..., None], min=1e-12)
    h_rec = torch.full_like(n, float("nan"))
    h_rec[:, 1:] = torch.where(chain_break[..., None], float("nan"),
                               n[:, 1:] + 1.01 * co)
    if h is not None:
        use = torch.isfinite(h).all(dim=-1, keepdim=True)
        h_eff = torch.where(use, h, h_rec)
    else:
        h_eff = h_rec
    has_h = torch.isfinite(h_eff).all(dim=-1)  # (F, R)
    if is_proline is not None:
        has_h = has_h & ~torch.as_tensor(np.asarray(is_proline, bool), device=dev)[None, :]
    h_filled = torch.where(has_h[..., None], h_eff, 1e6)
    e = _Q1Q2_F * (1.0 / _rdist(o, n) + 1.0 / _rdist(c, h_filled)
                   - 1.0 / _rdist(o, h_filled) - 1.0 / _rdist(c, n))
    allowed = has_h[:, None, :].expand(F, R, R).clone()
    idx = torch.arange(R, device=dev)
    allowed[:, idx, idx] = False
    # a residue cannot accept from its peptide-bonded successor; across a
    # chain break the two are not bonded and an H-bond there stands
    allowed[:, idx[:-1], idx[1:]] &= chain_break
    allowed &= _rdist(ca, ca) < 9.0  # DSSP's CA-CA prefilter
    return e, allowed


def kabsch_sander_hbonds(n: torch.Tensor, ca: torch.Tensor, c: torch.Tensor,
                         o: torch.Tensor, *, is_proline: Optional[Any] = None,
                         h: Optional[torch.Tensor] = None,
                         chain_break: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(F, R, R)`` bool Kabsch–Sander H-bond matrix on the inputs'
    device: ``out[f, i, j]`` is True when the CO of residue *i* accepts an
    H-bond from the NH of residue *j* in frame *f*. Arguments as for
    :func:`kabsch_sander_energy`."""
    F, R, _ = n.shape
    if R < 2:
        return torch.zeros((F, R, R), dtype=torch.bool, device=n.device)
    e, allowed = kabsch_sander_energy(n, ca, c, o, is_proline=is_proline, h=h,
                                      chain_break=chain_break)
    return (e < _HBOND_CUTOFF) & allowed


def _assign(hb: torch.Tensor, ca: torch.Tensor, chain_id: torch.Tensor) -> torch.Tensor:
    """Pattern assignment from the H-bond matrix: ``(F, R)`` uint8 codes
    into ``_LETTERS``. ``chain_id`` is ``(F, R)``."""
    F, R, _ = hb.shape
    dev = hb.device
    ss = torch.zeros((F, R), dtype=torch.uint8, device=dev)
    if R < 3:
        return ss

    def turn(nn):
        t = torch.zeros((F, R), dtype=torch.bool, device=dev)
        if R > nn:
            ok = chain_id[:, : R - nn] == chain_id[:, nn:]
            t[:, : R - nn] = torch.diagonal(hb, offset=nn, dim1=1, dim2=2) & ok
        return t

    def put(sl: slice, mask: torch.Tensor, letter: str) -> None:
        view = ss[:, sl]
        view[mask] = _CODE[letter]

    t3, t4, t5 = turn(3), turn(4), turn(5)

    # bends (lowest priority first; later assignments overwrite)
    if R >= 5:
        u = ca[:, 2:-2] - ca[:, :-4]
        v = ca[:, 4:] - ca[:, 2:-2]
        dot = u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]
        cosk = dot / torch.clamp(_norm(u) * _norm(v), min=1e-12)
        bend = torch.rad2deg(torch.arccos(torch.clamp(cosk, -1.0, 1.0))) > 70.0
        bend &= chain_id[:, :-4] == chain_id[:, 4:]
        put(slice(2, R - 2), bend, "S")

    # hydrogen-bonded turns: turn(i) marks residues i+1 .. i+n-1
    for nn, t in ((3, t3), (4, t4), (5, t5)):
        if R <= nn:
            continue
        m = t[:, : R - nn]
        for k in range(1, nn):
            put(slice(k, k + R - nn), m, "T")

    # pi and 3-10 helices: turns at i and i+1 -> helix i+1 .. i+n
    for nn, t, ch in ((5, t5, "I"), (3, t3, "G")):
        start = t[:, : R - 1] & t[:, 1:]
        for k in range(1, nn + 1):
            put(slice(k, k + R - 1), start[:, : R - k], ch)

    # beta bridges and ladders
    pad = torch.zeros((F, R + 2, R + 2), dtype=torch.bool, device=dev)
    pad[:, 1:-1, 1:-1] = hb

    def hbp(di, dj):
        return pad[:, 1 + di:R + 1 + di, 1 + dj:R + 1 + dj]

    def swap(m):
        return m.transpose(1, 2)

    # parallel(i,j)     = (HB[i-1,j] & HB[j,i+1]) | (HB[j-1,i] & HB[i,j+1])
    # antiparallel(i,j) = (HB[i,j] & HB[j,i])     | (HB[i-1,j+1] & HB[j-1,i+1])
    para = (hbp(-1, 0) & swap(hbp(0, 1))) | (swap(hbp(-1, 0)) & hbp(0, 1))
    anti = (hbp(0, 0) & swap(hbp(0, 0))) | (hbp(-1, 1) & swap(hbp(-1, 1)))
    # bridges across chains count, as in DSSP; ladders extend along a chain
    i = torch.arange(R, device=dev)
    sep = (i[:, None] - i[None, :]).abs() >= 3
    bridged = ((para | anti) & sep[None]).any(dim=2)
    same = chain_id[:, :-1] == chain_id[:, 1:]
    nb = torch.zeros_like(bridged)
    nb[:, 1:] |= bridged[:, :-1] & same
    nb[:, :-1] |= bridged[:, 1:] & same
    ss[bridged] = _CODE["B"]
    ss[bridged & nb] = _CODE["E"]

    # alpha helix (highest priority)
    start4 = t4[:, : R - 1] & t4[:, 1:]
    for k in range(1, 5):
        put(slice(k, k + R - 1), start4[:, : R - k], "H")
    return ss


def dssp_backbone(xyz: torch.Tensor, top) -> tuple:
    """The backbone arrays of :func:`kabsch_sander_energy` from ``(F,
    n_atoms, 3)`` float32 coordinates in nm on a device: ``(n, ca, c, o,
    h, is_pro, chain_break, res_idx)``, float64 in Angstrom, chain breaks
    per frame."""
    table, res_idx, is_pro, h_idx = _backbone_table(top)
    x = xyz.to(torch.float64) * 10.0  # nm -> Angstrom
    idx = torch.as_tensor(table, device=xyz.device)
    n, ca, c, o = (x[:, idx[:, k]] for k in range(4))
    h = torch.full_like(n, float("nan"))
    have = h_idx >= 0
    if have.any():
        h[:, torch.as_tensor(np.flatnonzero(have), device=xyz.device)] = \
            x[:, torch.as_tensor(h_idx[have], device=xyz.device)]
    brk = _norm(c[:, :-1] - n[:, 1:]) > _CHAIN_BREAK
    return n, ca, c, o, h, is_pro, brk, res_idx


def compute_dssp(traj, simplified: bool = True, device: Any = None) -> np.ndarray:
    """Secondary structure per frame and residue, on ``device`` (the card
    unless ``device="cpu"``).

    Args:
        traj: a ``SingleTraj`` (or any object with ``.xyz`` in nm and
            ``.top``).
        simplified: the 3-state alphabet H (helix), E (strand), C (coil),
            like ``mdtraj.compute_dssp(simplified=True)``; else the 8-state
            DSSP alphabet with ' ' for loop.

    Returns:
        ``(n_frames, n_residues)`` array of strings; residues without a
        complete protein backbone get 'NA'.
    """
    dev = resolve_device(device)
    xyz = np.asarray(traj.xyz, np.float32)
    top = traj.top
    table = _backbone_table(top)[0]
    F, R = xyz.shape[0], len(table)
    out = np.full((F, top.n_residues), "NA", dtype="<U2")
    if R == 0:
        return out
    # a frame holds about a dozen (R, R) float64 arrays at the peak
    # (the (R, R, 3) differences of a distance matrix and its four terms)
    frames = max(1, DSSP_BLOCK_BYTES // (12 * R * R * 8))
    codes = []
    with torch.no_grad():
        for f0 in range(0, F, frames):
            x = torch.as_tensor(xyz[f0:f0 + frames], device=dev)
            n, ca, c, o, h, is_pro, brk, res_idx = dssp_backbone(x, top)
            chain_id = torch.cat([torch.zeros((len(x), 1), dtype=torch.int64, device=dev),
                                  torch.cumsum(brk.to(torch.int64), dim=1)], dim=1)
            hb = kabsch_sander_hbonds(n, ca, c, o, is_proline=is_pro, h=h,
                                      chain_break=brk)
            codes.append(_assign(hb, ca, chain_id).cpu())
    codes = torch.cat(codes).numpy()
    out[:, res_idx] = (_SIMPLE if simplified else _LETTERS)[codes]
    return out
