# tests/test_torch_fused_sigmoid.py
"""The sigmoid-loss kernels' module (ops/fused_sigmoid.py) against the JAX
package.

On the CPU the port's wrappers run the kernels' plain versions; they are
held against the JAX Pallas kernel run in interpret mode (as
tests/test_pallas_sigmoid.py runs it) and against ``losses.sigmoid_loss``'s
XLA path, for values and latent gradients, a != 2 sigmoids and duplicate
points. The CUDA kernels themselves are compared with the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.

A numpy mirror of the CUDA kernels' schedule (``csrc/sigmoid_loss.cu``) is
held against the same two JAX references: upper-triangular T x T tiles of the
pair matrix, each unordered pair evaluated once with the kernels' cheap
powers and their s = 1 - u^e without cancellation (``sig_s``), the forward's
per-tile partial (twice the off-diagonal sum plus the diagonal), and the
backward's row and column partials written to (row, partner tile) slots and
added per row in tile order. The mirror's s is held to float64 within 4 ulp
where c t is small, where 1 - u^e in float32 is not.

Tolerances: the JAX kernel takes distances by the Gram identity, the port by
direct differences; over B = 512 pairs of 30-wide rows that costs up to
~1e-5 relative on the value and 1e-4 relative (to the largest entry) on the
latent gradient, the bounds tests/test_pallas_sigmoid.py itself holds the
JAX kernel to against the XLA path. Against the XLA path at small B (same
formulas) values agree to 1e-6 and gradients to 1e-5."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from encodermap_tpu import losses as JL
from encodermap_tpu.ops import pallas_sigmoid as ps
from encodermap_tpu_torch import losses as TL
from encodermap_tpu_torch.ops import _build
from encodermap_tpu_torch.ops import fused_sigmoid as fs

torch.set_num_threads(1)

PARAMS = [(5.9, 12.0, 4.0, 1.0, 2.0, 4.0), (4.5, 6.0, 10.0, 1.0, 3.0, 7.0)]
#: one parameter set per class of the kernels' outer exponent e = -b/a on
#: the (high-D, latent) sides: half-integer and integer (the defaults),
#: powf and integer, powf on both (an odd a on the latent side)
CLASSES = {"e=-0.5,-3": (4.5, 12.0, 6.0, 1.0, 2.0, 6.0),
           "e=-1/3,-2": PARAMS[0],
           "powf": PARAMS[1]}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _data(B, D, periodic, seed=0, duplicate=False, d=2):
    rng = np.random.default_rng(seed)
    h = (rng.uniform(-np.pi, np.pi, (B, D)) if periodic
         else rng.normal(size=(B, D))).astype(np.float32)
    l = rng.normal(size=(B, d)).astype(np.float32)
    if duplicate:
        h[1], l[1] = h[0], l[0]
        l[3] = l[2]  # same latent point, different inputs
    return h, l


def _port(h, l, params, periodicity):
    lt = torch.tensor(l, requires_grad=True)
    val = fs.fused_sigmoid_loss(torch.tensor(h), lt, params, periodicity)
    (g,) = torch.autograd.grad(val, lt)
    return float(val.detach()), g.numpy()


@pytest.mark.parametrize("params", PARAMS, ids=["a_l=2", "a_l=3"])
@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
@pytest.mark.parametrize("duplicate", [False, True], ids=["distinct", "duplicates"])
def test_plain_matches_jax_pallas_interpret(interpret, params, periodicity, duplicate):
    h, l = _data(512, 30, math.isfinite(periodicity), duplicate=duplicate)
    val_j, g_j = jax.value_and_grad(
        lambda x: ps.fused_sigmoid_loss(jnp.asarray(h), x, params, periodicity))(
        jnp.asarray(l))
    val_t, g_t = _port(h, l, params, periodicity)
    assert abs(val_t - float(val_j)) <= 1e-5 * abs(float(val_j))
    g_j = np.asarray(g_j)
    assert np.isfinite(g_t).all()
    assert np.abs(g_t - g_j).max() <= 1e-4 * np.abs(g_j).max()


@pytest.mark.parametrize("params", PARAMS, ids=["a_l=2", "a_l=3"])
@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
def test_plain_matches_jax_xla_path(params, periodicity):
    """Same formulas as ``losses.sigmoid_loss`` below its kernel threshold,
    with the zero mask on coincident latent points."""
    h, l = _data(48, 6, math.isfinite(periodicity), seed=1, duplicate=True)
    val_j, g_j = jax.value_and_grad(
        lambda x: JL.sigmoid_loss(jnp.asarray(h), x, params, periodicity))(
        jnp.asarray(l))
    val_t, g_t = _port(h, l, params, periodicity)
    np.testing.assert_allclose(val_t, float(val_j), rtol=1e-6)
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-5, atol=1e-7)


def test_h_gradient_is_exactly_zero():
    """The kernels' route gives ``h`` no gradient; materialised, it is the
    JAX kernel's exact zeros."""
    h, l = _data(32, 4, False)
    ht = torch.tensor(h, requires_grad=True)
    val = fs.fused_sigmoid_loss(ht, torch.tensor(l, requires_grad=True),
                                PARAMS[0], float("inf"))
    (g,) = torch.autograd.grad(val, ht, allow_unused=True, materialize_grads=True)
    assert torch.count_nonzero(g) == 0


@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
def test_router_below_threshold_is_the_general_path(periodicity):
    """``fused_or_reference`` (and so ``losses.sigmoid_loss``) takes the
    general path on the CPU, as the JAX router does below its threshold."""
    h, l = _data(64, 5, math.isfinite(periodicity), seed=2)
    out = float(TL.sigmoid_loss(torch.tensor(h), torch.tensor(l), PARAMS[0],
                                periodicity))
    ref = float(ps.fused_or_reference(jnp.asarray(h), jnp.asarray(l),
                                      PARAMS[0], periodicity))
    assert out == pytest.approx(ref, rel=1e-6)
    general = float(fs.sigmoid_loss_general(torch.tensor(h), torch.tensor(l),
                                            PARAMS[0], periodicity))
    assert out == general


def test_wrapper_routes_cpu_tensors_to_plain_version():
    h, l = _data(40, 3, False, seed=3)
    ht, lt = torch.tensor(h), torch.tensor(l)
    before = dict(_build.launch_counts)
    v = fs.sigmoid_loss_fwd(ht, lt, PARAMS[1], float("inf"))
    g = fs.sigmoid_loss_bwd(ht, lt, PARAMS[1], float("inf"))
    assert float(v) == float(fs.sigmoid_loss_fwd_plain(ht, lt, PARAMS[1], float("inf")))
    assert torch.equal(g, fs.sigmoid_loss_bwd_plain(ht, lt, PARAMS[1], float("inf")))
    assert dict(_build.launch_counts) == before  # no kernel launched
    with pytest.raises(ValueError):
        fs.sigmoid_loss_fwd(ht[:5], lt, PARAMS[1], float("inf"))


# ------------------------------------------- numpy mirror of the kernels
F32 = np.float32


def _pow_n(x, n):
    """x**n by squaring, in the order the kernels (and integer_pow) take."""
    acc, base = None, x
    while True:
        if n & 1:
            acc = base if acc is None else acc * base
        n >>= 1
        if not n:
            return acc
        base = base * base


def _side(sig, a, b):
    """The host's classification of one side's exponents (make_side)."""
    m = b / a
    integer_a = a == math.floor(a) and 1 <= a <= 64
    if m == math.floor(m) and 1 <= m <= 16:
        kind = ("int", int(m))
    elif m - 0.5 == math.floor(m - 0.5) and 0.5 <= m <= 16.5:
        kind = ("half", int(m - 0.5))
    else:
        kind = ("powf", 0)
    return dict(sig=sig, a=a, b=b, c=F32(2.0 ** (a / b) - 1.0), e=F32(-m),
                int_a=int(a) if integer_a else 0,
                half_a=int(a) // 2 if integer_a and int(a) % 2 == 0 else 0,
                kind=kind)


def _sig_t(s, d2, periodic):
    """(r/sig)**a from squared distances: no sqrt for an even a (Euclidean)."""
    if not periodic and s["half_a"]:
        return _pow_n(d2 * F32(1.0 / s["sig"] ** 2), s["half_a"])
    r = np.sqrt(d2)
    if periodic:
        r = r + F32(1e-12)
    x = r * F32(1.0 / s["sig"])
    return _pow_n(x, s["int_a"]) if s["int_a"] else np.power(x, F32(s["a"]))


def _sig_s(s, t):
    """(s, y, 1/u) with u = 1 + c t, y = u**e and s = 1 - y as the kernels
    take it (sig_s), without the cancellation of 1 - y where c t is small:
    e = -n as c t (u^-1 + ... + u^-n), e = -(n + 1/2) adds
    u^-n c t u^-1/2 / (1 + u^1/2), other e as 1 - powf."""
    ct = s["c"] * t
    u = F32(1) + ct
    kind, n = s["kind"]
    if kind == "powf":
        y = np.power(u, s["e"])
        return F32(1) - y, y, F32(1) / u
    if kind == "half":
        rs = F32(1) / np.sqrt(u)
    iu = F32(1) / u if kind == "int" or n else rs * rs
    total, y = np.zeros_like(t), np.ones_like(t)
    for _ in range(n):
        y = y * iu
        total = total + y
    if kind == "half":
        h = rs * (F32(1) / (F32(1) + u * rs))  # (1 - u^-1/2) / (c t)
        return ct * (total + y * h), y * rs, iu
    return ct * total, y, iu


def _tile_terms(h, l, ri, rj, sh, sl, periodicity):
    """(s_h, s_l, d_l^2, s_l'(r)/r) of the pairs ri x rj, in float32."""
    periodic = math.isfinite(periodicity)
    dh2 = np.zeros((len(ri), len(rj)), F32)
    for k in range(h.shape[1]):
        t = h[ri, k][:, None] - h[rj, k][None, :]
        if periodic:
            t = np.abs(t)
            t = np.minimum(t, F32(periodicity) - t)
            t = np.where(t == 0, F32(1e-12), t)
        dh2 = dh2 + t * t
    dl2 = np.zeros_like(dh2)
    for k in range(l.shape[1]):
        t = l[ri, k][:, None] - l[rj, k][None, :]
        dl2 = dl2 + t * t
    s_h, _, _ = _sig_s(sh, _sig_t(sh, dh2, periodic))
    tl = _sig_t(sl, dl2, False)
    s_l, yl, iu = _sig_s(sl, tl)
    sig_l, a_l, b_l = sl["sig"], sl["a"], sl["b"]
    c = 2.0 ** (a_l / b_l) - 1.0
    if a_l == 2:
        g = F32(b_l * c / sig_l ** 2) * yl * iu
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            g = F32(b_l * c) * yl * iu * tl * (F32(1) / dl2)
    return s_h, s_l, dl2, g


def _mirror(h, l, params, periodicity, T):
    """Loss and latent gradient as the kernels schedule them."""
    n, d = l.shape
    sh, sl = _side(*params[:3]), _side(*params[3:])
    nt = -(-n // T)
    weights = np.concatenate([np.ones((n, 1), F32), l], axis=1)  # v = 0..d
    partials = []
    ws = np.full((nt, d + 1, n), np.nan, F32)
    for I in range(nt):
        for J in range(I, nt):
            ri = np.arange(I * T, min(I * T + T, n))
            rj = np.arange(J * T, min(J * T + T, n))
            s_h, s_l, dl2, g = _tile_terms(h, l, ri, rj, sh, sl, periodicity)
            diag = I == J
            upper = ri[:, None] < rj[None, :]
            w = (np.where(upper, F32(2), np.where(ri[:, None] == rj[None, :], F32(1),
                                                   F32(0))) if diag else F32(2))
            partials.append(np.sum(w * (s_h - s_l) ** 2, dtype=F32))
            keep = (dl2 != 0) & (upper if diag else True)
            f = np.where(keep, (s_l - s_h) * g, F32(0)).astype(F32)
            rows = f @ weights[rj]    # row partials of the I rows
            cols = f.T @ weights[ri]  # column partials of the J rows
            if diag:
                assert np.isnan(ws[I][:, ri]).all()
                ws[I][:, ri] = (rows + cols).T
            else:
                assert np.isnan(ws[J][:, ri]).all() and np.isnan(ws[I][:, rj]).all()
                ws[J][:, ri] = rows.T
                ws[I][:, rj] = cols.T
    assert not np.isnan(ws).any()  # every (row, partner tile) slot once
    assert len(partials) == nt * (nt + 1) // 2
    loss = float(np.sum(np.asarray(partials, np.float64))) / (n * n)
    slots = ws[0]
    for t in range(1, nt):  # tile order
        slots = slots + ws[t]
    grad = F32(4.0 / (n * n)) * (slots[0][:, None] * l - slots[1:].T)
    return loss, grad


@functools.lru_cache(maxsize=None)
def _jax_interpret(params, periodicity, d):
    h, l = _data(512, 30, math.isfinite(periodicity), seed=d, duplicate=True, d=d)
    ps._INTERPRET = True
    try:
        val, g = jax.value_and_grad(
            lambda x: ps.fused_sigmoid_loss(jnp.asarray(h), x, params, periodicity))(
            jnp.asarray(l))
    finally:
        ps._INTERPRET = False
    return h, l, float(val), np.asarray(g)


@pytest.mark.parametrize("cls", list(CLASSES))
@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("T", [128, 96], ids=["T=128", "T=96-ragged"])
def test_kernel_schedule_matches_jax_pallas_interpret(cls, periodicity, d, T):
    """B = 512 (the JAX kernel's multiple); T = 96 leaves a ragged last tile."""
    h, l, val_j, g_j = _jax_interpret(CLASSES[cls], periodicity, d)
    val_m, g_m = _mirror(h, l, CLASSES[cls], periodicity, T)
    assert abs(val_m - val_j) <= 1e-5 * abs(val_j)
    assert np.isfinite(g_m).all()
    assert np.abs(g_m - g_j).max() <= 1e-4 * np.abs(g_j).max()


@pytest.mark.parametrize("cls", list(CLASSES))
@pytest.mark.parametrize("periodicity", [float("inf"), 2 * math.pi])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("B", [300, 50], ids=["B=300", "B=50-one-tile"])
def test_kernel_schedule_matches_jax_xla_path(cls, periodicity, d, B):
    """Three 128-tiles with a ragged last one, and one tile of 50 rows."""
    h, l = _data(B, 6, math.isfinite(periodicity), seed=B + d, duplicate=True, d=d)
    val_j, g_j = jax.value_and_grad(
        lambda x: JL.sigmoid_loss(jnp.asarray(h), x, CLASSES[cls], periodicity))(
        jnp.asarray(l))
    val_m, g_m = _mirror(h, l, CLASSES[cls], periodicity, 128)
    np.testing.assert_allclose(val_m, float(val_j), rtol=1e-6)
    np.testing.assert_allclose(g_m, np.asarray(g_j), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cls", list(CLASSES))
def test_exponent_classes(cls):
    """The host's classification: which power each side's sigmoid takes."""
    sh, sl = _side(*CLASSES[cls][:3]), _side(*CLASSES[cls][3:])
    expect = {"e=-0.5,-3": (("half", 0), 6, ("int", 3), 1),
              "e=-1/3,-2": (("powf", 0), 6, ("int", 2), 1),
              "powf": (("powf", 0), 3, ("powf", 0), 0)}[cls]
    assert (sh["kind"], sh["half_a"], sl["kind"], sl["half_a"]) == expect


#: one side of each class of e whose s the kernels take as a sum, without
#: the cancellation of 1 - u^e: e = -(n + 1/2) and e = -n (the powf class
#: keeps 1 - powf, the JAX package's own form)
SIG_S_SIDES = {"half n=0": (4.5, 12.0, 6.0), "half n=1": (1.0, 2.0, 3.0),
               "int n=3": (1.0, 2.0, 6.0), "int n=2": (1.0, 2.0, 4.0)}


@pytest.mark.parametrize("side", list(SIG_S_SIDES))
def test_sig_s_has_no_cancellation(side):
    """Where c t <= 1e-3, the mirror's float32 s is within 4 ulp of s from
    the same t in float64; 1 - y in float32 is not: y = u^e rounds near 1,
    and 1 - y keeps that rounding error of y, many ulp of a small s."""
    s = _side(*SIG_S_SIDES[side])
    assert s["kind"][0] == side.split()[0]
    t = (np.geomspace(1e-7, 1e-3, 2000) / float(s["c"])).astype(F32)
    got, y, _ = _sig_s(s, t)
    ct = np.float64(s["c"]) * t.astype(np.float64)  # exact
    want = -np.expm1(np.log1p(ct) * (-s["b"] / s["a"]))
    ulp = np.spacing(want.astype(F32)).astype(np.float64)
    assert got.dtype == F32 and y.dtype == F32
    assert (np.abs(got - want) / ulp).max() <= 4
    assert (np.abs((F32(1) - y) - want) / ulp).max() > 4
