# tests/test_torch_backmap.py
"""The port's backmapping (``encodermap_tpu_torch/ops/backmap.py``) against
the JAX package's and against the sequential numpy oracle of
``tests/reference_impl.py``.

Tolerances: positions agree with JAX and with the float64 oracle to 2e-6
nm absolute at chains of up to 26 atoms (float32 sums in another order:
the port composes its quaternions in doubling rounds, JAX in an associative
scan, the oracle rotates one dihedral at a time). The hand-derived backward
of ``_one_way`` passes ``torch.autograd.gradcheck`` in float64, and its
float32 gradient is held by the rule err(port, f64) <= 3 err(JAX, f64)
against central finite differences of the float64 oracle.

``data/one_way_jax.npz`` holds float32 half-chains at B=64 and the JAX
package's ``_one_way`` output and cotangents on them, for the card test
that holds the one-way CUDA kernels to the JAX package without JAX
(``tests/test_torch_cuda.py``); a test here recomputes it. Rewrite it
with ``python -c "from tests.test_torch_backmap import
write_one_way_jax_file; write_one_way_jax_file()"``.
"""

import functools
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.reference_impl import (
    chain_in_plane_np,
    backmap_np,
    dihedral_one_way_np,
    dihedrals_to_cartesian_np,
)

torch.set_num_threads(1)

J = importlib.import_module("encodermap_tpu.ops.backmap")
T = importlib.import_module("encodermap_tpu_torch.ops.backmap")

ATOL = 2e-6


def _internals(n_atoms, B=4, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.13, 0.155, (B, n_atoms - 1)).astype(np.float32)
    a = rng.uniform(1.6, 2.4, (B, n_atoms - 2)).astype(np.float32)
    t = rng.uniform(-np.pi, np.pi, (B, n_atoms - 3)).astype(np.float32)
    return d, a, t


# 12 atoms: 9 dihedrals (odd split); 13 atoms: 10 (even)
N_ATOMS = [12, 13]


@functools.lru_cache(maxsize=None)
def _jax_results(n_atoms):
    """JAX's chain, both-ways curl, backmap and backmap gradients of a
    random projection, as numpy, from one jitted program per size."""
    d, a, t = _internals(n_atoms)
    g = _projection(n_atoms)

    def run(d, a, t):
        chain = J.chain_in_plane(d, a)
        grads = jax.grad(lambda *x: jnp.sum(J.backmap(*x) * g), (0, 1, 2))(d, a, t)
        return chain, J.dihedrals_to_cartesian(t, chain), J.backmap(d, a, t), grads

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(d, a, t))


def _projection(n_atoms):
    return np.random.default_rng(1).normal(size=(4, n_atoms, 3)).astype(np.float32)


@pytest.mark.parametrize("n_atoms", N_ATOMS)
def test_chain_in_plane(n_atoms):
    d, a, _ = _internals(n_atoms)
    got = T.chain_in_plane(torch.tensor(d), torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, _jax_results(n_atoms)[0], atol=ATOL)
    np.testing.assert_allclose(got, chain_in_plane_np(d, a), atol=ATOL)


@pytest.mark.parametrize("n_atoms", N_ATOMS)
def test_dihedrals_to_cartesian(n_atoms):
    d, a, t = _internals(n_atoms)
    chain = _jax_results(n_atoms)[0]
    got = T.dihedrals_to_cartesian(torch.tensor(t), torch.tensor(chain)).numpy()
    np.testing.assert_allclose(got, _jax_results(n_atoms)[1], atol=ATOL)
    np.testing.assert_allclose(got, dihedrals_to_cartesian_np(t, chain), atol=ATOL)


@pytest.mark.parametrize("n_atoms", N_ATOMS)
def test_backmap_and_its_gradient(n_atoms):
    """Values against JAX and the oracle, bond lengths equal to the batch
    mean; gradients of a random projection against JAX's custom VJP to
    1e-5 of their largest entry."""
    d, a, t = _internals(n_atoms)
    _, _, ref, grads = _jax_results(n_atoms)
    xs = [torch.tensor(v, requires_grad=True) for v in (d, a, t)]
    got = T.backmap(*xs)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(got.detach().numpy(), backmap_np(d, a, t), atol=ATOL)
    bond = np.linalg.norm(np.diff(got.detach().numpy(), axis=1), axis=-1)
    np.testing.assert_allclose(bond, np.broadcast_to(d.mean(0), bond.shape), atol=1e-6)
    (got * torch.tensor(_projection(n_atoms))).sum().backward()
    for x, ref_g in zip(xs, grads):
        np.testing.assert_allclose(x.grad.numpy(), ref_g, atol=1e-5 * np.abs(ref_g).max())


def test_long_chain_matches_oracle():
    """A 158-residue backbone (474 atoms, 19 nm across; 8 doubling rounds
    per half) against the float64 oracle: exact in float64 (1e-9 nm); in
    float32 within 5e-4 nm (the JAX package's float32 scan is 1.8e-4 off
    here, the port's 2.5e-4)."""
    d, a, t = _internals(474, B=2)
    ref = backmap_np(d, a, t)
    for dtype, atol in ((torch.float64, 1e-9), (torch.float32, 5e-4)):
        got = T.backmap(*(torch.tensor(x, dtype=dtype) for x in (d, a, t)))
        np.testing.assert_allclose(got.numpy(), ref, atol=atol)


def test_split_and_reverse_match_jax():
    x = np.arange(2 * 9 * 3, dtype=np.float32).reshape(2, 9, 3)
    for n in (8, 9):
        for fn in ("split_and_reverse_dihedrals", "split_and_reverse_cartesians"):
            arr = x[:, :, 0] if fn.endswith("dihedrals") else x
            arr = arr[:, :n]
            for a, b in zip(getattr(T, fn)(torch.tensor(arr)), getattr(J, fn)(jnp.asarray(arr))):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [1, 4, 7])
def test_one_way_gradcheck_f64(n):
    gen = torch.Generator().manual_seed(n)
    dih = (torch.rand((3, n), generator=gen, dtype=torch.float64) * 2 - 1) * np.pi
    cart = torch.randn((3, n + 3, 3), generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(T._OneWay.apply,
                                    (dih.requires_grad_(), cart.requires_grad_()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 29, 33])
def test_one_way_on_cpu_runs_the_plain_version(n, dtype):
    """``_OneWay`` on CPU tensors launches no kernel (``launch_counts``
    unchanged, the kernels' library never loaded) and gives the plain
    functions' output and cotangents bit for bit."""
    from encodermap_tpu_torch.ops import _build

    rng = np.random.default_rng(n)
    dih = torch.tensor(rng.uniform(-np.pi, np.pi, (3, n)), dtype=dtype)
    cart = torch.tensor(rng.normal(size=(3, n + 3, 3)), dtype=dtype)
    g = torch.tensor(rng.normal(size=(3, n + 3, 3)), dtype=dtype)
    counts = dict(_build.launch_counts)
    x = [t.clone().requires_grad_(True) for t in (dih, cart)]
    y = T._OneWay.apply(*x)
    y.backward(g)
    out, saved = T._one_way_fwd_plain(dih, cart)
    d_bar, v = T._one_way_bwd_plain(saved, g)
    assert dict(_build.launch_counts) == counts
    assert T._LIB not in _build._loaded
    for a, b in ((y.detach(), out), (x[0].grad, d_bar), (x[1].grad, v)):
        assert a.dtype == dtype
        assert torch.equal(a, b)


def test_one_way_kernel_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA card raises before any
    library is loaded."""
    from encodermap_tpu_torch.ops import _build

    dih, cart = torch.zeros((2, 4), device="meta"), torch.zeros((2, 7, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        T._OneWay.apply(dih, cart)
    assert T._LIB not in _build._loaded


def _fd_grads(dih, cart, g, h=1e-6):
    """Central differences of sum(one_way(dih, cart) * g), float64 oracle."""
    def f(d_, c_):
        return float(np.sum(dihedral_one_way_np(d_, c_) * g))

    out = []
    for x in (dih, cart):
        grad = np.zeros_like(x)
        for i in np.ndindex(x.shape):
            xp, xm = x.copy(), x.copy()
            xp[i] += h
            xm[i] -= h
            args_p = (xp, cart) if x is dih else (dih, xp)
            args_m = (xm, cart) if x is dih else (dih, xm)
            grad[i] = (f(*args_p) - f(*args_m)) / (2 * h)
        out.append(grad)
    return out


def test_one_way_f32_gradient_rule():
    """err(port f32, f64) <= 3 err(JAX f32, f64), for the dihedral and the
    coordinate gradient of one 20-dihedral half-chain."""
    n, B = 20, 3
    rng = np.random.default_rng(5)
    dist = rng.uniform(0.13, 0.155, (B, n + 2))
    ang = rng.uniform(1.6, 2.4, (B, n + 1))
    cart = chain_in_plane_np(dist, ang) + rng.normal(0, 0.01, (B, n + 3, 3))
    dih = rng.uniform(-np.pi, np.pi, (B, n))
    g = rng.normal(size=(B, n + 3, 3))
    oracle = _fd_grads(dih, cart, g)

    d32, c32, g32 = (x.astype(np.float32) for x in (dih, cart, g))
    gj = jax.jit(jax.grad(lambda x, y: jnp.sum(J._one_way(x, y) * g32), (0, 1)))(
        jnp.asarray(d32), jnp.asarray(c32))
    xs = [torch.tensor(v, requires_grad=True) for v in (d32, c32)]
    (T._OneWay.apply(*xs) * torch.tensor(g32)).sum().backward()
    np.testing.assert_allclose(T._OneWay.apply(torch.tensor(d32), torch.tensor(c32)).detach().numpy(),
                               dihedral_one_way_np(dih, cart), atol=1e-5)
    for port, jx, ref in zip(xs, gj, oracle):
        err_port = np.abs(port.grad.numpy() - ref).max()
        err_jax = np.abs(np.asarray(jx) - ref).max()
        assert err_port <= 3 * err_jax, (err_port, err_jax)


ONE_WAY_JAX_FILE = Path(__file__).parent / "data" / "one_way_jax.npz"
#: trp-cage's two halves and one bond past a 32-bond tile
ONE_WAY_JAX_N = (28, 29, 33)


def one_way_jax_reference(n, B=64):
    """A float32 half-chain of ``n`` dihedrals (planar chain moved off the
    plane a little, dihedrals, output cotangent ``g``) and the JAX
    package's float32 ``_one_way`` output and its cotangents (``d_bar``,
    ``v``), as numpy."""
    rng = np.random.default_rng(n)
    cart = chain_in_plane_np(rng.uniform(0.13, 0.155, (B, n + 2)),
                             rng.uniform(1.6, 2.4, (B, n + 1)))
    cart = cart + rng.normal(0, 0.01, (B, n + 3, 3))
    dih = rng.uniform(-np.pi, np.pi, (B, n))
    g = rng.normal(size=(B, n + 3, 3))
    dih, cart, g = (x.astype(np.float32) for x in (dih, cart, g))
    out, vjp = jax.vjp(J._one_way, jnp.asarray(dih), jnp.asarray(cart))
    d_bar, v = vjp(jnp.asarray(g))
    return dict(dih=dih, cart=cart, g=g, out=np.asarray(out), d_bar=np.asarray(d_bar),
                v=np.asarray(v))


def write_one_way_jax_file(path=ONE_WAY_JAX_FILE):
    np.savez_compressed(path, **{f"n{n}_{k}": v for n in ONE_WAY_JAX_N
                                 for k, v in one_way_jax_reference(n).items()})


@pytest.mark.parametrize("n", ONE_WAY_JAX_N)
def test_one_way_jax_file_holds_the_jax_packages_output(n):
    """The stored inputs are the seed's, and the stored outputs are what
    the JAX package's ``_one_way`` gives on them (to 1e-6 of each tensor's
    largest entry: XLA's CPU code may round otherwise on another CPU)."""
    stored = np.load(ONE_WAY_JAX_FILE)
    for k, v in one_way_jax_reference(n).items():
        got = stored[f"n{n}_{k}"]
        assert got.dtype == np.float32 and got.shape == v.shape
        if k in ("dih", "cart", "g"):
            np.testing.assert_array_equal(got, v)
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-6 * np.abs(v).max())
