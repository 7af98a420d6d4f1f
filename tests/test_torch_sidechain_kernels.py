# tests/test_torch_sidechain_kernels.py
"""The sidechain backmap's kernel route, on the CPU.

``ops/backmap_sidechains.py::backmap_sidechains_fast`` launches
``csrc/backmap_sidechains.cu`` for CUDA tensors and runs the plain version
for CPU tensors. A CUDA kernel does not run here, so this file holds what
surrounds it:

* CPU tensors take the plain version: no launch is counted, the kernels'
  library is never loaded, and outputs and gradients equal
  ``_backmap_sidechains_fast_plain``'s bit for bit.
* A CUDA tensor of another type than float32 or float64, inputs on two
  devices, or a device neither the CPU nor CUDA raise.
* The kernels' int table (``_kernel_table``) holds each branch's CA, the
  central rotation it rides on, its length and first atom and dihedral,
  and the bonds' CSR tables, for trp-cage, a spec without a branch, one
  residue, 40 residues with 36 branches (more than a warp's 32 lanes) and
  branches of 6 and 8 atoms; it is built once per spec and device.

The kernels' arithmetic is held on the card (``tests/test_torch_cuda.py``):
to the sequential sweep, to autograd through the plain version and to the
JAX package's output and VJP stored in ``data/sidechain_jax.npz``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import encodermap_tpu_torch.ops.backmap_sidechains as T
from chip_smoke import TRP_CAGE_SIDECHAIN_INFO
from encodermap_tpu_torch.ops import _build

torch.set_num_threads(1)

INFOS = {
    "trp-cage": TRP_CAGE_SIDECHAIN_INFO,
    "none": {1: 0, 2: 0, 3: 0},
    "one-residue": {1: 3},
    "forty": {r: (0 if r % 10 == 5 else 1 + r % 4) for r in range(1, 41)},
    "long": {1: 5, 2: 0, 3: 7, 4: 2},
}


def _inputs(info, B=3, seed=0):
    """The six inputs in float64, the decoded angles on (-pi, pi], as a
    fresh model's decoder gives them."""
    spec = T.make_spec(info)
    rng = np.random.default_rng(seed)
    nb, ns = 3 * spec.n_residues, spec.n_sidechain_atoms
    x = (rng.uniform(0.13, 0.155, (B, nb - 1)), rng.uniform(-np.pi, np.pi, (B, nb - 2)),
         rng.uniform(-np.pi, np.pi, (B, nb - 3)), rng.uniform(0.13, 0.16, (B, ns)),
         rng.uniform(-np.pi, np.pi, (B, ns)),
         rng.uniform(-np.pi, np.pi, (B, sum(info.values()))))
    return spec, [torch.tensor(v) for v in x]


def _fields(spec, tab):
    """The table's parts: branch rows, the CSR by CA bond, the CSR by
    rotation bond."""
    n_br = int((T._side_atoms_per_res(spec) > 0).sum())
    nb = 3 * spec.n_residues
    tab = np.asarray(tab)
    rows = tab[:5 * n_br].reshape(n_br, 5)
    ca_ptr = tab[5 * n_br:5 * n_br + nb]
    ca_ids = tab[5 * n_br + nb:6 * n_br + nb]
    thr_ptr = tab[6 * n_br + nb:6 * n_br + 2 * nb]
    thr_ids = tab[6 * n_br + 2 * nb:]
    assert len(thr_ids) == n_br
    return rows, (ca_ptr, ca_ids), (thr_ptr, thr_ids)


@pytest.mark.parametrize("name", INFOS)
def test_kernel_table_rows_and_csr(name):
    """Each branch's row against the spec's own tables: its CA seeds its
    side atoms, its first atom and dihedral follow the residues before it,
    and it rides on the central rotation of the last central dihedral step
    whose free atoms hold its first atom (none where no step moves it); the
    CSR tables list each branch once, at the bond into its CA and at the
    bond whose rotation it rides on."""
    spec = T.make_spec(INFOS[name])
    nb = 3 * spec.n_residues
    rows, (ca_ptr, ca_ids), (thr_ptr, thr_ids) = _fields(
        spec, T._fast_tables(spec, torch.device("cpu"))["kernel"])
    v = T._side_atoms_per_res(spec)
    assert len(rows) == int((v > 0).sum())
    atom = dih = 0
    free = ~np.asarray(spec.dihedral_static_masks[:spec.n_central_dihedrals])
    for (ca, thr, L, a0, d0), res in zip(rows, np.where(v > 0)[0]):
        assert (ca, L, a0, d0) == (3 * res + 1, v[res], atom, dih)
        assert np.all(spec.side_seed_ca[a0:a0 + L] == ca)
        moving = np.where(free[:, nb + a0])[0]
        assert thr == (moving.max() if len(moving) else -1)
        atom, dih = atom + L, dih + L - 1
    assert (atom, dih) == (spec.n_sidechain_atoms, spec.n_sidechain_atoms - len(rows))
    for ptr, ids, keys in ((ca_ptr, ca_ids, rows[:, 0] - 1), (thr_ptr, thr_ids, rows[:, 1] + 1)):
        listed = ptr[-1]
        assert len(ptr) == nb and ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
        for bond in range(nb - 1):
            for k in ids[ptr[bond]:ptr[bond + 1]]:
                assert keys[k] == bond
        want = sorted(np.where(keys > 0 if ptr is thr_ptr else keys >= 0)[0])
        assert sorted(ids[:listed]) == want
    assert T._fast_tables(spec, torch.device("cpu"))["kernel"].dtype == torch.int32


def test_kernel_table_of_trp_cage():
    """trp-cage (NLYIQWLKDGGPSSGRPPPS): 17 branches, the longest arginine's
    (residue 16, CA atom 46) of 6 atoms; each branch but the first rides on
    the rotation of the bond into its CA."""
    spec = T.make_spec(TRP_CAGE_SIDECHAIN_INFO)
    rows, _, _ = _fields(spec, T._fast_tables(spec, torch.device("cpu"))["kernel"])
    assert len(rows) == 17 and rows[:, 2].max() == 6
    assert rows[np.argmax(rows[:, 2]), 0] == 46
    assert rows[0, 1] == -1 and np.all(rows[1:, 1] == rows[1:, 0] - 2)


def test_kernel_table_built_once_per_spec_and_device():
    a = T._fast_tables(T.make_spec(INFOS["forty"]), torch.device("cpu"))
    b = T._fast_tables(T.make_spec(dict(INFOS["forty"])), torch.device("cpu"))
    assert a is b and a["kernel"] is b["kernel"]
    meta = T._fast_tables(T.make_spec(INFOS["forty"]), torch.device("meta"))
    assert meta is not a and meta["kernel"].device.type == "meta"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name,spanned", [("trp-cage", False), ("trp-cage", True),
                                          ("none", False), ("none", True),
                                          ("one-residue", False), ("one-residue", True)])
def test_cpu_route_runs_the_plain_version(name, spanned, dtype):
    """No launch counted, the kernels' library never loaded, outputs and
    gradients bit for bit the plain version's (none for an input of width
    0, as autograd gives it), through the fast form with the spans off and
    on."""
    from encodermap_tpu_torch.misc import profiling as P

    spec, x = _inputs(INFOS[name])
    x = [t.to(dtype) for t in x]
    grad = torch.tensor(np.random.default_rng(2).normal(size=(3, spec.n_atoms, 3)), dtype=dtype)
    counts = dict(_build.launch_counts)
    leaves = [t.clone().requires_grad_(True) for t in x]
    with (P.record_spans() if spanned else contextlib.nullcontext()):
        y = T.backmap_sidechains_fast(spec, *leaves)
        (y * grad).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in x]
    want = T._backmap_sidechains_fast_plain(spec, *ref)
    (want * grad).sum().backward()
    assert dict(_build.launch_counts) == counts
    assert T._LIB not in _build._loaded
    assert y.dtype == dtype and torch.equal(y.detach(), want.detach())
    for a, b in zip(leaves, ref):
        assert (a.grad is None and b.grad is None and a.shape[1] == 0
                or torch.equal(a.grad, b.grad))


def test_other_devices_and_types_raise():
    """A device neither the CPU nor CUDA, inputs on two devices, and CUDA
    tensors of another type than float32 or float64 (or of two types)
    raise before any library is loaded."""
    spec, x = _inputs(INFOS["trp-cage"], B=2)
    with pytest.raises(ValueError, match="unsupported device"):
        T.backmap_sidechains_fast(spec, *(t.to("meta") for t in x))
    with pytest.raises(ValueError, match="lie on"):
        T.backmap_sidechains_fast(spec, *x[:5], x[5].to("meta"))
    cuda = torch.device("cuda")

    def fake(*dtypes):
        return [types.SimpleNamespace(device=cuda, dtype=d) for d in dtypes]

    def route(tensors):
        return _build.kernel_route(tensors, "the sidechain kernels")

    for dtypes in ([torch.float16] * 6, [torch.bfloat16] * 6,
                   [torch.float32] * 5 + [torch.float64]):
        with pytest.raises(TypeError, match="float32 or float64"):
            route(fake(*dtypes))
    assert route(fake(*[torch.float32] * 6))
    assert route(fake(*[torch.float64] * 6))
    assert not route(x)
    assert T._LIB not in _build._loaded
