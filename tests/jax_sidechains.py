# tests/jax_sidechains.py
"""The JAX package's fast sidechain backmap with the current dihedrals its
sequential sweep measures, for the tests that hold the port's
reconstruct-mode training to the JAX package's.

A decoded angle lies on (-pi, pi]; a negative one turns the plane chain
the other way, and the sweep (and upstream's BackMapLayerWithSidechains)
then measures a current dihedral of pi across the turn where JAX's fast
form assumes the 0 (pi on a branch's first step) of angles in (0, pi). The
port's fast form takes the measured value (a recorded divergence from the
JAX package). :func:`measured_fast` gives JAX's fast form the same: it
shifts each target by the difference, so JAX's own operations do the rest.
"""

import contextlib

import jax.numpy as jnp
import numpy as np

import encodermap_tpu.ops.backmap_sidechains as J

_FAST = J.backmap_sidechains_fast


def measured_fast(spec, cd, ca, cdi, sd, sa, sdi):
    """``J.backmap_sidechains_fast`` with the sweep's current dihedrals: pi
    across a bond whose two ends turn the plane chain different ways (by
    the sign of the turn's sine: a central angle's own, a branch's first
    side angle's, minus a later side angle's), else 0. Under
    ``jax.enable_x64`` it also gives back the difference between pi and
    the float32 pi that the JAX package's fast form takes from each
    branch's first side dihedral, so that its float64 result is the
    sweep's to float64 rounding."""
    t = jnp.sin(ca)
    cdi = cdi - jnp.pi * (t[:, :-1] * t[:, 1:] < 0)
    ends, first = [], []
    col = 0
    for v in J._side_atoms_per_res(spec):
        for k in range(int(v) - 1):
            ends.append((col + k, col + k + 1))
            first.append(float(k == 0))
        col += int(v)
    if ends:
        a, b = (np.asarray(x) for x in zip(*ends))
        first = np.asarray(first, np.dtype(sa.dtype))
        trans = (2 * first - 1) * jnp.sin(sa[:, a]) * -jnp.sin(sa[:, b]) < 0
        shift = jnp.pi * (first - trans)
        if sa.dtype == jnp.float64:
            shift = shift + first * (float(np.float32(np.pi)) - np.pi)
        sdi = sdi + shift
    return _FAST(spec, cd, ca, cdi, sd, sa, sdi)


@contextlib.contextmanager
def measured():
    """The JAX package's fast sidechain backmap is :func:`measured_fast`
    inside the block (its callers import it when they trace)."""
    J.backmap_sidechains_fast = measured_fast
    try:
        yield
    finally:
        J.backmap_sidechains_fast = _FAST
