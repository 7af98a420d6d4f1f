# encodermap_tpu_torch/ops/__init__.py
"""Numerical building blocks of the port: distances, backmapping, Kabsch,
the analytic and blocked Cartesian costs, the float64 ADC gradient oracle
``adc_adjoint``, and the kernel modules, ``fused_sigmoid`` (sketch-map
loss), ``fused_train`` (a chunk of EncoderMap steps), ``backmap``
(``_OneWay``), ``backmap_sidechains`` and ``clip_adam`` (the general
route's optimizer step). Counterpart of
``encodermap_tpu/ops``, with the same re-exports
(``encodermap_tpu/ops/__init__.py:3-39``). The kernel modules declare their
entry points with ``_build`` on import and build their CUDA libraries on
first launch."""

from . import adc_adjoint

from .backmap import (
    backmap,
    chain_in_plane,
    dihedral_to_cartesian_one_way,
    dihedrals_to_cartesian,
    guess_amide_H,
    guess_amide_O,
    merge_cartesians,
    rotation_matrices,
)
from .dssp import compute_dssp, kabsch_sander_hbonds
from .distances import (
    pairwise_dist,
    pairwise_dist_periodic,
    periodic_distance,
    periodic_distance_np,
    sigmoid,
)

__all__ = [
    "backmap",
    "chain_in_plane",
    "dihedral_to_cartesian_one_way",
    "dihedrals_to_cartesian",
    "guess_amide_H",
    "guess_amide_O",
    "merge_cartesians",
    "rotation_matrices",
    "compute_dssp",
    "kabsch_sander_hbonds",
    "pairwise_dist",
    "pairwise_dist_periodic",
    "periodic_distance",
    "periodic_distance_np",
    "sigmoid",
]
