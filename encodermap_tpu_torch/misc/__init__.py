# encodermap_tpu_torch/misc/__init__.py
"""Host-side utilities of the port: toy data, checkpoints, metrics logs
and TensorBoard events, images, and the names the reference's ``em.misc``
exports (counterpart of ``encodermap_tpu/misc``). Profiling and
``function`` live in ``misc/profiling.py`` and ``misc/function_def.py``."""

from ..ops.backmap import (
    guess_amide_H,
    guess_amide_O,
    guess_sp2_atom,
    merge_cartesians,
    split_and_reverse_cartesians,
    split_and_reverse_dihedrals,
)
from ..ops.backmap import rotation_matrices as rotation_matrix
from ..ops.distances import (
    pairwise_dist,
    pairwise_dist_periodic,
    periodic_distance,
    periodic_distance_np,
    sigmoid,
)
from .backmapping_offline import dihedral_backmapping, mdtraj_backmapping, mdtraj_rotate
from .misc import (
    all_equal,
    arbitrary_dihedral,
    backbone_hydrogen_oxygen_crossproduct,
    create_n_cube,
    get_full_common_str_and_ref,
    match_files,
    plot_model,
    printTable,
    random_on_cube_edges,
    run_path,
    temp_seed,
)
from .saving import (
    latest_checkpoint,
    load_checkpoint,
    load_model,
    load_pytree,
    save_checkpoint,
    save_model,
    save_pytree,
)
from .summaries import (
    MetricsWriter,
    add_layer_summaries,
    histogram_summary,
    image_summary,
)

__all__ = [
    "load_model",
    "save_model",
    "all_equal",
    "arbitrary_dihedral",
    "backbone_hydrogen_oxygen_crossproduct",
    "create_n_cube",
    "dihedral_backmapping",
    "get_full_common_str_and_ref",
    "guess_amide_H",
    "guess_amide_O",
    "guess_sp2_atom",
    "match_files",
    "mdtraj_backmapping",
    "mdtraj_rotate",
    "merge_cartesians",
    "rotation_matrix",
    "split_and_reverse_cartesians",
    "split_and_reverse_dihedrals",
    "temp_seed",
    "MetricsWriter",
    "add_layer_summaries",
    "histogram_summary",
    "image_summary",
    "pairwise_dist",
    "pairwise_dist_periodic",
    "periodic_distance",
    "periodic_distance_np",
    "plot_model",
    "printTable",
    "random_on_cube_edges",
    "run_path",
    "sigmoid",
    "latest_checkpoint",
    "load_checkpoint",
    "load_pytree",
    "save_checkpoint",
    "save_pytree",
]
