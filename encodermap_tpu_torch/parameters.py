# encodermap_tpu_torch/parameters.py
"""Configuration objects of the PyTorch port.

Counterpart of ``encodermap_tpu/parameters.py``, copied field for field
(names, defaults, JSON/YAML round-trip, ``main_path`` self-repair) so that a
``parameters.json`` written by either package loads in the other. The port
keeps its own copy because it imports nothing of the JAX package.

Fields that only the JAX package acts on (``mesh_shape``) are stored for
round-trips; ``fused_trainer`` and ``steps_per_scan`` drive the port's
trainer exactly as they drive the JAX one.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from math import pi
from pathlib import Path
from typing import Any, Optional, Union

__all__ = ["Parameters", "ADCParameters", "search_and_replace"]


def _as_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return x


def search_and_replace(
    file_path: Union[str, Path],
    search_pattern: str,
    replacement: str,
    backup: bool = True,
) -> None:
    """Search and replace inside a text file (used for main_path relocation
    repair, mirroring the reference parameter loader's behavior)."""
    file_path = Path(file_path)
    text = file_path.read_text()
    if backup:
        file_path.with_suffix(file_path.suffix + ".bak").write_text(text)
    file_path.write_text(text.replace(search_pattern, replacement))


@dataclass
class ParametersFramework:
    """Shared machinery: dict access, JSON/YAML save/load, pretty table.

    Unknown keys passed to ``from_dict``/``from_file`` are dropped with a
    message (reference: ``parameters.py:154-220``).
    """

    main_path: str = "."

    # ------------------------------------------------------------------ dict-style access
    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    def update(self, **kwargs: Any) -> None:
        known = {f.name for f in fields(self)}
        unknown = sorted(set(kwargs) - known)
        if unknown:
            # an explicit setter must not swallow typos silently
            # (p.update(learning_rte=...) losing the change)
            raise TypeError(f"unknown parameter(s): {unknown}")
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def defaults(self) -> dict[str, Any]:
        return {f.name: f.default if f.default is not dataclasses.MISSING
                else f.default_factory() for f in fields(type(self))}

    @classmethod
    def defaults_description(cls) -> str:
        """A tabulated description of the default parameter values."""
        lines = [f"{'Parameter':<40}{'Default':<30}"]
        for f in fields(cls):
            d = f.default if f.default is not dataclasses.MISSING else f.default_factory()
            lines.append(f"{f.name:<40}{str(d):<30}")
        return "\n".join(lines)

    # ------------------------------------------------------------------ (de)serialization
    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ParametersFramework":
        known = {f.name for f in fields(cls)}
        dropped = sorted(set(d) - known)
        if dropped:
            print(f"Dropping unknown parameter keys: {dropped}")
        kwargs = {k: v for k, v in d.items() if k in known}
        # legacy key migration: the reference computes
        # n_steps = n_epochs * n_steps_per_epoch (``parameters.py:336-341``)
        if "n_epochs" in d and "n_steps" not in kwargs:
            kwargs["n_steps"] = int(d["n_epochs"]) * int(
                d.get("n_steps_per_epoch", 1)
            )
        return cls(**kwargs)

    def save(self, path: Optional[Union[str, Path]] = None,
             backup: bool = True) -> str:
        """Write parameters as JSON (or YAML if path ends in .yaml/.yml).

        Reference parity (``parameters.py:237-246``): an existing file is
        backed up to ``<stem>_back_<timestamp><ext>`` first (never silently
        overwritten), and an unrecognized extension raises OSError.
        ``backup=False`` is for the trainer's periodic
        ``current_training_step`` refreshes (the reference writes nothing
        there — a backup per checkpoint would be pure clutter)."""
        if path is None:
            path = Path(self.main_path) / "parameters.json"
        path = Path(path)
        ext = path.suffix.lstrip(".")
        if ext not in ("json", "yaml", "yml"):
            raise OSError(
                f"Unrecognized extension .{ext} in path {path}. "
                f"Please provide either '.json' or '.yaml'"
            )
        path.parent.mkdir(parents=True, exist_ok=True)
        if backup and path.is_file():
            import datetime

            stamp = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
            path.rename(
                path.with_name(f"{path.stem}_back_{stamp}{path.suffix}")
            )
        d = self.to_dict()
        # JSON can't express inf; store as string sentinel
        if d.get("periodicity") == float("inf"):
            d["periodicity"] = "inf"
        if str(path).endswith((".yaml", ".yml")):
            try:
                import yaml  # type: ignore

                path.write_text(yaml.safe_dump(d))
            except ImportError:
                raise ValueError(
                    "PyYAML is not available in this environment; save as .json"
                )
        else:
            path.write_text(json.dumps(d, indent=2, default=str))
        return str(path)

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "ParametersFramework":
        """Load parameters from a JSON/YAML file.

        If the file was relocated (its recorded ``main_path`` no longer
        matches its actual location), ``main_path`` is repaired in-place,
        mirroring the reference loader (``parameters.py:360-365``).
        """
        path = Path(path)
        text = path.read_text()
        if str(path).endswith((".yaml", ".yml")):
            import yaml  # type: ignore

            d = yaml.safe_load(text)
        else:
            d = json.loads(text)
        if d.get("periodicity") == "inf":
            d["periodicity"] = float("inf")
        p = cls.from_dict(d)
        recorded = Path(p.main_path).resolve()
        actual = path.resolve().parent
        # path-PART comparison, not startswith: '/work/run10' must not
        # count as being inside '/work/run1'
        inside = recorded == actual or recorded in actual.parents
        if recorded != actual and not inside:
            print(
                "seems like the parameter file was moved to another directory. "
                "Parameter file is updated accordingly."
            )
            p.main_path = str(actual)
            p.save(path)
        return p

    def _setup_main_path(self, subdir_prefix: str = "run") -> None:
        """Create a unique run directory under main_path (runN), mirroring the
        reference's run-directory behavior."""
        base = Path(self.main_path)
        if base.name.startswith(subdir_prefix) and base.name[len(subdir_prefix):].isdigit():
            base.mkdir(parents=True, exist_ok=True)
            return
        i = 0
        while (base / f"{subdir_prefix}{i}").exists():
            i += 1
        run_path = base / f"{subdir_prefix}{i}"
        run_path.mkdir(parents=True, exist_ok=True)
        self.main_path = str(run_path)


@dataclass
class Parameters(ParametersFramework):
    """Parameters for the plain :class:`EncoderMap` autoencoder.

    Field semantics and defaults match the reference
    (``parameters.py:611-639``):

    - ``n_neurons``: neurons per encoder layer up to the bottleneck, mirrored
      for the decoder. ``[128, 128, 2]`` -> {i, 128, 128, 2, 128, 128, i}.
    - ``activation_functions``: names per layer; "" means linear. Encoder
      takes entries [1:], decoder reversed [-2::-1] (+ final "").
    - ``periodicity``: input periodicity; ``float('inf')`` for non-periodic.
    - ``dist_sig_parameters``: (sig_h, a_h, b_h, sig_l, a_l, b_l).

    Examples:
        >>> import tempfile
        >>> from encodermap_tpu_torch import Parameters
        >>> p = Parameters(periodicity=float("inf"), n_steps=50)
        >>> p.n_neurons          # reference defaults
        [128, 128, 2]
        >>> p["batch_size"]      # dict-style access works too
        256
        >>> with tempfile.TemporaryDirectory() as td:
        ...     p2 = Parameters(main_path=td)
        ...     path = p2.save()
        ...     loaded = Parameters.from_file(path)
        >>> loaded.n_steps == p2.n_steps
        True
    """

    n_neurons: list[int] = field(default_factory=lambda: [128, 128, 2])
    activation_functions: list[str] = field(
        default_factory=lambda: ["", "tanh", "tanh", ""]
    )
    periodicity: float = 2 * pi
    learning_rate: float = 0.001
    n_steps: int = 1000
    batch_size: int = 256
    summary_step: int = 10
    checkpoint_step: int = 5000
    dist_sig_parameters: tuple = (4.5, 12, 6, 1, 2, 6)
    distance_cost_scale: Optional[float] = 500
    auto_cost_scale: Optional[float] = 1
    auto_cost_variant: str = "mean_abs"
    center_cost_scale: Optional[float] = 0.0001
    l2_reg_constant: float = 0.001
    gpu_memory_fraction: float = 0
    analysis_path: str = ""
    id: str = ""
    model_api: str = "sequential"
    loss: str = "emap_cost"
    training: str = "auto"
    batched: bool = True
    tensorboard: bool = False
    seed: Optional[int] = None
    current_training_step: int = 0
    write_summary: bool = False
    trainable_dense_to_sparse: bool = False
    using_hypercube: bool = False
    # --- extensions of the JAX package (absent in the reference) ---
    # dtype used for matmuls inside the network ("float32" or "bfloat16").
    compute_dtype: str = "float32"
    # how many optimizer steps run per trainer call (one chunk)
    steps_per_scan: int = 100
    # data parallelism over one process per device, e.g. {"dp": 4}
    # (parallel/mesh.py); None trains on one device
    mesh_shape: Optional[dict] = None
    # route eligible configs through the fused train kernel
    # (ops/fused_train.py); False forces the general autograd path
    fused_trainer: bool = True

    def __post_init__(self):
        self.dist_sig_parameters = _as_tuple(self.dist_sig_parameters)
        self.n_neurons = list(self.n_neurons)
        self.activation_functions = list(self.activation_functions)
        if len(self.n_neurons) != len(self.activation_functions) - 1:
            # reference raises at construction (``parameters.py:204-207``);
            # without this, layer building zip-truncates and silently
            # assigns wrong activations (e.g. tanh on the latent layer)
            raise ValueError(
                f"Length of `n_neurons` and `activation_functions` (-1) "
                f"does not match: {self.n_neurons}, "
                f"{self.activation_functions}"
            )


@dataclass
class ADCParameters(Parameters):
    """Parameters for the AngleDihedralCartesianEncoderMap.

    Additional fields and defaults match the reference
    (``parameters.py:794-828``).
    """

    model_api: str = "functional"
    track_clashes: bool = False
    track_RMSD: bool = False
    cartesian_pwd_start: Optional[int] = None
    cartesian_pwd_stop: Optional[int] = None
    cartesian_pwd_step: Optional[int] = None
    use_backbone_angles: bool = False
    use_sidechains: bool = False
    angle_cost_scale: Optional[float] = 0
    angle_cost_variant: str = "mean_abs"
    angle_cost_reference: float = 1
    dihedral_cost_scale: Optional[float] = 1
    dihedral_cost_variant: str = "mean_abs"
    dihedral_cost_reference: float = 1
    side_dihedral_cost_scale: Optional[float] = 0.5
    side_dihedral_cost_variant: str = "mean_abs"
    side_dihedral_cost_reference: float = 1
    cartesian_cost_scale: Optional[float] = 1
    cartesian_cost_scale_soft_start: tuple = (None, None)
    cartesian_cost_variant: str = "mean_abs"
    cartesian_cost_reference: float = 1
    cartesian_dist_sig_parameters: tuple = (4.5, 12, 6, 1, 2, 6)
    cartesian_distance_cost_scale: Optional[float] = 1
    auto_cost_scale: Optional[float] = None
    distance_cost_scale: Optional[float] = None
    multimer_training: Optional[Any] = None
    multimer_topology_classes: Optional[Any] = None
    multimer_connection_bridges: Optional[Any] = None
    multimer_lengths: Optional[Any] = None
    reconstruct_sidechains: bool = False
    # residue (1-based) -> number of sidechain dihedrals; required when
    # reconstruct_sidechains=True (auto-filled from the topology when a
    # TrajEnsemble is provided). The reference stores the same mapping as
    # `sidechain_info` on its parameters.
    sidechain_info: Optional[dict] = None

    def __post_init__(self):
        super().__post_init__()
        self.cartesian_dist_sig_parameters = _as_tuple(
            self.cartesian_dist_sig_parameters
        )
        self.cartesian_cost_scale_soft_start = _as_tuple(
            self.cartesian_cost_scale_soft_start
        )
