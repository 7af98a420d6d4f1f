# encodermap_tpu_torch/misc/saving.py
"""Checkpoints: parameter trees <-> npz files, plus the parameters.json
sidecar.

Counterpart of ``encodermap_tpu/misc/saving.py``, in the same format so that
a checkpoint written by either package loads in the other:

* ``saved_model_{step}.npz``: the parameters, keyed by JSON-encoded tree
  paths (``[["d", "encoder"], ["s", 0], ["d", "kernel"]]``);
* ``saved_model_{step}.opt.npz``: the Adam state, under the paths of the JAX
  package's optax ``chain(clip, adam)`` state (``count``, then ``mu`` and
  ``nu`` in JAX's leaf order, which the JAX loader relies on);
* ``saved_model_{step}.rng.npy``: the batch RNG, two uint32 words;
* ``parameters.json`` with ``current_training_step`` updated.

Reference ``.keras`` checkpoints (the files published EncoderMap projects
ship) are read through :mod:`.keras_import`, which needs ``h5py``. No pickle
anywhere.

A tp-sharded state (``parallel/mesh.py::shard_params_tp``) is saved whole:
:func:`save_checkpoint` gathers its shards over ``tp`` on every rank and
rank 0 writes, so the file loads on one device and in the JAX package.
On a tp mesh, ``shard_params_tp`` of the loaded parameters (and of the
Adam moments) shards them again.
"""

from __future__ import annotations

import json
import re
import warnings
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_checkpoint",
    "latest_checkpoint",
    "load_checkpoint",
    "load_checkpoint_rng",
    "load_opt_state",
    "load_pytree_into",
    "save_model",
    "load_model",
]

#: path of the optax Adam state inside ``(clip_state, (adam_state, lr_state))``
_ADAM_PATH = [["s", 1], ["s", 0]]
#: path of ``lr_state``'s count when the learning rate is a schedule
#: (optax's ``ScaleByScheduleState``; ``encodermap_tpu/train/core.py:62-77``)
_SCHEDULE_PATH = [["s", 1], ["s", 1], ["a", "count"]]


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: list) -> dict[str, np.ndarray]:
    """Path-keyed leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + [["d", k]]))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + [["s", i]]))
        return out
    return {json.dumps(prefix): _to_numpy(tree)}


def save_pytree(tree: Any, path: Union[str, Path]) -> str:
    """Save a dict/list tree of tensors or arrays to one .npz file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_flatten(tree, []))
    return str(path)


def _opt_tree(opt_state: dict, scheduled: bool = False) -> dict[str, np.ndarray]:
    """The Adam state under the JAX package's optax paths and leaf order;
    ``scheduled`` adds the schedule's count (equal to Adam's), the last
    leaf of optax's ``chain(clip, adam(schedule))`` state."""
    count = np.asarray(opt_state["count"], np.int32)
    out = {json.dumps(_ADAM_PATH + [["a", "count"]]): count}
    for name in ("mu", "nu"):
        out.update(_flatten(opt_state[name], _ADAM_PATH + [["a", name]]))
    if scheduled:
        out[json.dumps(_SCHEDULE_PATH)] = count
    return out


def load_pytree(path: Union[str, Path]) -> Any:
    """Rebuild the nested dict/list structure from a .npz written by
    :func:`save_pytree` (or by the JAX package); values are numpy arrays."""
    data = np.load(path, allow_pickle=False)
    entries = [(json.loads(key), data[key]) for key in data.files]
    if not entries:
        return {}

    def make_container(elem):
        return [] if elem[0] == "s" else {}

    def ensure(container, elem, nxt_container):
        kind, key = elem
        if kind in ("d", "a"):
            if key not in container:
                container[key] = nxt_container
            return container[key]
        if kind == "s":
            while len(container) <= key:
                container.append(None)
            if container[key] is None:
                container[key] = nxt_container
            return container[key]
        raise ValueError(f"unsupported path element {elem}")

    root = make_container(entries[0][0][0]) if entries[0][0] else None
    for path_elems, value in entries:
        if not path_elems:
            return value
        node = root
        for i, elem in enumerate(path_elems[:-1]):
            node = ensure(node, elem, make_container(path_elems[i + 1]))
        kind, key = path_elems[-1]
        if kind == "s":
            while len(node) <= key:
                node.append(None)
        node[key] = value
    return root


def save_checkpoint(
    main_path: Union[str, Path],
    params: Any,
    step: int,
    opt_state: Optional[dict] = None,
    parameters: Any = None,
    prefix: str = "saved_model",
    rng: Any = None,
    scheduled: bool = False,
) -> str:
    """Write ``{prefix}_{step}.npz`` (+ ``.opt.npz``, ``.rng.npy``) and
    refresh ``parameters.json`` with the current step. ``scheduled``: the
    optimizer's learning rate is a schedule, whose optax state holds a
    count of its own. Parameters (and Adam moments) sharded over ``tp`` are
    gathered whole first, a collective that every rank must join; then
    only rank 0 writes (the others return None)."""
    from ..nn import has_tp_layers

    if has_tp_layers(params):
        from ..parallel.distributed import is_primary
        from ..parallel.mesh import unshard_params_tp

        params = unshard_params_tp(params)
        if opt_state is not None:
            opt_state = dict(opt_state, mu=unshard_params_tp(opt_state["mu"]),
                             nu=unshard_params_tp(opt_state["nu"]))
        if not is_primary():
            return None
    main_path = Path(main_path)
    main_path.mkdir(parents=True, exist_ok=True)
    ckpt = main_path / f"{prefix}_{step}.npz"
    save_pytree(params, ckpt)
    if opt_state is not None:
        np.savez(main_path / f"{prefix}_{step}.opt.npz",
                 **_opt_tree(opt_state, scheduled))
    if rng is not None:
        np.save(main_path / f"{prefix}_{step}.rng.npy",
                np.asarray(rng, np.uint32))
    if parameters is not None:
        parameters.current_training_step = int(step)
        parameters.save(main_path / "parameters.json", backup=False)
    return str(ckpt)


def latest_checkpoint(main_path: Union[str, Path],
                      prefix: str = "saved_model"
                      ) -> Optional[tuple[str, int]]:
    """The newest ``{prefix}_{step}.npz`` by step number, or None."""
    best = None
    pattern = re.compile(rf"{re.escape(prefix)}_(\d+)\.npz$")
    for f in Path(main_path).glob(f"{prefix}_*.npz"):
        m = pattern.match(f.name)
        if m and (best is None or int(m.group(1)) > best[1]):
            best = (str(f), int(m.group(1)))
    return best


def _sibling(path: Path, suffix: str) -> Optional[Path]:
    """The ``.opt.npz``/``.rng.npy`` sibling of a ``*.npz`` checkpoint."""
    if path.suffix == ".npz" and not str(path).endswith(suffix):
        return Path(str(path)[: -len(".npz")] + suffix)
    warnings.warn(
        f"checkpoint {path.name!r} does not end in '.npz'; its "
        f"'{suffix}' sidecar (optimizer state / RNG) cannot be derived and "
        f"will not be restored. Keep the saved_model_N.npz naming to resume "
        f"exactly.", stacklevel=3)
    return None


def load_checkpoint(path: Union[str, Path], prefix: str = "saved_model",
                    n_encoder: Optional[int] = None
                    ) -> tuple[Any, Optional[str], int]:
    """``(params, opt_npz_path_or_None, step)`` from a checkpoint file or
    the newest checkpoint in a directory; params are numpy arrays. A
    ``.keras`` file, or a directory holding only ``saved_model_*.keras``,
    gives no optimizer state and its file name's step (-1 for a name
    stamped with a time)."""
    path = Path(path)
    if path.suffix == ".keras":
        # a reference-format checkpoint given explicitly; n_encoder (the
        # encoder's depth, len(p.n_neurons)) splits files whose Dense
        # layers are not named Encoder_i/Decoder_i
        from .keras_import import import_keras_checkpoint

        params, step = import_keras_checkpoint(path, n_encoder=n_encoder)
        return params, None, step
    if path.is_dir():
        found = latest_checkpoint(path, prefix)
        if found is None:
            # reference-layout project directories (kondata downloads,
            # reference training runs) hold .keras checkpoints instead
            from .keras_import import import_keras_checkpoint, latest_keras_checkpoint

            kfound = latest_keras_checkpoint(path)
            if kfound is not None:
                params, step = import_keras_checkpoint(Path(kfound[0]),
                                                       n_encoder=n_encoder)
                return params, None, step
            raise FileNotFoundError(f"no {prefix}_*.npz or saved_model_*.keras "
                                    f"checkpoints in {path}")
        path = Path(found[0])
    m = re.match(rf"{re.escape(prefix)}_(\d+)\.npz$", path.name)
    step = int(m.group(1)) if m else 0
    params = load_pytree(path)
    opt_file = _sibling(path, ".opt.npz")
    opt = str(opt_file) if opt_file is not None and opt_file.exists() else None
    return params, opt, step


def load_opt_state(path: Union[str, Path]) -> dict:
    """The Adam state ``{"count": int, "mu": tree, "nu": tree}`` (numpy
    leaves) of an ``.opt.npz`` written by either package."""
    tree = load_pytree(path)

    def find(node):
        if isinstance(node, dict) and "mu" in node:
            return node
        if isinstance(node, (list, tuple)):
            for v in node:
                found = find(v)
                if found is not None:
                    return found
        return None

    adam = find(tree)
    if adam is None:
        raise ValueError(f"{path} holds no Adam state (mu/nu)")
    return {"count": int(adam["count"]), "mu": adam["mu"], "nu": adam["nu"]}


def load_checkpoint_rng(path: Union[str, Path], prefix: str = "saved_model"
                        ) -> Optional[np.ndarray]:
    """The RNG stored next to a checkpoint, or None."""
    path = Path(path)
    if path.is_dir():
        found = latest_checkpoint(path, prefix)
        if found is None:
            return None
        path = Path(found[0])
    rng_file = _sibling(path, ".rng.npy")
    if rng_file is not None and rng_file.exists():
        return np.load(rng_file)
    return None


def load_pytree_into(template: Any, path: Union[str, Path]) -> Any:
    """The leaves of a .npz in the structure of ``template`` (a dict/list
    tree), in the file's order; the leaf counts must agree, as they do for
    a freshly built state of the same model. Leaves are numpy arrays."""
    from ..train.core import tree_leaves, tree_unflatten

    data = np.load(path, allow_pickle=False)
    leaves = tree_leaves(template)
    saved = [data[k] for k in data.files]
    if len(saved) != len(leaves):
        raise ValueError(f"checkpoint {path} has {len(saved)} leaves, template "
                         f"has {len(leaves)}")
    return tree_unflatten(template, saved)


def save_model(model, main_path=None, inp_class_name=None, step=None,
               print_message: bool = False) -> Optional[str]:
    """Checkpoint an autoencoder under the reference's name
    (``saving_loading_models.py:201-330``): ``model.save(step)``.
    ``main_path`` defaults to the model's own ``p.main_path`` and must
    match it otherwise. Returns the checkpoint path."""
    if main_path is not None and str(main_path) != str(model.p.main_path):
        raise ValueError(
            f"save_model writes into the model's own main_path "
            f"({model.p.main_path}); to save elsewhere set p.main_path "
            f"first (got main_path={main_path})")
    out = model.save(step=step)
    if print_message and out is not None:
        print(f"Saved {inp_class_name or type(model).__name__} checkpoint at {out}")
    return out


def load_model(autoencoder=None, checkpoint_path=None, trajs=None,
               sparse: bool = False, dataset=None,
               print_message: bool = False, submodel: str = None,
               use_previous_model: bool = False, train_data=None,
               device=None):
    """Reload an autoencoder under the reference's name
    (``saving_loading_models.py:333-626``) from a checkpoint file or run
    directory.

    ``autoencoder`` is the class to build, or None to take it from the
    checkpoint's ``parameters.json`` (ADC keys mean the ADC). ``trajs`` (or
    ``dataset``) feed an ADC, ``train_data`` (or ``dataset``) the others;
    ``submodel="encoder"``/``"decoder"`` returns that bound callable;
    ``device`` goes to the constructor (None means the card).
    """
    if checkpoint_path is None:
        raise ValueError("load_model needs a checkpoint_path")
    ckpt = Path(checkpoint_path)
    directory = ckpt if ckpt.is_dir() else ckpt.parent
    from ..train.adc_autoencoder import AngleDihedralCartesianEncoderMap
    from ..train.autoencoder import EncoderMap

    cls = autoencoder
    if cls is None:
        pfile = directory / "parameters.json"
        keys = set(json.loads(pfile.read_text())) if pfile.exists() else set()
        cls = (AngleDihedralCartesianEncoderMap
               if "cartesian_cost_scale" in keys or "use_backbone_angles" in keys
               else EncoderMap)
    if issubclass(cls, AngleDihedralCartesianEncoderMap):
        out = cls.from_checkpoint(trajs, checkpoint_path,
                                  use_previous_model=use_previous_model,
                                  dataset=dataset, device=device)
    else:
        if train_data is None and dataset is not None:
            train_data = dataset
        out = cls.from_checkpoint(checkpoint_path, train_data=train_data,
                                  sparse=sparse,
                                  use_previous_model=use_previous_model,
                                  device=device)
    if print_message:
        print(f"Loaded {type(out).__name__} from {checkpoint_path}")
    if submodel is not None:
        if submodel not in ("encoder", "decoder"):
            raise ValueError(f"submodel must be 'encoder' or 'decoder', got {submodel!r}")
        return out.encode if submodel == "encoder" else out.decode
    return out
