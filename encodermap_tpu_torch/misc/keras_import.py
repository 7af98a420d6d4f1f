# encodermap_tpu_torch/misc/keras_import.py
"""Import weights from the reference's ``.keras`` checkpoints.

The reference's primary persistence is portable ``.keras`` files
(``encodermap/misc/saving_loading_models.py:201-268`` save,
``:333-628`` load) named ``saved_model_{step|isotime}.keras`` (plus optional
``*_encoder.keras`` / ``*_decoder.keras`` submodels), and its kondata
projects ship them. This module lets :func:`~encodermap_tpu_torch.misc.saving.
load_checkpoint` (and therefore every ``from_checkpoint`` /
``load_project`` flow) consume those files directly.

No TensorFlow import is needed: a ``.keras`` file is a zip holding
``config.json`` (the layer graph, real layer names, build order) and
``model.weights.h5``. The reference's models keep all their weights in
``Dense`` layers named ``Encoder_{i}`` / ``Decoder_{i}``
(``models/models.py:1720,1870``) inside submodels named "Encoder" /
"Decoder" — exactly the two MLP stacks of this framework's param pytree —
so the mapping is by name, with shape verification. The reference's custom
layers (PeriodicInput/Output, BackMapLayer, ...) are weightless, so their
classes never need to be deserialized.

Keras-3 weight-file layout (verified against the in-image keras): each
layer's variables live under a path of *generic per-class keys* assigned in
config order — e.g. the second ``Functional`` sublayer is
``layers/functional_1``, its first ``Dense`` is ``.../layers/dense`` —
while ``config.json`` carries the real names. The walker below mirrors the
config tree onto the h5 tree to recover name -> weights.

Counterpart of ``encodermap_tpu/misc/keras_import.py``; host numpy, copied
near verbatim, so both packages import a file to the same arrays. It needs
``h5py`` (imported where a file is read), which only the host side has.
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np

__all__ = [
    "read_keras_dense_weights",
    "keras_weights_to_pytree",
    "latest_keras_checkpoint",
    "import_keras_checkpoint",
]


def _snake(class_name: str) -> str:
    """Keras's generic per-class h5 key base ("InputLayer" ->
    "input_layer")."""
    return re.sub(r"(?<!^)(?=[A-Z])", "_", class_name).lower()


def _walk(cfg_layers: list, h5_group, prefix: str, out: list) -> None:
    counters: dict[str, int] = {}
    for layer in cfg_layers:
        cls = layer["class_name"]
        name = layer.get("config", {}).get("name", cls)
        k = counters.get(cls, 0)
        counters[cls] = k + 1
        key = _snake(cls) if k == 0 else f"{_snake(cls)}_{k}"
        if h5_group is None or key not in h5_group:
            continue
        node = h5_group[key]
        if cls in ("Functional", "Sequential") or "layers" in node:
            _walk(
                layer.get("config", {}).get("layers", []),
                node.get("layers"),
                prefix + name + "/",
                out,
            )
        elif "vars" in node and "0" in node["vars"]:
            v = node["vars"]
            out.append({
                "name": prefix + name,
                "class": cls,
                "kernel": np.asarray(v["0"]),
                "bias": np.asarray(v["1"]) if "1" in v else None,
            })


def read_keras_dense_weights(path: Union[str, Path]) -> list[dict]:
    """All weighted layers of a ``.keras`` file as
    ``[{name, class, kernel, bias}]`` in build order, names taken from the
    embedded ``config.json`` (e.g. ``Encoder/Encoder_0``)."""
    path = Path(path)
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        if "config.json" not in names or "model.weights.h5" not in names:
            raise ValueError(
                f"{path} is not a keras-v3 checkpoint (missing config.json "
                f"or model.weights.h5 in the archive)"
            )
        cfg = json.load(z.open("config.json"))
        import h5py

        top = cfg.get("config", {})
        layers_cfg = top.get("layers")
        with z.open("model.weights.h5") as f:
            with h5py.File(io.BytesIO(f.read()), "r") as h:
                out: list[dict] = []
                if layers_cfg is not None:
                    # functional/sequential model: the weights live under
                    # "layers" with generic per-class keys mirroring the
                    # config's layer list
                    _walk(layers_cfg, h.get("layers"), "", out)
                else:
                    # subclassed model (the reference's base-EncoderMap
                    # ``SequentialModel``, ``models/models.py:3283-3306``):
                    # no top-level layer graph. Its weighted sublayers are
                    # the serialized-submodel VALUES of get_config
                    # ("encoder"/"decoder" Sequential stacks, optionally
                    # "get_dense_model"), and the h5 tree keys each
                    # submodel by its ATTRIBUTE name (``encoder_model``,
                    # verified against in-image keras-3) — match config
                    # key -> h5 group by name prefix.
                    for key, val in top.items():
                        if not (
                            isinstance(val, dict)
                            and "class_name" in val
                            and isinstance(val.get("config"), dict)
                        ):
                            continue
                        grp = None
                        for hk in h:
                            if hk == key or hk == f"{key}_model":
                                grp = h[hk]
                                break
                        if grp is None or "layers" not in grp:
                            continue
                        name = val["config"].get("name", key)
                        _walk(
                            val["config"].get("layers", []),
                            grp["layers"], name + "/", out,
                        )
    if not out:
        raise ValueError(
            f"found no weighted layers in {path} — unsupported keras "
            f"save-file layout (expected keras-3 'layers/<class_key>/vars')"
        )
    return out


def _indexed(denses: list[dict], tag: str) -> Optional[list[dict]]:
    """The layers named ``{tag}_{i}`` (the reference's naming), sorted by
    ``i``; None if none match."""
    pat = re.compile(rf"(^|/){tag}_(\d+)$")
    hits = []
    for d in denses:
        m = pat.search(d["name"])
        if m:
            hits.append((int(m.group(2)), d))
    if not hits:
        return None
    hits.sort(key=lambda x: x[0])
    return [d for _, d in hits]


def keras_weights_to_pytree(
    denses: list[dict], n_encoder: Optional[int] = None
) -> dict:
    """Map ``read_keras_dense_weights`` output onto this framework's
    ``{"encoder": [...], "decoder": [...]}`` pytree.

    Primary mapping is by the reference's layer names
    (``Encoder_{i}`` / ``Decoder_{i}``); when a file carries other names
    (hand-built keras models), falls back to splitting the dense sequence
    at ``n_encoder`` layers. Shape chain consistency is verified."""
    enc = _indexed(denses, "Encoder")
    dec = _indexed(denses, "Decoder")
    if enc is not None:
        # the reference's subclassed SequentialModel names its bottleneck
        # Dense "Latent" (``models/models.py:3152``) between Encoder_{k}
        # and Decoder_0 — it is the last layer of this framework's
        # encoder stack (the shape-chain check below verifies the splice)
        latent = [d for d in denses if d["name"].split("/")[-1] == "Latent"]
        enc = enc + latent
    if enc is None or dec is None:
        others = [d["name"] for d in denses
                  if "Sparse" in d["name"] or "dense_to_sparse" in d["name"]]
        if others:
            raise ValueError(
                "this .keras checkpoint holds sparse-input densifier "
                f"layers ({others}); importing sparse reference models is "
                "not supported — retrain, or export dense weights"
            )
        if n_encoder is None:
            raise ValueError(
                "the checkpoint's dense layers are not named "
                "Encoder_i/Decoder_i; pass n_encoder to split "
                f"positionally (found: {[d['name'] for d in denses]})"
            )
        enc, dec = denses[:n_encoder], denses[n_encoder:]
    if not enc or not dec:
        raise ValueError("checkpoint is missing encoder or decoder layers")
    chain = enc + dec
    for a, b in zip(chain[:-1], chain[1:]):
        if a["kernel"].shape[1] != b["kernel"].shape[0]:
            raise ValueError(
                f"layer shapes do not chain: {a['name']} "
                f"{a['kernel'].shape} -> {b['name']} {b['kernel'].shape}"
            )

    def _leaf(d: dict) -> dict:
        bias = d["bias"]
        if bias is None:
            bias = np.zeros(d["kernel"].shape[1], d["kernel"].dtype)
        return {
            "kernel": np.asarray(d["kernel"], np.float32),
            "bias": np.asarray(bias, np.float32),
        }

    return {
        "encoder": [_leaf(d) for d in enc],
        "decoder": [_leaf(d) for d in dec],
    }


_STEP_RE = re.compile(r"saved_model_(\d+)\.keras$")


def latest_keras_checkpoint(
    directory: Union[str, Path]
) -> Optional[tuple[str, int]]:
    """Newest full-model ``saved_model_*.keras`` in a directory (submodel
    ``*_encoder/_decoder.keras`` files are skipped), matching the
    reference's sorting: numeric steps win by step, ISO-time names by
    mtime (``saving_loading_models.py:297-330``)."""
    directory = Path(directory)
    numbered, timed = [], []
    for f in directory.glob("saved_model_*.keras"):
        if f.name.endswith(("_encoder.keras", "_decoder.keras")):
            continue
        m = _STEP_RE.match(f.name)
        if m:
            numbered.append((int(m.group(1)), f))
        else:
            timed.append((f.stat().st_mtime, f))
    if numbered:
        step, f = max(numbered, key=lambda x: x[0])
        return str(f), step
    if timed:
        # ISO-time-named checkpoints carry no step; -1 = "unknown, adopt
        # parameters.json's current_training_step"
        _, f = max(timed, key=lambda x: x[0])
        return str(f), -1
    return None


def import_keras_checkpoint(
    path: Union[str, Path], n_encoder: Optional[int] = None
) -> tuple[dict, int]:
    """``(params_pytree, step)`` from a ``.keras`` file or a directory of
    reference checkpoints."""
    path = Path(path)
    step = 0
    if path.is_dir():
        found = latest_keras_checkpoint(path)
        if found is None:
            raise FileNotFoundError(
                f"no saved_model_*.keras checkpoints in {path}"
            )
        path, step = Path(found[0]), found[1]
    else:
        m = _STEP_RE.match(path.name)
        step = int(m.group(1)) if m else -1
    denses = read_keras_dense_weights(path)
    return keras_weights_to_pytree(denses, n_encoder=n_encoder), step
