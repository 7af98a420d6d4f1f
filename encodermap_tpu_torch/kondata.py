# encodermap_tpu_torch/kondata.py
"""Project dataset fetching (reference ``kondata.py:134-543``) and
``load_project``.

The reference downloads named tutorial datasets (trajs.h5, checkpoints)
from the University of Konstanz repository. A dataset resolves in this
order, as in the JAX package:

1. an existing local copy: ``output``, ``$ENCODERMAP_DATA_DIR/<name>`` or a
   ``mirror_dirs`` entry,
2. a download (:func:`_download`, which needs network access),
3. an error naming both.

Counterpart of ``encodermap_tpu/kondata.py``: host code, copied near
verbatim, with the download split out into :func:`_download` and
``device`` passed through ``load_project`` to ``from_checkpoint``.
``load_project`` reads ``.h5`` files and needs ``h5py``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

__all__ = ["get_from_kondata", "load_project"]

KONDATA_URL = "https://dx.doi.org/10.48606/99"

#: name -> KonDATA DOI, like the reference's mapping (``kondata.py:66-69``);
#: RADAR dataset ids are opaque, so names NOT in this table cannot be
#: fetched from KonDATA and fall back to the reference's second source
DATASET_URL_MAPPING = {
    "test": "https://dx.doi.org/10.48606/108",
    "H1Ub": "https://dx.doi.org/10.48606/99",
}


def _download_urls(dataset_name: str) -> list[str]:
    """Candidate download URLs in the reference's resolution order: the
    KonDATA RADAR endpoint derived from the dataset's DOI (when mapped),
    then the maintainer's plain-HTTP mirror (``kondata.py:176-177``)."""
    urls = []
    doi = DATASET_URL_MAPPING.get(dataset_name)
    if doi is not None:
        suffix = doi.rsplit("/", 1)[-1]
        urls.append(
            f"https://kondata.uni-konstanz.de/radar/api/datasets/"
            f"10.48606-{suffix}/download"
        )
    urls.append(f"https://sawade.io/encodermap_data/{dataset_name}.tar.gz")
    urls.append(f"https://sawade.io/encodermap_data/{dataset_name}.tar")
    return urls


def get_from_kondata(
    dataset_name: str,
    output: Optional[Union[str, Path]] = None,
    force_overwrite: bool = False,
    mk_parentdir: bool = False,
    silence_overwrite_message: bool = False,
    tqdm_class: Optional[object] = None,
    download_extra_data: bool = False,
    download_checkpoints: bool = False,
    download_h5: bool = True,
    mirror_dirs: tuple[str, ...] = (),
) -> str:
    """Obtain a named EncoderMap project dataset directory.

    Parameter names, order, and defaults match the reference
    (``kondata.py:134-144``) so positional call sites port verbatim;
    ``mirror_dirs`` is this package's keyword-only extension for
    egress-free environments. ``tqdm_class`` is accepted for
    compatibility (the urllib fetch here reports no per-chunk progress).

    Returns the local dataset directory path.
    """
    del tqdm_class
    if output is None:
        output = Path.cwd() / dataset_name
    output = Path(output)
    if not output.parent.exists():
        if mk_parentdir:
            output.parent.mkdir(parents=True)
        else:
            raise FileNotFoundError(
                f"parent directory {output.parent} does not exist; pass "
                f"mk_parentdir=True to create it (reference behavior)"
            )

    candidates = [output]
    env_dir = os.environ.get("ENCODERMAP_DATA_DIR")
    if env_dir:
        candidates.append(Path(env_dir) / dataset_name)
    candidates += [Path(m) / dataset_name for m in mirror_dirs]

    if not force_overwrite:
        for c in candidates:
            # a stray FILE named like the dataset is not a usable copy —
            # fall through to the download/error path instead of crashing
            # on iterdir()
            if c.is_dir() and any(c.iterdir()):
                if not silence_overwrite_message and c != output:
                    print(f"using local dataset copy at {c}")
                return str(c)

    try:
        _download(dataset_name, output, download_extra_data=download_extra_data,
                  download_checkpoints=download_checkpoints,
                  download_h5=download_h5)
        return str(output)
    except Exception as e:
        raise RuntimeError(
            f"Dataset {dataset_name!r} is not available locally "
            f"(searched {[str(c) for c in candidates]}) and could not be "
            f"downloaded ({type(e).__name__}: {e}). Place the files under "
            f"$ENCODERMAP_DATA_DIR/{dataset_name} or see {KONDATA_URL}."
        ) from e


def _download(dataset_name: str, output: Path, download_extra_data: bool,
              download_checkpoints: bool, download_h5: bool) -> None:
    """Download and unpack a dataset into ``output``. The archive is
    extracted into a temporary sibling and moved into place at the end, so
    a failed attempt leaves no partial copy that the local lookup of
    :func:`get_from_kondata` would later take for the dataset."""
    import shutil
    import tarfile
    import tempfile
    import urllib.request

    output.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(
        dir=output.parent, prefix=f".{dataset_name}.dl."
    ) as tmp:
        tmp = Path(tmp)
        target = tmp / f"{dataset_name}.tar"
        last_err: Optional[Exception] = None
        for url in _download_urls(dataset_name):
            try:
                urllib.request.urlretrieve(url, target)  # noqa: S310
                # an HTTP-200 error page (the RADAR API sends one) is not
                # a tar: try the next source
                if not tarfile.is_tarfile(target):
                    raise OSError(
                        f"{url} returned a non-tar body "
                        f"({target.stat().st_size} bytes)"
                    )
                break
            except Exception as e:  # try the next source
                last_err = e
        else:
            raise last_err if last_err is not None else RuntimeError(
                "no download sources"
            )
        extract = tmp / "extracted"
        extract.mkdir()

        def wanted(name: str) -> bool:
            # the download_* flags filter the archive's members
            low = name.lower()
            if not download_checkpoints and (
                "checkpoint" in low
                or low.endswith((".keras", ".ckpt", ".model"))
            ):
                return False
            if not download_h5 and low.endswith((".h5", ".hdf5")):
                return False
            if not download_extra_data and "extra_data" in low:
                return False
            return True

        with tarfile.open(target) as tf:
            members = [m for m in tf.getmembers() if wanted(m.name)]
            # "data" filter: refuse absolute paths, traversal and device
            # nodes in downloaded archives
            tf.extractall(extract, members=members, filter="data")
        if output.exists():
            shutil.rmtree(output)
        shutil.move(str(extract), str(output))


def load_project(
    project_name: str,
    traj: int = -1,
    load_autoencoder: bool = False,
    device=None,
):
    """Rebuild a project: the trajs (and, with ``load_autoencoder=True``,
    ``(trajs, autoencoder)``) from a downloaded project directory.

    Matches the reference contract (``__init__.py:631-747``): the default
    returns ONLY the ensemble (``load_autoencoder`` defaults False there
    too); ``traj > -1`` selects that single trajectory (a
    :class:`SingleTraj`) out of the ensemble. The autoencoder is built on
    ``device`` (the card unless ``device="cpu"``)."""
    from .data.trajectory import SingleTraj, TrajEnsemble

    root = Path(get_from_kondata(
        project_name, silence_overwrite_message=True,
        download_checkpoints=True, download_h5=True,
    ))
    h5_files = sorted(root.glob("*.h5"))
    trajs_h5 = [f for f in h5_files if "traj" in f.name.lower()]
    if not trajs_h5:
        trajs_h5 = h5_files
    if not trajs_h5:
        raise FileNotFoundError(f"no trajectory .h5 files in {root}")

    def _is_multi_group(path: Path) -> bool:
        # TrajEnsemble.save() writes one traj_N group per member; a
        # SingleTraj h5 has top-level coordinates/topology instead
        import h5py

        with h5py.File(path, "r") as f:
            return any(k.startswith("traj_") for k in f)

    members: list[SingleTraj] = []
    for f in trajs_h5:
        if _is_multi_group(f):
            members.extend(TrajEnsemble.from_dataset(f).trajs)
        else:
            members.append(SingleTraj(f))
    ensemble = TrajEnsemble(members)
    selected: Union[SingleTraj, TrajEnsemble] = ensemble
    if traj > -1:
        # the reference's guard is `traj > -1` (__init__.py:700) — any
        # negative value means "whole ensemble", and the selection is a
        # SingleTraj like `trajs[traj]` there
        selected = ensemble[traj]

    if not load_autoencoder:
        return selected

    # deterministic selection: iterdir() order is filesystem-dependent;
    # prefer the LAST run directory by name (runN sorts naturally enough
    # for the reference's run0/run1/... convention)
    ckpt_dirs = sorted(
        (d for d in root.iterdir() if d.is_dir()
         and (d / "parameters.json").exists()),
        key=lambda d: (len(d.name), d.name),
        reverse=True,
    )
    if (root / "parameters.json").exists():
        ckpt_dirs.insert(0, root)
    if not ckpt_dirs:
        return selected, None
    from .train.adc_autoencoder import AngleDihedralCartesianEncoderMap

    autoencoder = AngleDihedralCartesianEncoderMap.from_checkpoint(
        selected if isinstance(selected, TrajEnsemble)
        else TrajEnsemble([selected]),
        ckpt_dirs[0],
        device=device,
    )
    return selected, autoencoder
