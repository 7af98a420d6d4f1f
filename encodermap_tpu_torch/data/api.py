# encodermap_tpu_torch/data/api.py
"""The ``em.load()``-style entry point
(reference: ``encodermap/__init__.py:365-532``).

Counterpart of ``encodermap_tpu/data/api.py``; host numpy, copied near verbatim.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Union

from .trajectory import SingleTraj, TrajEnsemble

__all__ = ["load"]


def load(
    trajs: Union[str, Path, Sequence],
    tops: Optional[Union[str, Path, Sequence]] = None,
    common_str: Optional[Union[str, Sequence[str]]] = None,
    backend: str = "no_load",
    index: Optional[object] = None,
    traj_num: Optional[int] = None,
    basename_fn: Optional[Callable[[str], str]] = None,
    custom_top: Optional[dict] = None,
) -> Union[SingleTraj, TrajEnsemble]:
    """Load MD data lazily.

    A single file path returns a :class:`SingleTraj`; a sequence returns a
    :class:`TrajEnsemble`. No coordinate IO happens until frames are
    touched (``backend`` is accepted for reference compatibility; the only
    backend here is the lazy native one). ``basename_fn`` maps a file path
    to the display/matching basename; ``custom_top`` is a
    ``CustomAAsDict`` of unnatural residue definitions applied to every
    loaded trajectory (reference ``__init__.py:365-532``).
    """
    if backend not in ("no_load", "mdtraj"):
        raise ValueError(f"unknown backend {backend!r}")
    if isinstance(trajs, (str, Path)):
        if isinstance(common_str, (list, tuple)):
            common_str = common_str[0] if common_str else ""
        # the reference dispatches single .h5/.nc paths to
        # TrajEnsemble.from_dataset (__init__.py:505-509) — an ensemble
        # file is never a SingleTraj. Single-traj h5s (top-level layout)
        # wrap lazily so the return type still matches the reference's.
        if Path(trajs).suffix in (".h5", ".nc"):
            import h5py

            if isinstance(tops, (list, tuple)):
                tops = tops[0] if tops else None
            with h5py.File(trajs, "r") as f:
                multi = any(k.startswith("traj_") for k in f)
            if multi:
                out: Union[SingleTraj, TrajEnsemble] = (
                    TrajEnsemble.from_dataset(trajs)
                )
                if backend == "mdtraj":
                    # same eager-load contract as the sequence branch
                    # below — a corrupt member group must error HERE
                    for t in out.trajs:
                        t.load()
            else:
                out = TrajEnsemble([SingleTraj(
                    trajs, tops, common_str=common_str or "",
                    backend=backend, index=index, traj_num=traj_num,
                    basename_fn=basename_fn,
                )])
        else:
            top = tops
            if isinstance(tops, (list, tuple)):
                top = tops[0]
            out = SingleTraj(
                trajs, top, common_str=common_str or "", backend=backend,
                index=index, traj_num=traj_num, basename_fn=basename_fn,
            )
    else:
        if isinstance(tops, (str, Path)):
            tops = [tops]
        if isinstance(common_str, str):
            common_str = [common_str]
        out = TrajEnsemble(
            list(trajs), tops, common_str=common_str,
            basename_fn=basename_fn,
        )
        if backend == "mdtraj":
            # reference parity: backend="mdtraj" loads eagerly at
            # construction (a missing/corrupt file errors HERE, not at
            # first frame access)
            for t in out.trajs:
                t.load_traj()
    if custom_top is not None:
        out.load_custom_topology(custom_top)
    return out
