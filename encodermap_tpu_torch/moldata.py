# encodermap_tpu_torch/moldata.py
"""MolData back-compat shim (reference ``moldata/moldata.py:72-192``): turns
a trajectory into the six ADC CV arrays as attributes, for code written
against the EncoderMap 2.x MolData API.

Counterpart of ``encodermap_tpu/moldata.py`` on the port's featurizer;
``device`` goes to ``load_CVs`` (the card unless ``device="cpu"``)."""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

__all__ = ["MolData"]


class MolData:
    """Featurize a trajectory into the classic MolData attribute set:
    ``angles, dihedrals, cartesians, distances, sidedihedrals, central_cartesians``.
    """

    def __init__(self, trajs: Any, cache_path: str = "", top: Any = None,
                 device: Any = None) -> None:
        from .data.trajectory import SingleTraj, TrajEnsemble

        if isinstance(trajs, (str, Path)):
            trajs = [trajs]
        if isinstance(trajs, (list, tuple)) and trajs and all(
            isinstance(t, (str, Path)) for t in trajs
        ):
            # reference contract (``moldata.py:148-151``): a list of
            # trajectory paths + the `top` argument builds the ensemble
            # (the reference's own line references an undefined ``tops`` —
            # the documented intent is the ``top`` parameter)
            trajs = TrajEnsemble(list(trajs), tops=top)
        elif top is not None:
            raise ValueError(
                "`top` is only used when `trajs` is a (list of) trajectory "
                "path(s); pass pre-built SingleTraj/TrajEnsemble objects "
                "with their own topology instead"
            )
        if isinstance(trajs, SingleTraj):
            trajs = TrajEnsemble([trajs])
        self.trajs = trajs
        self._cache_path = str(cache_path)
        # side_dihedrals must count as "needed" too: a chi-bearing traj
        # that arrives with only the four central CVs loaded would
        # otherwise silently get an (n, 0) sidedihedrals array (ADVICE r4).
        # But only when some topology CAN produce them — for chi-less
        # peptides (poly-ALA/GLY) the featurizer warn-skips the empty
        # feature, so requiring the CV would re-run a full load_CVs("all")
        # on EVERY MolData construction (review wave 22).
        needed = [
            "central_angles", "central_dihedrals", "central_cartesians",
            "central_distances",
        ]
        if any(
            len(t.top.indices_chi(n))
            for t in trajs.trajs for n in range(1, 6)
        ):
            needed.append("side_dihedrals")
        if not all(k in trajs.CVs for k in needed):
            # reference contract: cache_path is an on-disk CV store
            # (``moldata.py:160-163`` routes the featurization through
            # ``load_CVs(..., directory=cache_path)``) — here: one
            # ``<cv_name>.npy`` per CV, loaded instead of recomputing
            cache = Path(cache_path) if cache_path else None
            if cache is not None and all(
                (cache / f"{k}.npy").exists() for k in needed
            ):
                for f in sorted(cache.glob("*.npy")):
                    trajs.load_CVs(np.load(f), attr_name=f.stem)
            if not all(k in trajs.CVs for k in needed):
                trajs.load_CVs("all", device=device)
                if cache is not None:
                    cache.mkdir(parents=True, exist_ok=True)
                    for k, v in trajs.CVs.items():
                        np.save(cache / f"{k}.npy", np.asarray(v))
        cvs = trajs.CVs
        self.angles = np.asarray(cvs["central_angles"])
        self.dihedrals = np.asarray(cvs["central_dihedrals"])
        self.central_cartesians = np.asarray(cvs["central_cartesians"])
        # reference MolData.cartesians is the xyz of EVERY atom
        # (``moldata.py:88,170`` fills it from all_cartesians) — aliasing
        # the backbone-only array here would silently break atom-indexed
        # downstream code
        self.cartesians = np.concatenate(
            [np.asarray(t.xyz, np.float32) for t in trajs.trajs], axis=0
        )
        self.lengths = np.asarray(cvs["central_distances"])
        self.distances = self.lengths
        if "side_dihedrals" in cvs:
            self.sidedihedrals = np.asarray(cvs["side_dihedrals"])
        else:
            # chi-less peptides (e.g. poly-ALA/GLY) have no side
            # dihedrals; the featurizer warn-skips the empty feature, and
            # the reference TF1 MolData ends up with an empty array too
            self.sidedihedrals = np.zeros(
                (len(self.dihedrals), 0), np.float32
            )

    def __len__(self) -> int:
        return len(self.dihedrals)
