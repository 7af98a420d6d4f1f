# encodermap_tpu_torch/loading/__init__.py
"""Featurization: CV computation from trajectory coordinates.

Mirrors the reference's ``em.loading`` star-export surface
(``encodermap/loading/__init__.py`` pulls in ``features``/``featurizer``),
so migrating code like ``from encodermap.loading import CentralDihedrals``
resolves here too. Counterpart of ``encodermap_tpu/loading``: features run
as PyTorch on the featurizer's device.
"""

from . import features
from .features import (
    ADC_FEATURES,
    AlignFeature,
    AllBondDistances,
    AllCartesians,
    AngleFeature,
    BackboneTorsionFeature,
    CentralAngles,
    CentralBondDistances,
    CentralCartesians,
    CentralDihedrals,
    ContactFeature,
    CustomFeature,
    DihedralFeature,
    DistanceFeature,
    Feature,
    GroupCOMFeature,
    InverseDistanceFeature,
    MinRmsdFeature,
    ResidueCOMFeature,
    ResidueMinDistanceFeature,
    SelectionFeature,
    SideChainAngles,
    SideChainBondDistances,
    SideChainCartesians,
    SideChainDihedrals,
    SideChainTorsions,
    describe_last_feats,
    pair,
    unpair,
)
from .featurizer import (
    EnsembleFeaturizer,
    Featurizer,
    SingleTrajFeaturizer,
    pairs,
)

__all__ = [
    "features",
    "Featurizer",
    "SingleTrajFeaturizer",
    "EnsembleFeaturizer",
    "ADC_FEATURES",
    "AlignFeature",
    "AllBondDistances",
    "AllCartesians",
    "AngleFeature",
    "BackboneTorsionFeature",
    "CentralAngles",
    "CentralBondDistances",
    "CentralCartesians",
    "CentralDihedrals",
    "ContactFeature",
    "CustomFeature",
    "DihedralFeature",
    "DistanceFeature",
    "Feature",
    "GroupCOMFeature",
    "InverseDistanceFeature",
    "MinRmsdFeature",
    "ResidueCOMFeature",
    "ResidueMinDistanceFeature",
    "SelectionFeature",
    "SideChainAngles",
    "SideChainBondDistances",
    "SideChainCartesians",
    "SideChainDihedrals",
    "SideChainTorsions",
    "describe_last_feats",
    "pair",
    "pairs",
    "unpair",
]
