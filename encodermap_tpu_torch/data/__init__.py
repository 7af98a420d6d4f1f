# encodermap_tpu_torch/data/__init__.py
"""Trajectories, topologies, file formats and CV storage of the port
(counterpart of ``encodermap_tpu/data``): host numpy, copied near verbatim
from the JAX package, with the XTC codec built by g++ on first use."""

from .api import load
from .custom_topology import CustomTopology
from .cvstore import CVCollection
from .pdb import load_pdb, write_pdb
from .topology import Topology
from .trajectory import SingleTraj, TrajEnsemble

__all__ = ["load", "CustomTopology", "CVCollection", "load_pdb", "write_pdb",
           "Topology", "SingleTraj", "TrajEnsemble"]
