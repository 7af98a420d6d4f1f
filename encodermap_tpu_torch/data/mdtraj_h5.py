# encodermap_tpu_torch/data/mdtraj_h5.py
"""Topology <-> JSON in the mdtraj HDF5 convention.

mdtraj's .h5 files (which the reference reads/writes through
``TrajEnsemble.save``) store the topology as one JSON string dataset with
chains -> residues -> atoms plus a bond list. Implementing the same schema
keeps our HDF5 files interoperable with mdtraj-written ones (e.g. the test
fixtures).

Counterpart of ``encodermap_tpu/data/mdtraj_h5.py``; host numpy, copied near verbatim.
"""

from __future__ import annotations

import json

from .topology import Topology

__all__ = ["topology_to_json", "topology_from_json"]


def topology_to_json(top: Topology, bonds=None) -> str:
    """Serialize a Topology to the mdtraj HDF5 JSON schema.

    ``bonds``: optional ``[(i, j), ...]`` atom-index pairs for the
    schema's bond list (mdtraj reads THIS field for connectivity — a
    bond-less topology silently degrades bond-dependent selections and
    visualization in external readers). The save sites pass
    ``guess_bonds(top, xyz[0])``."""
    chains: dict[int, dict] = {}
    for res in top.residues:
        chain = chains.setdefault(
            res.chain_index, {"index": res.chain_index, "residues": []}
        )
        chain["residues"].append(
            {
                "index": res.index,
                "name": res.name,
                "resSeq": res.resSeq,
                "atoms": [
                    {
                        "index": a.index,
                        "name": a.name,
                        "element": a.element.capitalize() or "VS",
                    }
                    for a in res.atoms
                ],
            }
        )
    return json.dumps(
        {
            "chains": [chains[k] for k in sorted(chains)],
            "bonds": [[int(a), int(b)] for a, b in (bonds or [])],
        }
    )


def topology_from_json(text: str) -> Topology:
    """Rebuild a Topology from mdtraj HDF5 JSON."""
    data = json.loads(text)
    top = Topology()
    # atoms may be indexed out of order in the JSON; rebuild by index
    records = []
    for chain in data.get("chains", []):
        ci = chain.get("index", 0)
        for res in chain.get("residues", []):
            for atom in res.get("atoms", []):
                records.append(
                    (
                        atom.get("index", len(records)),
                        atom.get("name", ""),
                        atom.get("element", ""),
                        res.get("name", ""),
                        res.get("resSeq", res.get("index", 0)),
                        ci,
                        res.get("index", 0),
                    )
                )
    records.sort(key=lambda r: r[0])
    cur_res_key = None
    cur_res = None
    for _, name, element, res_name, res_seq, ci, res_index in records:
        key = (ci, res_index)
        if key != cur_res_key:
            cur_res = top.add_residue(res_name, res_seq, ci)
            cur_res_key = key
        top.add_atom(name, element.upper(), cur_res)
    # keep the file's explicit connectivity available to callers (the
    # geometry pipeline guesses bonds from coordinates, but the file's
    # own list is the ground truth an mdtraj writer recorded)
    top._file_bonds = [
        (int(a), int(b)) for a, b in data.get("bonds", [])
    ]
    return top
