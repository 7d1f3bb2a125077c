"""Transfer FOFGroupIDs between snapshots with different particle order.

The port's copy of ``soap_tpu/tools/reorder_fof.py``, counterpart of
the reference's ``misc/reorder_swift_fof.py`` (MPI parallel match): for
every particle type carrying FOFGroupIDs in snapshot 1, write those ids
out in SNAPSHOT 2's particle order (matched by ParticleIDs) — used to
attach FOF membership from one run to another run's ordering.  Single-host vectorized searchsorted joins; h5py is
imported inside the functions.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def _files(template: str) -> List[str]:
    if os.path.exists(template):
        return [template]
    out, i = [], 0
    while os.path.exists(template.format(file_nr=i)):
        out.append(template.format(file_nr=i))
        i += 1
    if not out:
        raise FileNotFoundError(template)
    return out


def _read_concat(files: List[str], ptype: str, name: str) -> np.ndarray:
    import h5py

    parts = []
    for fn in files:
        with h5py.File(fn, "r") as f:
            if ptype in f and name in f[ptype]:
                parts.append(np.asarray(f[ptype][name]))
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def reorder_swift_fof(
    snapshot1: str, snapshot2: str, output_name: str
) -> Dict[str, np.ndarray]:
    """Write {ptype: FOFGroupIDs in snapshot-2 order} to ``output_name``."""
    import h5py

    files1 = _files(snapshot1)
    files2 = _files(snapshot2)
    with h5py.File(files1[0], "r") as f:
        ptypes = [
            g
            for g in f
            if g.startswith("PartType")
            and isinstance(f[g], h5py.Group)
            and "FOFGroupIDs" in f[g]
        ]

    out: Dict[str, np.ndarray] = {}
    os.makedirs(os.path.dirname(os.path.abspath(output_name)), exist_ok=True)
    with h5py.File(output_name, "w") as dst:
        for ptype in ptypes:
            ids1 = _read_concat(files1, ptype, "ParticleIDs")
            fof1 = _read_concat(files1, ptype, "FOFGroupIDs")
            ids2 = _read_concat(files2, ptype, "ParticleIDs")
            order = np.argsort(ids1)
            pos = np.searchsorted(ids1, ids2, sorter=order)
            pos = np.clip(pos, 0, max(len(ids1) - 1, 0))
            rows = order[pos]
            if len(ids1) == 0 or not (ids1[rows] == ids2).all():
                raise RuntimeError(
                    f"{ptype}: failed to match a particle ID between "
                    "snapshots"
                )
            out[ptype] = fof1[rows]
            g = dst.create_group(ptype)
            g.create_dataset("ParticleIDs", data=ids2)
            g.create_dataset("FOFGroupIDs", data=out[ptype])
    return out
