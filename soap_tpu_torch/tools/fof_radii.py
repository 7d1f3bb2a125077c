"""FOF group radii: maximum particle distance from each FOF centre.

The port's copy of ``soap_tpu/tools/fof_radii.py``, counterpart of the
reference's ``misc/calculate_fof_radii.py`` (an MPI program over virgo
parallel sorts): reads the snapshot's FOFGroupIDs and Coordinates and
the FOF catalogue's centres, computes each group's maximum periodic
particle distance, and writes an augmented FOF catalogue carrying
``Groups/Radii``, the dataset the pipeline's FOF join surfaces as
``FOF/Radii``.

``fof_max_radii`` is the array half and ``build_matrix`` unpacks the
catalogue's flattened symmetric matrices; both are numpy only.  Only
``calculate_fof_radii`` reads files (h5py inside).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np


def fof_max_radii(group_ids: np.ndarray, centres: np.ndarray, boxsize: float,
                  particles: Iterable[Tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """Per catalogue group (``group_ids``, ``centres``) the largest
    periodic distance of its particles, from ``(FOFGroupIDs,
    Coordinates)`` pairs (one per particle type); 0 for a group with
    none.  Particles with a negative id or an id not in the catalogue are
    skipped."""
    order = np.argsort(group_ids)
    sorted_ids = group_ids[order]
    radii = np.zeros(len(group_ids))
    for fof, coords in particles:
        fof = np.asarray(fof)
        keep = fof >= 0
        # map FOF ids to catalogue rows (ids may be arbitrary)
        pos_sorted = np.searchsorted(sorted_ids, fof[keep])
        pos_sorted = np.clip(pos_sorted, 0, len(sorted_ids) - 1)
        rows = order[pos_sorted]
        ok = sorted_ids[pos_sorted] == fof[keep]
        rows = rows[ok]
        d = np.asarray(coords, np.float64)[keep][ok] - centres[rows]
        d -= boxsize * np.round(d / boxsize)
        r = np.sqrt((d * d).sum(axis=1))
        np.maximum.at(radii, rows, r)
    return radii


def calculate_fof_radii(
    snapshot_file: str,
    fof_file: str,
    output_file: str,
    ptypes: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Compute per-FOF maximum radii and write the augmented catalogue."""
    import h5py

    from soap_tpu_torch.io import swift_snapshot

    meta = swift_snapshot.SnapshotMetadata(snapshot_file)
    if ptypes is None:
        ptypes = [pt for pt in meta.ptypes if pt != "PartType6"]

    with h5py.File(fof_file, "r") as f:
        group_ids = np.asarray(f["Groups/GroupIDs"])
        centres = np.asarray(f["Groups/Centres"], np.float64)

    fields = {
        pt: ["Coordinates", "FOFGroupIDs"]
        for pt in ptypes
        if pt in meta.datasets and "FOFGroupIDs" in meta.datasets[pt]
    }
    data = swift_snapshot.read_masked_cells(meta, np.ones(meta.nr_cells, dtype=bool), fields)
    radii = fof_max_radii(group_ids, centres, meta.boxsize,
                          ((arrs["FOFGroupIDs"], arrs["Coordinates"]) for arrs in data.values()))

    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with h5py.File(fof_file, "r") as src, h5py.File(output_file, "w") as dst:
        src.copy("Groups", dst)
        for k, v in src.attrs.items():
            dst.attrs[k] = v
        if "Radii" in dst["Groups"]:
            del dst["Groups/Radii"]
        ds = dst["Groups"].create_dataset("Radii", data=radii)
        ds.attrs["Description"] = np.bytes_(
            "Maximum comoving distance of any member particle from the "
            "group centre"
        )
    return radii


def build_matrix(flattened_matrix: np.ndarray) -> np.ndarray:
    """(N, d(d+1)/2) flattened symmetric matrices -> (N, d, d).

    The catalogue stores inertia tensors and velocity-dispersion
    matrices flattened with the d diagonal elements first, then the
    off-diagonals in lower-triangle order — the reference documents the
    unpacking in ``misc/load_symmetric_matrix.py``.
    """
    flat = np.asarray(flattened_matrix)
    if flat.ndim == 1:
        flat = flat[None, :]
    ndim = next((d for d in range(1, 5) if d * (d + 1) // 2 == flat.shape[1]), None)
    if ndim is None:
        raise ValueError(f"flattened length {flat.shape[1]} is not d(d+1)/2 for d<=4")
    n = flat.shape[0]
    out = np.empty((n, ndim, ndim), flat.dtype)
    row, col = np.tril_indices(ndim)
    diag = row == col
    idx = np.arange(n)[:, None]
    out[idx, row[diag], col[diag]] = flat[:, :ndim]
    out[idx, row[~diag], col[~diag]] = flat[:, ndim:]
    out[idx, col[~diag], row[~diag]] = flat[:, ndim:]
    return out
