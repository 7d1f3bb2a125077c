"""SWIFT FOF catalogue join: the ``FOF/{Centres, Masses, Sizes, Radii}`` columns.

The port's copy of ``soap_tpu/io/fof_catalogue.py`` (reference
``SOAP/core/combine_chunks.py:406-535``): every central subhalo with a
host FOF group takes the matching row of the SWIFT FOF output's
``Groups`` arrays; satellites and hostless halos get zeros.
``fof_join`` is numpy only; ``read_fof_groups`` imports ``h5py`` inside.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from soap_tpu_torch.pipeline.derived import match


def read_fof_groups(fof_filename: str) -> Dict[str, np.ndarray]:
    """Load the FOF group arrays from a (single-file) SWIFT FOF output."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(fof_filename.format(file_nr=0), "r") as f:
        g = f["Groups"]
        out["GroupIDs"] = np.asarray(g["GroupIDs"], dtype=np.int64)
        out["Centres"] = np.asarray(g["Centres"], dtype=np.float64)
        out["Masses"] = np.asarray(g["Masses"], dtype=np.float64)
        if "Sizes" in g:
            out["Sizes"] = np.asarray(g["Sizes"], dtype=np.int64)
        if "Radii" in g:
            out["Radii"] = np.asarray(g["Radii"], dtype=np.float64)
    return out


def fof_join(
    fof: Dict[str, np.ndarray],
    host_fof_id: np.ndarray,  # (H,) HBT HostHaloId
    is_central: np.ndarray,  # (H,) bool
) -> Dict[str, np.ndarray]:
    """FOF columns per halo (zeros for satellites/hostless)."""
    H = len(host_fof_id)
    keep = is_central.astype(bool) & (host_fof_id >= 0)
    idx = match(host_fof_id[keep], fof["GroupIDs"])
    if (idx < 0).any():
        raise RuntimeError(
            f"{int((idx < 0).sum())} central subhalos have no FOF group "
            "in the FOF catalogue"
        )
    out: Dict[str, np.ndarray] = {}
    centres = np.zeros((H, 3), np.float64)
    centres[keep] = fof["Centres"][idx]
    out["FOF/Centres"] = centres
    masses = np.zeros(H, np.float64)
    masses[keep] = fof["Masses"][idx]
    out["FOF/Masses"] = masses
    if "Sizes" in fof:
        sizes = np.zeros(H, np.int64)
        sizes[keep] = fof["Sizes"][idx]
        out["FOF/Sizes"] = sizes
    if "Radii" in fof:
        radii = np.zeros(H, np.float64)
        radii[keep] = fof["Radii"][idx]
        out["FOF/Radii"] = radii
    return out
