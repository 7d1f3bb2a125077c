"""Evolution of SOAP properties along HBT tracks.

The port's copy of ``soap_tpu/tools/track_evolution.py``, counterpart
of the reference's ``misc/get_evolution_HBT_tracks.py`` (MPI
+ virgo parallel sorts): given a list of catalogues in time order and a
set of HBTplus TrackIds, extract each requested property's value per
catalogue for every track — missing tracks (not yet formed / disrupted)
get the fill value.  Output layout matches the reference: one
``(n_tracks, n_snapshots)``-shaped dataset per property plus
``Redshifts`` and ``TrackIds``.  h5py is imported inside the functions.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def get_property_evolution(
    catalogue_paths: Sequence[str],
    track_ids: np.ndarray,
    properties: Sequence[str],
    fill_value: float = -1.0,
):
    """(redshifts, {property: (n_tracks, n_cats) array})."""
    import h5py

    track_ids = np.unique(np.asarray(track_ids, np.int64))
    n = len(track_ids)
    redshifts = np.full(len(catalogue_paths), -1.0)
    evolution: Dict[str, np.ndarray] = {}
    for i, path in enumerate(catalogue_paths):
        with h5py.File(path, "r") as cat:
            redshifts[i] = float(
                np.ravel(cat["Header"].attrs["Redshift"])[0]
            )
            cat_tracks = np.asarray(cat["InputHalos/HBTplus/TrackId"])
            order = np.argsort(cat_tracks)
            pos = np.searchsorted(cat_tracks, track_ids, sorter=order)
            pos = np.clip(pos, 0, max(len(cat_tracks) - 1, 0))
            rows = order[pos] if len(cat_tracks) else np.zeros(0, np.int64)
            hit = (
                cat_tracks[rows] == track_ids
                if len(cat_tracks)
                else np.zeros(n, bool)
            )
            for prop in properties:
                data = np.asarray(cat[prop])
                if prop not in evolution:
                    evolution[prop] = np.full(
                        (n, len(catalogue_paths)) + data.shape[1:],
                        fill_value,
                        dtype=np.float64,
                    )
                evolution[prop][hit, i] = data[rows[hit]]
    return redshifts, evolution


def save_evolution(
    redshifts: np.ndarray,
    evolution: Dict[str, np.ndarray],
    track_ids: np.ndarray,
    output_file: str,
) -> None:
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with h5py.File(output_file, "w") as f:
        f.create_dataset("Redshifts", data=redshifts)
        f.create_dataset("TrackIds", data=np.unique(np.asarray(track_ids)))
        for prop, arr in evolution.items():
            f.create_dataset(prop, data=arr)


def get_track_evolution(
    catalogue_paths: Sequence[str],
    output_file: str,
    track_ids: Sequence[int],
    properties: Sequence[str],
) -> Dict[str, np.ndarray]:
    z, ev = get_property_evolution(
        catalogue_paths, np.asarray(track_ids, np.int64), properties
    )
    save_evolution(z, ev, np.asarray(track_ids, np.int64), output_file)
    return ev
