"""Derived ``SOAP/*`` catalogue columns, on the host.

The port's copy of ``soap_tpu/pipeline/derived.py`` (reference
``SOAP/core/combine_chunks.py:537-735`` and
``SOAP/property_calculation/subhalo_rank.py``), numpy only: a chunk's
catalogue is a few thousand to ~10^7 scalar rows, so these run on the
host.  Every function takes arrays in the FINAL (spatially sorted)
catalogue order, and the indices it returns refer to rows of that order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def match(needles: np.ndarray, haystack: np.ndarray) -> np.ndarray:
    """Index in ``haystack`` of each needle, -1 when absent (the
    host-side analogue of ``psort.parallel_match``)."""
    order = np.argsort(haystack, kind="stable")
    skeys = haystack[order]
    pos = np.searchsorted(skeys, needles)
    pos = np.minimum(pos, len(skeys) - 1) if len(skeys) else pos * 0
    if len(skeys) == 0:
        return np.full(len(needles), -1, dtype=np.int64)
    hit = skeys[pos] == needles
    return np.where(hit, order[pos], -1)


def host_halo_index(
    host_fof_id: np.ndarray,  # (H,) HBT HostHaloId (-1 hostless)
    is_central: np.ndarray,  # (H,) bool
) -> np.ndarray:
    """Catalogue row of the host FOF group's central subhalo
    (``combine_chunks.py:551-564``); -1 for hostless halos."""
    cen_fof = np.where(is_central, host_fof_id, -1)
    out = np.full(len(host_fof_id), -1, dtype=np.int64)
    has_host = host_fof_id >= 0
    out[has_host] = match(host_fof_id[has_host], cen_fof)
    return out


def subhalo_rank_by_bound_mass(
    host_fof_id: np.ndarray,
    track_id: np.ndarray,
    total_mass: np.ndarray,
) -> np.ndarray:
    """Rank of each subhalo by bound mass within its host group; 0 = most
    massive (``subhalo_rank.py:10-85``).  Hostless halos get a unique
    synthetic host (-TrackId, ``combine_chunks.py:588-591``) and thus
    rank 0."""
    host = host_fof_id.copy().astype(np.int64)
    hostless = host < 0
    host[hostless] = -track_id[hostless].astype(np.int64)
    order = np.lexsort((-total_mass, host))
    rank = np.empty(len(host), dtype=np.int32)
    sorted_host = host[order]
    new_seg = np.concatenate([[True], sorted_host[1:] != sorted_host[:-1]])
    seg_id = np.cumsum(new_seg) - 1
    seg_start = np.flatnonzero(new_seg)
    rank[order] = np.arange(len(host)) - seg_start[seg_id]
    return rank


def included_in_reduced_snapshot(
    mass_msun: np.ndarray,
    halos_per_bin: int,
    bin_size_dex: float,
    min_halo_mass_msun: float,
    seed: int = 0,
) -> np.ndarray:
    """Mass-binned random down-sampling flag
    (``combine_chunks.py:606-674``): log-spaced bins from the minimum
    mass; every halo kept when a bin holds <= halos_per_bin, else a
    seeded random subset of exactly halos_per_bin."""
    out = np.zeros(len(mass_msun), dtype=np.int32)
    valid = mass_msun > 0
    if not valid.any():
        return out
    rng = np.random.RandomState(seed)
    lo = np.log10(min_halo_mass_msun)
    hi = np.log10(mass_msun[valid].max()) + bin_size_dex
    bins = 10 ** np.arange(lo, hi, bin_size_dex)
    for i in range(len(bins) - 1):
        in_bin = np.flatnonzero(
            (mass_msun >= bins[i]) & (mass_msun < bins[i + 1])
        )
        if len(in_bin) == 0:
            continue
        if len(in_bin) <= halos_per_bin:
            out[in_bin] = 1
        else:
            keep = rng.choice(in_bin, size=halos_per_bin, replace=False)
            out[keep] = 1
    return out


def progenitor_descendant_index(
    track_id: np.ndarray,
    other_track_id_sorted: Optional[np.ndarray],
) -> np.ndarray:
    """Row of each TrackId in the adjacent snapshot's (sorted) catalogue,
    -1 when the catalogue is unavailable or the track is absent
    (``combine_chunks.py:676-735``)."""
    if other_track_id_sorted is None:
        return np.full(len(track_id), -1, dtype=np.int32)
    return match(track_id, other_track_id_sorted).astype(np.int32)
