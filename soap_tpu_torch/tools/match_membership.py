"""Match halos between two simulations run from the same initial
conditions, by comparing bound particle IDs.

The port's copy of ``soap_tpu/tools/match_membership.py``, equivalent of
the reference's
``misc/match_group_membership.py`` (an MPI program built on virgo
parallel sorts): for each halo in catalogue 1, take its ``nr_particles``
most-bound particles, look up which halo of simulation 2 they are bound
to, and match to the halo holding the plurality; repeat 2→1 and flag
consistent (mutual) matches.  Here the parallel sort/match machinery
collapses into vectorized numpy sorts on one host.

Output datasets (reference names): MatchIndex1to2, MatchCount1to2,
Consistent1to2 and the 2→1 counterparts; indices are ROW indices into
the other catalogue, -1 for no match.

``match_halos`` is the array half (numpy only): the particles and
catalogues in, the six datasets out.  Only the file half,
``match_group_membership``, imports h5py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class MatchCatalogue:
    """The catalogue columns matching reads."""

    halo_idx: np.ndarray  # InputHalos/HaloCatalogueIndex
    is_central: np.ndarray
    host_row: np.ndarray  # SOAP/HostHaloIndex (row of host, or -1)


def _index_of(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Row of each ``values`` entry in ``table`` (-1 when absent)."""
    order = np.argsort(table)
    pos = np.searchsorted(table, values, sorter=order)
    pos = np.clip(pos, 0, len(table) - 1)
    rows = order[pos]
    rows = np.where(table[rows] == values, rows, -1)
    return rows


def _expand_files(basename: str) -> List[str]:
    """Resolve a file, a ``{file_nr}`` template, or a ``.N.hdf5`` set."""
    if os.path.exists(basename):
        return [basename]
    if "{file_nr}" in basename:
        out, i = [], 0
        while os.path.exists(basename.format(file_nr=i)):
            out.append(basename.format(file_nr=i))
            i += 1
        if out:
            return out
    out, i = [], 0
    while os.path.exists(f"{basename}.{i}.hdf5"):
        out.append(f"{basename}.{i}.hdf5")
        i += 1
    if not out:
        raise FileNotFoundError(basename)
    return out


def load_particles(
    snapshot: str, membership: str, ptypes: Sequence[int]
) -> Dict[str, np.ndarray]:
    """(particle_ids, halo ids, rank_bound) for the bound particles.

    Snapshot and membership files must be partitioned identically
    (the membership program guarantees this) — reference
    ``load_particle_data``.
    """
    import h5py

    ids, hid, rank = [], [], []
    snap_files = _expand_files(snapshot)
    mem_files = _expand_files(membership)
    assert len(snap_files) == len(mem_files), "file set mismatch"
    for sf, mf in zip(snap_files, mem_files):
        with h5py.File(sf, "r") as s, h5py.File(mf, "r") as m:
            for pt in ptypes:
                g = f"PartType{pt}"
                if g not in s:
                    continue
                ids.append(np.asarray(s[g]["ParticleIDs"]))
                hid.append(np.asarray(m[g]["GroupNr_bound"]))
                rank.append(np.asarray(m[g]["Rank_bound"]))
    ids = np.concatenate(ids)
    hid = np.concatenate(hid)
    rank = np.concatenate(rank)
    keep = hid != -1
    return {
        "particle_ids": ids[keep],
        "halo_ids": hid[keep].astype(np.int64),
        "rank_bound": rank[keep],
    }


def load_catalogue(filename: str) -> MatchCatalogue:
    import h5py

    with h5py.File(filename, "r") as f:
        return MatchCatalogue(
            halo_idx=np.asarray(f["InputHalos/HaloCatalogueIndex"]),
            is_central=np.asarray(f["InputHalos/IsCentral"]) == 1,
            host_row=np.asarray(f["SOAP/HostHaloIndex"]),
        )


def match_sim(
    d1: Dict[str, np.ndarray],
    d2: Dict[str, np.ndarray],
    cat1: MatchCatalogue,
    cat2: MatchCatalogue,
    nr_particles: int = 50,
    match_satellites: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Match halos of sim 1 to sim 2 (reference ``match_sim``)."""
    pids1 = d1["particle_ids"]
    hid1 = d1["halo_ids"].copy()
    rank1 = d1["rank_bound"]
    pids2 = d2["particle_ids"]
    hid2 = d2["halo_ids"].copy()

    if not match_satellites:
        # sim 1: keep only particles bound to centrals
        row1 = _index_of(hid1, cat1.halo_idx)
        keep = (row1 >= 0) & cat1.is_central[np.maximum(row1, 0)]
        pids1, hid1, rank1 = pids1[keep], hid1[keep], rank1[keep]
        # sim 2: replace satellite halo ids with the host's catalogue idx
        row2 = _index_of(hid2, cat2.halo_idx)
        sat = (row2 >= 0) & ~cat2.is_central[np.maximum(row2, 0)]
        host = cat2.host_row[np.maximum(row2, 0)]
        ok = sat & (host >= 0)
        hid2[ok] = cat2.halo_idx[host[ok]]

    # sort sim-1 particles by (halo, boundness) and keep the first
    # nr_particles of each halo
    order = np.lexsort((rank1, hid1))
    pids1, hid1 = pids1[order], hid1[order]
    if nr_particles != -1 and len(hid1):
        uniq, counts = np.unique(hid1, return_counts=True)
        before = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos_in_group = np.arange(len(hid1)) - np.repeat(before, counts)
        keep = pos_in_group < nr_particles
        pids1, hid1 = pids1[keep], hid1[keep]

    # which sim-2 halo is each particle bound to
    i2 = _index_of(pids1, pids2)
    found = i2 >= 0
    hid1, matched = hid1[found], hid2[i2[found]]

    # plurality vote per halo: sort by (halo, -count, matched), take first
    pair = (hid1.astype(np.int64) << np.int64(32)) + matched.astype(np.int64)
    pair_ids, pair_counts = np.unique(pair, return_counts=True)
    m_ids = (pair_ids & np.int64(0xFFFFFFFF)).astype(np.int64)
    h_ids = (pair_ids >> np.int64(32)).astype(np.int64)
    sel = np.lexsort((m_ids, -pair_counts, h_ids))
    h_ids, m_ids, pair_counts = h_ids[sel], m_ids[sel], pair_counts[sel]
    h_ids, first = np.unique(h_ids, return_index=True)
    m_ids, pair_counts = m_ids[first], pair_counts[first]

    match_index = -np.ones(len(cat1.halo_idx), dtype=np.int64)
    match_count = np.zeros(len(cat1.halo_idx), dtype=np.int64)
    rows1 = _index_of(h_ids, cat1.halo_idx)
    rows2 = _index_of(m_ids, cat2.halo_idx)
    ok = (rows1 >= 0) & (rows2 >= 0)
    match_index[rows1[ok]] = rows2[ok]
    match_count[rows1[ok]] = pair_counts[ok]
    return match_index, match_count


def consistent_match(m12: np.ndarray, m21: np.ndarray) -> np.ndarray:
    """1 where halo i's match points back at i (reference
    ``consistent_match``)."""
    back = -np.ones(len(m12), dtype=np.int64)
    has = m12 >= 0
    back[has] = m21[m12[has]]
    return (back == np.arange(len(m12))).astype(np.int32)


def match_halos(
    d1: Dict[str, np.ndarray],
    d2: Dict[str, np.ndarray],
    cat1: MatchCatalogue,
    cat2: MatchCatalogue,
    nr_particles: int = 50,
    match_satellites: bool = False,
) -> Dict[str, np.ndarray]:
    """Match both ways between two simulations' bound particles
    (``load_particles``' layout), after keeping only the particles bound
    in both (reference main)."""
    common = np.isin(d1["particle_ids"], d2["particle_ids"])
    d1 = {k: v[common] for k, v in d1.items()}
    common = np.isin(d2["particle_ids"], d1["particle_ids"])
    d2 = {k: v[common] for k, v in d2.items()}

    m12, c12 = match_sim(d1, d2, cat1, cat2, nr_particles, match_satellites)
    m21, c21 = match_sim(d2, d1, cat2, cat1, nr_particles, match_satellites)
    return {
        "MatchIndex1to2": m12,
        "MatchCount1to2": c12,
        "Consistent1to2": consistent_match(m12, m21),
        "MatchIndex2to1": m21,
        "MatchCount2to1": c21,
        "Consistent2to1": consistent_match(m21, m12),
    }


def match_group_membership(
    snapshot1: str,
    membership1: str,
    catalogue1: str,
    snapshot2: str,
    membership2: str,
    catalogue2: str,
    output: str,
    ptypes: Sequence[int] = (1,),
    nr_particles: int = 50,
    match_satellites: bool = False,
) -> Dict[str, np.ndarray]:
    import h5py

    out = match_halos(
        load_particles(snapshot1, membership1, ptypes),
        load_particles(snapshot2, membership2, ptypes),
        load_catalogue(catalogue1), load_catalogue(catalogue2), nr_particles, match_satellites,
    )
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    with h5py.File(output, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["catalogue-filename1"] = catalogue1
        hdr.attrs["catalogue-filename2"] = catalogue2
        hdr.attrs["ptypes"] = list(ptypes)
        hdr.attrs["nr-particles"] = nr_particles
        hdr.attrs["match-satellites"] = match_satellites
        for k, v in out.items():
            f.create_dataset(k, data=v)
    return out
