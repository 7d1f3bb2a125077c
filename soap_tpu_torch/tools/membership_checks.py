"""Membership validation and birth-halo tracking tools.

The port's copy of ``soap_tpu/tools/membership_checks.py``: counterparts
of the reference's ``misc/check_group_membership.py`` (membership files
against the halo finder's bound lists) and
``misc/compute_BirthHaloCatalogueIndex.py`` (the subhalo each star
belonged to when it formed), as vectorized numpy on one host.

Each has an array half that reads no file: ``check_labels`` takes the
snapshot's IDs, their labels and the bound lists; ``birth_halo_index``
takes the stars and a loader of each snapshot's star IDs and labels.
Only the file halves import h5py.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def check_labels(ids: np.ndarray, halo: np.ndarray, rank: np.ndarray, nr_halos: int,
                 bound_ids: np.ndarray, bound_halo: np.ndarray,
                 bound_rank: Optional[np.ndarray] = None) -> Dict[str, int]:
    """Hold membership labels to the finder's bound lists.

    ``ids``, ``halo`` and ``rank`` are every snapshot particle's ID,
    GroupNr_bound and Rank_bound; ``bound_ids``, ``bound_halo`` and
    ``bound_rank`` the finder's bound lists.  Every labelled particle
    must be in its halo's list at its rank, and every listed particle
    labelled with its halo.  Returns counters; raises RuntimeError on the
    first inconsistency.
    """
    if len(ids) != len(halo):
        raise RuntimeError("membership and snapshot row counts differ")
    # The JAX tool searches each list in the other's storage order.  Here
    # both sides are sorted first and every search runs over sorted
    # queries: each element meets the same row and the same checks, the
    # failures and their counts are the same, and the searches do not
    # miss the cache on every query.
    order = np.argsort(bound_ids)
    sb_ids = bound_ids[order]
    order2 = np.argsort(ids)
    s_ids = ids[order2]
    s_halo = halo[order2]

    # membership -> finder: every labelled particle appears in its
    # halo's bound list at the recorded rank
    lab = s_halo >= 0
    pos = np.searchsorted(sb_ids, s_ids[lab])
    pos = np.clip(pos, 0, len(sb_ids) - 1)
    found = sb_ids[pos] == s_ids[lab]
    if not found.all():
        raise RuntimeError(
            f"{int((~found).sum())} membership-labelled particles are not "
            "in any bound list"
        )
    rows = order[pos]
    if not (bound_halo[rows] == s_halo[lab]).all():
        raise RuntimeError("GroupNr_bound mismatch vs finder bound lists")
    if bound_rank is not None and not (bound_rank[rows] == rank[order2][lab]).all():
        raise RuntimeError("Rank_bound mismatch vs finder bound lists")

    # finder -> membership: every bound particle is labelled
    pos2 = np.searchsorted(s_ids, sb_ids)
    pos2 = np.clip(pos2, 0, len(ids) - 1)
    found2 = s_ids[pos2] == sb_ids
    if not found2.all():
        raise RuntimeError(f"{int((~found2).sum())} bound particles missing from snapshot")
    if not (s_halo[pos2] == bound_halo[order]).all():
        raise RuntimeError("bound particles with wrong/no membership label")

    return {
        "n_particles": int(len(ids)),
        "n_labelled": int(lab.sum()),
        "n_bound": int(len(bound_ids)),
        "n_halos": int(nr_halos),
    }


def check_group_membership(snapshot_file: str, membership_file: str, halo_basename: str,
                           halo_format: str = "HBTplus") -> Dict[str, int]:
    """``check_labels`` of a snapshot's and its membership file's
    labels against the finder's bound lists (``GROUPNR_READERS``:
    HBTplus and VR)."""
    import h5py

    from soap_tpu_torch.io.halo_catalogue import GROUPNR_READERS

    res = GROUPNR_READERS[halo_format](halo_basename)
    nr_halos, bound_ids, bound_halo = res[:3]
    bound_rank = res[3] if len(res) > 3 else None

    # particle IDs + membership labels over the full snapshot
    snap_ids: List[np.ndarray] = []
    mem_halo: List[np.ndarray] = []
    mem_rank: List[np.ndarray] = []
    with h5py.File(snapshot_file, "r") as snap, h5py.File(membership_file, "r") as mem:
        for pt in list(snap):
            if not pt.startswith("PartType") or pt not in mem:
                continue
            if "ParticleIDs" not in snap[pt]:
                continue
            snap_ids.append(np.asarray(snap[pt]["ParticleIDs"]))
            mem_halo.append(np.asarray(mem[pt]["GroupNr_bound"]))
            mem_rank.append(np.asarray(mem[pt]["Rank_bound"]))
    return check_labels(np.concatenate(snap_ids), np.concatenate(mem_halo),
                        np.concatenate(mem_rank), nr_halos, bound_ids, bound_halo, bound_rank)


def birth_halo_index(star_ids: np.ndarray, birth_a: np.ndarray, snapshot_a: Sequence[float],
                     load: Callable[[int], Optional[Tuple[np.ndarray, np.ndarray]]]
                     ) -> np.ndarray:
    """GroupNr_bound of each star in the first snapshot with scale factor
    >= its ``birth_a``, -1 where it has none.

    ``snapshot_a`` holds each snapshot's scale factor; ``load(i)`` gives
    snapshot ``i``'s star IDs and GroupNr_bound (None when it has no
    stars) and is called only for snapshots some unassigned star needs.
    """
    out = np.full(len(star_ids), -1, dtype=np.int64)
    assigned = np.zeros(len(star_ids), bool)
    for i in np.argsort(snapshot_a):
        todo = ~assigned & (birth_a <= snapshot_a[i])
        if not todo.any():
            continue
        loaded = load(i)
        if loaded is None:
            continue
        ids_i, grnr_i = loaded
        o = np.argsort(ids_i)
        pos = np.searchsorted(ids_i, star_ids[todo], sorter=o)
        pos = np.clip(pos, 0, len(ids_i) - 1)
        hit = ids_i[o[pos]] == star_ids[todo]
        rows = np.flatnonzero(todo)[hit]
        out[rows] = grnr_i[o[pos[hit]]]
        assigned[rows] = True
    return out


def compute_birth_halo_index(snapshots: Sequence[Tuple[str, str]], final_snapshot: str,
                             output_file: str) -> np.ndarray:
    """Subhalo catalogue index each star belonged to when it formed.

    ``snapshots`` is an ordered list of (snapshot_file, membership_file)
    covering increasing scale factor.  For every star in
    ``final_snapshot``, its birth snapshot is the first snapshot with
    a >= BirthScaleFactors; the star's GroupNr_bound there (looked up by
    ParticleID) is its BirthHaloCatalogueIndex, -1 if unassigned or born
    after the last listed snapshot (reference
    ``misc/compute_BirthHaloCatalogueIndex.py``).  Writes
    ``PartType4/BirthHaloCatalogueIndex`` and ``PartType4/ParticleIDs``.
    """
    import h5py

    with h5py.File(final_snapshot, "r") as f:
        star_ids = np.asarray(f["PartType4/ParticleIDs"])
        birth_a = np.asarray(f["PartType4/BirthScaleFactors"], np.float64)
    snap_as = []
    for snap_file, _ in snapshots:
        with h5py.File(snap_file, "r") as f:
            snap_as.append(float(np.ravel(f["Header"].attrs["Scale-factor"])[0]))

    def load(i):
        snap_file, mem_file = snapshots[i]
        with h5py.File(snap_file, "r") as f:
            if "PartType4" not in f or "ParticleIDs" not in f["PartType4"]:
                return None
            ids_i = np.asarray(f["PartType4/ParticleIDs"])
        with h5py.File(mem_file, "r") as f:
            return ids_i, np.asarray(f["PartType4/GroupNr_bound"])

    out = birth_halo_index(star_ids, birth_a, snap_as, load)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with h5py.File(output_file, "w") as f:
        g = f.create_group("PartType4")
        ds = g.create_dataset("BirthHaloCatalogueIndex", data=out)
        ds.attrs["Description"] = np.bytes_(
            "Catalogue index of the subhalo this star was bound to in the "
            "first snapshot at/after its birth scale factor (-1 if none)"
        )
        g.create_dataset("ParticleIDs", data=star_ids)
    return out
