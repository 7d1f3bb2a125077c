"""The halo-finder catalogue the entry runs on, its HBTplus reader and
the readers of every finder by name.

The port's copy of ``soap_tpu/io/halo_catalogue.py``'s
``read_hbtplus_catalogue`` (reference
``SOAP/catalogue_readers/read_hbtplus.py``): an HBTplus ``SubSnap``
(the unsorted multi-file layout or the sorted single file), lengths in
Mpc/h comoving and masses in Msun/h converted to the snapshot's Mpc and
1e10 Msun, orphans (``Nbound == 0``) dropped, search radius 1.01 x
``REncloseComoving``, and TrackId / HostHaloId / Depth / peak-mass
passthrough columns; ``read_hbtplus_groupnr``, the bound-particle lists
the membership program joins on; and the two dispatch tables,
``CATALOGUE_READERS`` (the five finders, the other four from
``io/finder_readers.py``) and ``GROUPNR_READERS`` (HBTplus and VR, as in
the JAX package).  The readers import ``h5py`` inside the functions that
open files, so importing this module loads no h5py.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from soap_tpu_torch.io import finder_readers as fr
from soap_tpu_torch.io.halos import HaloCatalogue


def _hbt_layout(basename: str) -> Tuple[str, List[str]]:
    """('unsorted', SubSnap files) or ('sorted', [single file]): the
    sorted layout is a file with a ``Particles`` group."""
    import h5py

    first = f"{basename}.0.hdf5"
    if os.path.exists(first):
        with h5py.File(first, "r") as f:
            nr_files = int(np.asarray(f["NumberOfFiles"])[0])
        return "unsorted", [f"{basename}.{i}.hdf5" for i in range(nr_files)]
    for cand in (basename, f"{basename}.hdf5"):
        if os.path.exists(cand):
            with h5py.File(cand, "r") as f:
                if "Particles" in f:
                    return "sorted", [cand]
            return "unsorted", [cand]
    raise FileNotFoundError(f"No HBTplus catalogue at {basename}")


def _hbt_units(basename: str) -> Tuple[float, float, float]:
    """(length in Mpc/h, mass in Msun/h, velocity in km/s) factors, from
    the catalogue's Units group or else the run's ``Parameters.log`` two
    levels up."""
    import h5py

    _, filenames = _hbt_layout(basename)
    with h5py.File(filenames[0], "r") as f:
        if "Units" in f:
            return (
                float(np.asarray(f["Units/LengthInMpch"]).ravel()[0]),
                float(np.asarray(f["Units/MassInMsunh"]).ravel()[0]),
                float(np.asarray(f["Units/VelInKmS"]).ravel()[0])
                if "VelInKmS" in f["Units"]
                else 1.0,
            )
    length, mass, vel = 1.0, 1.0, 1.0
    log_path = os.path.join(os.path.dirname(os.path.dirname(filenames[0])), "Parameters.log")
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                fields = line.split()
                if len(fields) == 2:
                    if fields[0] == "LengthInMpch":
                        length = float(fields[1])
                    elif fields[0] == "MassInMsunh":
                        mass = float(fields[1])
                    elif fields[0] == "VelInKmS":
                        vel = float(fields[1])
    return length, mass, vel


def _expand_vlen(vlen: np.ndarray, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """(concatenated values, per-halo lengths) from a vlen object array."""
    lengths = np.fromiter((len(v) for v in vlen), dtype=np.int64, count=len(vlen))
    if len(vlen) and lengths.sum():
        flat = np.concatenate([np.asarray(v, dtype=dtype) for v in vlen])
    else:
        flat = np.zeros(0, dtype)
    return flat, lengths


def read_hbtplus_groupnr(basename: str, read_potential_energies: bool = False):
    """(nr_halos, ids_bound, grnr_bound, rank_bound[, potentials]) for the
    membership program.  Group numbers are the subhalo's row across all
    files; rank is the position in its bound list (0 = most bound).
    Both the unsorted multi-file and the sorted single-file layouts are
    read, vlen datasets whole; potential energies come back in
    (km/s)^2."""
    import h5py

    layout, filenames = _hbt_layout(basename)
    if layout == "sorted":
        with h5py.File(filenames[0], "r") as f:
            ids = np.asarray(f["Particles/ParticleIDs"], dtype=np.uint64)
            lengths = np.asarray(f["Subhalos/Nbound"], dtype=np.int64)
            pots = (
                np.asarray(f["Particles/PotentialEnergies"], dtype=np.float64)
                if read_potential_energies and "PotentialEnergies" in f["Particles"]
                else None
            )
    else:
        ids_list, len_list, pot_list = [], [], []
        for fname in filenames:
            with h5py.File(fname, "r") as f:
                flat, lengths_f = _expand_vlen(f["SubhaloParticles"][...], np.uint64)
                ids_list.append(flat)
                len_list.append(lengths_f)
                if read_potential_energies and "PotentialEnergies" in f:
                    pot_list.append(_expand_vlen(f["PotentialEnergies"][...], np.float64)[0])
        ids = np.concatenate(ids_list) if ids_list else np.zeros(0, np.uint64)
        lengths = np.concatenate(len_list) if len_list else np.zeros(0, np.int64)
        pots = np.concatenate(pot_list) if pot_list else None
    n = len(lengths)
    grnr = np.repeat(np.arange(n, dtype=np.int64), lengths)
    ends = np.cumsum(lengths)
    rank = (np.arange(len(ids)) - np.repeat(ends - lengths, lengths)).astype(np.int32)
    out = (n, ids, grnr, rank)
    if read_potential_energies:
        vel = _hbt_units(basename)[2]
        out = out + ((pots * vel**2) if pots is not None else None,)
    return out


def hbtplus_catalogue(
    subs: Dict[str, np.ndarray],
    h: float,
    length_unit: float = 1.0,
    mass_unit: float = 1.0,
    keep_orphans: bool = False,
) -> HaloCatalogue:
    """The catalogue from an HBTplus ``Subhalos`` table's columns as
    stored (Mpc/h comoving, Msun/h, in ``length_unit`` and ``mass_unit``
    of them)."""
    fields = set(subs)
    H = len(subs["Nbound"])
    nbound = subs["Nbound"].astype(np.int64)
    keep = np.ones(H, bool) if keep_orphans else nbound > 0

    to_mpc = length_unit / h  # Mpc/h -> Mpc comoving
    cofp = subs["ComovingMostBoundPosition"].astype(np.float64) * to_mpc
    renclose = subs["REncloseComoving"].astype(np.float64) * to_mpc
    host = subs["HostHaloId"].astype(np.int64)
    depth = subs["Depth"].astype(np.int64) if "Depth" in fields else np.zeros(H, np.int64)

    to_1e10msun = mass_unit / h / 1.0e10
    passthrough = {
        "HBTplus/TrackId": subs["TrackId"].astype(np.int64),
        "HBTplus/HostHaloId": host,
        "HBTplus/Depth": depth,
    }
    for src, conv in (
        ("NestedParentTrackId", None),
        ("DescendantTrackId", None),
        ("LastMaxMass", to_1e10msun),
        ("LastMaxVmaxPhysical", None),
        ("SnapshotOfBirth", None),
        ("SnapshotOfLastMaxMass", None),
        ("SnapshotOfLastMaxVmax", None),
        ("SnapshotOfLastIsolation", None),
    ):
        if src in fields:
            col = subs[src]
            passthrough[f"HBTplus/{src}"] = col * conv if conv else np.asarray(col)

    cat = HaloCatalogue(
        nr_halos=H,
        index=np.arange(H, dtype=np.int64),
        cofp=cofp,
        search_radius=1.01 * renclose,
        is_central=subs["Rank"].astype(np.int64) == 0,
        nr_bound_part=nbound,
        fof_id=host,
        passthrough=passthrough,
    )
    return cat.select(keep)


def read_hbtplus_catalogue(
    basename: str,
    h: float,
    a: float = 1.0,  # unused: HBT columns are comoving already
    keep_orphans: bool = False,
) -> HaloCatalogue:
    """Read an HBTplus SubSnap into a :class:`HaloCatalogue`."""
    import h5py

    layout, filenames = _hbt_layout(basename)
    length_unit, mass_unit, _vel = _hbt_units(basename)
    if layout == "sorted":
        # one dataset per Subhalos field
        with h5py.File(filenames[0], "r") as f:
            subs = {name: np.asarray(f["Subhalos"][name]) for name in f["Subhalos"]}
    else:
        rows = []
        for fname in filenames:
            with h5py.File(fname, "r") as f:
                rows.append(np.asarray(f["Subhalos"]))
        packed = np.concatenate(rows)
        subs = {name: packed[name] for name in packed.dtype.names}
    return hbtplus_catalogue(subs, h, length_unit, mass_unit, keep_orphans)


#: the entry's catalogue readers by finder (reference dispatch:
#: ``halo_centres.py:75-96``): ``reader(basename, h=..., a=...)``
CATALOGUE_READERS = {
    "HBTplus": read_hbtplus_catalogue,
    "VR": fr.read_vr_catalogue,
    "Gadget4": fr.read_gadget4_catalogue,
    "SubfindEagle": fr.read_subfind_eagle_catalogue,
    "Rockstar": fr.read_rockstar_catalogue,
}
#: the membership program's readers by finder: (nr_halos, ids_bound,
#: grnr_bound[, rank_bound[, potentials]]).  Gadget-4's bound lists need
#: the snapshot too (``fr.read_gadget4_groupnr(tab, snap)``), so, as in
#: the JAX package, only these two are registered
GROUPNR_READERS = {"HBTplus": read_hbtplus_groupnr, "VR": fr.read_vr_groupnr}
