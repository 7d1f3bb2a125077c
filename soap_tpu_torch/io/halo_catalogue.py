"""The halo-finder catalogue the entry runs on, and its HBTplus reader.

The port's copy of ``soap_tpu/io/halo_catalogue.py``'s
``HaloCatalogue`` and ``read_hbtplus_catalogue`` (reference
``SOAP/catalogue_readers/read_hbtplus.py``): an HBTplus ``SubSnap``
(the unsorted multi-file layout or the sorted single file), lengths in
Mpc/h comoving and masses in Msun/h converted to the snapshot's Mpc and
1e10 Msun, orphans (``Nbound == 0``) dropped, search radius 1.01 x
``REncloseComoving``, and TrackId / HostHaloId / Depth / peak-mass
passthrough columns.  The reader imports ``h5py`` inside the functions
that open files, so importing this module loads no h5py.  The other
finders' readers are not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class HaloCatalogue:
    """Host-side halo catalogue ready for the engine."""

    nr_halos: int
    index: np.ndarray  # i64 catalogue row of each halo (pre-filter)
    cofp: np.ndarray  # (H, 3) f64 comoving centre of potential
    search_radius: np.ndarray  # (H,) f64 comoving
    is_central: np.ndarray  # (H,) bool
    nr_bound_part: np.ndarray  # (H,) i64
    fof_id: np.ndarray  # (H,) i64 host FOF group id
    passthrough: Dict[str, np.ndarray] = field(default_factory=dict)

    def select(self, mask: np.ndarray) -> "HaloCatalogue":
        return HaloCatalogue(
            nr_halos=int(mask.sum()),
            index=self.index[mask],
            cofp=self.cofp[mask],
            search_radius=self.search_radius[mask],
            is_central=self.is_central[mask],
            nr_bound_part=self.nr_bound_part[mask],
            fof_id=self.fof_id[mask],
            passthrough={k: v[mask] for k, v in self.passthrough.items()},
        )


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
