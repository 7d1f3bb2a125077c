"""The other halo finders' readers: VELOCIraptor, Gadget-4 SubFind,
EAGLE SubFind and Rockstar.

The port's copy of ``soap_tpu/io/finder_readers.py``, with the same
functions and results (reference ``SOAP/catalogue_readers/``): a
``read_<finder>_catalogue`` returning a ``HaloCatalogue`` for the entry,
and for VR and Gadget-4 a ``read_<finder>_groupnr`` with the bound lists
for the membership program.

 - VELOCIraptor (``read_vr.py``): single- or multi-file (``Num_of_files``)
   ``.properties`` (Xcminpot/Ycminpot/Zcminpot, R_size, ID, hostHaloID,
   Structuretype, numSubStruct, npart), ``.catalog_groups`` (Offset, local
   to each file) and ``.catalog_particles[.unbound]``; centrals have
   Structuretype == 10; lengths scaled by the ``UnitInfo`` attributes
   (``read_vr.py:309-333``).
 - Gadget-4 SubFind (``read_subfind.py``): single- or multi-file
   (``Header/NumFiles``) ``fof_subhalo_tab`` files; lengths from
   ``Parameters/UnitLength_in_cm`` / ``HubbleParam``; search radius 4 x
   SubhaloHalfmassRad, physical (``read_subfind.py:228-232``).
 - EAGLE SubFind (``read_subfind_eagle.py``): catalogue only.
 - Rockstar (``read_rockstar.py``): ASCII ``out_*.list`` halo lists and
   the binary ``halos_*.bin`` chunks (256-byte header, packed halo
   structs, particle IDs).

Each HDF5 reader has two halves: a plain function from the datasets as
arrays to its result (``vr_catalogue``, ``vr_groupnr``,
``gadget4_catalogue``, ``subfind_eagle_catalogue``), and the file
function that reads the datasets and calls it.  Rockstar's files are
plain ASCII and binary.  ``h5py`` is imported inside the functions that
open files, so importing this module loads no h5py.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from soap_tpu_torch.io.halos import HaloCatalogue

MPC_CM = 3.08567758e24


# ----------------------------------------------------------------------
# VELOCIraptor
# ----------------------------------------------------------------------

#: the ``.properties`` datasets the catalogue reads, with their dtypes
VR_COLUMNS = (
    ("Xcminpot", np.float64),
    ("Ycminpot", np.float64),
    ("Zcminpot", np.float64),
    ("R_size", np.float64),
    ("ID", np.int64),
    ("hostHaloID", np.int64),
    ("Structuretype", np.int32),
    ("numSubStruct", np.int64),
    ("npart", np.int64),
)


def _vr_files(basename: str, suffix: str) -> List[str]:
    """All files of one VR output kind (single- or multi-file layout)."""
    single = f"{basename}.{suffix}"
    if os.path.exists(single):
        return [single]
    first = f"{basename}.{suffix}.0"
    if os.path.exists(first):
        import h5py

        with h5py.File(first, "r") as f:
            nr = int(np.asarray(f["Num_of_files"]).ravel()[0])
        return [f"{basename}.{suffix}.{i}" for i in range(nr)]
    raise FileNotFoundError(f"no VR {suffix} file for {basename}")


def _vr_read(filenames: List[str], name: str, dtype) -> np.ndarray:
    import h5py

    parts = []
    for fn in filenames:
        with h5py.File(fn, "r") as f:
            parts.append(np.asarray(f[name], dtype=dtype))
    return np.concatenate(parts)


def vr_groupnr(files: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """(nr_halos, ids_bound, grnr_bound) from each file's ``Offset``
    (local to its file's bound IDs) and ``Particle_IDs``, in file order:
    the halos get a running number over the files.  VR gives no rank."""
    all_ids, all_grnr = [], []
    halo_offset = 0
    for offset, ids_bound in files:
        offset = np.asarray(offset, dtype=np.int64)
        ids_bound = np.asarray(ids_bound, dtype=np.uint64)
        n = len(offset)
        end_bound = np.concatenate([offset[1:], [len(ids_bound)]])
        grnr = np.repeat(np.arange(halo_offset, halo_offset + n, dtype=np.int64),
                         end_bound - offset)
        all_ids.append(ids_bound)
        all_grnr.append(grnr)
        halo_offset += n
    return (
        halo_offset,
        np.concatenate(all_ids) if all_ids else np.zeros(0, np.uint64),
        np.concatenate(all_grnr) if all_grnr else np.zeros(0, np.int64),
    )


def read_vr_groupnr(basename: str):
    """(nr_halos, ids_bound, grnr_bound) of a VR catalogue: offsets in
    ``catalog_groups`` are local to each file's ``catalog_particles``
    (``read_vr.py:25-110``), so membership is assembled per file with a
    running halo number (``vr_groupnr``)."""
    import h5py

    group_files = _vr_files(basename, "catalog_groups")
    part_files = _vr_files(basename, "catalog_particles")
    unbound_files = _vr_files(basename, "catalog_particles.unbound")
    files = []
    for gf, pf, _uf in zip(group_files, part_files, unbound_files):
        with h5py.File(gf, "r") as f:
            offset = np.asarray(f["Offset"], dtype=np.int64)
        with h5py.File(pf, "r") as f:
            files.append((offset, np.asarray(f["Particle_IDs"], dtype=np.uint64)))
    return vr_groupnr(files)


def _vr_units(prop_file: str) -> Optional[Dict[str, object]]:
    """The ``UnitInfo`` attributes, or ``SimulationInfo``'s when they give
    ``Length_unit_to_kpc``, or None."""
    import h5py

    with h5py.File(prop_file, "r") as f:
        if "UnitInfo" in f:
            return dict(f["UnitInfo"].attrs)
        if "SimulationInfo" in f and "Length_unit_to_kpc" in f["SimulationInfo"].attrs:
            return dict(f["SimulationInfo"].attrs)
    return None


def vr_length_conversion(units: Optional[Mapping[str, object]], h: float, a: float) -> float:
    """File length unit -> comoving Mpc from the unit attributes
    (``read_vr.py:309-333``); 1 without them."""
    if units is None:
        return 1.0
    comoving = int(float(units.get("Comoving_or_Physical", 1)))
    to_kpc = float(units.get("Length_unit_to_kpc", 1000.0))
    if comoving == 0:
        # physical units, no h factor -> comoving
        return (1.0 / a) * to_kpc / 1000.0
    # comoving 1/h units (reference read_vr.py:331-333)
    return h * to_kpc / 1000.0


def _vr_length_conversion(prop_file: str, h: float, a: float) -> float:
    """File length unit -> comoving Mpc, from a ``.properties`` file."""
    return vr_length_conversion(_vr_units(prop_file), h, a)


def vr_catalogue(
    columns: Mapping[str, np.ndarray],
    units: Optional[Mapping[str, object]] = None,
    h: float = 1.0,
    a: float = 1.0,
) -> HaloCatalogue:
    """The catalogue from a VR ``.properties`` table's columns
    (``VR_COLUMNS``) and its unit attributes (None: lengths in Mpc)."""
    col = {name: np.asarray(columns[name], dtype) for name, dtype in VR_COLUMNS}
    conv = vr_length_conversion(units, h, a)
    vr_id, host, stype = col["ID"], col["hostHaloID"], col["Structuretype"]
    H = len(vr_id)
    return HaloCatalogue(
        nr_halos=H,
        index=np.arange(H, dtype=np.int64),
        cofp=np.stack([col["Xcminpot"], col["Ycminpot"], col["Zcminpot"]], axis=1) * conv,
        search_radius=1.01 * col["R_size"] * conv,
        is_central=stype == 10,
        nr_bound_part=col["npart"],
        fof_id=np.where(host >= 0, host, vr_id),
        passthrough={
            "VR/ID": vr_id.astype(np.uint64),
            "VR/Structuretype": stype,
            "VR/hostHaloID": host,
            "VR/numSubStruct": col["numSubStruct"].astype(np.uint64),
        },
    )


def read_vr_catalogue(basename: str, h: float = 1.0, a: float = 1.0) -> HaloCatalogue:
    files = _vr_files(basename, "properties")
    columns = {name: _vr_read(files, name, dtype) for name, dtype in VR_COLUMNS}
    return vr_catalogue(columns, _vr_units(files[0]), h, a)


# ----------------------------------------------------------------------
# Gadget-4 SubFind
# ----------------------------------------------------------------------

#: the ``Subhalo`` datasets the catalogue reads, with their dtypes
GADGET4_COLUMNS = (
    ("SubhaloPos", np.float64),
    ("SubhaloRankInGr", np.int64),
    ("SubhaloLen", np.int64),
    ("SubhaloGroupNr", np.int64),
    ("SubhaloHalfmassRad", np.float64),
)


def _gadget4_files(path: str) -> List[str]:
    """Single tab file, or all files of a multi-file tab set."""
    import h5py

    if os.path.exists(path):
        with h5py.File(path, "r") as f:
            nr = (
                int(np.asarray(f["Header"].attrs.get("NumFiles", 1)).ravel()[0])
                if "Header" in f
                else 1
            )
        if nr == 1 or not path.endswith(".0.hdf5"):
            return [path]
        base = path[: -len(".0.hdf5")]
        return [f"{base}.{i}.hdf5" for i in range(nr)]
    first = f"{path}.0.hdf5"
    if os.path.exists(first):
        with h5py.File(first, "r") as f:
            nr = int(np.asarray(f["Header"].attrs["NumFiles"]).ravel()[0])
        return [f"{path}.{i}.hdf5" for i in range(nr)]
    single = f"{path}.hdf5"
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(f"no Gadget-4 tab file at {path}")


def _gadget4_read(filenames: List[str], name: str, dtype) -> np.ndarray:
    import h5py

    parts = []
    for fn in filenames:
        with h5py.File(fn, "r") as f:
            if name in f:
                parts.append(np.asarray(f[name], dtype=dtype))
    return np.concatenate(parts) if parts else np.zeros(0, dtype)


def read_gadget4_groupnr(tab_file: str, snap_file: str):
    """(nr_halos, ids, grnr) from the subhaloes' length and offset ranges
    over the group-ordered snapshot particle IDs; both file sets may be
    multi-file."""
    tabs = _gadget4_files(tab_file)
    lens = _gadget4_read(tabs, "Subhalo/SubhaloLenType", np.int64)
    offs = _gadget4_read(tabs, "Subhalo/SubhaloOffsetType", np.int64)
    snaps = _gadget4_files(snap_file)
    all_ids, all_grnr = [], []
    for type_nr in range(lens.shape[1]):
        ids = _gadget4_read(snaps, f"PartType{type_nr}/ParticleIDs", np.uint64)
        if len(ids) == 0:
            continue
        grnr = np.full(len(ids), -1, dtype=np.int64)
        sub = np.flatnonzero(lens[:, type_nr] > 0)
        starts = offs[sub, type_nr]
        counts = lens[sub, type_nr]
        rows = np.repeat(starts, counts) + (
            np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        grnr[rows] = np.repeat(sub, counts)
        all_ids.append(ids)
        all_grnr.append(grnr)
    return (
        lens.shape[0],
        np.concatenate(all_ids) if all_ids else np.zeros(0, np.uint64),
        np.concatenate(all_grnr) if all_grnr else np.zeros(0, np.int64),
    )


def gadget4_catalogue(
    subhalo: Mapping[str, np.ndarray],
    parameters: Mapping[str, object],
    h: float = 1.0,
    a: float = 1.0,
) -> HaloCatalogue:
    """The catalogue from a tab's ``Subhalo`` columns (``GADGET4_COLUMNS``)
    and its ``Parameters`` attributes (an empty mapping: Mpc/h)."""
    length_cgs = float(np.asarray(parameters.get("UnitLength_in_cm", MPC_CM)).ravel()[0])
    hubble = float(np.asarray(parameters.get("Hubble", 100.0)).ravel()[0])
    hubbleparam = float(np.asarray(parameters.get("HubbleParam", h)).ravel()[0])
    if hubble != 100.0:
        # reference read_subfind.py:177-178: only 1/h unit systems
        raise ValueError("Gadget-4 runs with Hubble != 100.0 not supported")
    conv = length_cgs / hubbleparam / MPC_CM  # -> Mpc (no h)
    col = {name: np.asarray(subhalo[name], dtype) for name, dtype in GADGET4_COLUMNS}
    H = len(col["SubhaloLen"])
    return HaloCatalogue(
        nr_halos=H,
        index=np.arange(H, dtype=np.int64),
        cofp=col["SubhaloPos"] * conv,
        # reference: 4 x half-mass radius in physical units
        # (read_subfind.py:228-232) -> comoving for our convention
        search_radius=4.0 * (col["SubhaloHalfmassRad"] * conv) / a,
        is_central=col["SubhaloRankInGr"] == 0,
        nr_bound_part=col["SubhaloLen"],
        fof_id=col["SubhaloGroupNr"],
        passthrough={},
    )


def read_gadget4_catalogue(tab_file: str, h: float = 1.0, a: float = 1.0) -> HaloCatalogue:
    import h5py

    tabs = _gadget4_files(tab_file)
    with h5py.File(tabs[0], "r") as f:
        parameters = dict(f["Parameters"].attrs) if "Parameters" in f else {}
    subhalo = {name: _gadget4_read(tabs, f"Subhalo/{name}", dtype)
               for name, dtype in GADGET4_COLUMNS}
    return gadget4_catalogue(subhalo, parameters, h, a)


# ----------------------------------------------------------------------
# EAGLE SubFind (catalogue only; membership via conversion scripts)
# ----------------------------------------------------------------------

#: the ``Subhalo`` datasets the catalogue reads, with their dtypes
SUBFIND_EAGLE_COLUMNS = (
    ("CentreOfPotential", np.float64),
    ("SubLength", np.int64),
    ("SubGroupNumber", np.int64),
    ("GroupNumber", np.int64),
    ("HalfMassRad", np.float64),
)


def subfind_eagle_catalogue(
    subhalo: Mapping[str, np.ndarray], h: float = 1.0, a: float = 1.0
) -> HaloCatalogue:
    """The catalogue from an EAGLE SubFind tab's ``Subhalo`` columns
    (``SUBFIND_EAGLE_COLUMNS``; ``h`` and ``a`` unused, as the reference's
    lengths are taken as stored)."""
    col = {name: np.asarray(subhalo[name], dtype) for name, dtype in SUBFIND_EAGLE_COLUMNS}
    halfmass = col["HalfMassRad"]
    if halfmass.ndim == 2:  # per-type; use the total/stellar max
        halfmass = halfmass.max(axis=1)
    group, subgroup = col["GroupNumber"], col["SubGroupNumber"]
    H = len(col["SubLength"])
    return HaloCatalogue(
        nr_halos=H,
        index=np.arange(H, dtype=np.int64),
        cofp=col["CentreOfPotential"],
        search_radius=4.0 * halfmass,
        is_central=subgroup == 0,
        nr_bound_part=col["SubLength"],
        fof_id=group,
        passthrough={
            "SubfindEagle/group_nr": group.astype(np.uint64),
            "SubfindEagle/sub_group_nr": subgroup.astype(np.uint64),
        },
    )


def read_subfind_eagle_catalogue(tab_file: str, h: float = 1.0, a: float = 1.0) -> HaloCatalogue:
    import h5py

    with h5py.File(tab_file, "r") as f:
        subhalo = {name: np.asarray(f[f"Subhalo/{name}"], dtype)
                   for name, dtype in SUBFIND_EAGLE_COLUMNS}
    return subfind_eagle_catalogue(subhalo, h, a)


# ----------------------------------------------------------------------
# Rockstar (ASCII out_*.list and binary halos_*.bin)
# ----------------------------------------------------------------------

#: the Rockstar binary chunk header (io/io_internal.h): 256 bytes
_ROCKSTAR_HEADER = np.dtype(
    [
        ("magic", "u8"),
        ("snap", "i8"),
        ("chunk", "i8"),
        ("scale", "f4"),
        ("Om", "f4"),
        ("Ol", "f4"),
        ("h0", "f4"),
        ("bounds", "f4", 6),
        ("num_halos", "i8"),
        ("num_particles", "i8"),
        ("box_size", "f4"),
        ("particle_mass", "f4"),
        ("particle_type", "i8"),
        ("format_revision", "i4"),
        ("rockstar_version", "S12"),
        ("unused", "S144"),
    ]
)

#: the packed `struct halo` (halo.h, standard build, 264 bytes)
_ROCKSTAR_HALO = np.dtype(
    [
        ("id", "i8"),
        ("pos", "f4", 6),
        ("corevel", "f4", 3),
        ("bulkvel", "f4", 3),
        ("m", "f4"),
        ("r", "f4"),
        ("child_r", "f4"),
        ("vmax_r", "f4"),
        ("mgrav", "f4"),
        ("vmax", "f4"),
        ("rvmax", "f4"),
        ("rs", "f4"),
        ("klypin_rs", "f4"),
        ("vrms", "f4"),
        ("J", "f4", 3),
        ("energy", "f4"),
        ("spin", "f4"),
        ("alt_m", "f4", 4),
        ("Xoff", "f4"),
        ("Voff", "f4"),
        ("b_to_a", "f4"),
        ("c_to_a", "f4"),
        ("A", "f4", 3),
        ("b_to_a2", "f4"),
        ("c_to_a2", "f4"),
        ("A2", "f4", 3),
        ("bullock_spin", "f4"),
        ("kin_to_pot", "f4"),
        ("m_pe_b", "f4"),
        ("m_pe_d", "f4"),
        ("halfmass_radius", "f4"),
        ("num_p", "i8"),
        ("num_child_particles", "i8"),
        ("p_start", "i8"),
        ("desc", "i8"),
        ("flags", "i8"),
        ("n_core", "i8"),
        ("min_pos_err", "f4"),
        ("min_vel_err", "f4"),
        ("min_bulkvel_err", "f4"),
        ("_pad2", "f4"),
    ]
)


def read_rockstar_binary(path: str) -> Tuple[np.ndarray, Dict[str, float]]:
    """(halo struct array, header info) from one binary chunk file."""
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(_ROCKSTAR_HEADER.itemsize), _ROCKSTAR_HEADER)[0]
        n = int(header["num_halos"])
        file_size = os.path.getsize(path)
        per_halo = (
            (file_size - _ROCKSTAR_HEADER.itemsize - 8 * int(header["num_particles"])) // n
            if n
            else _ROCKSTAR_HALO.itemsize
        )
        if per_halo != _ROCKSTAR_HALO.itemsize:
            raise ValueError(
                f"unsupported Rockstar halo struct size {per_halo} "
                f"(expected {_ROCKSTAR_HALO.itemsize}) in {path}"
            )
        halos = np.frombuffer(f.read(n * _ROCKSTAR_HALO.itemsize), _ROCKSTAR_HALO)
    info = {
        "scale": float(header["scale"]),
        "h0": float(header["h0"]),
        "box_size": float(header["box_size"]),
        "num_particles": int(header["num_particles"]),
    }
    return halos, info


def _rockstar_binary_files(path: str) -> List[str]:
    if os.path.exists(path) and path.endswith(".bin"):
        base = path.rsplit(".", 2)[0]
        chunks = sorted(glob.glob(f"{base}.*.bin"), key=lambda p: int(p.rsplit(".", 2)[1]))
        return chunks if chunks else [path]
    return []


def read_rockstar_catalogue(list_file: str, h: float, a: float = 1.0) -> HaloCatalogue:
    """Read a Rockstar catalogue: ASCII ``out_*.list`` or binary
    ``halos_*.bin`` chunks (positions Mpc/h comoving, radii kpc/h)."""
    if list_file.endswith(".bin"):
        parts = [read_rockstar_binary(c) for c in _rockstar_binary_files(list_file)]
        halos = np.concatenate([p[0] for p in parts])
        h0 = parts[0][1]["h0"] or h
        hid = halos["id"].astype(np.int64)
        rvir = halos["r"].astype(np.float64) / h0 / 1000.0  # kpc/h -> Mpc
        pid = np.full(len(hid), -1, np.int64)  # binary chunks: no parents
        H = len(hid)
        return HaloCatalogue(
            nr_halos=H,
            index=np.arange(H, dtype=np.int64),
            cofp=halos["pos"][:, :3].astype(np.float64) / h0,
            search_radius=2.0 * rvir,
            is_central=pid < 0,
            nr_bound_part=halos["num_p"].astype(np.int64),
            fof_id=hid,
            passthrough={},
        )
    with open(list_file) as f:
        header = f.readline().lstrip("#").split()
    cols = {name.split("(")[0].lower(): i for i, name in enumerate(header)}
    data = np.loadtxt(list_file, comments="#", ndmin=2)
    if data.size == 0:
        data = np.zeros((0, len(header)))

    def col(*names):
        for n in names:
            if n in cols:
                return data[:, cols[n]]
        raise KeyError(f"Rockstar column {names} not found in {header}")

    rvir = col("rvir", "r200c", "rs") / h / 1000.0  # kpc/h -> Mpc
    hid = col("id").astype(np.int64)
    pid = (col("pid", "parent_id").astype(np.int64) if ("pid" in cols or "parent_id" in cols)
           else np.full(len(hid), -1, np.int64))
    npart = (col("np", "num_p").astype(np.int64) if ("np" in cols or "num_p" in cols)
             else np.zeros(len(hid), np.int64))
    H = len(hid)
    return HaloCatalogue(
        nr_halos=H,
        index=np.arange(H, dtype=np.int64),
        cofp=np.stack([col("x") / h, col("y") / h, col("z") / h], axis=1),
        search_radius=2.0 * rvir,
        is_central=pid < 0,
        nr_bound_part=npart,
        fof_id=np.where(pid >= 0, pid, hid),
        passthrough={},
    )
