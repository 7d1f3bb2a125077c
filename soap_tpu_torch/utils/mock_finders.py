"""A halo catalogue as each of the other halo finders stores it.

From a ``HaloCatalogue`` (a mock universe's HBTplus one,
``pipeline/run.py::mock_catalogue``) this gives the datasets each other
finder's reader reads, in that finder's own units, for the same halos in
the same order, so that a membership file's ``GroupNr_bound`` indexes
them all alike:

 - VELOCIraptor (``vr_tables``): ``.properties`` columns in comoving
   units with ``UnitInfo`` (``Length_unit_to_kpc`` 1000, which the reader
   scales by h), ``Structuretype`` 10 for centrals and 15 for satellites,
   a satellite's ``hostHaloID`` its central's ``ID``;
 - Gadget-4 SubFind (``gadget4_tables``): ``Subhalo`` columns in Mpc/h
   with their ``Parameters``, the half-mass radius a quarter of the
   physical search radius;
 - EAGLE SubFind (``subfind_eagle_tables``): ``Subhalo`` columns in Mpc;
 - Rockstar: an ASCII ``out_*.list`` (``write_rockstar_list``; Mpc/h and
   kpc/h, written with 17 significant digits) and binary ``halos_*.bin``
   chunks (``write_rockstar_binary``; float32 positions and radii, as
   the format stores them, and no parents, so every halo reads back
   central).

Each reader gives back the catalogue's centrality and bound counts
exactly, and its centres and search radii up to the unit round trip:
EAGLE's exactly, VR's, Gadget-4's and the ASCII list's within an ulp or
two, the binary chunks' within float32.  ``finder_catalogue`` builds the
catalogue a reader returns (through the array halves, and through files
for Rockstar), so ``chip_smoke.py`` needs no h5py; ``write_finder_files``
writes every finder's files, importing h5py inside.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from soap_tpu_torch.io import finder_readers as fr
from soap_tpu_torch.io.halos import HaloCatalogue

#: VR's unit attributes the tables carry (comoving, kpc per length unit)
VR_UNITS = {"Comoving_or_Physical": 1, "Length_unit_to_kpc": 1000.0}

#: the ASCII halo list's columns (Rockstar's ``out_*.list`` header)
ROCKSTAR_LIST_COLUMNS = ("ID", "DescID", "Mvir", "Vmax", "Vrms", "Rvir", "Rs", "Np",
                         "X", "Y", "Z", "VX", "VY", "VZ", "PID")


def _ranks(cat: HaloCatalogue) -> np.ndarray:
    """0 for a central, 1, 2 ... for its satellites in catalogue order."""
    rank = np.zeros(cat.nr_halos, np.int64)
    sat = np.flatnonzero(~cat.is_central.astype(bool))
    for host in np.unique(cat.fof_id[sat]):
        rows = sat[cat.fof_id[sat] == host]
        rank[rows] = np.arange(1, len(rows) + 1)
    return rank


def _central_rows(cat: HaloCatalogue) -> np.ndarray:
    """Each halo's central's row (its own for a central), by FOF id."""
    cen = np.flatnonzero(cat.is_central.astype(bool))
    row_of = dict(zip(cat.fof_id[cen].tolist(), cen.tolist()))
    return np.array([row_of.get(int(f), i) for i, f in enumerate(cat.fof_id)], np.int64)


def vr_tables(cat: HaloCatalogue, h: float) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
    """(``.properties`` columns, ``UnitInfo`` attributes) of a VR
    catalogue of these halos: IDs 1..H, a satellite's ``hostHaloID`` its
    central's ID."""
    conv = fr.vr_length_conversion(VR_UNITS, h, 1.0)
    central = cat.is_central.astype(bool)
    vr_id = np.arange(1, cat.nr_halos + 1, dtype=np.int64)
    host = np.where(central, -1, vr_id[_central_rows(cat)])
    nsub = np.bincount(_central_rows(cat)[~central], minlength=cat.nr_halos)
    columns = {
        "Xcminpot": cat.cofp[:, 0] / conv,
        "Ycminpot": cat.cofp[:, 1] / conv,
        "Zcminpot": cat.cofp[:, 2] / conv,
        "R_size": cat.search_radius / 1.01 / conv,
        "ID": vr_id,
        "hostHaloID": host,
        "Structuretype": np.where(central, 10, 15).astype(np.int32),
        "numSubStruct": np.asarray(nsub, np.int64),
        "npart": np.asarray(cat.nr_bound_part, np.int64),
    }
    return columns, dict(VR_UNITS)


def gadget4_tables(
    cat: HaloCatalogue, h: float, a: float
) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
    """(``Subhalo`` columns, ``Parameters`` attributes) of a Gadget-4
    SubFind tab of these halos, lengths in Mpc/h."""
    parameters = {"UnitLength_in_cm": fr.MPC_CM, "Hubble": 100.0, "HubbleParam": h}
    conv = fr.MPC_CM / h / fr.MPC_CM
    subhalo = {
        "SubhaloPos": cat.cofp / conv,
        "SubhaloRankInGr": _ranks(cat),
        "SubhaloLen": np.asarray(cat.nr_bound_part, np.int64),
        "SubhaloGroupNr": np.asarray(cat.fof_id, np.int64),
        # physical half-mass radius: 4 of them, over a, make the search radius
        "SubhaloHalfmassRad": cat.search_radius * a / 4.0 / conv,
    }
    return subhalo, parameters


def subfind_eagle_tables(cat: HaloCatalogue) -> Dict[str, np.ndarray]:
    """``Subhalo`` columns of an EAGLE SubFind tab of these halos (Mpc)."""
    return {
        "CentreOfPotential": np.array(cat.cofp, np.float64),
        "SubLength": np.asarray(cat.nr_bound_part, np.int64),
        "SubGroupNumber": _ranks(cat),
        "GroupNumber": np.asarray(cat.fof_id, np.int64),
        "HalfMassRad": cat.search_radius / 4.0,
    }


def write_rockstar_list(path: str, cat: HaloCatalogue, h: float) -> str:
    """An ASCII ``out_*.list`` of these halos (IDs their rows, a
    satellite's PID its central's ID), positions in Mpc/h and radii in
    kpc/h with 17 significant digits."""
    central = cat.is_central.astype(bool)
    hid = np.arange(cat.nr_halos, dtype=np.float64)
    cols = {name: np.zeros(cat.nr_halos) for name in ROCKSTAR_LIST_COLUMNS}
    cols.update(ID=hid, DescID=np.full(cat.nr_halos, -1.0),
                Rvir=cat.search_radius / 2.0 * h * 1000.0,
                Np=np.asarray(cat.nr_bound_part, np.float64),
                X=cat.cofp[:, 0] * h, Y=cat.cofp[:, 1] * h, Z=cat.cofp[:, 2] * h,
                PID=np.where(central, -1.0, hid[_central_rows(cat)]))
    table = np.stack([cols[name] for name in ROCKSTAR_LIST_COLUMNS], axis=1)
    with open(path, "w") as f:
        f.write("#" + " ".join(ROCKSTAR_LIST_COLUMNS) + "\n")
        np.savetxt(f, table, fmt="%.17g")
    return path


def write_rockstar_binary(basename: str, cat: HaloCatalogue, h: float, a: float,
                          n_chunks: int = 1) -> str:
    """Binary ``{basename}.{chunk}.bin`` chunks of these halos, split in
    catalogue order: the 256-byte header (h0 and scale as float32), the
    halo structs (IDs their rows, float32 positions in Mpc/h and radii in
    kpc/h), and each chunk's particle IDs (none).  Returns the first
    chunk's path, the one the reader is given."""
    paths = []
    for c, rows in enumerate(np.array_split(np.arange(cat.nr_halos), n_chunks)):
        halos = np.zeros(len(rows), fr._ROCKSTAR_HALO)
        halos["id"] = rows
        halos["pos"][:, :3] = (cat.cofp[rows] * h).astype(np.float32)
        halos["r"] = (cat.search_radius[rows] / 2.0 * h * 1000.0).astype(np.float32)
        halos["num_p"] = cat.nr_bound_part[rows]
        header = np.zeros(1, fr._ROCKSTAR_HEADER)
        header["magic"] = 0xFABFABFA
        header["chunk"] = c
        header["num_halos"] = len(rows)
        header["h0"] = h
        header["scale"] = a
        path = f"{basename}.{c}.bin"
        with open(path, "wb") as f:
            f.write(header.tobytes())
            f.write(halos.tobytes())
        paths.append(path)
    return paths[0]


def finder_catalogue(finder: str, cat: HaloCatalogue, h: float, a: float,
                     tmpdir: str = "") -> HaloCatalogue:
    """The catalogue ``finder``'s reader returns for these halos: through
    its array half for VR, Gadget4 and SubfindEagle, and through files
    written to ``tmpdir`` for Rockstar (the ASCII list) and RockstarBinary
    (four binary chunks)."""
    if finder == "VR":
        return fr.vr_catalogue(*vr_tables(cat, h), h=h, a=a)
    if finder == "Gadget4":
        return fr.gadget4_catalogue(*gadget4_tables(cat, h, a), h=h, a=a)
    if finder == "SubfindEagle":
        return fr.subfind_eagle_catalogue(subfind_eagle_tables(cat), h=h, a=a)
    if finder == "Rockstar":
        return fr.read_rockstar_catalogue(
            write_rockstar_list(os.path.join(tmpdir, "out_0.list"), cat, h), h, a)
    if finder == "RockstarBinary":
        return fr.read_rockstar_catalogue(
            write_rockstar_binary(os.path.join(tmpdir, "halos_0"), cat, h, a, 4), h, a)
    raise ValueError(f"no mock tables for the finder {finder!r}")


def write_finder_files(tmpdir: str, cat: HaloCatalogue, h: float, a: float,
                       ids_bound: np.ndarray) -> Dict[str, str]:
    """Each other finder's files of these halos in ``tmpdir``: a VR
    catalogue with its bound lists (``ids_bound``, the halos' bound
    particle IDs concatenated in catalogue order, ``nr_bound_part`` of
    each), a Gadget-4 tab, an EAGLE SubFind tab and a Rockstar list.
    Returns the name each reader takes, by finder."""
    import h5py

    out = {"VR": os.path.join(tmpdir, "vr_catalogue")}
    columns, units = vr_tables(cat, h)
    with h5py.File(out["VR"] + ".properties", "w") as f:
        for name, arr in columns.items():
            f[name] = arr
        g = f.create_group("UnitInfo")
        for k, v in units.items():
            g.attrs[k] = v
    counts = np.asarray(cat.nr_bound_part, np.int64)
    with h5py.File(out["VR"] + ".catalog_groups", "w") as f:
        f["Group_Size"] = counts
        f["Offset"] = np.cumsum(counts) - counts
        f["Offset_unbound"] = np.zeros(cat.nr_halos, np.int64)
    with h5py.File(out["VR"] + ".catalog_particles", "w") as f:
        f["Particle_IDs"] = np.asarray(ids_bound, np.uint64)
    with h5py.File(out["VR"] + ".catalog_particles.unbound", "w") as f:
        f["Particle_IDs"] = np.zeros(0, np.uint64)
    subhalo, parameters = gadget4_tables(cat, h, a)
    out["Gadget4"] = os.path.join(tmpdir, "fof_subhalo_tab.hdf5")
    with h5py.File(out["Gadget4"], "w") as f:
        f.create_group("Header").attrs["NumFiles"] = np.array([1])
        p = f.create_group("Parameters")
        for k, v in parameters.items():
            p.attrs[k] = v
        for name, arr in subhalo.items():
            f[f"Subhalo/{name}"] = arr
    out["SubfindEagle"] = os.path.join(tmpdir, "eagle_subfind_tab.hdf5")
    with h5py.File(out["SubfindEagle"], "w") as f:
        for name, arr in subfind_eagle_tables(cat).items():
            f[f"Subhalo/{name}"] = arr
    out["Rockstar"] = write_rockstar_list(os.path.join(tmpdir, "out_0.list"), cat, h)
    return out
