"""Convert EAGLE GADGET particledata snapshots to SWIFT layout.

The port's copy of ``soap_tpu/tools/convert_eagle.py``, counterpart of
the reference's ``misc/convert_eagle.py`` (an MPI script over virgo
parallel sorts): reads the EAGLE ``particledata_***`` files (which carry
GroupNumber/SubGroupNumber, so membership files fall out for free),
converts every dataset to SWIFT conventions — h-free comoving values in
SWIFT internal units, SWIFT dataset names, a SWIFT top-level cell
structure — and writes a single SWIFT-layout snapshot plus the matching
membership file.  The converted pair feeds the normal pipeline with
``halo_format="SubfindEagle"``.

Unit handling mirrors the reference: each GADGET dataset carries
``h-scale-exponent``, ``aexp-scale-exponent`` and
``CGSConversionFactor`` attributes; SWIFT values are
``raw * h**h_exp * CGS / U(dims)`` with the a-exponent preserved as
metadata (values stay comoving).  h5py is imported inside the
functions that open files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

#: SWIFT internal units (FLAMINGO convention): Mpc, 1e10 Msun, Mpc/(km/s)
U_L = 3.08567758e24
U_M = 1.98841e43
U_V = 1.0e5
U_T = U_L / U_V

#: GADGET name -> (SWIFT name, cgs dims (L, M, t) exponents)
DATASET_MAP: Dict[str, Dict[str, Tuple[str, Tuple[int, int, int]]]] = {
    "PartType0": {
        "Coordinates": ("Coordinates", (1, 0, 0)),
        "Velocity": ("Velocities", (1, 0, -1)),
        "Mass": ("Masses", (0, 1, 0)),
        "ParticleIDs": ("ParticleIDs", (0, 0, 0)),
        "Density": ("Densities", (-3, 1, 0)),
        "Temperature": ("Temperatures", (0, 0, 0)),
        "InternalEnergy": ("InternalEnergies", (2, 0, -2)),
        "StarFormationRate": ("StarFormationRates", (0, 1, -1)),
        "Metallicity": ("MetalMassFractions", (0, 0, 0)),
    },
    "PartType1": {
        "Coordinates": ("Coordinates", (1, 0, 0)),
        "Velocity": ("Velocities", (1, 0, -1)),
        "ParticleIDs": ("ParticleIDs", (0, 0, 0)),
    },
    "PartType4": {
        "Coordinates": ("Coordinates", (1, 0, 0)),
        "Velocity": ("Velocities", (1, 0, -1)),
        "Mass": ("Masses", (0, 1, 0)),
        "ParticleIDs": ("ParticleIDs", (0, 0, 0)),
        "InitialMass": ("InitialMasses", (0, 1, 0)),
        "StellarFormationTime": ("BirthScaleFactors", (0, 0, 0)),
        "Metallicity": ("MetalMassFractions", (0, 0, 0)),
    },
    "PartType5": {
        "Coordinates": ("Coordinates", (1, 0, 0)),
        "Velocity": ("Velocities", (1, 0, -1)),
        "Mass": ("DynamicalMasses", (0, 1, 0)),
        "BH_Mass": ("SubgridMasses", (0, 1, 0)),
        "BH_Mdot": ("AccretionRates", (0, 1, -1)),
        "ParticleIDs": ("ParticleIDs", (0, 0, 0)),
    },
}

ELEMENTS = (
    "Hydrogen", "Helium", "Carbon", "Nitrogen", "Oxygen",
    "Neon", "Magnesium", "Silicon", "Iron",
)


def _files(basename: str) -> List[str]:
    if os.path.exists(basename):
        return [basename]
    out, i = [], 0
    while os.path.exists(f"{basename}.{i}.hdf5"):
        out.append(f"{basename}.{i}.hdf5")
        i += 1
    if not out:
        raise FileNotFoundError(basename)
    return out


def _u_cgs(dims: Tuple[int, int, int]) -> float:
    L, M, t = dims
    return U_L**L * U_M**M * U_T**t


def _read_converted(
    files: List[str], ptype: str, gname: str, dims, h: float
) -> Optional[np.ndarray]:
    """Concatenated dataset in SWIFT units (h-free comoving)."""
    import h5py

    parts, h_exp, cgs = [], 0.0, 1.0
    for fn in files:
        with h5py.File(fn, "r") as f:
            if ptype not in f or gname not in f[ptype]:
                continue
            ds = f[ptype][gname]
            h_exp = float(ds.attrs.get("h-scale-exponent", 0.0))
            cgs = float(ds.attrs.get("CGSConversionFactor", 1.0))
            parts.append(np.asarray(ds))
    if not parts:
        return None
    raw = np.concatenate(parts)
    if raw.dtype.kind in "iu":
        return raw
    factor = h**h_exp * cgs / _u_cgs(dims)
    return (raw.astype(np.float64) * factor).astype(np.float32)


def convert_eagle(
    particledata_basename: str,
    output_snapshot: str,
    output_membership: str,
    subfind_basename: Optional[str] = None,
    cells_per_dim: int = 4,
) -> Dict[str, int]:
    """Write the SWIFT-layout snapshot + membership file; returns
    per-ptype particle counts."""
    import h5py

    files = _files(particledata_basename)
    with h5py.File(files[0], "r") as f:
        hdr = f["Header"].attrs
        h = float(np.ravel(hdr["HubbleParam"])[0])
        a = float(np.ravel(hdr.get("ExpansionFactor", hdr.get("Time")))[0])
        box_hinv = float(np.ravel(hdr["BoxSize"])[0])  # h^-1 cMpc
        omega0 = float(np.ravel(hdr["Omega0"])[0])
        omegaL = float(np.ravel(hdr["OmegaLambda"])[0])
        omegaB = float(np.ravel(hdr.get("OmegaBaryon", 0.0))[0])
        mass_table = np.ravel(np.asarray(hdr.get("MassTable", np.zeros(6))))
    boxsize = box_hinv / h  # cMpc, h-free

    # subhalo row lookup (catalogue order defines GroupNr_bound)
    cat_rows = None
    if subfind_basename is not None:
        with h5py.File(_files(subfind_basename)[0], "r") as f:
            cg = np.asarray(f["Subhalo/GroupNumber"], np.int64)
            cs = np.asarray(f["Subhalo/SubGroupNumber"], np.int64)
        key = cg * np.int64(1 << 32) + cs
        order = np.argsort(key)
        cat_rows = (key[order], order)

    counts: Dict[str, int] = {}
    ptype_data: Dict[str, Dict[str, np.ndarray]] = {}
    membership: Dict[str, np.ndarray] = {}
    for ptype, dmap in DATASET_MAP.items():
        out: Dict[str, np.ndarray] = {}
        for gname, (sname, dims) in dmap.items():
            arr = _read_converted(files, ptype, gname, dims, h)
            if arr is not None:
                out[sname] = arr
        if "Coordinates" not in out:
            continue
        n = len(out["Coordinates"])
        if ptype == "PartType1" and "Masses" not in out:
            # DM mass from the GADGET mass table (1e10 Msun/h)
            out["Masses"] = np.full(n, mass_table[1] / h, np.float32)
        # EAGLE stores per-element abundances as separate datasets
        elem = []
        for el in ELEMENTS:
            col = _read_converted(
                files, ptype, f"ElementAbundance/{el}", (0, 0, 0), h
            )
            if col is None:
                elem = []
                break
            elem.append(col)
        if elem:
            out["ElementMassFractions"] = np.stack(elem, axis=1)

        # membership from GroupNumber/SubGroupNumber
        grp = _read_converted(files, ptype, "GroupNumber", (0, 0, 0), h)
        sub = _read_converted(files, ptype, "SubGroupNumber", (0, 0, 0), h)
        grnr = np.full(n, -1, dtype=np.int64)
        if grp is not None and sub is not None and cat_rows is not None:
            # negative GroupNumber = not in a FOF group; huge
            # SubGroupNumber = unbound fuzz
            bound = (grp > 0) & (sub < (1 << 30))
            key = grp.astype(np.int64) * np.int64(1 << 32) + sub.astype(
                np.int64
            )
            skey, srows = cat_rows
            pos = np.searchsorted(skey, key[bound])
            pos = np.clip(pos, 0, len(skey) - 1)
            hit = skey[pos] == key[bound]
            tmp = np.full(int(bound.sum()), -1, dtype=np.int64)
            tmp[hit] = srows[pos[hit]]
            grnr[bound] = tmp
        if grp is not None:
            out["FOFGroupIDs"] = np.where(
                grp > 0, grp, -1
            ).astype(np.int64)
        membership[ptype] = grnr
        counts[ptype] = n
        ptype_data[ptype] = out

    _write_swift_snapshot(
        output_snapshot, ptype_data, boxsize, a, h,
        omega0, omegaL, omegaB, cells_per_dim,
    )
    _write_membership(output_membership, ptype_data, membership)
    return counts


def _write_swift_snapshot(
    path, ptype_data, boxsize, a, h, omega_m, omega_l, omega_b, cells_per_dim
):
    """Single-file SWIFT layout with a real cell structure (reuses the
    mock writer's layout conventions)."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cell_size = boxsize / cells_per_dim
    n_cells = cells_per_dim**3

    def cell_of(pos):
        ijk = np.floor(np.mod(pos, boxsize) / cell_size).astype(np.int64)
        ijk = np.clip(ijk, 0, cells_per_dim - 1)
        return (
            ijk[:, 0] * cells_per_dim + ijk[:, 1]
        ) * cells_per_dim + ijk[:, 2]

    with h5py.File(path, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["BoxSize"] = np.array([boxsize] * 3)
        hdr.attrs["Scale-factor"] = np.array([a])
        hdr.attrs["Redshift"] = np.array([1.0 / a - 1.0])
        hdr.attrs["NumFilesPerSnapshot"] = np.array([1], dtype=np.int32)
        npart = np.zeros(7, np.int64)
        for pt, fields in ptype_data.items():
            npart[int(pt[-1])] = len(fields["Coordinates"])
        hdr.attrs["NumPart_ThisFile"] = npart
        hdr.attrs["NumPart_Total"] = npart.astype(np.uint64)
        hdr.attrs["RunName"] = np.bytes_("EAGLE-converted")

        cos = f.create_group("Cosmology")
        cos.attrs["Scale-factor"] = np.array([a])
        cos.attrs["Redshift"] = np.array([1.0 / a - 1.0])
        cos.attrs["h"] = np.array([h])
        cos.attrs["H0 [internal units]"] = np.array([100.0 * h])
        E2 = omega_m / a**3 + omega_l
        cos.attrs["H [internal units]"] = np.array([100.0 * h * np.sqrt(E2)])
        cos.attrs["Omega_m"] = np.array([omega_m])
        cos.attrs["Omega_lambda"] = np.array([omega_l])
        cos.attrs["Omega_b"] = np.array([omega_b])
        cos.attrs["Critical density [internal units]"] = np.array(
            [3.0 * (100.0 * h) ** 2 / (8.0 * np.pi * 43.0187) * E2]
        )

        units = f.create_group("Units")
        units.attrs["Unit length in cgs (U_L)"] = np.array([U_L])
        units.attrs["Unit mass in cgs (U_M)"] = np.array([U_M])
        units.attrs["Unit time in cgs (U_t)"] = np.array([U_T])
        units.attrs["Unit current in cgs (U_I)"] = np.array([1.0])
        units.attrs["Unit temperature in cgs (U_T)"] = np.array([1.0])
        f.copy("Units", f, name="InternalCodeUnits")

        pcg = f.create_group("PhysicalConstants")
        pc = pcg.create_group("CGS")
        pc.attrs["newton_G"] = np.array([6.67430e-8])
        pc.attrs["parsec"] = np.array([3.08567758149e18])
        pc.attrs["solar_mass"] = np.array([1.98841e33])
        internal = pcg.create_group("InternalUnits")
        # G in internal units: G_cgs * U_M * U_t^2 / U_L^3
        internal.attrs["newton_G"] = np.array(
            [6.67430e-8 * U_M * U_T**2 / U_L**3]
        )
        f.create_group("Parameters")

        cells = f.create_group("Cells")
        md = cells.create_group("Meta-data")
        md.attrs["nr_cells"] = np.int64(n_cells)
        md.attrs["dimension"] = np.array([cells_per_dim] * 3, np.int64)
        md.attrs["size"] = np.array([cell_size] * 3)
        centres = np.zeros((n_cells, 3))
        idx = np.arange(n_cells)
        centres[:, 0] = (idx // (cells_per_dim**2) + 0.5) * cell_size
        centres[:, 1] = ((idx // cells_per_dim) % cells_per_dim + 0.5) * cell_size
        centres[:, 2] = (idx % cells_per_dim + 0.5) * cell_size
        cells.create_dataset("Centres", data=centres)
        for sub in ("Counts", "OffsetsInFile", "Files"):
            cells.create_group(sub)

        for pt, fields in ptype_data.items():
            cid = cell_of(fields["Coordinates"])
            order = np.argsort(cid, kind="stable")
            cnt = np.bincount(cid, minlength=n_cells).astype(np.int64)
            cells["Counts"].create_dataset(pt, data=cnt)
            cells["OffsetsInFile"].create_dataset(
                pt, data=np.cumsum(cnt) - cnt
            )
            cells["Files"].create_dataset(
                pt, data=np.zeros(n_cells, np.int32)
            )
            g = f.create_group(pt)
            for name, arr in fields.items():
                ds = g.create_dataset(name, data=arr[order])
                ds.attrs["a-scale exponent"] = np.array(
                    [1.0 if name == "Coordinates" else 0.0]
                )
            fields["__order__"] = order
        if any("ElementMassFractions" in d for d in ptype_data.values()):
            nc = f.create_group("SubgridScheme").create_group("NamedColumns")
            nc.create_dataset(
                "ElementMassFractions",
                data=np.array([e.encode() for e in ELEMENTS]),
            )


def _write_membership(path, ptype_data, membership):
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        for pt, grnr in membership.items():
            if pt not in ptype_data:
                continue
            order = ptype_data[pt]["__order__"]
            g = f.create_group(pt)
            sorted_grnr = grnr[order]
            g.create_dataset("GroupNr_bound", data=sorted_grnr)
            # EAGLE carries no boundness rank; use in-halo order
            rank = np.full(len(sorted_grnr), -1, np.int32)
            bound = sorted_grnr >= 0
            o = np.argsort(sorted_grnr[bound], kind="stable")
            r = np.empty(int(bound.sum()), np.int32)
            uniq, start = np.unique(sorted_grnr[bound][o], return_index=True)
            pos_in = np.arange(int(bound.sum())) - np.repeat(
                start, np.diff(np.append(start, int(bound.sum())))
            )
            r[o] = pos_in.astype(np.int32)
            rank[bound] = r
            g.create_dataset("Rank_bound", data=rank)
