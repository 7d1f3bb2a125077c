"""A universe handed to the port as its own input types.

Frozen copies (commit d6ae473) of what the port's mock helpers derive,
with the top-level cells per side as a parameter:

- ``snapshot_info``: ``soap_tpu_torch/pipeline/run.py::mock_metadata``
  with ``utils/mock_data.py``'s header values (``snapshot_attrs``,
  ``NAMED_COLUMNS``, ``MOCK_PARAMETER_TEXT``, ``snapshot_header``,
  ``cell_centres``), built as the port's ``SnapshotInfo``;
- ``hbtplus_subs``: ``run.py::mock_catalogue``'s HBTplus ``Subhalos``
  columns as the file stores them (Mpc/h and Msun/h in float32), which
  the port's reader (``io/halo_catalogue.py::hbtplus_catalogue``) turns
  into its ``HaloCatalogue``;
- ``host_fields``: ``pipeline/chunks.py::mock_fields``: each type's
  positions and the datasets the run reads, in snapshot (cell) order,
  with ``StellarAges`` derived by the port's reader function.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from halobench import universe as U

#: named-column labels of the multi-column datasets (SWIFT's
#: SubgridScheme/NamedColumns)
NAMED_COLUMNS = {
    "ElementMassFractions": ["Hydrogen", "Helium", "Carbon", "Nitrogen", "Oxygen", "Neon",
                             "Magnesium", "Silicon", "Iron"],
    "SpeciesFractions": ["elec", "HI", "HII", "H2", "H2p"],
    "ElementMassFractionsDiffuse": ["Hydrogen", "Helium", "Carbon", "Nitrogen", "Oxygen",
                                    "Neon", "Magnesium", "Silicon", "Iron"],
    "DustMassFractions": ["GraphiteLarge", "MgSilicatesLarge", "FeSilicatesLarge",
                          "GraphiteSmall", "MgSilicatesSmall", "FeSilicatesSmall"],
    "Luminosities": ["GAMA_u", "GAMA_g", "GAMA_r", "GAMA_i", "GAMA_z", "GAMA_Y", "GAMA_J",
                     "GAMA_H", "GAMA_K"],
}
#: the run parameters the snapshot records, as stored text
PARAMETER_TEXT = {
    "Gravity:comoving_DM_softening": "0.02",
    "Gravity:max_physical_DM_softening": "0.01",
    "Gravity:comoving_baryon_softening": "0.01",
    "Gravity:max_physical_baryon_softening": "0.005",
    "EAGLEAGN:AGN_delta_T_K": "3.16228e7",
}
MEMBERSHIP_DATASETS = ("GroupNr_bound", "Rank_bound")


def snapshot_attrs(cosmo: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """The snapshot's header groups for a configuration's cosmology."""
    a, h, om, ob = (float(cosmo[k]) for k in ("a", "h", "omega_m", "omega_b"))
    rho_crit0 = 3.0 * (100.0 * h) ** 2 / (8.0 * np.pi * U.G_INTERNAL)
    E2 = om / a**3 + 1.0 - om
    return {
        "Cosmology": {
            "Scale-factor": a, "Redshift": 1.0 / a - 1.0, "h": h,
            "H0 [internal units]": 100.0 * h,
            "H [internal units]": 100.0 * h * np.sqrt(E2),
            "Critical density [internal units]": rho_crit0 * E2,
            "Omega_m": om, "Omega_lambda": 1.0 - om, "Omega_k": 0.0,
            "Omega_b": ob, "Omega_cdm": om - ob, "Omega_r": 0.0,
            "Omega_nu_0": 0.0, "w_0": -1.0, "w_a": 0.0,
        },
        "Units": {
            "Unit length in cgs (U_L)": U.MPC_CM, "Unit mass in cgs (U_M)": U.UNIT_MASS_G,
            "Unit time in cgs (U_t)": U.UNIT_TIME_S, "Unit temperature in cgs (U_T)": 1.0,
            "Unit current in cgs (U_I)": 1.0,
        },
        "PhysicalConstants/CGS": {
            "newton_G": 6.67430e-8, "parsec": 3.08567758149e18, "solar_mass": U.MSUN_G,
        },
        "PhysicalConstants/InternalUnits": {"newton_G": U.G_INTERNAL},
    }


def cell_centres(boxsize: float, n: int) -> np.ndarray:
    size = boxsize / n
    k = np.arange(n**3)
    return np.stack([(k // n**2 + 0.5) * size, ((k // n) % n + 0.5) * size,
                     (k % n + 0.5) * size], 1)


def snapshot_info(config: Mapping, traffic: Mapping):
    """The port's ``SnapshotInfo`` of a cell's snapshot and membership
    file (snapshot and code units coincide), known before the universe
    is drawn (``universe.schema``)."""
    from soap_tpu_torch.core.cosmology import Cosmology
    from soap_tpu_torch.core.units import UnitRegistry
    from soap_tpu_torch.pipeline.run import SnapshotInfo

    attrs = snapshot_attrs(config["cosmology"])
    cosmo = attrs["Cosmology"]
    cosmology = Cosmology.from_attrs(cosmo)
    par = {k: float(v) for k, v in PARAMETER_TEXT.items()}
    a, h = float(cosmo["Scale-factor"]), float(cosmo["h"])
    box = float(traffic["boxsize"])
    layout = U.schema(config, traffic)

    def soft(comoving, physical):
        return min(par.get(comoving, 0.0) * a, par.get(physical, 0.0))

    datasets = {
        pt: {**{k: v for k, v in lay["datasets"].items() if k != "GroupNr_bound"},
             **{m: () for m in MEMBERSHIP_DATASETS}}
        for pt, lay in layout.items()
    }
    used = {name for names in datasets.values() for name in names}
    numpart = np.zeros(7, dtype=np.int64)
    for pt, lay in layout.items():
        numpart[int(pt[-1])] = lay["count"]
    n = int(traffic["cells_per_side"])
    return SnapshotInfo(
        a=a, z=1.0 / a - 1.0, h=h, boxsize=box,
        cosmology_attrs=dict(cosmo), snap_units_cgs=dict(attrs["Units"]),
        constants_cgs=dict(attrs["PhysicalConstants/CGS"]), cosmology=cosmology,
        critical_density=float(cosmo["Critical density [internal units]"]),
        mean_density=cosmology.mean_density_internal(
            attrs["PhysicalConstants/InternalUnits"]["newton_G"]),
        virBN98=cosmology.bn98_virial_multiple(),
        dark_matter_softening=soft("Gravity:comoving_DM_softening",
                                   "Gravity:max_physical_DM_softening"),
        baryon_softening=soft("Gravity:comoving_baryon_softening",
                              "Gravity:max_physical_baryon_softening"),
        nu_softening=0.0,
        AGN_delta_T=par["EAGLEAGN:AGN_delta_T_K"],
        observer_position=np.full(3, 0.5 * box),
        named_columns={k: list(v) for k, v in NAMED_COLUMNS.items() if k in used},
        ptypes=sorted(datasets), datasets=datasets,
        header={
            "BoxSize": np.array([box] * 3),
            "NumFilesPerSnapshot": np.array([1], dtype=np.int32),
            "NumPart_ThisFile": numpart, "NumPart_Total": numpart.copy(),
            "Redshift": np.array([1.0 / a - 1.0]), "RunName": np.bytes_("halobench"),
            "Scale-factor": np.array([a]),
        },
        parameters={k: np.bytes_(v) for k, v in sorted(PARAMETER_TEXT.items())},
        code_units_cgs=dict(attrs["Units"]), nr_cells=n**3,
        dimension=np.full(3, n, dtype=np.int64), cell_size=np.full(3, box / n),
        cell_centres=cell_centres(box, n),
        units=UnitRegistry(attrs["Units"], attrs["Units"], a, h,
                           attrs["PhysicalConstants/CGS"]),
    )


def hbtplus_subs(uni: U.Universe, centres: np.ndarray) -> Dict[str, np.ndarray]:
    """The HBTplus ``Subhalos`` columns of the universe's halos at
    ``centres`` (comoving Mpc), as the file stores them."""
    n = uni.n_halos
    z32 = np.zeros(n, np.int32)
    idx = np.arange(n, dtype=np.int64)
    mass = float(uni.ptypes[U.PTYPE_DM]["Masses"][0])
    return {
        "TrackId": idx, "Nbound": uni.halo_nbound.astype(np.int64),
        "Rank": np.zeros(n, np.int64), "HostHaloId": idx, "Depth": z32,
        "ComovingMostBoundPosition": (centres * uni.h).astype(np.float32),
        "PhysicalAverageVelocity": np.zeros((n, 3), np.float32),
        "REncloseComoving": (uni.halo_renclose * uni.h).astype(np.float32),
        "NestedParentTrackId": np.full(n, -1, np.int64),
        "DescendantTrackId": np.full(n, -1, np.int64),
        "LastMaxMass": (uni.halo_nbound * mass * 1.0e10 * uni.h).astype(np.float32),
        "LastMaxVmaxPhysical": np.full(n, 100.0, np.float32),
        "SnapshotOfBirth": z32, "SnapshotOfLastMaxMass": z32,
        "SnapshotOfLastMaxVmax": z32, "SnapshotOfLastIsolation": z32,
    }


def host_fields(uni: U.Universe, meta, wanted: Mapping[str, Sequence[str]],
                ptypes: Sequence[str]) -> Dict[str, tuple]:
    """{ptype: (positions, {dataset: array})} as the port's reader hands
    them over: ``wanted``'s datasets (``Coordinates`` apart) and the
    derived ``StellarAges``."""
    from soap_tpu_torch.pipeline.chunks import stellar_ages
    from soap_tpu_torch.pipeline.run import age_table

    ages = age_table(meta)
    out = {}
    for pt in ptypes:
        data = uni.ptypes[pt]
        fields = {name: data[name] for name in wanted[pt] if name != "Coordinates"}
        if pt == U.PTYPE_STAR and ages is not None and "BirthScaleFactors" in fields:
            fields["StellarAges"] = stellar_ages(fields["BirthScaleFactors"], ages, meta.a)
        out[pt] = (data["Coordinates"], fields)
    return out
