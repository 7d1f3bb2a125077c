"""A run's host context: snapshot metadata -> ``HaloContext``.

The port's copy of ``soap_tpu/pipeline/run.py::make_context`` (with
``DEFAULT_CONSTANTS``) and of the stellar-age table the JAX run hands
its chunk staging.  ``make_context`` takes any metadata object shaped
like the JAX package's ``SnapshotMetadata`` (duck-typed: the HDF5
reader is not ported); ``mock_metadata`` builds one for a mock universe
from the values its snapshot would record, without writing a file.
A parameter file (``core/params.py::ParameterFile``) sets the
recently-heated and cold dense gas filters and the defined constants;
without one they take their defaults.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from soap_tpu_torch.core.cosmology import Cosmology
from soap_tpu_torch.core.params import ParameterFile
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.utils import mock_data

#: default solar abundance ratios (a parameter file's defined_constants
#: override them)
DEFAULT_CONSTANTS = {
    "O_H_sun": 4.9e-4,
    "Fe_H_sun": 2.82e-5,
    "N_O_sun": 0.138,
    "C_O_sun": 0.549,
    "Mg_H_sun": 3.98e-5,
}

#: Julian seconds per Myr
_MYR_S = 3.15576e13
#: hydrogen mass (g), for the cold dense gas filter's density threshold
_M_H_G = 1.67262192369e-24


@dataclass
class SnapshotInfo:
    """The snapshot metadata ``make_context`` and ``required_datasets``
    read, by the attribute names of the JAX package's
    ``SnapshotMetadata``; every value is in snapshot units."""

    a: float
    z: float
    h: float
    boxsize: float  # comoving
    cosmology_attrs: Dict[str, float]
    snap_units_cgs: Dict[str, float]
    constants_cgs: Dict[str, float]
    cosmology: Cosmology
    critical_density: float  # physical
    mean_density: float  # physical
    virBN98: float
    dark_matter_softening: float  # physical
    baryon_softening: float
    nu_softening: float
    AGN_delta_T: float  # K
    observer_position: np.ndarray  # comoving
    named_columns: Dict[str, list]
    ptypes: list
    datasets: Dict[str, Dict[str, Tuple[int, ...]]]  # ptype -> name -> row shape


#: datasets the membership pass adds to every particle type
MEMBERSHIP_DATASETS = {"GroupNr_bound": (), "Rank_bound": ()}


def mock_metadata(uni: mock_data.MockUniverse) -> SnapshotInfo:
    """The metadata the JAX package reads back from this universe's mock
    snapshot and its membership file, derived as ``SnapshotMetadata``
    derives it (snapshot and code units coincide, so every conversion
    factor is 1)."""
    attrs = mock_data.snapshot_attrs(uni)
    cosmo_attrs = attrs["Cosmology"]
    cosmology = Cosmology.from_attrs(cosmo_attrs)
    par = mock_data.MOCK_PARAMETERS
    a = float(cosmo_attrs["Scale-factor"])

    def soft(comoving, physical):
        return min(par.get(comoving, 0.0) * a, par.get(physical, 0.0))

    dm = {
        "Coordinates": uni.pos, "Velocities": uni.vel, "Masses": uni.mass,
        "ParticleIDs": uni.ids, "FOFGroupIDs": uni.fof_ids,
    }
    datasets = {}
    for ptype, fields in (("PartType1", dm),) + tuple((uni.extra_ptypes or {}).items()):
        datasets[ptype] = {
            name: tuple(np.asarray(arr).shape[1:]) for name, arr in fields.items()
        }
    for names in datasets.values():
        names.update(MEMBERSHIP_DATASETS)
    used = {name for names in datasets.values() for name in names}
    return SnapshotInfo(
        a=a,
        z=1.0 / a - 1.0,
        h=float(cosmo_attrs["h"]),
        boxsize=float(uni.boxsize),
        cosmology_attrs=dict(cosmo_attrs),
        snap_units_cgs=dict(attrs["Units"]),
        constants_cgs=dict(attrs["PhysicalConstants/CGS"]),
        cosmology=cosmology,
        critical_density=float(cosmo_attrs["Critical density [internal units]"]),
        mean_density=cosmology.mean_density_internal(
            attrs["PhysicalConstants/InternalUnits"]["newton_G"]
        ),
        virBN98=cosmology.bn98_virial_multiple(),
        dark_matter_softening=soft(
            "Gravity:comoving_DM_softening", "Gravity:max_physical_DM_softening"
        ),
        baryon_softening=soft(
            "Gravity:comoving_baryon_softening", "Gravity:max_physical_baryon_softening"
        ),
        nu_softening=soft(
            "Gravity:comoving_nu_softening", "Gravity:max_physical_nu_softening"
        ),
        AGN_delta_T=float(par.get("EAGLEAGN:AGN_delta_T_K", 0.0)),
        observer_position=np.full(3, 0.5 * uni.boxsize),
        named_columns={k: list(v) for k, v in mock_data.NAMED_COLUMNS.items() if k in used},
        ptypes=sorted(datasets),
        datasets=datasets,
    )


def make_context(
    meta, ptypes: Sequence[str], dmo: bool, parameter_file: Optional[ParameterFile] = None
) -> HaloContext:
    """HaloContext from snapshot metadata (physical snapshot units), with
    the filters and constants of ``parameter_file`` (defaults without)."""
    # recently-heated AGN gas: a_limit such that the lookback time to it
    # is delta_time_in_Myr (15); the AGN heating temperature sets the
    # [dT 10^delta_logT_min, dT 10^delta_logT_max] window
    agn_a_limit, agn_Tmin, agn_Tmax = 2.0, 0.0, float("inf")
    rh = parameter_file.recently_heated_gas_params() if parameter_file else {}
    H0_internal = float(meta.cosmology_attrs.get("H0 [internal units]", 0.0))
    if H0_internal > 0:
        delta_myr = float(rh.get("delta_time_in_Myr", 15.0))
        delta_internal = delta_myr * _MYR_S / meta.snap_units_cgs["Unit time in cgs (U_t)"]
        age_a, age_h0 = meta.cosmology.age_table()
        ages_internal = age_h0 / H0_internal
        t_now = np.interp(meta.a, age_a, ages_internal)
        agn_a_limit = float(np.interp(t_now - delta_internal, ages_internal, age_a))
        if rh.get("use_AGN_delta_T", True) and meta.AGN_delta_T > 0:
            agn_Tmin = meta.AGN_delta_T * 10.0 ** float(rh.get("delta_logT_min", -1.0))
            agn_Tmax = meta.AGN_delta_T * 10.0 ** float(rh.get("delta_logT_max", 0.3))
    # cold dense gas: float() as YAML 1.1 reads "3.16e4" as a string
    cold = (
        parameter_file.get_parameters().get("calculations", {}).get("cold_dense_gas_filter", {})
        if parameter_file else {}
    )
    constants = {**DEFAULT_CONSTANTS,
                 **(parameter_file.get_defined_constants() if parameter_file else {})}
    ul = meta.snap_units_cgs["Unit length in cgs (U_L)"]
    um = meta.snap_units_cgs["Unit mass in cgs (U_M)"]
    ut = meta.snap_units_cgs["Unit time in cgs (U_t)"]
    G_snap = meta.constants_cgs["newton_G"] * um * ut**2 / ul**3
    soft = []
    for pt in ptypes:
        if pt == "PartType1":
            soft.append(meta.dark_matter_softening)
        elif pt == "PartType6":
            soft.append(meta.nu_softening)
        else:
            soft.append(meta.baryon_softening)
    # mean neutrino background density (physical): Omega_nu_0 rho_crit0 / a^3
    nu_density = 0.0
    omega_nu = float(meta.cosmology_attrs.get("Omega_nu_0", 0.0))
    if omega_nu:
        rho_crit0 = meta.critical_density / float(meta.cosmology.E(np.array(meta.a)) ** 2)
        nu_density = omega_nu * rho_crit0 / meta.a**3
    return HaloContext(
        a=meta.a,
        z=meta.z,
        G=G_snap,
        boxsize=meta.boxsize,
        critical_density=meta.critical_density,
        mean_density=meta.mean_density,
        nu_density=nu_density,
        H=float(meta.cosmology_attrs.get("H [internal units]", 0.0)),
        omega_m=float(meta.cosmology_attrs.get("Omega_m", 0.0)),
        omega_g=float(meta.cosmology_attrs.get("Omega_g", 0.0)),
        agn_a_limit=agn_a_limit,
        agn_Tmin=agn_Tmin,
        agn_Tmax=agn_Tmax,
        observer_position=tuple(float(v) for v in meta.observer_position),
        # n_H > n_min as a physical mass density in snapshot units
        cold_dense_rho_threshold=(
            float(cold.get("minimum_hydrogen_number_density_cm3", 0.1)) * _M_H_G * ul**3 / um
        ),
        cold_dense_Tmax=float(cold.get("maximum_temperature_K", 10.0**4.5)),
        named_columns=tuple(
            (f"{pt}/{ds}", tuple(cols))
            for ds, cols in sorted(meta.named_columns.items())
            for pt in meta.ptypes
            if ds in meta.datasets.get(pt, {})
        ),
        constants=tuple(sorted(constants.items())),
        softening=tuple(soft),
        ptypes=tuple(ptypes),
        capacities=tuple(0 for _ in ptypes),
        dmo=dmo,
    )


def age_table(meta) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The a -> age table in internal time units, as float32 (None
    without H0): what the JAX run hands its chunk staging."""
    H0_internal = float(meta.cosmology_attrs.get("H0 [internal units]", 0.0))
    if H0_internal <= 0:
        return None
    age_a, age_h0 = meta.cosmology.age_table()
    return age_a.astype(np.float32), (age_h0 / H0_internal).astype(np.float32)
