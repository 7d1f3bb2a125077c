"""Seeded in-memory mock universes (NFW halos in a uniform field, with
gas, stars and black holes when ``hydro``).

A numpy-only copy of ``soap_tpu.utils.mock_data``'s universe generator
(``MockUniverse``, ``build_mock_universe``, ``_sample_nfw_radii`` and the
unit constants) and of the metadata its snapshot writer records (the
datasets' units, the named columns, the header values), as plain
values: the port must run where neither JAX nor h5py is installed, so
it cannot import the original, and builds its inputs in memory.  The
file writers stay in the JAX package.  ``tests/test_torch_host_mirror.py``
holds this copy to the original: the same seed gives byte-identical
arrays, and the metadata equals what the written snapshot holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

#: top-level cells per dimension of the mock snapshot's layout
MOCK_CELLS_PER_DIM = 4

# Internal/snapshot unit system: Mpc, 1e10 Msun, km/s (so U_t = Mpc s/km).
MPC_CM = 3.08567758149e24
MSUN_G = 1.98841e33
UNIT_MASS_G = 1.0e10 * MSUN_G
UNIT_TIME_S = MPC_CM / 1.0e5  # Mpc / (km/s)
G_INTERNAL = 6.67430e-8 * UNIT_MASS_G * UNIT_TIME_S**2 / MPC_CM**3  # ~43.0


@dataclass
class MockUniverse:
    """In-memory mock simulation prior to writing files."""

    boxsize: float
    a: float
    h: float
    omega_m: float
    omega_lambda: float
    omega_b: float
    pos: np.ndarray  # comoving Mpc, float64 (dark matter, PartType1)
    vel: np.ndarray  # peculiar km/s
    mass: np.ndarray  # 1e10 Msun
    ids: np.ndarray  # uint64
    # halo catalogue (HBT-style), one entry per subhalo
    halo_pos: np.ndarray  # most-bound particle position
    halo_renclose: np.ndarray  # max radius of bound particles (comoving Mpc)
    halo_nbound: np.ndarray
    halo_rank: np.ndarray  # 0 for centrals
    halo_host: np.ndarray  # HostHaloId (FOF-group style id)
    halo_track: np.ndarray
    halo_depth: np.ndarray
    bound_ids: list  # list of arrays: bound particle IDs, most-bound first
    fof_ids: np.ndarray  # per-particle FOF group id (-1 for field)
    # hydro particle types: ptype -> {dataset name: array}; each carries
    # at least Coordinates/Velocities/Masses/ParticleIDs/FOFGroupIDs
    extra_ptypes: Optional[Dict[str, Dict[str, np.ndarray]]] = None

    @property
    def n_halos(self) -> int:
        return len(self.halo_nbound)


def _sample_nfw_radii(rng, n, c, r200):
    """Inverse-CDF sampling of the NFW enclosed-mass profile."""
    mu = lambda x: np.log(1.0 + x) - x / (1.0 + x)
    grid = np.linspace(1e-3, c, 2048)
    cdf = mu(grid) / mu(c)
    u = rng.uniform(0.0, 1.0, n)
    x = np.interp(u, cdf, grid)
    return x * (r200 / c)


def build_mock_universe(
    n_halos: int = 16,
    n_field: int = 20000,
    boxsize: float = 40.0,
    a: float = 1.0,
    h: float = 0.681,
    omega_m: float = 0.306,
    omega_b: float = 0.0486,
    particle_mass: float = 0.1,  # 1e9 Msun
    seed: int = 42,
    mass_range=(50.0, 2000.0),  # halo masses in 1e10 Msun
    hydro: bool = False,
    gas_fraction: float = 0.15,
    star_fraction: float = 0.06,
    n_satellites: int = 0,
) -> MockUniverse:
    rng = np.random.default_rng(seed)
    omega_lambda = 1.0 - omega_m
    rho_crit0 = 3.0 * (100.0 * h) ** 2 / (8.0 * np.pi * G_INTERNAL)
    # physical critical density at a (flat LCDM)
    E2 = omega_m / a**3 + omega_lambda
    rho_crit = rho_crit0 * E2

    positions = []
    velocities = []
    halo_pos, halo_renclose, halo_nbound = [], [], []
    halo_rank, halo_host, halo_track, halo_depth = [], [], [], []
    bound_counts = []

    # log-uniform halo masses
    logm = rng.uniform(np.log(mass_range[0]), np.log(mass_range[1]), n_halos)
    m200 = np.exp(logm)
    order = np.argsort(-m200)  # biggest first, like a halo finder would rank
    m200 = m200[order]

    # per-halo hydro particles, accumulated per type
    hy = {
        "gas": {"pos": [], "vel": [], "cnt": []},
        "star": {"pos": [], "vel": [], "cnt": []},
        "bh": {"pos": [], "vel": [], "cnt": []},
    }

    def _nfw_sphere(centre, n, c, r200, sigma):
        rr = _sample_nfw_radii(rng, n, c, r200)
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        return centre[None, :] + rr[:, None] * u, rng.normal(0.0, sigma, (n, 3))

    for i in range(n_halos):
        centre = rng.uniform(0.0, boxsize, 3)
        c = rng.uniform(4.0, 10.0)
        # R200c from M200c = 4/3 pi 200 rho_crit R^3 (physical), stored comoving
        r200_phys = (3.0 * m200[i] / (4.0 * np.pi * 200.0 * rho_crit)) ** (1.0 / 3.0)
        r200 = r200_phys / a  # comoving
        npart = max(int(round(m200[i] / particle_mass)), 32)
        sigma = np.sqrt(G_INTERNAL * m200[i] / (2.0 * r200_phys))
        r = _sample_nfw_radii(rng, npart, c, r200)
        # random isotropic directions
        u = rng.normal(size=(npart, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        ppos = centre[None, :] + r[:, None] * u
        # most-bound particle exactly at the centre (r=0), mirroring HBT's
        # centre-of-potential convention
        ppos[0] = centre
        pvel = rng.normal(0.0, sigma, (npart, 3))
        positions.append(np.mod(ppos, boxsize))
        velocities.append(pvel)
        halo_pos.append(centre)
        dr = np.linalg.norm(ppos - centre[None, :], axis=1)
        renclose = dr.max()

        n_gas = n_star = n_bh = 0
        if hydro:
            n_gas = max(int(npart * gas_fraction), 25)
            n_star = max(int(npart * star_fraction), 12)
            n_bh = 1 if npart >= 300 else 0
            gpos, gvel = _nfw_sphere(centre, n_gas, c * 0.7, r200 * 0.9, sigma)
            spos, svel = _nfw_sphere(centre, n_star, c * 2.0, r200 * 0.3, sigma)
            hy["gas"]["pos"].append(np.mod(gpos, boxsize))
            hy["gas"]["vel"].append(gvel)
            hy["star"]["pos"].append(np.mod(spos, boxsize))
            hy["star"]["vel"].append(svel)
            renclose = max(
                renclose,
                np.linalg.norm(gpos - centre[None, :], axis=1).max(),
                np.linalg.norm(spos - centre[None, :], axis=1).max(),
            )
            if n_bh:
                hy["bh"]["pos"].append(
                    np.mod(centre[None, :] + rng.normal(0, 0.01, (1, 3)), boxsize)
                )
                hy["bh"]["vel"].append(rng.normal(0.0, sigma, (1, 3)))
        hy["gas"]["cnt"].append(n_gas)
        hy["star"]["cnt"].append(n_star)
        hy["bh"]["cnt"].append(n_bh)

        halo_renclose.append(renclose)
        halo_nbound.append(npart + n_gas + n_star + n_bh)
        halo_rank.append(0)
        halo_host.append(i)
        halo_track.append(i)
        halo_depth.append(0)
        bound_counts.append(npart)

    # satellite subhalos orbiting halo 0 (the most massive): inside its
    # R200, sharing its FOF group, HBT Rank >= 1 (the reference's
    # Mfrac_satellites counts exactly these, ``SO_properties.py:459-466``)
    halo_fofgrp = [i + 1 for i in range(n_halos)]
    host_centre = np.array(halo_pos[0])
    host_r200 = (
        3.0 * m200[0] / (4.0 * np.pi * 200.0 * rho_crit)
    ) ** (1.0 / 3.0) / a
    for s in range(n_satellites):
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        centre = host_centre + (0.25 + 0.2 * s / max(n_satellites, 1)) * (
            host_r200 * u
        )
        m_sat = mass_range[0]
        npart = max(int(round(m_sat / particle_mass)), 32)
        c = rng.uniform(6.0, 10.0)
        r_sat = (
            3.0 * m_sat / (4.0 * np.pi * 200.0 * rho_crit)
        ) ** (1.0 / 3.0) / a
        sigma = np.sqrt(G_INTERNAL * m_sat / (2.0 * r_sat * a))
        rr = _sample_nfw_radii(rng, npart, c, r_sat)
        uu = rng.normal(size=(npart, 3))
        uu /= np.linalg.norm(uu, axis=1, keepdims=True)
        ppos = centre[None, :] + rr[:, None] * uu
        ppos[0] = centre
        positions.append(np.mod(ppos, boxsize))
        velocities.append(rng.normal(0.0, sigma, (npart, 3)))
        halo_pos.append(centre % boxsize)
        halo_renclose.append(
            np.linalg.norm(ppos - centre[None, :], axis=1).max()
        )
        halo_nbound.append(npart)
        halo_rank.append(1 + s)
        halo_host.append(0)
        halo_track.append(n_halos + s)
        halo_depth.append(1)
        bound_counts.append(npart)
        halo_fofgrp.append(halo_fofgrp[0])
        for kind in ("gas", "star", "bh"):
            hy[kind]["cnt"].append(0)

    field = rng.uniform(0.0, boxsize, (n_field, 3))
    field_vel = rng.normal(0.0, 100.0, (n_field, 3))
    positions.append(field)
    velocities.append(field_vel)

    pos = np.concatenate(positions)
    vel = np.concatenate(velocities)
    n_tot = len(pos)
    mass = np.full(n_tot, particle_mass)
    ids = np.arange(1, n_tot + 1, dtype=np.uint64)
    rng.shuffle(ids)  # IDs are not position-ordered in real snapshots

    # hydro particle arrays + their IDs (allocated after the DM ID block)
    extra_ptypes = None
    hydro_ids = {}
    if hydro:
        next_id = n_tot + 1
        extra_ptypes = {}
        for kind, ptype in (("gas", "PartType0"), ("star", "PartType4"), ("bh", "PartType5")):
            if not hy[kind]["pos"]:
                continue
            p = np.concatenate(hy[kind]["pos"])
            v = np.concatenate(hy[kind]["vel"])
            n = len(p)
            pids = np.arange(next_id, next_id + n, dtype=np.uint64)
            next_id += n
            hydro_ids[kind] = pids
            fields = {
                "Coordinates": p,
                "Velocities": v.astype(np.float32),
                "Masses": np.full(n, particle_mass, np.float32),
                "ParticleIDs": pids,
            }
            if kind in ("gas", "star"):
                # 9-element mass fractions: H-dominated with small metals
                elem = np.zeros((n, 9), np.float32)
                elem[:, 0] = 0.74  # Hydrogen
                elem[:, 1] = 0.24  # Helium
                elem[:, 2:] = rng.uniform(0.0, 0.004, (n, 7))
                fields["ElementMassFractions"] = elem
            if kind == "gas":
                # species fractions relative to hydrogen: HI / HII / H2
                sp = np.zeros((n, 5), np.float32)
                sp[:, 1] = rng.uniform(0.0, 0.8, n)  # HI
                sp[:, 3] = rng.uniform(0.0, 0.1, n)  # H2
                sp[:, 2] = 1.0 - sp[:, 1] - 2.0 * sp[:, 3]  # HII
                fields["SpeciesFractions"] = sp
                fields["Temperatures"] = 10.0 ** rng.uniform(3.0, 8.0, n).astype(
                    np.float32
                )
                # comoving mass density in internal units (1e10 Msun/Mpc^3)
                fields["Densities"] = 10.0 ** rng.uniform(-2.0, 6.0, n).astype(
                    np.float32
                )
                # specific internal energy u ~ (km/s)^2, correlated with T
                fields["InternalEnergies"] = (
                    fields["Temperatures"] * 1.2e-2
                ).astype(np.float32)
                fields["Pressures"] = (
                    (5.0 / 3.0 - 1.0)
                    * fields["Densities"]
                    * fields["InternalEnergies"]
                ).astype(np.float32)
                sfr = rng.uniform(0.01, 5.0, n).astype(np.float32)
                # ~70% of gas is not star-forming: SWIFT stores the last
                # star-formation scale factor as a NEGATIVE value there
                not_sf = rng.uniform(size=n) < 0.7
                sfr[not_sf] = -rng.uniform(0.1, 1.0, not_sf.sum())
                fields["StarFormationRates"] = sfr
                fields["MetalMassFractions"] = (
                    0.02 * rng.uniform(0.0, 1.0, n)
                ).astype(np.float32)
                fields["TotalDustMassFractions"] = (
                    0.1 * fields["MetalMassFractions"]
                ).astype(np.float32)
                # COLIBRE-style dust-excluded element fractions + grain
                # species columns (exercise the chemistry/dust tail)
                fields["ElementMassFractionsDiffuse"] = (
                    fields["ElementMassFractions"]
                    * rng.uniform(0.6, 0.95, (n, 1)).astype(np.float32)
                ).astype(np.float32)
                grain = rng.dirichlet(np.ones(6), n).astype(np.float32)
                fields["DustMassFractions"] = (
                    grain * fields["TotalDustMassFractions"][:, None]
                ).astype(np.float32)
                fields["ComptonYParameters"] = 10.0 ** rng.uniform(
                    -10.0, -6.0, n
                ).astype(np.float32)
                # electron number density ~ rho/m_H scale in snapshot units
                fields["ElectronNumberDensities"] = (
                    fields["Densities"] * rng.uniform(0.5, 1.2, n) * 4.2e7
                ).astype(np.float32)
                # ~25% of gas was recently AGN-heated (scale factors near
                # a); the rest long ago — exercises the no_agn exclusions
                last_agn = rng.uniform(0.1, 0.5, n)
                recent = rng.uniform(size=n) < 0.25
                last_agn[recent] = rng.uniform(0.98 * a, a, recent.sum())
                fields["LastAGNFeedbackScaleFactors"] = last_agn.astype(
                    np.float32
                )
                for xk in (
                    "XrayLuminosities",
                    "XrayPhotonLuminosities",
                    "XrayLuminositiesRestframe",
                    "XrayPhotonLuminositiesRestframe",
                ):
                    fields[xk] = 10.0 ** rng.uniform(
                        2.0, 8.0, (n, 3)
                    ).astype(np.float32)
            if kind == "star":
                fields["InitialMasses"] = np.full(
                    n, particle_mass * 1.1, np.float32
                )
                fields["BirthScaleFactors"] = rng.uniform(0.15, a, n).astype(
                    np.float32
                )
                fields["MetalMassFractions"] = (
                    0.03 * rng.uniform(0.0, 1.0, n)
                ).astype(np.float32)
                fields["Luminosities"] = 10.0 ** rng.uniform(
                    6.0, 9.0, (n, 9)
                ).astype(np.float32)
            if kind == "bh":
                fields["SubgridMasses"] = (
                    particle_mass * 10.0 ** rng.uniform(0.0, 2.0, n)
                ).astype(np.float32)
                fields["DynamicalMasses"] = np.full(n, particle_mass, np.float32)
                fields["AccretionRates"] = rng.uniform(0.0, 0.1, n).astype(
                    np.float32
                )
                fields["LastAGNFeedbackScaleFactors"] = rng.uniform(
                    0.2, a, n
                ).astype(np.float32)
            extra_ptypes[ptype] = fields

    # bound particle lists: IDs of each halo's particles, most-bound first;
    # hydro members are appended after the halo's DM block
    bound_ids = []
    fof = np.full(n_tot, -1, dtype=np.int64)
    start = 0
    offsets = {k: 0 for k in hy}
    for i, cnt in enumerate(bound_counts):
        members = [ids[start : start + cnt].copy()]
        # FOF ids are 1-based; satellites share their host's group
        fof[start : start + cnt] = halo_fofgrp[i]
        start += cnt
        if hydro:
            for kind in ("gas", "star", "bh"):
                n_k = hy[kind]["cnt"][i]
                if n_k and kind in hydro_ids:
                    o = offsets[kind]
                    members.append(hydro_ids[kind][o : o + n_k])
                    offsets[kind] = o + n_k
        bound_ids.append(np.concatenate(members))
    if hydro:
        # per-particle FOF ids for hydro members
        for kind, ptype in (("gas", "PartType0"), ("star", "PartType4"), ("bh", "PartType5")):
            if ptype not in (extra_ptypes or {}):
                continue
            n = len(extra_ptypes[ptype]["Coordinates"])
            f = np.full(n, -1, dtype=np.int64)
            o = 0
            for i in range(len(bound_counts)):
                n_k = hy[kind]["cnt"][i]
                f[o : o + n_k] = halo_fofgrp[i]
                o += n_k
            extra_ptypes[ptype]["FOFGroupIDs"] = f

    return MockUniverse(
        boxsize=boxsize,
        a=a,
        h=h,
        omega_m=omega_m,
        omega_lambda=omega_lambda,
        omega_b=omega_b,
        pos=pos,
        vel=vel,
        mass=mass,
        ids=ids,
        halo_pos=np.array(halo_pos),
        halo_renclose=np.array(halo_renclose),
        halo_nbound=np.array(halo_nbound, dtype=np.int64),
        halo_rank=np.array(halo_rank, dtype=np.int32),
        halo_host=np.array(halo_host, dtype=np.int64),
        halo_track=np.array(halo_track, dtype=np.int64),
        halo_depth=np.array(halo_depth, dtype=np.int32),
        bound_ids=bound_ids,
        fof_ids=fof,
        extra_ptypes=extra_ptypes,
    )


# ---- the mock snapshot's metadata, as values (the JAX package's writer
# stores them in the HDF5 file; the port builds its inputs from them) ----

#: dataset name -> unit exponents (length, mass, time, temperature,
#: current), a-scale exponent and "stored physical" flag of the mock's
#: particle datasets; every conversion factor to snapshot units is 1
_FIELD_UNITS = {
    "Coordinates": dict(l=1.0, a_exp=1.0),
    "Velocities": dict(l=1.0, t=-1.0),
    "Masses": dict(m=1.0),
    "InitialMasses": dict(m=1.0),
    "SubgridMasses": dict(m=1.0),
    "DynamicalMasses": dict(m=1.0),
    "ParticleIDs": dict(),
    "FOFGroupIDs": dict(),
    "Temperatures": dict(temp=1.0, physical=True),
    "StarFormationRates": dict(m=1.0, t=-1.0, physical=True),
    "AccretionRates": dict(m=1.0, t=-1.0, physical=True),
    "MetalMassFractions": dict(),
    "TotalDustMassFractions": dict(),
    "BirthScaleFactors": dict(),
    "Luminosities": dict(),
    "LastAGNFeedbackScaleFactors": dict(),
    "ElementMassFractions": dict(),
    "SpeciesFractions": dict(),
    "ElementMassFractionsDiffuse": dict(),
    "DustMassFractions": dict(),
    "Densities": dict(m=1.0, l=-3.0, a_exp=-3.0),
    "InternalEnergies": dict(l=2.0, t=-2.0, physical=True),
    "Pressures": dict(m=1.0, l=-1.0, t=-2.0, physical=True),
}

#: named-column labels of the mock's multi-column datasets (SWIFT's
#: SubgridScheme/NamedColumns)
NAMED_COLUMNS = {
    "ElementMassFractions": [
        "Hydrogen", "Helium", "Carbon", "Nitrogen", "Oxygen",
        "Neon", "Magnesium", "Silicon", "Iron",
    ],
    "SpeciesFractions": ["elec", "HI", "HII", "H2", "H2p"],
    "ElementMassFractionsDiffuse": [
        "Hydrogen", "Helium", "Carbon", "Nitrogen", "Oxygen",
        "Neon", "Magnesium", "Silicon", "Iron",
    ],
    "DustMassFractions": [
        "GraphiteLarge", "MgSilicatesLarge", "FeSilicatesLarge",
        "GraphiteSmall", "MgSilicatesSmall", "FeSilicatesSmall",
    ],
    "Luminosities": [
        "GAMA_u", "GAMA_g", "GAMA_r", "GAMA_i", "GAMA_z",
        "GAMA_Y", "GAMA_J", "GAMA_H", "GAMA_K",
    ],
}

#: the run parameters the mock snapshot records, as the text it stores:
#: softenings (Mpc) and the AGN heating temperature (K) behind the
#: recently-heated gas filter
MOCK_PARAMETER_TEXT = {
    "Gravity:comoving_DM_softening": "0.02",
    "Gravity:max_physical_DM_softening": "0.01",
    "Gravity:comoving_baryon_softening": "0.01",
    "Gravity:max_physical_baryon_softening": "0.005",
    "EAGLEAGN:AGN_delta_T_K": "3.16228e7",
}
#: the same as numbers
MOCK_PARAMETERS = {k: float(v) for k, v in MOCK_PARAMETER_TEXT.items()}


def snapshot_attrs(uni: MockUniverse) -> Dict[str, Dict[str, float]]:
    """The header groups of the universe's mock snapshot, as plain values:
    ``Cosmology``, ``Units`` (snapshot and code units are the same),
    ``PhysicalConstants/CGS`` and ``PhysicalConstants/InternalUnits``."""
    rho_crit0 = 3.0 * (100.0 * uni.h) ** 2 / (8.0 * np.pi * G_INTERNAL)
    E2 = uni.omega_m / uni.a**3 + uni.omega_lambda
    return {
        "Cosmology": {
            "Scale-factor": uni.a,
            "Redshift": 1.0 / uni.a - 1.0,
            "h": uni.h,
            "H0 [internal units]": 100.0 * uni.h,
            "H [internal units]": 100.0 * uni.h * np.sqrt(E2),
            "Critical density [internal units]": rho_crit0 * E2,
            "Omega_m": uni.omega_m,
            "Omega_lambda": uni.omega_lambda,
            "Omega_k": 0.0,
            "Omega_b": uni.omega_b,
            "Omega_cdm": uni.omega_m - uni.omega_b,
            "Omega_r": 0.0,
            "Omega_nu_0": 0.0,
            "w_0": -1.0,
            "w_a": 0.0,
        },
        "Units": {
            "Unit length in cgs (U_L)": MPC_CM,
            "Unit mass in cgs (U_M)": UNIT_MASS_G,
            "Unit time in cgs (U_t)": UNIT_TIME_S,
            "Unit temperature in cgs (U_T)": 1.0,
            "Unit current in cgs (U_I)": 1.0,
        },
        "PhysicalConstants/CGS": {
            "newton_G": 6.67430e-8,
            "parsec": 3.08567758149e18,
            "solar_mass": MSUN_G,
        },
        "PhysicalConstants/InternalUnits": {"newton_G": G_INTERNAL},
    }


def snapshot_header(uni: MockUniverse) -> Dict[str, object]:
    """The mock snapshot's ``Header`` attributes as h5py reads them back
    (by name, values as stored)."""
    numpart = np.zeros(7, dtype=np.int64)
    numpart[1] = len(uni.pos)
    for ptype, fields in (uni.extra_ptypes or {}).items():
        numpart[int(ptype[-1])] = len(fields["Coordinates"])
    return {
        "BoxSize": np.array([uni.boxsize] * 3),
        "NumFilesPerSnapshot": np.array([1], dtype=np.int32),
        "NumPart_ThisFile": numpart,
        "NumPart_Total": numpart.copy(),
        "Redshift": np.array([1.0 / uni.a - 1.0]),
        "RunName": np.bytes_("soap_tpu_mock"),
        "Scale-factor": np.array([uni.a]),
    }


def cell_centres(boxsize: float, cells_per_dim: int) -> np.ndarray:
    """(cells_per_dim**3, 3) centres of the snapshot's top-level cells,
    row-major."""
    cell_size = boxsize / cells_per_dim
    centres = np.zeros((cells_per_dim**3, 3))
    k = np.arange(cells_per_dim**3)
    centres[:, 0] = (k // (cells_per_dim**2) + 0.5) * cell_size
    centres[:, 1] = ((k // cells_per_dim) % cells_per_dim + 0.5) * cell_size
    centres[:, 2] = (k % cells_per_dim + 0.5) * cell_size
    return centres
