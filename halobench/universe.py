"""A cell's seeded mock universe: NFW halos in a uniform field, with gas,
stars and black holes when the configuration is hydro.

A frozen, vectorised copy of ``soap_tpu_torch/utils/mock_data.py::
build_mock_universe`` (commit d6ae473), with three changes for a benchmark:

- the population follows a published halo mass function: the halos of
  the traffic's box above its least particle count are as many as the
  fit (Tinker et al. 2008 on an Eisenstein & Hu 1998 spectrum, the
  parameters in the traffic file and the configuration's cosmology)
  expects there, their masses are fixed quantiles of it, and the field
  holds the rest of the box's mean matter density;
- the work is the same for every seed: masses are fixed, and
  concentrations and every position come from generators of the
  traffic's own ``layout_seed``, so every seed gathers the same
  candidate rows per halo, plans the same buckets and peaks at the same
  memory; the run's seed draws the velocities and the gas, star and
  black-hole datasets;
- everything is drawn on ``device`` in a few large calls, each dataset
  from a generator of its own (seeded from the run's seed and the
  dataset's name), so drawing one dataset more or less changes no other.

Imports torch and numpy only: the reference builds on these arrays too.
"""

from __future__ import annotations

import json
import math
import zlib
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

# snapshot (= internal) units: Mpc, 1e10 Msun, km/s
MPC_CM = 3.08567758149e24
MSUN_G = 1.98841e33
UNIT_MASS_G = 1.0e10 * MSUN_G
UNIT_TIME_S = MPC_CM / 1.0e5
G_INTERNAL = 6.67430e-8 * UNIT_MASS_G * UNIT_TIME_S**2 / MPC_CM**3

PTYPE_DM, PTYPE_GAS, PTYPE_STAR, PTYPE_BH = "PartType1", "PartType0", "PartType4", "PartType5"


@dataclass
class Universe:
    """Host arrays of one universe, comoving positions in [0, box)."""

    boxsize: float
    a: float
    h: float
    omega_m: float
    omega_b: float
    #: ptype -> dataset -> array (``Coordinates`` f64, ``GroupNr_bound``
    #: the bound halo's index or -1), each type in top-level cell order
    ptypes: Dict[str, Dict[str, np.ndarray]]
    halo_centre: np.ndarray  # (H, 3) f64 comoving, in [0, box)
    halo_renclose: np.ndarray  # (H,) f64 comoving
    halo_nbound: np.ndarray  # (H,) i64

    @property
    def n_halos(self) -> int:
        return len(self.halo_nbound)


def critical_density(h: float, omega_m: float, a: float) -> float:
    """Physical critical density at ``a`` (flat LCDM), internal units."""
    rho_crit0 = 3.0 * (100.0 * h) ** 2 / (8.0 * math.pi * G_INTERNAL)
    return rho_crit0 * (omega_m / a**3 + 1.0 - omega_m)


def mean_matter_density(config: Mapping) -> float:
    """Comoving mean matter density (internal units)."""
    h, om = float(config["cosmology"]["h"]), float(config["cosmology"]["omega_m"])
    return om * 3.0 * (100.0 * h) ** 2 / (8.0 * math.pi * G_INTERNAL)


def mass_function(traffic: Mapping, config: Mapping):
    """(M (1e10 Msun), dn/dlnM (per comoving Mpc^3)) at the traffic's
    ``mass_function``: Tinker et al. (2008, ApJ 688, 709) eq. 3,
    f(sigma) = A ((sigma/b)^-a + 1) exp(-c/sigma^2), on the linear power
    spectrum k^n_s T(k)^2 normalised to sigma_8, with T the no-wiggle
    transfer function of Eisenstein & Hu (1998, ApJ 496, 605) eq. 26-31."""
    key = json.dumps([traffic["mass_function"], config["cosmology"]], sort_keys=True)
    if key not in _MASS_FUNCTIONS:
        _MASS_FUNCTIONS[key] = _mass_function(traffic["mass_function"], config)
    return _MASS_FUNCTIONS[key]


#: mass functions worked out in this process, by their parameters
_MASS_FUNCTIONS: Dict[str, tuple] = {}


def _mass_function(mf: Mapping, config: Mapping):
    cosmo = config["cosmology"]
    h, om, ob = (float(cosmo[k]) for k in ("h", "omega_m", "omega_b"))
    k = np.logspace(-5.0, 3.0, 8000)  # 1/Mpc
    theta = float(mf["T_cmb"]) / 2.7
    wm, wb, fb = om * h * h, ob * h * h, ob / om
    s = 44.5 * math.log(9.83 / wm) / math.sqrt(1.0 + 10.0 * wb**0.75)
    alpha = 1.0 - 0.328 * math.log(431.0 * wm) * fb + 0.38 * math.log(22.3 * wm) * fb**2
    gamma = om * h * (alpha + (1.0 - alpha) / (1.0 + (0.43 * k * s) ** 4))
    q = k / h * theta**2 / gamma
    L0 = np.log(2.0 * math.e + 1.8 * q)
    T = L0 / (L0 + (14.2 + 731.0 / (1.0 + 62.5 * q)) * q * q)
    power = k ** float(mf["n_s"]) * T * T

    def sigma(R):
        x = np.outer(R, k)
        W = 3.0 * (np.sin(x) - x * np.cos(x)) / x**3
        return np.sqrt(np.trapezoid(k * k * power * W * W, k, axis=1) / (2.0 * math.pi**2))

    rho = mean_matter_density(config)
    lnM = np.linspace(math.log(float(mf["lo"])), math.log(float(mf["hi"])), 4000)
    M = np.exp(lnM)
    sig = sigma((3.0 * M / (4.0 * math.pi * rho)) ** (1.0 / 3.0))
    sig *= float(mf["sigma_8"]) / sigma(np.array([8.0 / h]))[0]
    A, a, b, c = (float(mf[x]) for x in ("A", "a", "b", "c"))
    f = A * ((sig / b) ** (-a) + 1.0) * np.exp(-c / sig**2)
    return M, f * rho / M * np.abs(np.gradient(np.log(sig), lnM))


def halo_population(traffic: Mapping, config: Mapping):
    """(M (H,) 1e10 Msun, descending; concentrations (H,); DM particles
    per halo (H,)): the halos of the traffic's box above
    ``min_particles``, as many as the mass function expects there, each
    at a fixed quantile of it; the same for every seed."""
    pm = float(config["particle_mass"])
    M, dn = mass_function(traffic, config)
    keep = M >= int(traffic["min_particles"]) * pm
    lnM, dn = np.log(M[keep]), dn[keep]
    # halos per comoving volume above each mass
    above = np.concatenate([np.cumsum((0.5 * (dn[1:] + dn[:-1]) * np.diff(lnM))[::-1])[::-1],
                            [0.0]])
    n = int(round(above[0] * float(traffic["boxsize"]) ** 3))
    q = (np.arange(n) + 0.5) / n * above[0]
    m = np.exp(np.interp(q, above[::-1], lnM[::-1]))
    conc = np.random.default_rng(0).uniform(4.0, 10.0, n)
    npart = np.maximum(np.rint(m / pm).astype(np.int64), int(traffic["min_particles"]))
    return m, conc, npart


def field_counts(traffic: Mapping, config: Mapping, bound: Mapping[str, np.ndarray]):
    """{ptype: particles outside every halo}: the box's mean matter
    density less what the halos hold, in the configuration's particles;
    in a hydro run the gas takes ``gas_fraction`` of the field's dark
    matter, as it does in a halo."""
    total = int(round(mean_matter_density(config) * float(traffic["boxsize"]) ** 3
                      / float(config["particle_mass"])))
    field = max(total - int(sum(int(c.sum()) for c in bound.values())), 0)
    if not config["hydro"]:
        return {PTYPE_DM: field}
    gas = int(round(field * float(config["gas_fraction"]) / (1.0 + float(config["gas_fraction"]))))
    return {PTYPE_DM: field - gas, PTYPE_GAS: gas}


def halo_layout(traffic: Mapping, n_halos: int) -> np.ndarray:
    """(H, 3) comoving halo centres in [0, box): the traffic's, for every
    seed (``layout_seed``)."""
    rng = np.random.default_rng(int(traffic["layout_seed"]))
    box = float(traffic["boxsize"])
    return rng.uniform(0.0, box, (n_halos, 3))


class _Draws:
    """One generator per named dataset, seeded from the run's seed and
    the name (the seed may exceed 32 bits)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed) % (1 << 63)
        self.device = torch.device(device)

    def gen(self, name: str) -> torch.Generator:
        g = torch.Generator(self.device)
        g.manual_seed((self.seed * 1_000_003 + zlib.crc32(name.encode())) % (1 << 63))
        return g

    def uniform(self, name, shape, lo=0.0, hi=1.0, dtype=torch.float64):
        u = torch.rand(shape, generator=self.gen(name), device=self.device, dtype=dtype)
        return lo + (hi - lo) * u

    def normal(self, name, shape, sigma=1.0, dtype=torch.float64):
        z = torch.randn(shape, generator=self.gen(name), device=self.device, dtype=dtype)
        return z * sigma


def _nfw_radii(u: torch.Tensor, c: torch.Tensor, r200: torch.Tensor) -> torch.Tensor:
    """Inverse of the NFW enclosed-mass profile: mu(x) = u mu(c) on
    [1e-3, c] by bisection (the copied generator interpolates a 2048-point
    table over the same interval), scaled to r200 / c."""

    def mu(x):
        return torch.log1p(x) - x / (1.0 + x)

    target = u * mu(c)
    lo = torch.full_like(c, 1.0e-3)
    hi = c.clone()
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        below = mu(mid) < target
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi) * (r200 / c)


def _directions(d: _Draws, name: str, n: int) -> torch.Tensor:
    v = d.normal(name, (n, 3))
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp(min=1e-300)


def _sphere(g, d, name, centre, c, r200, sigma, halo_of):
    """NFW positions (from ``g``) and Gaussian velocities (from ``d``) of
    one population."""
    n = len(halo_of)
    r = _nfw_radii(g.uniform(f"{name}/u", (n,)), c[halo_of], r200[halo_of])
    pos = centre[halo_of] + r[:, None] * _directions(g, f"{name}/dir", n)
    vel = d.normal(f"{name}/vel", (n, 3)) * sigma[halo_of, None]
    return pos, vel


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0) - counts


def _gas_fields(d: _Draws, n: int, a: float, wanted: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The mock's gas datasets (the copied generator's distributions)."""
    f32 = torch.float32
    out: Dict[str, torch.Tensor] = {}
    g = "PartType0"
    elem = torch.zeros((n, 9), dtype=f32, device=d.device)
    elem[:, 0], elem[:, 1] = 0.74, 0.24
    elem[:, 2:] = d.uniform(f"{g}/elem", (n, 7), 0.0, 0.004).to(f32)
    temp = (10.0 ** d.uniform(f"{g}/T", (n,), 3.0, 8.0)).to(f32)
    dens = (10.0 ** d.uniform(f"{g}/rho", (n,), -2.0, 6.0)).to(f32)
    u = (temp * 1.2e-2).to(f32)
    metal = (0.02 * d.uniform(f"{g}/Z", (n,))).to(f32)
    dust = (0.1 * metal).to(f32)
    sfr = d.uniform(f"{g}/sfr", (n,), 0.01, 5.0).to(f32)
    not_sf = d.uniform(f"{g}/not_sf", (n,)) < 0.7
    sfr = torch.where(not_sf, -d.uniform(f"{g}/sfr_a", (n,), 0.1, 1.0).to(f32), sfr)
    hi_ = d.uniform(f"{g}/HI", (n,), 0.0, 0.8).to(f32)
    h2 = d.uniform(f"{g}/H2", (n,), 0.0, 0.1).to(f32)
    species = torch.zeros((n, 5), dtype=f32, device=d.device)
    species[:, 1], species[:, 3] = hi_, h2
    species[:, 2] = 1.0 - hi_ - 2.0 * h2
    last_agn = d.uniform(f"{g}/agn", (n,), 0.1, 0.5)
    recent = d.uniform(f"{g}/agn_recent", (n,)) < 0.25
    last_agn = torch.where(recent, d.uniform(f"{g}/agn_a", (n,), 0.98 * a, a), last_agn)
    grain = -torch.log(d.uniform(f"{g}/grain", (n, 6)).clamp(min=1e-300))
    grain = grain / grain.sum(1, keepdim=True)
    make = {
        "ElementMassFractions": lambda: elem,
        "SpeciesFractions": lambda: species,
        "Temperatures": lambda: temp,
        "Densities": lambda: dens,
        "InternalEnergies": lambda: u,
        "Pressures": lambda: ((5.0 / 3.0 - 1.0) * dens * u).to(f32),
        "StarFormationRates": lambda: sfr,
        "MetalMassFractions": lambda: metal,
        "TotalDustMassFractions": lambda: dust,
        "ElementMassFractionsDiffuse": lambda: (
            elem * d.uniform(f"{g}/diffuse", (n, 1), 0.6, 0.95).to(f32)).to(f32),
        "DustMassFractions": lambda: (grain.to(f32) * dust[:, None]).to(f32),
        "ComptonYParameters": lambda: (10.0 ** d.uniform(f"{g}/y", (n,), -10.0, -6.0)).to(f32),
        "ElectronNumberDensities": lambda: (
            dens * d.uniform(f"{g}/ne", (n,), 0.5, 1.2) * 4.2e7).to(f32),
        "LastAGNFeedbackScaleFactors": lambda: last_agn.to(f32),
    }
    for xk in ("XrayLuminosities", "XrayPhotonLuminosities", "XrayLuminositiesRestframe",
               "XrayPhotonLuminositiesRestframe"):
        make[xk] = (lambda k: lambda: (10.0 ** d.uniform(f"{g}/{k}", (n, 3), 2.0, 8.0)).to(f32))(xk)
    for name in wanted:
        if name in make:
            out[name] = make[name]()
    return out


def _star_fields(d: _Draws, n: int, a: float, pm: float, wanted) -> Dict[str, torch.Tensor]:
    f32 = torch.float32
    s = "PartType4"

    def elem():
        e = torch.zeros((n, 9), dtype=f32, device=d.device)
        e[:, 0], e[:, 1] = 0.74, 0.24
        e[:, 2:] = d.uniform(f"{s}/elem", (n, 7), 0.0, 0.004).to(f32)
        return e

    make = {
        "ElementMassFractions": elem,
        "InitialMasses": lambda: torch.full((n,), pm * 1.1, dtype=f32, device=d.device),
        "BirthScaleFactors": lambda: d.uniform(f"{s}/birth", (n,), 0.15, a).to(f32),
        "MetalMassFractions": lambda: (0.03 * d.uniform(f"{s}/Z", (n,))).to(f32),
        "Luminosities": lambda: (10.0 ** d.uniform(f"{s}/lum", (n, 9), 6.0, 9.0)).to(f32),
    }
    return {k: make[k]() for k in wanted if k in make}


def _bh_fields(d: _Draws, n: int, a: float, pm: float, wanted) -> Dict[str, torch.Tensor]:
    f32 = torch.float32
    b = "PartType5"
    make = {
        "SubgridMasses": lambda: (pm * 10.0 ** d.uniform(f"{b}/subgrid", (n,), 0.0, 2.0)).to(f32),
        "DynamicalMasses": lambda: torch.full((n,), pm, dtype=f32, device=d.device),
        "AccretionRates": lambda: d.uniform(f"{b}/acc", (n,), 0.0, 0.1).to(f32),
        "LastAGNFeedbackScaleFactors": lambda: d.uniform(f"{b}/agn", (n,), 0.2, a).to(f32),
    }
    return {k: make[k]() for k in wanted if k in make}


#: datasets every particle type carries, by row shape
BASE = {"Coordinates": (3,), "Velocities": (3,), "Masses": (), "ParticleIDs": (),
        "FOFGroupIDs": (), "GroupNr_bound": ()}
#: the further datasets of each hydro type, by row shape
EXTRA = {
    PTYPE_GAS: {
        "ElementMassFractions": (9,), "SpeciesFractions": (5,), "Temperatures": (),
        "Densities": (), "InternalEnergies": (), "Pressures": (), "StarFormationRates": (),
        "MetalMassFractions": (), "TotalDustMassFractions": (),
        "ElementMassFractionsDiffuse": (9,), "DustMassFractions": (6,),
        "ComptonYParameters": (), "ElectronNumberDensities": (),
        "LastAGNFeedbackScaleFactors": (), "XrayLuminosities": (3,),
        "XrayPhotonLuminosities": (3,), "XrayLuminositiesRestframe": (3,),
        "XrayPhotonLuminositiesRestframe": (3,),
    },
    PTYPE_STAR: {"ElementMassFractions": (9,), "InitialMasses": (), "BirthScaleFactors": (),
                 "MetalMassFractions": (), "Luminosities": (9,)},
    PTYPE_BH: {"SubgridMasses": (), "DynamicalMasses": (), "AccretionRates": (),
               "LastAGNFeedbackScaleFactors": ()},
}


def _bound_counts(npart: np.ndarray, config: Mapping) -> Dict[str, np.ndarray]:
    """Bound particles per halo and type (DM from the mass function)."""
    out = {PTYPE_DM: npart}
    if config["hydro"]:
        out[PTYPE_GAS] = np.maximum(np.floor(npart * float(config["gas_fraction"])), 25)
        out[PTYPE_STAR] = np.maximum(np.floor(npart * float(config["star_fraction"])), 12)
        out[PTYPE_BH] = (npart >= 300).astype(np.int64)
    return {pt: c.astype(np.int64) for pt, c in out.items()}


def schema(config: Mapping, traffic: Mapping) -> Dict[str, Dict[str, object]]:
    """{ptype: {"count": particles, "datasets": {name: row shape}}}: what
    the universe's snapshot holds, known before anything is drawn."""
    _, _, npart = halo_population(traffic, config)
    bound = _bound_counts(npart, config)
    field = field_counts(traffic, config, bound)
    out = {}
    for pt, counts in bound.items():
        n = int(counts.sum()) + field.get(pt, 0)
        out[pt] = {"count": n, "datasets": {**BASE, **EXTRA.get(pt, {})}}
    return out


def build_universe(
    config: Mapping,
    traffic: Mapping,
    seed: int,
    device="cpu",
    wanted: Optional[Mapping[str, Iterable[str]]] = None,
) -> Universe:
    """The cell's universe, drawn on ``device`` and handed back as host
    arrays: every position from the traffic's ``layout_seed``, velocities
    and the further datasets from ``seed``.  ``wanted`` names the further
    datasets to draw per type (all of ``EXTRA`` when None); the base ones
    always come."""
    d = _Draws(seed, device)
    g = _Draws(int(traffic["layout_seed"]), device)
    dev = d.device
    cosmo = config["cosmology"]
    a, h, om = float(cosmo["a"]), float(cosmo["h"]), float(cosmo["omega_m"])
    box = float(traffic["boxsize"])
    pm = float(config["particle_mass"])
    hydro = bool(config["hydro"])
    rho_crit = critical_density(h, om, a)

    m200_np, c_np, npart_np = halo_population(traffic, config)
    H = len(m200_np)
    m200 = torch.as_tensor(m200_np, device=dev)
    c = torch.as_tensor(c_np, device=dev)
    npart = torch.as_tensor(npart_np, device=dev)
    r200_phys = (3.0 * m200 / (4.0 * math.pi * 200.0 * rho_crit)) ** (1.0 / 3.0)
    r200 = r200_phys / a
    sigma = torch.sqrt(G_INTERNAL * m200 / (2.0 * r200_phys))
    centre = torch.as_tensor(halo_layout(traffic, H), device=dev)

    # dark matter: each halo's first particle at its centre, then the field
    halo_of = torch.repeat_interleave(torch.arange(H, device=dev), npart)
    pos, vel = _sphere(g, d, "dm", centre, c, r200, sigma, halo_of)
    pos[_offsets(npart)] = centre
    dist = torch.linalg.vector_norm(pos - centre[halo_of], dim=1)
    renclose = torch.zeros(H, dtype=torch.float64, device=dev).scatter_reduce(
        0, halo_of, dist, "amax")
    nbound = npart.clone()
    pops = {PTYPE_DM: dict(pos=pos, vel=vel, halo=halo_of)}
    bound = _bound_counts(npart_np, config)

    if hydro:
        counts = {pt: torch.as_tensor(v, device=dev) for pt, v in bound.items()}
        n_gas, n_star, n_bh = counts[PTYPE_GAS], counts[PTYPE_STAR], counts[PTYPE_BH]
        for pt, counts, cf, rf in ((PTYPE_GAS, n_gas, 0.7, 0.9), (PTYPE_STAR, n_star, 2.0, 0.3)):
            of = torch.repeat_interleave(torch.arange(H, device=dev), counts)
            p, v = _sphere(g, d, pt, centre, c * cf, r200 * rf, sigma, of)
            dist = torch.linalg.vector_norm(p - centre[of], dim=1)
            renclose = renclose.scatter_reduce(0, of, dist, "amax")
            pops[pt] = dict(pos=p, vel=v, halo=of)
        of = torch.repeat_interleave(torch.arange(H, device=dev), n_bh)
        pops[PTYPE_BH] = dict(
            pos=centre[of] + g.normal("bh/pos", (len(of), 3), 0.01),
            vel=d.normal("bh/vel", (len(of), 3)) * sigma[of, None],
            halo=of,
        )
        nbound = npart + n_gas + n_star + n_bh

    # the field: uniform, after each type's halo particles
    for pt, n_field in field_counts(traffic, config, bound).items():
        tag = "field" if pt == PTYPE_DM else f"field/{pt}"
        pop = pops[pt]
        pop["pos"] = torch.cat([pop["pos"], g.uniform(f"{tag}/pos", (n_field, 3), 0.0, box)])
        pop["vel"] = torch.cat([pop["vel"], d.normal(f"{tag}/vel", (n_field, 3), 100.0)])
        pop["halo"] = torch.cat([pop["halo"], torch.full((n_field,), -1, device=dev)])

    cells = int(traffic["cells_per_side"])
    ptypes: Dict[str, Dict[str, np.ndarray]] = {}
    next_id = 1
    for pt in sorted(pops):
        pop = pops[pt]
        n = len(pop["halo"])
        p = torch.remainder(pop["pos"], box)
        # the snapshot's order: stable by top-level cell
        ijk = torch.clamp(torch.floor(p / (box / cells)).long(), 0, cells - 1)
        order = torch.sort((ijk[:, 0] * cells + ijk[:, 1]) * cells + ijk[:, 2], stable=True)[1]
        halo = pop["halo"][order]
        fields = {
            "Coordinates": p[order],
            "Velocities": pop["vel"][order].to(torch.float32),
            "Masses": torch.full((n,), pm, dtype=torch.float32, device=dev),
            "ParticleIDs": torch.arange(next_id, next_id + n, device=dev),
            "FOFGroupIDs": torch.where(halo >= 0, halo + 1, -1),
            "GroupNr_bound": halo,
        }
        next_id += n
        names = list(EXTRA.get(pt, {})) if wanted is None else [
            k for k in wanted.get(pt, ()) if k in EXTRA.get(pt, {})]
        extra = {
            PTYPE_GAS: lambda: _gas_fields(d, n, a, names),
            PTYPE_STAR: lambda: _star_fields(d, n, a, pm, names),
            PTYPE_BH: lambda: _bh_fields(d, n, a, pm, names),
        }.get(pt, dict)()
        fields.update({k: v[order] for k, v in extra.items()})
        ptypes[pt] = {k: v.cpu().numpy() for k, v in fields.items()}
        ptypes[pt]["ParticleIDs"] = ptypes[pt]["ParticleIDs"].astype(np.uint64)
    return Universe(
        boxsize=box, a=a, h=h, omega_m=om, omega_b=float(cosmo["omega_b"]), ptypes=ptypes,
        halo_centre=centre.cpu().numpy(), halo_renclose=renclose.cpu().numpy(),
        halo_nbound=nbound.cpu().numpy().astype(np.int64),
    )


def pass_shift(seed: int, pass_nr: int, cells_per_side: int) -> np.ndarray:
    """The whole top-level cells (3,) by which pass ``pass_nr`` shifts the
    universe: a snapshot is catalogued once, so no pass may find the
    inputs of the one before.  The harness draws them from the traffic's
    ``layout_seed``: the staging grid need not align with the top-level
    cells, so a shift can change a halo's candidate rows."""
    rng = np.random.default_rng([int(seed) % (1 << 63), int(pass_nr) + 1])
    return rng.integers(1, cells_per_side, 3)


def shifted(pos: np.ndarray, shift_cells: np.ndarray, boxsize: float,
            cells_per_side: int) -> np.ndarray:
    """Comoving positions moved by whole top-level cells, periodically."""
    t = torch.from_numpy(pos) + torch.as_tensor(shift_cells * (boxsize / cells_per_side))
    return torch.remainder(t, boxsize).numpy()
