"""The plain reference: each sampled halo's properties worked out again
from the cell's inputs, and the comparison that decides ``correct``.

Imports torch and numpy only, and nothing of the port: it reads the
universe the benchmark drew (``universe.py``), the HBTplus columns it
handed over, each pass's shift, and SOAP's parameter values frozen in the
configuration file (``reference`` section).  The port's catalogue is read
only to be judged.

Definitions (SOAP's, as ``SWIFTSIM/SOAP`` states them):

- bound subhalo: the particles whose ``GroupNr_bound`` is the halo;
  counts, masses, centre of mass and its velocity, the half-mass radius
  (``property_calculation/half_mass_radius.py``: the first particle at
  which the cumulative mass reaches half, interpolated from the previous
  one), the iterative inertia tensor (``inertia_tensors.py``: a sphere of
  ten half-mass radii, reshaped to the eigenvalue axis ratios at fixed
  volume until q changes by less than 1e-4, at most 20 iterations, 20
  particles at least), the gas and stellar sums;
- spherical overdensity: every particle, sorted by radius, the mass at
  its radius, leading r = 0 rows skipped (at least one); the first
  crossing of the mean density below the threshold, solved inside its
  interval with the mass linear in r (``SO_properties.py``);
- apertures: bound (exclusive) or all (inclusive) particles with
  r < the aperture radius;
- the catalogue: halos sorted by top-level cell, then catalogue index;
  properties of a category zeroed for halos under its particle limit.

A port's answer is judged by what it says.  Where an answer rests on a
radius test, the reference counts what lies inside ``band`` (relative)
either side of the radius, so a particle that rounding puts on either
side is no fault; an SO radius must solve the reference's own profile
and have no earlier crossing.  The control (``answers`` with
``precision="bfloat16"``) is the same arithmetic on inputs rounded to
bfloat16 and sums in float32, with its outputs rounded to bfloat16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping

import numpy as np
import torch

from halobench import universe as U

FOUR_PI_3 = 4.0 * math.pi / 3.0
COUNT_NAMES = {
    U.PTYPE_DM: "NumberOfDarkMatterParticles", U.PTYPE_GAS: "NumberOfGasParticles",
    U.PTYPE_STAR: "NumberOfStarParticles", U.PTYPE_BH: "NumberOfBlackHoleParticles",
}
MASS_NAMES = {U.PTYPE_DM: "DarkMatterMass", U.PTYPE_GAS: "GasMass", U.PTYPE_STAR: "StellarMass"}
#: the hydro sums of the bound subhalo: name -> (type, weight field, per mass)
HYDRO_SUMS = {
    "StarFormationRate": (U.PTYPE_GAS, "sfr", False),
    "GasTemperature": (U.PTYPE_GAS, "temp", True),
    "GasMassFractionInMetals": (U.PTYPE_GAS, "zgas", True),
    "StellarMassFractionInMetals": (U.PTYPE_STAR, "zstar", True),
    "StellarInitialMass": (U.PTYPE_STAR, "minit", False),
}
#: the per-particle fields those sums read: name -> (type, dataset)
HYDRO_FIELDS = {
    "sfr": (U.PTYPE_GAS, "StarFormationRates"), "temp": (U.PTYPE_GAS, "Temperatures"),
    "zgas": (U.PTYPE_GAS, "MetalMassFractions"), "zstar": (U.PTYPE_STAR, "MetalMassFractions"),
    "minit": (U.PTYPE_STAR, "InitialMasses"),
}


def threshold_density(so: Mapping, cosmo: Mapping) -> float:
    """An SO's physical threshold density (internal units)."""
    a, h, om = float(cosmo["a"]), float(cosmo["h"]), float(cosmo["omega_m"])
    rho_crit = U.critical_density(h, om, a)
    if so["type"] == "crit":
        return float(so["value"]) * rho_crit
    if so["type"] == "mean":
        rho_crit0 = 3.0 * (100.0 * h) ** 2 / (8.0 * math.pi * U.G_INTERNAL)
        return float(so["value"]) * om * rho_crit0 / a**3
    raise ValueError(f"SO type {so['type']!r}")


def catalogue_centres(subs: Mapping[str, np.ndarray], h: float) -> np.ndarray:
    """Comoving Mpc centres from HBTplus's stored Mpc/h columns."""
    return subs["ComovingMostBoundPosition"].astype(np.float64) * (1.0 / h)


def sort_order(centres: np.ndarray, boxsize: float, cells_per_side: int) -> np.ndarray:
    """Catalogue rows in the spatial order: top-level cell, then index."""
    size = boxsize / cells_per_side
    ijk = np.clip(np.floor(np.mod(centres, boxsize) / size).astype(np.int64), 0,
                  cells_per_side - 1)
    cell = (ijk[:, 0] * cells_per_side + ijk[:, 1]) * cells_per_side + ijk[:, 2]
    return np.lexsort((np.arange(len(centres)), cell))


# ---------------------------------------------------------------- particles


class PassParticles:
    """Every particle of one pass on ``device``: shifted comoving
    positions, masses, velocities, type, bound halo and the hydro fields
    the reference sums (0 where a type has none)."""

    def __init__(self, uni: U.Universe, device, hydro: bool):
        self.box = uni.boxsize
        self.a = uni.a
        dev = torch.device(device)
        pts = sorted(uni.ptypes)
        cat = lambda f: torch.cat([torch.as_tensor(f(pt, uni.ptypes[pt])) for pt in pts])
        self.base = cat(lambda pt, d: d["Coordinates"]).to(dev)
        self.mass = cat(lambda pt, d: d["Masses"].astype(np.float64)).to(dev)
        self.vel = cat(lambda pt, d: d["Velocities"].astype(np.float64)).to(dev)
        self.ptype = cat(lambda pt, d: np.full(len(d["Masses"]), int(pt[-1]), np.int8)).to(dev)
        self.group = cat(lambda pt, d: d["GroupNr_bound"].astype(np.int64)).to(dev)
        self.fields = {}
        if hydro:
            for name, (fpt, ds) in HYDRO_FIELDS.items():
                self.fields[name] = cat(lambda pt, d: (
                    d[ds].astype(np.float64) if pt == fpt else np.zeros(len(d["Masses"])))).to(dev)
        order = torch.sort(self.group, stable=True)[1]
        self._bound_order = order
        g = self.group[order]
        H = int(uni.n_halos)
        self._bound_start = torch.searchsorted(g, torch.arange(H, device=dev))
        self._bound_end = torch.searchsorted(g, torch.arange(H, device=dev), right=True)
        self.pos = self.base

    def shift(self, shift_cells: np.ndarray, cells_per_side: int) -> None:
        """Positions of a pass: the universe moved by whole cells."""
        s = torch.as_tensor(shift_cells * (self.box / cells_per_side), dtype=torch.float64,
                            device=self.base.device)
        self.pos = torch.remainder(self.base + s, self.box)

    def bound(self, halo: int) -> torch.Tensor:
        lo, hi = int(self._bound_start[halo]), int(self._bound_end[halo])
        return self._bound_order[lo:hi]

    def near(self, centres: torch.Tensor, radii: torch.Tensor, block: int = 8) -> List[torch.Tensor]:
        """Indices of the particles within ``radii`` (comoving) of each
        centre, periodically, a block of halos at a time."""
        out = []
        pos32 = self.pos.to(torch.float32)
        for b0 in range(0, len(centres), block):
            c = centres[b0:b0 + block].to(torch.float32)
            d2 = torch.zeros((len(c), len(pos32)), dtype=torch.float32, device=pos32.device)
            for k in range(3):
                d = pos32[None, :, k] - c[:, None, k]
                d -= self.box * torch.round(d / self.box)
                d2 += d * d
            lim = (radii[b0:b0 + block].to(torch.float32) * 1.01) ** 2
            for i in range(len(c)):
                out.append(torch.nonzero(d2[i] < lim[i])[:, 0])
        return out


@dataclass
class HaloData:
    """One halo's candidate particles in float64 on the host: positions
    relative to the centre (physical), radii, masses, velocities, types,
    the bound flag, the hydro fields; and the centre (comoving)."""

    centre: np.ndarray
    rel: np.ndarray
    r: np.ndarray
    m: np.ndarray
    v: np.ndarray
    t: np.ndarray
    bound: np.ndarray
    fields: Dict[str, np.ndarray]


def halo_data(parts: PassParticles, halo: int, centre: np.ndarray, idx: torch.Tensor) -> HaloData:
    idx = torch.unique(torch.cat([idx, parts.bound(halo)]))
    c = torch.as_tensor(centre, dtype=torch.float64, device=idx.device)
    d = parts.pos[idx] - c
    d -= parts.box * torch.round(d / parts.box)
    rel = (d * parts.a).cpu().numpy()
    return HaloData(
        centre=np.asarray(centre, np.float64), rel=rel, r=np.sqrt((rel * rel).sum(1)),
        m=parts.mass[idx].cpu().numpy(), v=parts.vel[idx].cpu().numpy(),
        t=parts.ptype[idx].cpu().numpy(), bound=(parts.group[idx] == halo).cpu().numpy(),
        fields={k: f[idx].cpu().numpy() for k, f in parts.fields.items()},
    )


# ---------------------------------------------------------------- answers


def _rounder(precision: str):
    """(input rounding, accumulation dtype, output rounding)."""
    if precision == "float64":
        ident = lambda x: np.asarray(x, np.float64)
        return ident, np.float64, ident
    if precision == "bfloat16":
        def bf16(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(torch.bfloat16).double().numpy()
        return bf16, np.float32, bf16
    raise ValueError(f"precision {precision!r}")


def half_mass_radius(r: np.ndarray, m: np.ndarray, acc=np.float64) -> float:
    """SOAP's half-mass radius of particles at radii ``r`` with masses ``m``."""
    if len(r) == 0:
        return 0.0
    o = np.argsort(r, kind="stable")
    r, cum = r[o], np.cumsum(m[o], dtype=acc)
    target = 0.5 * cum[-1]
    if target <= 0:
        return 0.0
    i = int(np.argmax(cum >= target))
    prev_r, prev_w = (r[i - 1], cum[i - 1]) if i > 0 else (0.0, 0.0)
    if cum[i] == prev_w:
        return float(0.5 * (prev_r + r[i]))
    return float(prev_r + (target - prev_w) / (cum[i] - prev_w) * (r[i] - prev_r))


def inertia_tensor(m, x, R, acc=np.float64, max_iterations=20, tol=1.0e-4, min_particles=20):
    """SOAP's iterative (unreduced) inertia tensor, (xx, yy, zz, xy, xz, yz)."""
    if len(m) < min_particles:
        return np.zeros(6)
    x = np.asarray(x, acc)
    m = np.asarray(m, acc)
    val, vec = np.ones(3), np.eye(3)
    q, tensor = 1000.0, None
    for i in range(max_iterations):
        old_q = q
        q = math.sqrt(val[1] / val[2])
        s = math.sqrt(val[0] / val[2])
        p = math.sqrt(val[0] / val[1])
        if abs((old_q - q) / q) < tol:
            break
        axis = R * np.array([np.cbrt(s * p), np.cbrt(q / p), 1.0 / np.cbrt(q * s)])
        inside = np.sqrt((((x @ vec) / axis) ** 2).sum(1)) <= 1.0
        if i == 0 and inside.sum() < min_particles:
            return np.zeros(6)
        w = m[inside] / m[inside].sum()
        xi = x[inside]
        tensor = (w[:, None, None] * xi[:, :, None] * xi[:, None, :]).sum(0)
        val, vec = np.linalg.eigh(tensor.astype(np.float64))
        val = np.abs(val)
        if q == 0.0:
            break
    if tensor is None:
        return np.zeros(6)
    t = tensor
    return np.array([t[0, 0], t[1, 1], t[2, 2], t[0, 1], t[0, 2], t[1, 2]], np.float64)


def so_solve(r: np.ndarray, m: np.ndarray, rho: float, acc=np.float64):
    """(radius, mass) of the SO at physical density ``rho`` from unsorted
    radii and masses; (0, 0) when no crossing lies in the data."""
    o = np.argsort(r, kind="stable")
    r, cum = r[o], np.cumsum(m[o], dtype=acc)
    K = len(r)
    pos = np.nonzero(r > 0)[0]
    nskip = max(int(pos[0]) if len(pos) else K, 1)
    if nskip >= K:
        return 0.0, 0.0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        dens = cum / (FOUR_PI_3 * r**3)
    above = dens > rho
    if not above[nskip]:
        rb, mb = r[nskip], cum[nskip]
        R = math.sqrt(0.75 * mb / (math.pi * rb * rho))
        return R, mb * R / rb
    i = np.arange(nskip + 1, K)
    cross = i[(above[i] != above[i - 1]) & (r[i] != r[i - 1])]
    if not len(cross):
        return 0.0, 0.0
    i = int(cross[0])
    r1, r2, M1, M2 = float(r[i - 1]), float(r[i]), float(cum[i - 1]), float(cum[i])
    slope = (M2 - M1) / (r2 - r1)
    lo, hi = r1, r2
    f = lambda x: FOUR_PI_3 * rho * x**3 - (M1 + slope * (x - r1))
    f_lo = f(lo)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if (f(mid) > 0) == (f_lo > 0):
            lo = mid
        else:
            hi = mid
    R = 0.5 * (lo + hi)
    return R, FOUR_PI_3 * rho * R**3


def answer_paths(ref: Mapping) -> List[str]:
    """The catalogue datasets ``answers`` gives, in its order."""
    types = ref["particle_types"]

    def region(group):
        out = []
        for pt in types:
            out.append(f"{group}/{COUNT_NAMES[pt]}")
            if pt in MASS_NAMES:
                out.append(f"{group}/{MASS_NAMES[pt]}")
        return out

    paths = region("BoundSubhalo") + [
        f"BoundSubhalo/{k}" for k in ("TotalMass", "CentreOfMass", "CentreOfMassVelocity",
                                      "HalfMassRadiusTotal")]
    paths += [f"BoundSubhalo/{s['key']}" for s in ref["inertia"]]
    if ref.get("hydro"):
        paths += [f"BoundSubhalo/{name}" for name in HYDRO_SUMS]
    for so in ref["so"]:
        paths += [f"{so['group']}/SORadius", f"{so['group']}/TotalMass"] + region(so["group"])
    for ap in ref["apertures"]:
        paths += [f"{ap['group']}/TotalMass"] + region(ap["group"])
    return paths


def answers(hd: HaloData, ref: Mapping, cosmo: Mapping, precision: str = "float64",
            masks: bool = True) -> Dict:
    """Every compared output of one halo, in physical internal units,
    by catalogue name (vectors as arrays)."""
    rin, acc, rout = _rounder(precision)
    a = float(cosmo["a"])
    rel, m, v = rin(hd.rel), rin(hd.m), rin(hd.v)
    r = np.sqrt((rel * rel).sum(1, dtype=acc))
    f = {k: rin(x) for k, x in hd.fields.items()}
    types = ref["particle_types"]
    out: Dict[str, object] = {}
    put = lambda k, x: out.__setitem__(k, rout(x))

    # bound subhalo
    b = hd.bound
    for pt in types:
        sel = b & (hd.t == int(pt[-1]))
        out[f"BoundSubhalo/{COUNT_NAMES[pt]}"] = int(sel.sum())
        if pt in MASS_NAMES:
            put(f"BoundSubhalo/{MASS_NAMES[pt]}", m[sel].sum(dtype=acc))
    mb = m[b]
    mtot = mb.sum(dtype=acc)
    put("BoundSubhalo/TotalMass", mtot)
    com_rel = (mb[:, None] * rel[b]).sum(0, dtype=acc) / mtot if mtot > 0 else np.zeros(3)
    put("BoundSubhalo/CentreOfMass", hd.centre * a + com_rel)
    vcom = (mb[:, None] * v[b]).sum(0, dtype=acc) / mtot if mtot > 0 else np.zeros(3)
    put("BoundSubhalo/CentreOfMassVelocity", vcom)
    hmr = half_mass_radius(r[b], mb, acc)
    put("BoundSubhalo/HalfMassRadiusTotal", hmr)
    for spec in ref["inertia"]:
        codes = [int(pt[-1]) for pt in spec["types"]]
        sel = b & np.isin(hd.t, codes)
        if sel.sum() and m[sel].sum() > 0:
            R = 10.0 * (hmr if spec["types"] == types else
                        half_mass_radius(r[sel], m[sel], acc))
            t = inertia_tensor(m[sel], rel[sel], R, acc)
        else:
            t = np.zeros(6)
        put(f"BoundSubhalo/{spec['key']}", t)
    if ref.get("hydro"):
        for name, (pt, fk, per_mass) in HYDRO_SUMS.items():
            sel = b & (hd.t == int(pt[-1]))
            w = np.maximum(f[fk][sel], 0.0) if fk == "sfr" else f[fk][sel]
            if per_mass:
                ms = m[sel].sum(dtype=acc)
                val = (m[sel] * w).sum(dtype=acc) / ms if ms > 0 else 0.0
            else:
                val = w.sum(dtype=acc)
            put(f"BoundSubhalo/{name}", val)

    # spherical overdensities
    for so in ref["so"]:
        R, M = so_solve(r, m, threshold_density(so, cosmo), acc)
        g = so["group"]
        put(f"{g}/SORadius", R)
        put(f"{g}/TotalMass", M)
        inside = r < R
        for pt in types:
            sel = inside & (hd.t == int(pt[-1]))
            out[f"{g}/{COUNT_NAMES[pt]}"] = int(sel.sum())
            if pt in MASS_NAMES:
                put(f"{g}/{MASS_NAMES[pt]}", m[sel].sum(dtype=acc))

    # apertures
    for ap in ref["apertures"]:
        g = ap["group"]
        inside = r < float(ap["radius_kpc"]) / 1000.0
        if not ap["inclusive"]:
            inside &= b
        put(f"{g}/TotalMass", m[inside].sum(dtype=acc))
        for pt in types:
            sel = inside & (hd.t == int(pt[-1]))
            out[f"{g}/{COUNT_NAMES[pt]}"] = int(sel.sum())
            if pt in MASS_NAMES:
                put(f"{g}/{MASS_NAMES[pt]}", m[sel].sum(dtype=acc))

    if not masks:
        return out
    # the category filters, from this answer's own bound counts
    kept = category_masks(ref, {f"BoundSubhalo/{COUNT_NAMES[pt]}":
                                out[f"BoundSubhalo/{COUNT_NAMES[pt]}"] for pt in types})
    drop = [p for p, c in ref.get("categories", {}).items() if not kept.get(c, True)]
    drop += [p for g, c in ref.get("group_filters", {}).items() if not kept.get(c, True)
             for p in out if p.startswith(g + "/")]
    for p in drop:
        if p in out:
            out[p] = np.zeros_like(np.asarray(out[p]))
    return out


# ---------------------------------------------------------------- judging


def _rel(got, want, floor: float = 0.0) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = max(float(np.max(np.abs(want))), floor)
    if den == 0.0:
        return float(np.max(np.abs(got))) and 1.0
    return float(np.max(np.abs(got - want)) / den)


def _banded(x: float, lo: float, hi: float) -> float:
    return max(0.0, x - hi, lo - x)


def category_masks(ref: Mapping, counts: Mapping[str, int]) -> Dict[str, bool]:
    """{category: kept} from the bound counts (a DMO run counts no
    baryons)."""
    kept = {"basic": True}
    for name, flt in ref.get("filters", {}).items():
        total = sum(int(counts.get(ds, 0)) for ds in flt["properties"])
        kept[name] = total >= int(flt["limit"])
    return kept


def judge(got: Mapping, ref_ans: Mapping, hd: HaloData, ref: Mapping, cosmo: Mapping) -> Dict[str, float]:
    """The gaps of one halo's answers ``got`` (the port's, or the
    control's) against the reference (``ref_ans``, float64, and the
    halo's particles)."""
    band = float(ref["band"])
    types = ref["particle_types"]
    gaps = dict.fromkeys(ref["numbers"], 0.0)
    pm = float(np.median(hd.m)) if len(hd.m) else 1.0
    counts = {f"BoundSubhalo/{COUNT_NAMES[pt]}": ref_ans[f"BoundSubhalo/{COUNT_NAMES[pt]}"]
              for pt in types}
    kept = category_masks(ref, counts)

    def up(name, value):
        if name in gaps:
            gaps[name] = max(gaps[name], float(value))

    def masked(path):
        cat = ref.get("categories", {}).get(path, "basic")
        group = path.rsplit("/", 1)[0]
        return not (kept.get(cat, True) and kept.get(ref.get("group_filters", {}).get(group, "basic"), True))

    # masks: a masked value is zero; an unmasked one is judged below
    for path in list(ref.get("categories", {})) + [
            f"{g}/SORadius" for g in ref.get("group_filters", {})]:
        if path in got and masked(path) and np.any(np.asarray(got[path]) != 0):
            up("mask_wrong", 1.0)

    # bound subhalo: membership is exact
    for pt in types:
        k = f"BoundSubhalo/{COUNT_NAMES[pt]}"
        up("bound_count_gap", abs(int(got[k]) - int(ref_ans[k])))
        if pt in MASS_NAMES:
            k = f"BoundSubhalo/{MASS_NAMES[pt]}"
            up("mass_gap", _rel(got[k], ref_ans[k], pm))
    up("mass_gap", _rel(got["BoundSubhalo/TotalMass"], ref_ans["BoundSubhalo/TotalMass"], pm))
    b = hd.bound
    hmr = float(ref_ans["BoundSubhalo/HalfMassRadiusTotal"])
    if not masked("BoundSubhalo/HalfMassRadiusTotal"):
        up("halfmass_gap", _rel(got["BoundSubhalo/HalfMassRadiusTotal"], hmr))
    if hmr > 0:
        box_a = float(ref["boxsize"]) * float(cosmo["a"])
        d = np.asarray(got["BoundSubhalo/CentreOfMass"], np.float64) - ref_ans["BoundSubhalo/CentreOfMass"]
        d -= box_a * np.round(d / box_a)
        up("centre_gap", float(np.sqrt((d * d).sum())) / hmr)
        vcom = np.asarray(ref_ans["BoundSubhalo/CentreOfMassVelocity"], np.float64)
        mb = hd.m[b]
        sigma = math.sqrt(float((mb[:, None] * (hd.v[b] - vcom) ** 2).sum() / mb.sum()))
        dv = np.asarray(got["BoundSubhalo/CentreOfMassVelocity"], np.float64) - vcom
        up("centre_gap", float(np.sqrt((dv * dv).sum())) / max(sigma, 1e-30))
    for spec in ref["inertia"]:
        k = f"BoundSubhalo/{spec['key']}"
        if masked(k):
            continue
        want = np.asarray(ref_ans[k], np.float64)
        trace = float(want[:3].sum())
        up("inertia_gap", _rel(got[k], want, trace) if trace > 0 else
           (1.0 if np.any(np.asarray(got[k]) != 0) else 0.0))
    if ref.get("hydro"):
        for name in HYDRO_SUMS:
            k = f"BoundSubhalo/{name}"
            if not masked(k):
                up("hydro_gap", _rel(got[k], ref_ans[k]))

    def region(group, R, inside_of):
        """Counts and masses within the band about radius R."""
        lo = inside_of(R * (1.0 - band))
        hi = inside_of(R * (1.0 + band))
        for pt in types:
            code = int(pt[-1])
            k = f"{group}/{COUNT_NAMES[pt]}"
            if k in got:
                n_lo, n_hi = int((lo & (hd.t == code)).sum()), int((hi & (hd.t == code)).sum())
                up("aperture_count_gap", _banded(int(got[k]), n_lo, n_hi))
            k = f"{group}/{MASS_NAMES.get(pt, '')}"
            if k in got:
                m_lo = hd.m[lo & (hd.t == code)].sum()
                m_hi = hd.m[hi & (hd.t == code)].sum()
                up("mass_gap", _banded(float(got[k]), m_lo, m_hi) / max(m_hi, pm))
        return lo, hi

    for ap in ref["apertures"]:
        g = ap["group"]
        R = float(ap["radius_kpc"]) / 1000.0
        sel = (lambda x: hd.r < x) if ap["inclusive"] else (lambda x: (hd.r < x) & b)
        lo, hi = region(g, R, sel)
        up("mass_gap", _banded(float(got[f"{g}/TotalMass"]), hd.m[lo].sum(), hd.m[hi].sum())
           / max(hd.m[hi].sum(), pm))

    o = np.argsort(hd.r, kind="stable")
    r_s, cum = hd.r[o], np.cumsum(hd.m[o])
    pos = np.nonzero(r_s > 0)[0]
    nskip = max(int(pos[0]) if len(pos) else len(r_s), 1)
    for so in ref["so"]:
        g = so["group"]
        if masked(f"{g}/SORadius"):
            continue
        rho = threshold_density(so, cosmo)
        R, M = float(got[f"{g}/SORadius"]), float(got[f"{g}/TotalMass"])
        R_ref = float(ref_ans[f"{g}/SORadius"])
        if (R > 0) != (R_ref > 0):
            up("so_gap", 1.0)
            continue
        if R <= 0:
            continue
        shell = FOUR_PI_3 * rho * R**3
        up("so_gap", abs(M - shell) / shell)
        # the reference profile's mass at R, linear inside its interval
        if nskip >= len(r_s):
            up("so_gap", 1.0)
            continue
        if R <= r_s[nskip]:
            m_at = cum[nskip] * R / r_s[nskip]
        else:
            i = min(int(np.searchsorted(r_s, R)), len(r_s) - 1)
            dr = r_s[i] - r_s[i - 1]
            m_at = cum[i] if dr == 0 else cum[i - 1] + (R - r_s[i - 1]) / dr * (cum[i] - cum[i - 1])
        up("so_gap", abs(m_at / shell - 1.0))
        # no earlier crossing: every usable particle well inside R is
        # above the threshold
        idx = np.arange(nskip, len(r_s))
        idx = idx[r_s[idx] < R * (1.0 - band)]
        if len(idx):
            dens = cum[idx] / (FOUR_PI_3 * r_s[idx] ** 3)
            up("so_gap", max(0.0, float(np.max((rho * (1.0 - band) - dens) / rho))))
        region(g, R, lambda x: hd.r < x)
    return gaps
