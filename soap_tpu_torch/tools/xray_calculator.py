"""X-ray luminosity recalculation: emissivity tables -> per-particle
extra-input datasets.

The port's copy of ``soap_tpu/tools/xray_calculator.py`` (reference
``misc/recalculate_xrays.py`` and ``misc/xray_calculator.py``), with its
device work in torch on an explicit device (``"cuda"`` by default), in
float64, which is what the JAX package computes with x64 on.

Full tables (reference ``misc/xray_calculator.py:50-396``) are
5-dimensional per band and observing type, ``(redshift, helium
fraction, element, temperature, density)``, holding log10 per-element
emissivities with the last element slot the zero-metal background.  Per
particle:

  1. ``n_H`` from the hydrogen mass fraction and the density;
  2. per-element abundances relative to hydrogen by number, divided by
     solar (``find_indices``), with the Ca and S columns copies of Si and
     Fe moved to the end;
  3. the (z, He, T, n) bins: regular grids for T, n and z, a sorted
     search for the irregular He axis;
  4. each element's log-emissivity, quadrilinear over the 16 (z, He, T,
     n) corners (``get_table_interp``);
  5. ``10^background + sum_j 10^f_j * (Z_j/Z_sun,j)`` over the metals;
  6. times ``n_H^2`` and the particle's volume: a luminosity.  Particles
     outside the table's (T, n) bounds, rounded to one decimal as the
     reference rounds them, get ``fill_value``.

Table layout (HDF5), as the reference's tables:
  Bins/Redshift_bins     (nz,)
  Bins/He_bins           (nHe,)   log10 n_He/n_H, may be irregular
  Bins/Temperature_bins  (nT,)    log10 T [K]
  Bins/Density_bins      (nn,)    log10 n_H [cm^-3]
  Bins/Element_masses    (9,)     atomic masses, H first
  Bins/Solar_metallicities (11,)  log10 solar abundance (H..Fe + Ca, S)
  Bins/Missing_element   informational
  <band>/<observing_type>  (nz, nHe, nElem, nT, nn) log10 emissivity

A simplified 3D layout (``Emissivities/<band>`` over (z, T, n)) is kept
for quick-look tables.  ``mock_table_5d`` builds the arrays of a
synthetic full table without h5py (what ``XrayCalculator.from_arrays``
takes); the functions that open files import h5py inside.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BANDS = ("erosita-low", "erosita-high", "ROSAT")
DEFAULT_OBSERVING_TYPES = (
    "energies_intrinsic",
    "photons_intrinsic",
    "energies_observed",
    "photons_observed",
)
#: output dataset name per observing type (reference
#: ``misc/recalculate_xrays.py:59-154``)
OUTPUT_DATASETS = {
    "energies_intrinsic": "XrayLuminositiesRestframe",
    "photons_intrinsic": "XrayPhotonLuminositiesRestframe",
    "energies_observed": "XrayLuminosities",
    "photons_observed": "XrayPhotonLuminosities",
}

#: proton mass in grams
M_H_G = 1.67262192369e-24

#: the ``Bins`` datasets a full table's calculator reads
_BIN_NAMES = ("Redshift_bins", "He_bins", "Temperature_bins", "Density_bins",
              "Element_masses", "Solar_metallicities")


def _index_regular(bins: np.ndarray, x: torch.Tensor):
    """Bin index and fractional offset on a regular grid, with the
    reference's clamping (``get_index_1d``)."""
    bins = np.asarray(bins, np.float64)
    delta = (len(bins) - 1) / (bins[-1] - bins[0])
    t = (x - bins[0]) * delta
    idx = torch.clamp(torch.floor(t).to(torch.int32), 0, len(bins) - 2)
    dx = torch.clamp(t - idx, 0.0, 1.0)
    return idx, dx


def _index_irregular(bins: np.ndarray, x: torch.Tensor):
    """Bin index and fractional offset for irregular bin edges
    (``get_index_1d_irregular``), clamped at both ends."""
    bins = np.asarray(bins, np.float64)
    edges = _f64(bins, x.device)
    xc = torch.clamp(x, float(bins[0]), float(bins[-1]))
    idx = torch.clamp(torch.searchsorted(edges, xc, right=True) - 1, 0, len(bins) - 2)
    widths = _f64(np.diff(bins), x.device)
    dx = (xc - edges[idx]) / widths[idx]
    return idx, torch.clamp(dx, 0.0, 1.0)


def _f64(x, device) -> torch.Tensor:
    """A float64 copy of an array or tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float64)
    return torch.tensor(np.asarray(x, np.float64), device=device)


class XrayCalculator:
    """Full-table X-ray emissivity interpolator.

    As the reference's ``XrayCalculator``: the tables are sliced to the
    two redshift bins around the snapshot's redshift when loaded;
    ``interpolate`` then runs the per-particle work on ``device``.
    """

    def __init__(
        self,
        redshift: float,
        table_path: str,
        bands: Sequence[str],
        observing_types: Sequence[str],
        device="cuda",
    ):
        import h5py

        with h5py.File(table_path, "r") as f:
            bins = {name: f[f"Bins/{name}"] for name in _BIN_NAMES}
            self._load(redshift, bins, lambda band, otype: f[band][otype], bands,
                       observing_types, device)

    @classmethod
    def from_arrays(
        cls,
        redshift: float,
        bins: Mapping[str, np.ndarray],
        tables: Mapping[str, Mapping[str, np.ndarray]],
        bands: Sequence[str],
        observing_types: Sequence[str],
        device="cuda",
    ) -> "XrayCalculator":
        """The calculator of a table given as arrays: ``bins`` by the
        ``Bins`` dataset names, ``tables[band][observing_type]`` the 5D
        emissivities (``mock_table_5d`` gives both)."""
        calc = cls.__new__(cls)
        calc._load(redshift, bins, lambda band, otype: tables[band][otype], bands,
                   observing_types, device)
        return calc

    def _load(self, redshift, bins, table, bands, observing_types, device) -> None:
        """The bins, the redshift weight and each (band, observing type)
        table's two redshift slices around ``redshift`` (reference
        ``load_all_tables``), from ``bins[name]`` and ``table(band,
        observing_type)``."""
        bins = {name: np.asarray(bins[name], np.float64) for name in _BIN_NAMES}
        self.device = torch.device(device)
        self.z_now = float(redshift)
        self.z_bins = bins["Redshift_bins"]
        self.he_bins = bins["He_bins"]
        self.t_bins = bins["Temperature_bins"]
        self.n_bins = bins["Density_bins"]
        self.element_masses = bins["Element_masses"]
        self.solar_metallicity = 10.0 ** bins["Solar_metallicities"]
        delta = (len(self.z_bins) - 1) / (self.z_bins[-1] - self.z_bins[0])
        t = np.clip((self.z_now - self.z_bins[0]) * delta, 0.0, len(self.z_bins) - 1)
        iz = int(np.clip(np.floor(t), 0, len(self.z_bins) - 2))
        self.dx_z = float(np.clip(t - iz, 0.0, 1.0))
        self.tables: Dict[str, Dict[str, np.ndarray]] = {}
        for band, otype in zip(bands, observing_types):
            tbl = self.tables.setdefault(band, {})
            if otype not in tbl:
                tbl[otype] = np.asarray(table(band, otype)[iz: iz + 2], np.float32)

    # -- per-particle preparation (reference ``find_indices``) ---------

    def abundance_to_solar(self, element_mass_fractions) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, 9) element mass fractions (H..Fe) -> the (N, 9) metal
        abundances over solar (C, N, O, Ne, Mg, Si, Ca, S, Fe) and the
        log10 He/H number abundance of the He axis, on the device."""
        mf = _f64(element_mass_fractions, self.device)
        masses = _f64(self.element_masses, self.device)
        # number abundance relative to hydrogen
        abundances = (mf / mf[:, :1]) * (masses[0] / masses)
        # Ca and S proxied by Si; Fe moved to the end (reference
        # ``find_indices`` np.c_ block); divided by solar after padding
        padded = torch.cat([abundances[:, :-1], abundances[:, -2:-1], abundances[:, -2:-1],
                            abundances[:, -1:]], dim=1)
        ats = padded / _f64(self.solar_metallicity, self.device)
        log_he = torch.log10(torch.clamp(abundances[:, 1], min=1e-30))
        return ats[:, 2:], log_he

    def interpolate_tensor(
        self,
        densities_cgs,
        temperatures_K,
        element_mass_fractions,
        masses_g,
        bands: Sequence[str],
        observing_types: Sequence[str],
        fill_value: float = 0.0,
    ) -> torch.Tensor:
        """``interpolate``'s luminosities as a float64 tensor on the
        device."""
        dev = self.device
        rho = _f64(densities_cgs, dev)
        T = _f64(temperatures_K, dev)
        mf = _f64(element_mass_fractions, dev)
        m = _f64(masses_g, dev)

        data_n = torch.log10(torch.clamp(mf[:, 0] * rho / M_H_G, min=1e-300))
        data_t = torch.log10(torch.clamp(T, min=1e-300))
        vol = m / torch.clamp(rho, min=1e-300)  # cm^3

        # reference bounds mask, rounded to one decimal
        joint = (
            (data_n >= float(np.round(self.n_bins.min(), 1)))
            & (data_n <= float(np.round(self.n_bins.max(), 1)))
            & (data_t >= float(np.round(self.t_bins.min(), 1)))
            & (data_t <= float(np.round(self.t_bins.max(), 1)))
        )
        ats, log_he = self.abundance_to_solar(mf)

        idx_n, dx_n = _index_regular(self.n_bins, data_n)
        idx_t, dx_t = _index_regular(self.t_bins, data_t)
        idx_he, dx_he = _index_irregular(self.he_bins, log_he)
        w_z = (1.0 - self.dx_z, self.dx_z)
        w_t = (1.0 - dx_t, dx_t)
        w_n = (1.0 - dx_n, dx_n)
        w_he = (1.0 - dx_he, dx_he)
        ih = [(idx_he + b).long()[:, None] for b in (0, 1)]
        it = [(idx_t + b).long()[:, None] for b in (0, 1)]
        inn = [(idx_n + b).long()[:, None] for b in (0, 1)]
        n_h2 = 10.0 ** (2.0 * data_n)

        out = torch.full((len(rho), len(bands)), float(fill_value), dtype=torch.float64,
                         device=dev)
        for col, (band, otype) in enumerate(zip(bands, observing_types)):
            # (2, nHe, nElem, nT, nn), float32 values exactly in float64
            tbl = _f64(self.tables[band][otype], dev)
            elem = torch.arange(tbl.shape[2], device=dev)[None, :]
            f = torch.zeros((len(rho), tbl.shape[2]), dtype=torch.float64, device=dev)
            for bz in (0, 1):
                for bh in (0, 1):
                    for bt in (0, 1):
                        for bn in (0, 1):
                            w = w_z[bz] * w_he[bh] * w_t[bt] * w_n[bn]
                            f = f + w[:, None] * tbl[bz][ih[bh], elem, it[bt], inn[bn]]
            total = 10.0 ** f[:, -1] + (10.0 ** f[:, :-1] * ats).sum(1)
            out[:, col] = torch.where(joint, total * n_h2 * vol, float(fill_value))
        return out

    def interpolate(
        self,
        densities_cgs,
        temperatures_K,
        element_mass_fractions,
        masses_g,
        bands: Sequence[str],
        observing_types: Sequence[str],
        fill_value: float = 0.0,
    ) -> np.ndarray:
        """Luminosities (erg/s or photons/s), shape (N, len(bands))."""
        return self.interpolate_tensor(
            densities_cgs, temperatures_K, element_mass_fractions, masses_g, bands,
            observing_types, fill_value).cpu().numpy()


class XrayTable:
    """Simplified (z, T, nH) emissivity table, for quick looks."""

    def __init__(self, filename: str):
        import h5py

        with h5py.File(filename, "r") as f:
            self.log_t = np.asarray(f["Bins/Temperature"], dtype=np.float64)
            self.log_n = np.asarray(f["Bins/Density"], dtype=np.float64)
            self.z_grid = np.asarray(f["Bins/Redshift"], dtype=np.float64)
            self.bands: Dict[str, np.ndarray] = {
                band: np.asarray(f["Emissivities"][band], dtype=np.float64)
                for band in f["Emissivities"]
            }

    def at_redshift(self, z: float) -> Dict[str, np.ndarray]:
        zg = self.z_grid
        z = float(np.clip(z, zg[0], zg[-1]))
        i = int(np.clip(np.searchsorted(zg, z) - 1, 0, len(zg) - 2))
        f = (z - zg[i]) / (zg[i + 1] - zg[i]) if len(zg) > 1 else 0.0
        return {
            band: (1 - f) * tbl[i] + f * tbl[min(i + 1, len(zg) - 1)]
            for band, tbl in self.bands.items()
        }


def bilinear_interp(
    table: np.ndarray,  # (nT, nn)
    t_grid: np.ndarray,
    n_grid: np.ndarray,
    log_t: np.ndarray,
    log_n: np.ndarray,
    device="cuda",
) -> np.ndarray:
    """Clamped bilinear interpolation on a regular (T, nH) grid, on
    ``device``."""
    tg = _f64(t_grid, device)
    ng = _f64(n_grid, device)
    t = torch.clamp(_f64(log_t, device), float(t_grid[0]), float(t_grid[-1]))
    n = torch.clamp(_f64(log_n, device), float(n_grid[0]), float(n_grid[-1]))
    it = torch.clamp(torch.searchsorted(tg, t) - 1, 0, len(t_grid) - 2)
    inn = torch.clamp(torch.searchsorted(ng, n) - 1, 0, len(n_grid) - 2)
    ft = (t - tg[it]) / (tg[it + 1] - tg[it])
    fn = (n - ng[inn]) / (ng[inn + 1] - ng[inn])
    tbl = _f64(table, device)
    v00 = tbl[it, inn]
    v01 = tbl[it, inn + 1]
    v10 = tbl[it + 1, inn]
    v11 = tbl[it + 1, inn + 1]
    return (
        (1 - ft) * (1 - fn) * v00 + (1 - ft) * fn * v01 + ft * (1 - fn) * v10 + ft * fn * v11
    ).cpu().numpy()


def _is_full_table(table_file: str) -> bool:
    import h5py

    with h5py.File(table_file, "r") as f:
        return "Bins/Redshift_bins" in f


def compute_xray_luminosities(
    snapshot_file: str,
    table_file: str,
    output_file: str,
    bands: Optional[List[str]] = None,
    observing_types: Optional[List[str]] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Write an extra-input file with per-particle X-ray luminosities.

    With a full 5D table every available observing type is written as
    its own dataset (XrayLuminosities, XrayPhotonLuminosities and the
    ``Restframe`` pair; reference ``misc/recalculate_xrays.py:59-154``);
    with the simple 3D table only XrayLuminosities.  The interpolation
    runs on ``device``.
    """
    import h5py

    from soap_tpu_torch.io.swift_snapshot import SnapshotMetadata

    meta = SnapshotMetadata(snapshot_file)
    with h5py.File(snapshot_file, "r") as snap:
        gas = snap["PartType0"]
        T = np.asarray(gas["Temperatures"], dtype=np.float64)
        rho = np.asarray(gas["Densities"], dtype=np.float64)
        m = np.asarray(gas["Masses"], dtype=np.float64)
        if "SmoothedElementMassFractions" in gas:
            mf = np.asarray(gas["SmoothedElementMassFractions"], np.float64)
        elif "ElementMassFractions" in gas:
            mf = np.asarray(gas["ElementMassFractions"], np.float64)
        else:
            mf = None

    ul = meta.snap_units_cgs["Unit length in cgs (U_L)"]
    um = meta.snap_units_cgs["Unit mass in cgs (U_M)"]
    ut = meta.snap_units_cgs["Unit time in cgs (U_t)"]
    rho_cgs = rho * um / ul**3 / meta.a**3  # physical g/cm^3
    lum_unit = um * ul**2 / ut**3  # snapshot power unit in erg/s
    out: Dict[str, np.ndarray] = {}

    if _is_full_table(table_file):
        if bands is None:
            bands = list(DEFAULT_BANDS)
        if observing_types is None:
            with h5py.File(table_file, "r") as f:
                observing_types = [t for t in DEFAULT_OBSERVING_TYPES if t in f[bands[0]]]
        if mf is None:
            raise ValueError("full X-ray tables need ElementMassFractions in the snapshot")
        for otype in observing_types:
            calc = XrayCalculator(meta.z, table_file, bands, [otype] * len(bands), device)
            lum = calc.interpolate(rho_cgs, T, mf, m * um, bands, [otype] * len(bands))
            if "energies" in otype:
                lum = lum / lum_unit  # erg/s -> snapshot power units
            else:
                lum = lum * (ut / 1.0)  # photons/s -> photons per U_t
            f32max = np.finfo(np.float32).max
            out[OUTPUT_DATASETS[otype]] = np.clip(lum, -f32max, f32max).astype(np.float32)
    else:
        table = XrayTable(table_file)
        tables_z = table.at_redshift(meta.z)
        if bands is None:
            bands = list(tables_z.keys())
        xh = mf[:, 0] if mf is not None else np.full(len(T), 0.74)
        n_h = rho_cgs * xh / M_H_G
        log_t = np.log10(np.maximum(T, 1.0))
        log_n = np.log10(np.maximum(n_h, 1e-30))
        volume_cgs = (m * um) / np.maximum(rho_cgs, 1e-60)
        lum = np.zeros((len(T), len(bands)), np.float64)
        for i, band in enumerate(bands):
            log_eps = bilinear_interp(tables_z[band], table.log_t, table.log_n, log_t, log_n,
                                      device)
            lum[:, i] = 10.0**log_eps * n_h**2 * volume_cgs  # erg/s
        out["XrayLuminosities"] = (lum / lum_unit).astype(np.float32)

    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with h5py.File(snapshot_file, "r") as snap, h5py.File(output_file, "w") as f:
        if "Cells" in snap:
            snap.copy("Cells", f)
        g = f.create_group("PartType0")
        for name, data in out.items():
            ds = g.create_dataset(name, data=data)
            ds.attrs["Description"] = np.bytes_(f"{name} in bands {list(bands)}")
    return out


def write_mock_table(
    filename: str,
    nz: int = 4,
    nt: int = 32,
    nn: int = 24,
    bands=DEFAULT_BANDS,
) -> None:
    """Synthetic simplified emissivity table for tests."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    log_t = np.linspace(4.0, 9.0, nt)
    log_n = np.linspace(-8.0, 2.0, nn)
    z = np.linspace(0.0, 3.0, nz)
    with h5py.File(filename, "w") as f:
        b = f.create_group("Bins")
        b["Temperature"] = log_t
        b["Density"] = log_n
        b["Redshift"] = z
        e = f.create_group("Emissivities")
        for k, band in enumerate(bands):
            eps = (
                -24.0
                + 0.5 * (log_t[None, :, None] - 7.0)
                - 0.1 * k
                + 0.02 * z[:, None, None]
                + 0.0 * log_n[None, None, :]
            )
            e[band] = np.broadcast_to(eps, (nz, nt, nn)).copy()


#: element masses (H, He, C, N, O, Ne, Mg, Si, Fe) used by the mock
MOCK_ELEMENT_MASSES = np.array(
    [1.008, 4.003, 12.011, 14.007, 15.999, 20.18, 24.305, 28.086, 55.845]
)
#: log10 solar abundances by number for the 11 padded columns
MOCK_SOLAR = np.array(
    [0.0, -1.07, -3.57, -4.17, -3.31, -4.07, -4.4, -4.49, -5.66, -4.88, -4.5]
)


def mock_table_5d(
    nz: int = 3,
    nhe: int = 5,
    nt: int = 16,
    nn: int = 12,
    bands=DEFAULT_BANDS,
    observing_types=DEFAULT_OBSERVING_TYPES,
    seed: int = 0,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Dict[str, np.ndarray]]]:
    """(bins, tables) of a synthetic full-layout (5D) table: smooth
    analytic per-element emissivity shapes, ``bins`` by the ``Bins``
    dataset names and ``tables[band][observing_type]`` float32, as
    ``write_mock_table_5d`` writes them."""
    n_elem = 10  # 9 metals + no-metal background
    log_t = np.linspace(5.0, 9.5, nt)
    log_n = np.linspace(-8.0, 6.0, nn)
    z = np.linspace(0.0, 2.0, nz)
    he = np.array([-2.0, -1.5, -1.2, -1.0, -0.7])[:nhe]
    rng = np.random.default_rng(seed)
    bins = {
        "Redshift_bins": z,
        "He_bins": he,
        "Temperature_bins": log_t,
        "Density_bins": log_n,
        "Element_masses": MOCK_ELEMENT_MASSES,
        "Solar_metallicities": MOCK_SOLAR,
    }
    tables: Dict[str, Dict[str, np.ndarray]] = {}
    for bi, band in enumerate(dict.fromkeys(bands)):
        for oi, otype in enumerate(dict.fromkeys(observing_types)):
            amp = rng.uniform(0.3, 0.7, n_elem)
            eps = (
                -26.0
                - 0.1 * bi
                - 0.05 * oi
                + amp[None, None, :, None, None] * (log_t[None, None, None, :, None] - 7.0)
                + 0.1 * z[:, None, None, None, None]
                + 0.2 * (he[None, :, None, None, None] + 1.0)
                + 0.01 * log_n[None, None, None, None, :]
            )
            tables.setdefault(band, {})[otype] = np.broadcast_to(
                eps, (nz, nhe, n_elem, nt, nn)).astype(np.float32)
    return bins, tables


def write_mock_table_5d(
    filename: str,
    nz: int = 3,
    nhe: int = 5,
    nt: int = 16,
    nn: int = 12,
    bands=DEFAULT_BANDS,
    observing_types=DEFAULT_OBSERVING_TYPES,
    seed: int = 0,
) -> None:
    """Synthetic full-layout (5D) table for tests: ``mock_table_5d``'s
    arrays in the reference file layout."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    bins, tables = mock_table_5d(nz, nhe, nt, nn, bands, observing_types, seed)
    with h5py.File(filename, "w") as f:
        b = f.create_group("Bins")
        for name, arr in bins.items():
            b[name] = arr
        b["Missing_element"] = np.bytes_("none")
        for band, by_type in tables.items():
            g = f.create_group(band)
            for otype, arr in by_type.items():
                g[otype] = arr
