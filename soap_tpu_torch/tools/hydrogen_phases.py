"""Approximate HI / H2 species fractions for snapshots lacking them.

The port's copy of ``soap_tpu/tools/hydrogen_phases.py``, counterpart of the reference's ``misc/hdecompose_hydrogen_fractions.py``
(which wraps the external Hdecompose package): per gas particle,

 1. the NEUTRAL hydrogen fraction from the Rahmati et al. (2013,
    MNRAS 430, 2427) photoionization-equilibrium fitting formulas
    (their Appendix A: UVB photoionization rate with self-shielding
    suppression A1, case-A recombination A3, collisional ionization A6,
    equilibrium solution A8), and
 2. the MOLECULAR fraction of that neutral hydrogen from the
    Blitz & Rosolowsky (2006, ApJ 650, 933) midplane-pressure relation
    R_mol = (P/P0)^0.92,

then HI = x_neutral (1 - f_mol), H2 = x_neutral f_mol (per unit
hydrogen), written as a SpeciesFractions-style extra-input dataset.
All fits are implemented from the published papers.

``hydrogen_fractions`` is the array half (numpy only, float64);
``compute_hydrogen_fractions`` reads the snapshot and writes the file
(h5py inside).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

#: Haardt & Madau (2001) UVB HI photoionization rates used by
#: Rahmati+2013 Table 2, log-interpolated in redshift [1/s]
_UVB_Z = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
_UVB_GAMMA = np.array([8.34e-14, 7.39e-13, 1.5e-12, 1.16e-12, 7.92e-13, 5.43e-13])
#: HI photoionization cross-section at the Lyman limit per Table 2 [cm^2]
_SIGMA_NU = np.array([3.27e-18, 2.76e-18, 2.55e-18, 2.49e-18, 2.45e-18, 2.45e-18])


def neutral_fraction(
    n_H: np.ndarray, T: np.ndarray, z: float, f_gas: float = 0.17
) -> np.ndarray:
    """Equilibrium neutral hydrogen fraction (Rahmati+2013 App. A)."""
    n_H = np.asarray(n_H, np.float64)
    T = np.maximum(np.asarray(T, np.float64), 1.0)
    zc = float(np.clip(z, _UVB_Z[0], _UVB_Z[-1]))
    gamma_uvb = float(np.interp(zc, _UVB_Z, _UVB_GAMMA))
    sigma = float(np.interp(zc, _UVB_Z, _SIGMA_NU))

    # self-shielding density (A13)
    n_ssh = (
        6.73e-3
        * (sigma / 2.49e-18) ** (-2.0 / 3.0)
        * (T / 1.0e4) ** 0.17
        * (gamma_uvb / 1.0e-12) ** (2.0 / 3.0)
        * (f_gas / 0.17) ** (-1.0 / 3.0)
    )
    x = n_H / n_ssh
    # photoionization-rate suppression (A1)
    gamma_phot = gamma_uvb * (
        0.98 * (1.0 + x**1.64) ** -2.28 + 0.02 * (1.0 + x) ** -0.84
    )
    # case-A recombination (A3)
    lam = 315614.0 / T
    alpha_a = (
        1.269e-13 * lam**1.503 / (1.0 + (lam / 0.522) ** 0.47) ** 1.923
    )
    # collisional ionization (A6)
    lambda_t = (
        1.17e-10 * np.sqrt(T) * np.exp(-157809.0 / T)
        / (1.0 + np.sqrt(T / 1.0e5))
    )
    # equilibrium solution (A8)
    A = alpha_a + lambda_t
    B = 2.0 * alpha_a + gamma_phot / np.maximum(n_H, 1e-30) + lambda_t
    disc = np.maximum(B * B - 4.0 * A * alpha_a, 0.0)
    return np.clip((B - np.sqrt(disc)) / (2.0 * A), 0.0, 1.0)


#: Blitz & Rosolowsky (2006) midplane pressure normalization P0/k_B [K cm^-3]
BR06_P0_OVER_K = 4.3e4
BR06_ALPHA = 0.92


def molecular_fraction(pressure_over_k: np.ndarray) -> np.ndarray:
    """Molecular fraction of neutral hydrogen: R = (P/P0)^alpha,
    f_mol = R / (1 + R) (Blitz & Rosolowsky 2006)."""
    r = (np.maximum(np.asarray(pressure_over_k, np.float64), 0.0)
         / BR06_P0_OVER_K) ** BR06_ALPHA
    return r / (1.0 + r)


def hydrogen_fractions(
    T: np.ndarray,
    rho: np.ndarray,
    xh: np.ndarray,
    press: Optional[np.ndarray],
    snap_units_cgs: Mapping[str, float],
    a: float,
    z: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(HI, HII, H2) per hydrogen number, in float64, of gas with
    temperatures ``T`` [K], comoving densities ``rho``, hydrogen mass
    fractions ``xh`` and comoving pressures ``press`` (None: estimated
    from density and temperature) in snapshot units: HI + HII + 2 H2 = 1.
    """
    ul = snap_units_cgs["Unit length in cgs (U_L)"]
    um = snap_units_cgs["Unit mass in cgs (U_M)"]
    ut = snap_units_cgs["Unit time in cgs (U_t)"]
    m_h = 1.67262192369e-24
    k_b = 1.380649e-16
    rho_cgs = rho * um / ul**3 / a**3
    n_h = rho_cgs * xh / m_h

    x_neutral = neutral_fraction(n_h, T, z)
    if press is not None:
        p_cgs = press * um / (ul * ut**2) / a**3
        f_mol = molecular_fraction(p_cgs / k_b)
    else:
        # ideal-gas pressure estimate from (rho, T)
        f_mol = molecular_fraction(n_h * T / xh)
    hi = x_neutral * (1.0 - f_mol)
    h2 = 0.5 * x_neutral * f_mol  # per H number; 2 H atoms per molecule
    hii = np.clip(1.0 - hi - 2.0 * h2, 0.0, 1.0)
    return hi, hii, h2


def compute_hydrogen_fractions(
    snapshot_file: str,
    output_file: str,
) -> Dict[str, np.ndarray]:
    """Write HI/HII/H2 SpeciesFractions for the snapshot's gas.

    Fractions are per hydrogen NUMBER (the SWIFT SpeciesFractions
    convention): HI + HII + 2 H2 = 1.
    """
    import h5py

    from soap_tpu_torch.io.swift_snapshot import SnapshotMetadata

    meta = SnapshotMetadata(snapshot_file)
    with h5py.File(snapshot_file, "r") as f:
        gas = f["PartType0"]
        T = np.asarray(gas["Temperatures"], np.float64)
        rho = np.asarray(gas["Densities"], np.float64)
        if "ElementMassFractions" in gas:
            xh = np.asarray(gas["ElementMassFractions"][:, 0], np.float64)
        else:
            xh = np.full(len(T), 0.74)
        press = (
            np.asarray(gas["Pressures"], np.float64)
            if "Pressures" in gas
            else None
        )
    hi, hii, h2 = hydrogen_fractions(T, rho, xh, press, meta.snap_units_cgs, meta.a, meta.z)

    sp = np.zeros((len(T), 5), np.float32)
    sp[:, 1] = hi
    sp[:, 2] = hii
    sp[:, 3] = h2
    out = {"SpeciesFractions": sp}
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with h5py.File(snapshot_file, "r") as snap, h5py.File(
        output_file, "w"
    ) as f:
        if "Cells" in snap:
            snap.copy("Cells", f)
        g = f.create_group("PartType0")
        ds = g.create_dataset("SpeciesFractions", data=sp)
        ds.attrs["Description"] = np.bytes_(
            "Approximate species fractions per hydrogen number "
            "(elec, HI, HII, H2, H2p); Rahmati+13 neutral fractions, "
            "Blitz & Rosolowsky 06 molecular split"
        )
        nc = f.create_group("SubgridScheme").create_group("NamedColumns")
        nc.create_dataset(
            "SpeciesFractions",
            data=np.array([b"elec", b"HI", b"HII", b"H2", b"H2p"]),
        )
    return out
