"""Cosmology helpers on the host: densities, the BN98 multiple, ages.

A numpy-only copy of the parts of ``soap_tpu/core/cosmology.py`` that
``pipeline/run.py::make_context`` and the host staging use: H(a)/H0 for
a flat w0waCDM model with radiation and massive neutrinos, and the
a -> age table (a Gauss-Legendre Friedmann integral), from which the
recently-heated-gas scale-factor limit and the stellar ages come.
``tests/test_torch_host_mirror.py`` holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np


@dataclass(frozen=True)
class Cosmology:
    """Flat w0waCDM parameters as recorded in SWIFT snapshot metadata."""

    a: float
    h: float
    H0_internal: float  # H0 in internal (code) units, from the snapshot
    omega_m: float  # matter (cdm + baryons)
    omega_lambda: float
    omega_k: float
    omega_b: float = 0.0
    omega_r: float = 0.0  # photons + massless neutrinos
    omega_nu_0: float = 0.0  # massive neutrinos today (non-relativistic)
    w0: float = -1.0
    wa: float = 0.0

    @classmethod
    def from_attrs(cls, cosmo: Mapping[str, float]) -> "Cosmology":
        def g(k, d=0.0):
            return float(cosmo.get(k, d))

        return cls(
            a=g("Scale-factor", 1.0),
            h=g("h", 0.681),
            H0_internal=g("H0 [internal units]", 0.0),
            omega_m=g("Omega_m"),
            omega_lambda=g("Omega_lambda"),
            omega_k=g("Omega_k", 0.0),
            omega_b=g("Omega_b", 0.0),
            omega_r=g("Omega_r", 0.0),
            omega_nu_0=g("Omega_nu_0", 0.0),
            w0=g("w_0", -1.0),
            wa=g("w_a", 0.0),
        )

    def critical_density_z0_internal(self, newton_G_internal: float) -> float:
        """rho_crit(z=0) in internal units: 3 H0^2 / (8 pi G)."""
        return 3.0 * self.H0_internal**2 / (8.0 * np.pi * newton_G_internal)

    def mean_density_internal(self, newton_G_internal: float) -> float:
        """Physical mean matter density (massive neutrinos included)."""
        rho_crit0 = self.critical_density_z0_internal(newton_G_internal)
        return rho_crit0 * (self.omega_m + self.omega_nu_0) / self.a**3

    def bn98_virial_multiple(self) -> float:
        """Bryan & Norman (1998) virial overdensity multiple at a."""
        x = -(self.omega_k / self.a**2 + self.omega_lambda) / (
            self.omega_k / self.a**2 + self.omega_m / self.a**3 + self.omega_lambda
        )
        vir = 18.0 * np.pi**2 + 82.0 * x - 39.0 * x**2
        if vir < 50.0 or vir > 1000.0:
            raise RuntimeError(f"Invalid value for virBN98: {vir}")
        return vir

    def E(self, a: np.ndarray) -> np.ndarray:
        """Dimensionless Hubble rate H(a)/H0 (CPL dark energy, neutrinos
        as matter)."""
        a = np.asarray(a, dtype=np.float64)
        de = a ** (-3.0 * (1.0 + self.w0 + self.wa)) * np.exp(-3.0 * self.wa * (1.0 - a))
        return np.sqrt(
            self.omega_r / a**4
            + (self.omega_m + self.omega_nu_0) / a**3
            + self.omega_k / a**2
            + self.omega_lambda * de
        )

    def age_of_universe_H0(self, a, order: int = 256):
        """Age t(a) in units of 1/H0: the integral of da'/(a' E(a')) from 0
        to a, by Gauss-Legendre quadrature in u = sqrt(a')."""
        a = np.asarray(a, dtype=np.float64)
        nodes, weights = np.polynomial.legendre.leggauss(order)

        def single(av):
            if av <= 0.0:
                return 0.0
            umax = np.sqrt(av)
            u = 0.5 * umax * (nodes + 1.0)
            w = 0.5 * umax * weights
            ap = u**2
            return float(np.sum(w * (2.0 * u / (ap * self.E(ap)))))

        if a.ndim == 0:
            return single(float(a))
        return np.array([single(float(v)) for v in a.ravel()]).reshape(a.shape)

    def age_table(self, n: int = 4096, a_min: float = 1e-4):
        """The a -> age [1/H0 units] lookup table."""
        a_grid = np.linspace(a_min, 1.0, n)
        return a_grid, self.age_of_universe_H0(a_grid)
