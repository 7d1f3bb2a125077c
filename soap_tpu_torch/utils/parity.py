"""How one engine's results are held to another's, key by key.

Used where the port's engine is compared with the JAX engine on the CPU
(``tests/test_torch_engine_*.py``) and where its GPU run is compared with
its CPU run (``chip_smoke.py``).  The classes follow what the two sides'
summation orders explain, as measured on the test mocks (``CHANGES.md``):

- particle counts are equal;
- ``TIGHT`` keys (the SO solution's radius and mass, masses summed per
  type, half-mass radii) within rtol 1e-5 (measured <= 9.5e-7);
- the ``is_loose`` keys within rtol 1e-5 plus 1e-4 of the key's largest
  magnitude: the iterative inertia tensors (up to 4.3e-5 of the scale;
  the port's loop sums its moments in float64, the JAX loop in float32)
  and the luminosity-weighted stellar kappa (3.6e-5);
- every other key within rtol 1e-5 plus 1e-5 of its largest magnitude
  (measured <= 5.9e-6 of the scale).
"""

from __future__ import annotations

import numpy as np

COUNTS = ("Ngas", "Ndm", "Nstar", "Nbh")
TIGHT = ("r", "Mtot", "Mgas", "Mdm", "Mstar", "Mbh_dynamical", "HalfMassRadiusTot",
         "HalfMassRadiusDM")
RTOL = 1e-5
ATOL = 1e-5  # of the key's largest magnitude
LOOSE_ATOL = 1e-4


def is_loose(key: str) -> bool:
    """The keys held at LOOSE_ATOL: iterative inertia tensors and the
    luminosity-weighted stellar kappa."""
    iterative_inertia = "InertiaTensor" in key and "Noniterative" not in key
    return iterative_inertia or key == "kappa_corot_star_luminosity_weighted"


def key_close(ref, got, key: str) -> bool:
    """``got`` holds to ``ref`` under ``key``'s class (same shape, finite)."""
    a = np.asarray(ref, np.float64)
    b = np.asarray(got, np.float64)
    if a.shape != b.shape or not np.isfinite(b).all():
        return False
    if key in COUNTS:
        return np.array_equal(a, b)
    if key in TIGHT:
        return np.allclose(b, a, rtol=RTOL, atol=0.0)
    scale = max(np.abs(a).max() if a.size else 1.0, 1e-30)
    atol = LOOSE_ATOL if is_loose(key) else ATOL
    return np.allclose(b, a, rtol=RTOL, atol=atol * scale)


def scaled_error(ref, got) -> float:
    """Largest |got - ref| over the largest |ref|."""
    a = np.asarray(ref, np.float64)
    b = np.asarray(got, np.float64)
    if not a.size:
        return 0.0
    return float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30))
