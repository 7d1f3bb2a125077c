"""Batched spherical-overdensity radius and mass from sorted profiles.

Ported from ``soap_tpu/ops/so_radius.py`` (reference
``SOAP/particle_selection/SO_properties.py``):
 - cumulative mass with each particle's full mass at its radius, plus a
   uniform neutrino background ``rho_nu 4/3 pi r^3``;
 - the leading r == 0 entries are skipped (at least one);
 - the SO radius is the first crossing of the density profile below the
   threshold, solved inside the crossing interval by fixed-count
   bisection of ``4 pi/3 rho r^3 = M1 + slope (r - r1)``;
 - a profile that starts below the threshold is extrapolated linearly
   from zero;
 - no crossing inside the searched region flags ``needs_bigger``.
The threshold is any physical density (crit, mean or BN98 multiples);
``enclosed_mass_sorted`` gives the mass at a fixed radius instead (the
SO of a radius multiple, e.g. 5 x R_500crit).
All functions take a leading halo axis: (B, K) profiles, (B,) results.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from soap_tpu_torch.ops.reductions import prefix_sum

_FOUR_PI_3 = 4.0 * math.pi / 3.0
_BISECT_ITERS = 48


class SOResult(NamedTuple):
    radius: torch.Tensor  # SO radius (0 where not found)
    mass: torch.Tensor  # SO mass (0 where not found)
    found: torch.Tensor  # bool: radius and mass both positive
    needs_bigger: torch.Tensor  # bool: search region must grow


def _cube(x: torch.Tensor) -> torch.Tensor:
    return x * x * x


def _first_true(x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(x.to(torch.int8), 1)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return x.gather(1, i[:, None])[:, 0]


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """x[:, i-1] at column i, ``fill`` at column 0."""
    pad = torch.full_like(x[:, :1], fill)
    return torch.cat([pad, x[:, :-1]], 1)


def _bisect_cubic(rho_dim, slope_dim, u_hi):
    """Solve 4pi/3 rho u^3 - s u + s - 1 = 0 on [1, u_hi] by bisection
    (the bracket changes sign by construction)."""

    def f(u):
        return _FOUR_PI_3 * rho_dim * _cube(u) - slope_dim * u + slope_dim - 1.0

    lo = torch.ones_like(u_hi)
    hi = u_hi
    f_lo = f(lo)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        same_side = (f(mid) > 0) == (f_lo > 0)
        lo = torch.where(same_side, mid, lo)
        hi = torch.where(same_side, hi, mid)
    return 0.5 * (lo + hi)


def _usable(r, v):
    """(cumulative-profile mask, nskip): valid rows from the first
    strictly positive radius on, floored at row 1."""
    K = r.shape[1]
    n_valid = v.sum(1)
    pos = v & (r > 0.0)
    nskip = torch.clamp(torch.where(pos.any(1), _first_true(pos), n_valid), min=1)
    idx = torch.arange(K, device=r.device)
    return v & (idx[None, :] >= nskip[:, None]), nskip


def _profile(r, m, v, nu_background_density):
    m = torch.where(v, m, 0.0)
    nu = float(nu_background_density) * _FOUR_PI_3
    return prefix_sum(m) + torch.where(v, nu * _cube(r), 0.0)


def so_radius_sorted(
    r: torch.Tensor,  # (B, K) radii sorted ascending (invalid slots last)
    m: torch.Tensor,  # (B, K) masses in the same order
    v: torch.Tensor,  # (B, K) validity in the same order
    reference_density,  # (B,) tensor or scalar > 0
    nu_background_density: float,  # 0 for DMO
) -> SOResult:
    """SO radius and mass per halo from pre-sorted profiles."""
    K = r.shape[1]
    rho = torch.as_tensor(reference_density, dtype=torch.float32, device=r.device)
    rho = rho.expand(r.shape[0]) if rho.dim() == 0 else rho
    cum = _profile(r, m, v, nu_background_density)
    usable, nskip = _usable(r, v)
    n_usable = usable.sum(1)

    dens = torch.where(usable, cum / (_FOUR_PI_3 * _cube(r)), 0.0)
    above = usable & (dens > rho[:, None])
    first_above = _take(above, torch.clamp(nskip, max=K - 1))

    # case A: profile starts above the threshold
    prev_ok = _shift_right(usable, False)
    prev_above = _shift_right(above, False)
    prev_r = _shift_right(r, 0.0)
    prev_cum = _shift_right(cum, 0.0)
    is_crossing = usable & prev_ok & (prev_above != above) & (r != prev_r)
    has_crossing = is_crossing.any(1)
    ci = _first_true(is_crossing)
    r1 = _take(prev_r, ci)
    r2 = _take(r, ci)
    M1 = _take(prev_cum, ci)
    M2 = _take(cum, ci)
    rho_dim = rho * _cube(r1) / M1
    slope_dim = (M2 - M1) / (r2 - r1) * (r1 / M1)
    u = _bisect_cubic(rho_dim, slope_dim, r2 / r1)
    so_r_a = r1 * u
    so_m_a = _FOUR_PI_3 * _cube(so_r_a) * rho

    # case B: the whole profile below the threshold: linear mass growth
    # from zero to the first non-negative cumulative mass
    nonneg = usable & (cum >= 0.0)
    bi = _first_true(nonneg)
    rb = _take(r, bi)
    Mb = _take(cum, bi)
    so_r_b = torch.sqrt(0.75 * Mb / (math.pi * rb * rho))
    so_m_b = Mb * so_r_b / rb

    case_a = (n_usable > 0) & first_above
    case_b = (n_usable > 0) & ~first_above & nonneg.any(1)
    a_ok = case_a & has_crossing
    so_r = torch.where(a_ok, so_r_a, torch.where(case_b, so_r_b, 0.0))
    so_m = torch.where(a_ok, so_m_a, torch.where(case_b, so_m_b, 0.0))
    found = (so_r > 0.0) & (so_m > 0.0)
    return SOResult(
        radius=torch.where(found, so_r, 0.0),
        mass=torch.where(found, so_m, 0.0),
        found=found,
        needs_bigger=case_a & ~has_crossing,
    )


def enclosed_mass_sorted(
    r: torch.Tensor,  # (B, K) radii sorted ascending
    m: torch.Tensor,
    v: torch.Tensor,
    target_radius,  # (B,) tensor or scalar: fixed physical aperture
    nu_background_density: float,
) -> torch.Tensor:
    """Interpolated cumulative mass (B,) at a fixed radius: linear between
    the bracketing particles, the total when every particle is inside,
    the first cumulative value when the first is already outside."""
    K = r.shape[1]
    tr = torch.as_tensor(target_radius, dtype=torch.float32, device=r.device)
    tr = tr.expand(r.shape[0]) if tr.dim() == 0 else tr
    cum = _profile(r, m, v, nu_background_density)
    usable, nskip = _usable(r, v)

    outside = usable & (r > tr[:, None])
    has_outside = outside.any(1)
    i = _first_true(outside)
    any_usable = usable.any(1)
    last_usable = torch.where(
        any_usable, K - 1 - _first_true(usable.flip(1)), 0
    )
    total = _take(cum, last_usable)
    im1 = torch.clamp(i - 1, min=0)
    r1 = _take(r, im1)
    M1 = _take(cum, im1)
    r2 = _take(r, i)
    M2 = _take(cum, i)
    interp = M1 + (tr - r1) / (r2 - r1) * (M2 - M1)
    mass_out = torch.where(
        ~has_outside, total, torch.where(i <= nskip, M2, interp)
    )
    return torch.where(any_usable, mass_out, 0.0)

