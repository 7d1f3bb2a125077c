"""Angular momentum, Vmax and the spin parameter over padded halo slices.

Ported from ``soap_tpu/ops/kinematics.py`` (reference
``SOAP/property_calculation/kinematic_properties.py:228-263`` and
``:555-593``).  Every function takes a leading halo axis: per-particle
(B, K[, 3]) arrays with a (B, K) selection, per-halo (B[, 3]) results.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


def angular_momentum(
    mass: torch.Tensor,  # (B, K)
    pos: torch.Tensor,  # (B, K, 3) relative to the reference position
    vel: torch.Tensor,  # (B, K, 3) relative to the reference velocity
    mask: torch.Tensor,  # (B, K)
) -> torch.Tensor:
    """Mass-weighted angular momentum (B, 3) of the selected particles."""
    m = torch.where(mask, mass, 0.0)
    L = m[..., None] * torch.linalg.cross(pos, vel, dim=-1)
    return torch.where(mask[..., None], L, 0.0).sum(1)


class VmaxResult(NamedTuple):
    radius: torch.Tensor  # (B,) radius of the circular-velocity maximum
    vmax_sq_over_G: torch.Tensor  # (B,) max M(<r)/r; the caller applies G


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return x.gather(1, i[:, None])[:, 0]


def vmax_sorted(
    m: torch.Tensor,  # (B, K) masses in radius-sorted order
    r: torch.Tensor,  # (B, K) radii ascending
    v: torch.Tensor,  # (B, K) selection in the same order
) -> VmaxResult:
    """Vmax from a pre-sorted profile: the cumulative selected mass over
    radius, maximised over the selected rows with non-zero radius."""
    cum = torch.cumsum(torch.where(v, m, 0.0), 1)
    usable = v & ~(torch.abs(r) <= 1e-8)
    ratio = torch.where(usable, cum / torch.clamp(r, min=1e-37), -torch.inf)
    imax = torch.argmax(ratio, 1)
    any_usable = usable.any(1)
    best = _take(ratio, imax)
    return VmaxResult(
        radius=torch.where(any_usable, _take(r, imax), 0.0),
        vmax_sq_over_G=torch.where(any_usable, torch.clamp(best, min=0.0), 0.0),
    )


def vmax_sorted_multi_soft(
    m_sorted: torch.Tensor,  # (B, K) masses in the shared radius order
    r_sorted: torch.Tensor,  # (B, K) unsoftened radii ascending (inf-padded)
    type_masks: Sequence[torch.Tensor],  # per softening value, (B, K) each
    softenings: Tuple[float, ...],  # aligned with type_masks
) -> VmaxResult:
    """Softened Vmax on the shared radius order with per-type softenings.

    ``max(r_i, s_t) <= x`` iff ``r_i <= x`` and ``s_t <= x``, so the
    softened cumulative mass is a sum of per-type cumsums in the existing
    order, each gated by its softening.  Candidates, as in the reference:
    a selected particle's own radius where it is at least its softening,
    and each softening value below which some selected particle of that
    type lies."""
    cums = [torch.cumsum(torch.where(tm, m_sorted, 0.0), 1) for tm in type_masks]
    finite = torch.isfinite(r_sorted)
    M_r = torch.zeros_like(cums[0])
    own_point = torch.zeros_like(type_masks[0])
    for s, tm, cu in zip(softenings, type_masks, cums):
        gate = s <= r_sorted
        M_r = M_r + torch.where(gate, cu, 0.0)
        own_point = own_point | (tm & gate)
    usable = own_point & finite & (r_sorted > 1e-8)
    ratio = torch.where(usable, M_r / torch.clamp(r_sorted, min=1e-37), -torch.inf)
    imax = torch.argmax(ratio, 1)
    any_usable = usable.any(1)
    best = _take(ratio, imax)
    best_x = _take(r_sorted, imax)
    for t, s in enumerate(softenings):
        if s <= 1e-8:
            continue
        sf = torch.tensor(s, dtype=torch.float32, device=r_sorted.device)
        present = (type_masks[t] & (r_sorted <= sf)).any(1)
        idx = torch.searchsorted(
            r_sorted.contiguous(), sf.expand(r_sorted.shape[0], 1).contiguous(),
            right=True,
        )[:, 0]
        M_s = torch.zeros_like(best)
        for su, cu in zip(softenings, cums):
            if su <= s:
                M_s = M_s + torch.where(idx > 0, _take(cu, torch.clamp(idx - 1, min=0)), 0.0)
        val = torch.where(present, M_s / sf, -torch.inf)
        better = val > torch.where(any_usable, best, -torch.inf)
        best = torch.where(better, val, best)
        best_x = torch.where(better, sf, best_x)
        any_usable = any_usable | present
    return VmaxResult(
        radius=torch.where(any_usable, best_x, 0.0),
        vmax_sq_over_G=torch.where(any_usable, torch.clamp(best, min=0.0), 0.0),
    )


def spin_parameter(
    L_norm: torch.Tensor,  # (B,) |L| within radius R
    mass: torch.Tensor,  # (B,) mass within R
    radius: torch.Tensor,  # (B,) R
    newton_G: float,
) -> torch.Tensor:
    """Bullock et al. (2001): |L| / (sqrt(2) M V R) with V = sqrt(G M / R)."""
    denom = torch.sqrt(2.0 * newton_G * mass**3 * radius)
    return torch.where(denom > 0, L_norm / torch.clamp(denom, min=1e-37), 0.0)
