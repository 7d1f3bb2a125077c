"""Angular momentum, kappa_corot, cylindrical velocities, Vmax and the
spin parameter over padded halo slices.

Ported from ``soap_tpu/ops/kinematics.py`` (reference
``SOAP/property_calculation/kinematic_properties.py`` and
``cylindrical_coordinates.py``).  Every function takes a leading halo
axis: per-particle (B, K[, 3]) arrays with a (B, K) selection, per-halo
(B[, 3]) results.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from soap_tpu_torch.ops.reductions import masked_sum, particle_mean, particle_sum, prefix_sum


def angular_momentum(
    mass: torch.Tensor,  # (B, K)
    pos: torch.Tensor,  # (B, K, 3) relative to the reference position
    vel: torch.Tensor,  # (B, K, 3) relative to the reference velocity
    mask: torch.Tensor,  # (B, K)
) -> torch.Tensor:
    """Mass-weighted angular momentum (B, 3) of the selected particles."""
    m = torch.where(mask, mass, 0.0)
    L = m[..., None] * torch.linalg.cross(pos, vel, dim=-1)
    return masked_sum(L, mask)


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
    cum = prefix_sum(torch.where(v, m, 0.0))
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
    cums = [prefix_sum(torch.where(tm, m_sorted, 0.0)) for tm in type_masks]
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


class AngularMomentumResult(NamedTuple):
    L: torch.Tensor  # (B, 3) about (pos_ref, vel_ref)
    kappa_corot: torch.Tensor  # (B,)
    m_counterrot: torch.Tensor  # (B,) counter-rotating mass (or weight)


def angular_momentum_and_kappa(
    mass: torch.Tensor,  # (B, K)
    pos: torch.Tensor,  # (B, K, 3) relative to the reference position
    vel: torch.Tensor,  # (B, K, 3) relative to the reference velocity
    mask: torch.Tensor,  # (B, K)
) -> AngularMomentumResult:
    """Weighted L, kappa_corot (Correa+2017) and counter-rotating weight:
    kappa_corot is the co-rotating particles' sum of L_i^2 / (2 m_i R_i^2)
    over the total kinetic energy, particles on the rotation axis
    excluded (reference ``kinematic_properties.py:266-425``)."""
    m = torch.where(mask, mass, 0.0)
    Lpart = m[..., None] * torch.linalg.cross(pos, vel, dim=-1)
    Ltot = masked_sum(Lpart, mask)
    Lnrm = torch.sqrt((Ltot * Ltot).sum(1))
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    K = 0.5 * particle_sum(m * (vx * vx + vy * vy + vz * vz))
    Ldir = Ltot / torch.clamp(Lnrm, min=1e-37)[:, None]
    Li = (
        Lpart[..., 0] * Ldir[:, None, 0]
        + Lpart[..., 1] * Ldir[:, None, 1]
        + Lpart[..., 2] * Ldir[:, None, 2]
    )
    px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
    r2 = px * px + py * py + pz * pz
    rdotL = px * Ldir[:, None, 0] + py * Ldir[:, None, 1] + pz * Ldir[:, None, 2]
    Ri2 = r2 - rdotL * rdotL
    on_axis = Ri2 == 0.0
    Krot = 0.5 * Li * Li / (torch.clamp(mass, min=1e-37) * torch.where(on_axis, 1.0, Ri2))
    corot = mask & ~on_axis & (Li > 0.0)
    Kcorot = masked_sum(Krot, corot)
    kappa = torch.where(
        (Lnrm > 0.0) & (K > 0.0), Kcorot / torch.clamp(K, min=1e-37), 0.0
    )
    counter = mask & (Li < 0.0)
    m_counter = torch.where(Lnrm > 0.0, masked_sum(mass, counter), 0.0)
    return AngularMomentumResult(Ltot, kappa, m_counter)


def cylindrical_velocities(
    pos: torch.Tensor,  # (B, K, 3) halo-relative positions
    vel: torch.Tensor,  # (B, K, 3) frame-shifted velocities
    L: torch.Tensor,  # (B, 3) the new z axis
) -> torch.Tensor:
    """(v_r, v_phi, v_z) per particle (B, K, 3) in the frame whose z axis
    is L, x from a helper vector not parallel to it (reference
    ``cylindrical_coordinates.py:13-93``)."""
    Lnorm = torch.sqrt(torch.clamp((L * L).sum(1), min=1e-37))
    z = L / Lnorm[:, None]
    hx = torch.tensor([1.0, 0.0, 0.0], dtype=pos.dtype, device=pos.device)
    hy = torch.tensor([0.0, 1.0, 0.0], dtype=pos.dtype, device=pos.device)
    use_y = torch.abs((z * hx).sum(1)) > 0.9
    helper = torch.where(use_y[:, None], hy, hx)
    x = torch.linalg.cross(helper, z, dim=-1)
    x = x / torch.sqrt(torch.clamp((x * x).sum(1), min=1e-37))[:, None]
    y = torch.linalg.cross(z, x, dim=-1)
    R = torch.stack([x, y, z], 1)  # (B, 3, 3): rows are the new axes
    pr, vr3 = _rotate(pos, R), _rotate(vel, R)
    phi = torch.atan2(pr[..., 1], pr[..., 0])
    c, s = torch.cos(phi), torch.sin(phi)
    v_r = vr3[..., 0] * c + vr3[..., 1] * s
    v_phi = -vr3[..., 0] * s + vr3[..., 1] * c
    return torch.stack([v_r, v_phi, vr3[..., 2]], -1)


def _rotate(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(B, K, 3) ``x`` in the frame whose axes are ``R``'s rows: three
    elementwise products and sums in a fixed order, so a particle's
    result does not depend on the batched product a bucket's shape
    would pick."""
    return sum(x[..., d, None] * R[:, None, :, d] for d in range(3))


def weighted_cylindrical_dispersion(
    weights: torch.Tensor,  # (B, K)
    v_cyl: torch.Tensor,  # (B, K, 3)
    mask: torch.Tensor,  # (B, K)
) -> torch.Tensor:
    """[sigma_r, sigma_phi, sigma_z] (B, 3) about the weighted mean
    (reference ``kinematic_properties.py:130-219``)."""
    w = torch.where(mask, weights, 0.0)
    wn = w / torch.clamp(particle_sum(w), min=1e-37)[:, None]
    mean = particle_sum(wn[..., None] * v_cyl)
    var = particle_sum(wn[..., None] * (v_cyl - mean[:, None, :]) ** 2)
    return torch.sqrt(var)


def weighted_rotation_velocity(
    weights: torch.Tensor, v_phi: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Weight-averaged azimuthal velocity (B,) (reference
    ``kinematic_properties.py:35-51``)."""
    w = torch.where(mask, weights, 0.0)
    return particle_mean(w, v_phi, particle_sum(w))


def spin_parameter(
    L_norm: torch.Tensor,  # (B,) |L| within radius R
    mass: torch.Tensor,  # (B,) mass within R
    radius: torch.Tensor,  # (B,) R
    newton_G: float,
) -> torch.Tensor:
    """Bullock et al. (2001): |L| / (sqrt(2) M V R) with V = sqrt(G M / R)."""
    denom = torch.sqrt(2.0 * newton_G * mass**3 * radius)
    return torch.where(denom > 0, L_norm / torch.clamp(denom, min=1e-37), 0.0)
