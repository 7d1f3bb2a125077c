"""Masked reductions over a batch of padded halo slices.

Every function takes a leading halo axis: per-particle arrays are
(B, K) or (B, K, D) with a (B, K) validity/selection mask, and reduce
over the particle axis (ported from ``soap_tpu/ops/reductions.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the particle axis (dim 1), accumulated in
    float64 on every device and rounded back to ``x``'s dtype.  PyTorch's
    CPU kernel accumulates float32 this way already (so the CPU result is
    bit for bit ``torch.cumsum``'s); its CUDA float32 scan associates
    by row length, which would make a halo's SO radius depend on the
    capacity of the bucket it shares with other halos."""
    return torch.cumsum(x, 1, dtype=torch.float64).to(x.dtype)


def particle_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the particle axis (dim 1), accumulated in float64 and
    rounded back to ``x``'s dtype.  PyTorch's CUDA float32 sum
    associates by the reduced length, so a halo's centre-of-mass
    velocity and angular momentum, and with them which particles count
    as co-rotating, would depend on the capacity of the bucket it shares
    with other halos."""
    return x.sum(1, dtype=torch.float64).to(x.dtype)


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of x over the selected particles; x is (B, K) or (B, K, D)."""
    if x.dim() > mask.dim():
        mask = mask[..., None]
    return torch.where(mask, x, 0).sum(1)


def masked_count(mask: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Number of selected particles per halo."""
    return mask.sum(1).to(dtype)


def centre_of_mass(
    mass: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total mass (B,), centre of mass (B, 3)) over the selected
    particles, with halo-relative ``pos``."""
    m = torch.where(mask, mass, 0.0)
    mtot = m.sum(1)
    com = (m[..., None] * pos).sum(1) / torch.clamp(mtot, min=1e-37)[:, None]
    return mtot, torch.where(mtot[:, None] > 0, com, 0.0)


def centre_of_mass_velocity(
    mass: torch.Tensor, vel: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mass-weighted mean velocity (B, 3) of the selected particles."""
    m = torch.where(mask, mass, 0.0)
    mtot = particle_sum(m)
    v = particle_sum(m[..., None] * vel) / torch.clamp(mtot, min=1e-37)[:, None]
    return torch.where(mtot[:, None] > 0, v, 0.0)


def velocity_dispersion_matrix(
    mass: torch.Tensor,  # (B, K)
    vel: torch.Tensor,  # (B, K, 3)
    vcom: torch.Tensor,  # (B, 3)
    mask: torch.Tensor,  # (B, K)
) -> torch.Tensor:
    """Mass-fraction-weighted velocity dispersion matrix (B, 6), in the
    reference's order XX, YY, ZZ, XY, XZ, YZ."""
    m = torch.where(mask, mass, 0.0)
    frac = m / torch.clamp(m.sum(1), min=1e-37)[:, None]
    dv = torch.where(mask[..., None], vel - vcom[:, None, :], 0.0)
    x, y, z = dv[..., 0], dv[..., 1], dv[..., 2]
    return torch.stack(
        [(frac * a * b).sum(1) for a, b in ((x, x), (y, y), (z, z), (x, y), (x, z), (y, z))],
        1,
    )
