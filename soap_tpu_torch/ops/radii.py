"""Half-weight radii from radius-sorted profiles.

Reference semantics (``SOAP/property_calculation/half_mass_radius.py``,
ported from ``soap_tpu/ops/radii.py``): build the cumulative weight
profile, find the first selected particle where it reaches half the
total, and interpolate linearly within that bin (averaging the bin edges
when both carry the same cumulative weight).  Selections may have gaps
in sorted order, so "previous particle" means the previous SELECTED one.
"""

from __future__ import annotations

import torch

from soap_tpu_torch.ops.reductions import prefix_sum


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 when none)."""
    return torch.argmax(x.to(torch.int8), 1)


def half_weight_radius_sorted(
    r: torch.Tensor,  # (B, K) radii sorted ascending (invalid slots last)
    w: torch.Tensor,  # (B, K) weights in the same order
    v: torch.Tensor,  # (B, K) selection in the same order
    total_weight: torch.Tensor,  # (B,) sum of selected weights
) -> torch.Tensor:
    """Half-weight radius (B,) from pre-sorted profiles."""
    w = torch.where(v, w, 0.0)
    cum = prefix_sum(w)
    target = 0.5 * total_weight
    reached = v & (cum >= target[:, None])
    ihalf = _first_true(reached)[:, None]
    any_reached = reached.any(1)

    r_sel = torch.where(v, r, -torch.inf)
    prev_sel_r = torch.cummax(r_sel, 1).values
    im1 = torch.clamp(ihalf - 1, min=0)
    prev_r_raw = prev_sel_r.gather(1, im1)[:, 0]
    has_prev = ihalf[:, 0] > 0
    prev_r = torch.where(has_prev & torch.isfinite(prev_r_raw), prev_r_raw, 0.0)
    prev_w = torch.where(has_prev, cum.gather(1, im1)[:, 0], 0.0)
    rmax = r.gather(1, ihalf)[:, 0]
    wmax = cum.gather(1, ihalf)[:, 0]

    flat_bin = wmax == prev_w
    interp = prev_r + (target - prev_w) / torch.where(
        flat_bin, 1.0, wmax - prev_w
    ) * (rmax - prev_r)
    result = torch.where(flat_bin, 0.5 * (prev_r + rmax), interp)
    ok = (total_weight > 0) & any_reached
    return torch.where(ok, result, 0.0)


def enclose_radius(radius: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Radius of the furthest selected particle (B,); 0 when none."""
    return torch.where(mask, radius, 0.0).amax(1)
