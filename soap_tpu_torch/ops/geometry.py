"""Position handling: hi/lo float32 splits and periodic wrapping.

Positions are carried as an unevaluated hi+lo float32 pair, split once on
the host, so halo-relative offsets keep full f32 precision of the small
separation (see ``soap_tpu/ops/geometry.py`` for the derivation).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def split_hi_lo(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a float64 host array into (hi, lo) float32 with x == hi + lo."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def periodic_offset(
    pos_hi: torch.Tensor,
    pos_lo: torch.Tensor,
    centre_hi: torch.Tensor,
    centre_lo: torch.Tensor,
    boxsize: float,
) -> torch.Tensor:
    """Offset of particles from a centre, wrapped to the nearest image.

    All inputs are hi/lo f32 pairs that broadcast against each other; the
    wrap is applied to the hi difference, where it is an exact multiple
    of the box.
    """
    d_hi = pos_hi - centre_hi
    d_lo = pos_lo - centre_lo
    box = torch.tensor(boxsize, dtype=torch.float32, device=d_hi.device)
    wrap = torch.round(d_hi / box) * box
    return (d_hi - wrap) + d_lo
