"""Cell-sorted particle grid: geometry and per-halo cell ranges.

Particles of a chunk are sorted by flat cell key (``stage_ptype``), so a
halo's candidates are the union of the contiguous row ranges of the
cells its search cube overlaps.  ``halo_cell_ranges`` enumerates a
fixed-size cube of cells for a whole batch of halos at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


#: particles per cell of a chunk grid (the JAX package's default)
PARTICLES_PER_CELL = 16.0


def choose_resolution(n_particles: int) -> int:
    """Cells per dimension for a chunk grid: about ``PARTICLES_PER_CELL``
    particles per cell, clipped to [1, 192] cells per dimension, as in
    the JAX package."""
    return int(
        np.clip(round((n_particles / PARTICLES_PER_CELL) ** (1.0 / 3.0)), 1, 192)
    )


@dataclass(frozen=True)
class GridSpec:
    """Static description of a chunk grid."""

    origin: Tuple[float, float, float]
    cell_size: Tuple[float, float, float]
    dims: Tuple[int, int, int]
    periodic: bool  # wrap cell indices (grid covers the full box)

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


def cell_index_of(spec: GridSpec, pos_hi: torch.Tensor) -> torch.Tensor:
    """Flat cell key per particle (row-major over dims), int64."""
    origin = torch.tensor(spec.origin, dtype=pos_hi.dtype, device=pos_hi.device)
    cell = torch.tensor(spec.cell_size, dtype=pos_hi.dtype, device=pos_hi.device)
    dims = torch.tensor(spec.dims, dtype=torch.int64, device=pos_hi.device)
    ijk = torch.floor((pos_hi - origin) / cell).to(torch.int64)
    if spec.periodic:
        ijk = torch.remainder(ijk, dims)
    else:
        ijk = torch.minimum(torch.clamp(ijk, min=0), dims - 1)
    return (ijk[..., 0] * spec.dims[1] + ijk[..., 1]) * spec.dims[2] + ijk[..., 2]


def halo_cell_ranges(
    spec: GridSpec,
    cell_offsets: torch.Tensor,  # (n_cells,) i32
    cell_counts: torch.Tensor,  # (n_cells,) i32
    centre: torch.Tensor,  # (B, 3) f32
    radius: torch.Tensor,  # (B,) f32
    cube: int,  # cells per axis of the search cube
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, counts), each (B, cube**3) i32, of the cube of cells
    overlapping each halo's search sphere.

    Cells of the cube outside the sphere's AABB (or outside a
    non-periodic grid) get count 0; the cell order is z-minor, as in
    ``soap_tpu.ops.grid.halo_cell_ranges``.
    """
    dev = centre.device
    origin = torch.tensor(spec.origin, dtype=torch.float32, device=dev)
    cell = torch.tensor(spec.cell_size, dtype=torch.float32, device=dev)
    dims = torch.tensor(spec.dims, dtype=torch.int64, device=dev)

    r = radius[:, None]
    lo = torch.floor((centre - r - origin) / cell).to(torch.int64)  # (B, 3)
    hi = torch.floor((centre + r - origin) / cell).to(torch.int64)

    ax = torch.arange(cube, dtype=torch.int64, device=dev)
    idx = lo[:, None, :] + ax[None, :, None]  # (B, cube, 3)
    in_span = idx <= hi[:, None, :]
    if spec.periodic:
        wrapped = torch.remainder(idx, dims)
        # avoid double counting when the span exceeds the grid size
        valid_ax = in_span & (ax[None, :, None] < dims)
    else:
        wrapped = torch.minimum(torch.clamp(idx, min=0), dims - 1)
        valid_ax = in_span & (idx >= 0) & (idx < dims)

    wi, wj, wk = wrapped[:, :, 0], wrapped[:, :, 1], wrapped[:, :, 2]
    flat = (
        wi[:, :, None, None] * spec.dims[1] + wj[:, None, :, None]
    ) * spec.dims[2] + wk[:, None, None, :]
    valid = (
        valid_ax[:, :, None, None, 0]
        & valid_ax[:, None, :, None, 1]
        & valid_ax[:, None, None, :, 2]
    )
    flat = flat.reshape(flat.shape[0], -1)
    valid = valid.reshape(valid.shape[0], -1)
    zero = torch.zeros((), dtype=cell_offsets.dtype, device=dev)
    starts = torch.where(valid, cell_offsets[flat], zero)
    counts = torch.where(valid, cell_counts[flat], zero)
    return starts, counts
