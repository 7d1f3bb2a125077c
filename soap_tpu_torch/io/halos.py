"""The halo catalogue every finder's reader returns.

The port's copy of ``soap_tpu/io/halo_catalogue.py::HaloCatalogue``, in
a module of its own so that ``io/halo_catalogue.py`` (HBTplus and the
dispatch tables) and ``io/finder_readers.py`` (the other four finders)
both build it without importing each other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass
class HaloCatalogue:
    """Host-side halo catalogue ready for the engine."""

    nr_halos: int
    index: np.ndarray  # i64 catalogue row of each halo (pre-filter)
    cofp: np.ndarray  # (H, 3) f64 comoving centre of potential
    search_radius: np.ndarray  # (H,) f64 comoving
    is_central: np.ndarray  # (H,) bool
    nr_bound_part: np.ndarray  # (H,) i64
    fof_id: np.ndarray  # (H,) i64 host FOF group id
    passthrough: Dict[str, np.ndarray] = field(default_factory=dict)

    def select(self, mask: np.ndarray) -> "HaloCatalogue":
        return HaloCatalogue(
            nr_halos=int(mask.sum()),
            index=self.index[mask],
            cofp=self.cofp[mask],
            search_radius=self.search_radius[mask],
            is_central=self.is_central[mask],
            nr_bound_part=self.nr_bound_part[mask],
            fof_id=self.fof_id[mask],
            passthrough={k: v[mask] for k, v in self.passthrough.items()},
        )
