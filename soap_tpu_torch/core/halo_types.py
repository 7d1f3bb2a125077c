"""Per-halo-type property key lists and the implemented-subset resolver.

A copy of ``soap_tpu/core/halo_types.py``: the reference's per-class
``property_list`` key lists (``halo_type_property_keys.json``, copied
verbatim) intersected with what the port's slice classes implement
(introspection over their attributes) and, for DMO runs, with the
table's DMO subset.  Keys the port has no method for, such as every
hydro key, stay out by construction.
"""

from __future__ import annotations

import json
from functools import lru_cache
from importlib import resources
from typing import Tuple

from soap_tpu_torch.core.registry import full_property_table


@lru_cache(maxsize=1)
def halo_type_keys() -> dict:
    path = resources.files("soap_tpu_torch.core").joinpath(
        "halo_type_property_keys.json"
    )
    with path.open() as f:
        return json.load(f)


def _slice_class(halo_type: str):
    # late import: the slice module imports this one
    from soap_tpu_torch.models import halo_slice as hs

    return {
        "BoundSubhalo": hs.BoundSubhaloSlice,
        "SO": hs.SOSlice,
        "CoreExcisedSO": hs.SOSlice,
        "Aperture": hs.ApertureSlice,
        "ProjectedAperture": hs.ProjectedApertureSlice,
    }[halo_type]


@lru_cache(maxsize=None)
def implemented_keys_for(halo_type: str, dmo: bool) -> Tuple[str, ...]:
    """The halo type's property keys that are implemented (and DMO-legal)."""
    cls = _slice_class(halo_type)
    table = full_property_table()
    return tuple(
        key
        for key in halo_type_keys()[halo_type]
        if key in table and (table[key].dmo or not dmo) and hasattr(cls, key)
    )
