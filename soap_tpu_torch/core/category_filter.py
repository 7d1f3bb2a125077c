"""Category filters: which properties are kept per halo.

The port's copy of ``soap_tpu/core/category_filter.py`` (reference
``SOAP/core/category_filter.py``): the categories ``basic`` (always)
and ``general`` / ``gas`` / ``dm`` / ``star`` / ``baryon``, thresholds
on BoundSubhalo particle counts from a parameter file's ``filters``
section (``DEFAULT_FILTERS`` without one); a DMO run counts no baryons.
Every halo is computed and a masked halo's values are zeroed afterwards
(``pipeline/run.py::apply_category_filters``), with the ``Masked`` /
``Mask Datasets`` / ``Mask Threshold`` attributes the reference writes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

DEFAULT_FILTERS = {
    "general": {
        "limit": 100,
        "properties": [
            "BoundSubhalo/NumberOfGasParticles",
            "BoundSubhalo/NumberOfDarkMatterParticles",
            "BoundSubhalo/NumberOfStarParticles",
            "BoundSubhalo/NumberOfBlackHoleParticles",
        ],
        "combine_properties": "sum",
    },
    "baryon": {
        "limit": 100,
        "properties": [
            "BoundSubhalo/NumberOfGasParticles",
            "BoundSubhalo/NumberOfStarParticles",
        ],
        "combine_properties": "sum",
    },
    "dm": {"limit": 100, "properties": ["BoundSubhalo/NumberOfDarkMatterParticles"]},
    "gas": {"limit": 100, "properties": ["BoundSubhalo/NumberOfGasParticles"]},
    "star": {"limit": 100, "properties": ["BoundSubhalo/NumberOfStarParticles"]},
}

#: output dataset name -> property-table key of the count columns
_COUNT_KEYS = {
    "BoundSubhalo/NumberOfGasParticles": "Ngas",
    "BoundSubhalo/NumberOfDarkMatterParticles": "Ndm",
    "BoundSubhalo/NumberOfStarParticles": "Nstar",
    "BoundSubhalo/NumberOfBlackHoleParticles": "Nbh",
}

_BARYON_COUNTS = (
    "BoundSubhalo/NumberOfGasParticles",
    "BoundSubhalo/NumberOfStarParticles",
    "BoundSubhalo/NumberOfBlackHoleParticles",
)


class CategoryFilter:
    """Vectorized category masks over a halo batch."""

    def __init__(self, filters: Optional[Dict] = None, dmo: bool = False):
        self.filters = dict(filters) if filters else dict(DEFAULT_FILTERS)
        self.dmo = dmo

    def category_masks(
        self, subhalo_results: Mapping[str, np.ndarray], n_halos: int
    ) -> Dict[str, np.ndarray]:
        """Per-category keep-mask arrays from BoundSubhalo counts.

        ``subhalo_results`` maps property-table keys ('Ngas', ...) to
        (H,) arrays.
        """

        def count(dataset_name: str) -> np.ndarray:
            if self.dmo and dataset_name in _BARYON_COUNTS:
                return np.zeros(n_halos, dtype=np.int64)
            key = _COUNT_KEYS[dataset_name]
            if key in subhalo_results:
                return np.asarray(subhalo_results[key], dtype=np.int64)
            return np.zeros(n_halos, dtype=np.int64)

        masks = {"basic": np.ones(n_halos, dtype=bool)}
        for name, info in self.filters.items():
            total = np.zeros(n_halos, dtype=np.int64)
            for ds in info["properties"]:
                total += count(ds)
            masks[name] = total >= int(info["limit"])
        return masks

    def filter_metadata(self, category: Optional[str]) -> Dict[str, object]:
        """Masking metadata attributes for one property's category."""
        if category is None or category == "basic" or category not in self.filters:
            return {"Masked": False}
        info = self.filters[category]
        md: Dict[str, object] = {
            "Masked": True,
            "Mask Datasets": [np.bytes_(p) for p in info["properties"]],
            "Mask Threshold": int(info["limit"]),
        }
        if len(info["properties"]) > 1:
            md["Mask Dataset Combination"] = np.bytes_(
                info.get("combine_properties", "sum")
            )
        return md
