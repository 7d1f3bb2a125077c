"""The property table: per key its output name, dtype, unit and metadata.

A copy of ``soap_tpu/core/property_table.json`` (the reference's
``full_property_list``) as package data: per property key its output
dataset name, per-halo shape, whether a dark-matter-only run computes it
(every key a DMO run skips is a hydro key), the particle datasets it
needs, and what the catalogue writes with it: dtype, unit expression
over the snapshot's base units, a-scale exponent, whether it is stored
physical, description and lossy compression filter; and the footnotes
each property's documentation row cites.  ``build_specs`` (with
``by_output_name`` for parameter files), ``implemented_keys_for``,
``pipeline/chunks.py::required_datasets``, the category filters,
``io/catalogue.py`` and the documentation and empty-catalogue tools read
it.  ``tests/test_torch_host_mirror.py`` holds the copy to the original.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from importlib import resources
from typing import Dict, Optional, Tuple

import numpy as np

_DTYPES = {
    "float32": np.float32,
    "float64": np.float64,
    "int32": np.int32,
    "int64": np.int64,
    "uint32": np.uint32,
    "uint64": np.uint64,
    "bool_": np.bool_,
}

#: Human-readable descriptions of SWIFT lossy compression filters
#: (reference ``SOAP/property_table.py:297-307``).
COMPRESSION_DESCRIPTION = {
    "FMantissa9": "1.36693e10 -> 1.367e10",
    "FMantissa13": "1.36693e10 -> 1.3669e10",
    "DMantissa9": "1.36693e10 -> 1.367e10",
    "DScale6": "1 pc accurate",
    "DScale5": "10 pc accurate",
    "DScale1": "0.1 km/s accurate",
    "Nbit40": "Store less bits",
    "None": "no compression",
}


@dataclass(frozen=True)
class PropertyDef:
    key: str  # internal name used by the slice classes
    name: str  # dataset name in the output file
    shape: int  # per-halo shape (1 = scalar, 3 = vector, 6 = symmetric tensor, ...)
    dmo: bool  # computed in dark-matter-only runs?
    particle_properties: Tuple[str, ...]  # "PartTypeN/<dataset>" it reads
    dtype: np.dtype  # stored dtype
    unit: str  # unit expression over snapshot base units
    description: str
    compression: str  # SWIFT lossy compression filter name
    physical: bool  # stored physical (True) or comoving (False)
    a_exponent: Optional[float]  # a-scale exponent; None = not convertible


class PropertyTable:
    """Dictionary-like access to the property list."""

    def __init__(self, data: dict):
        self._props: Dict[str, PropertyDef] = {
            key: PropertyDef(
                key=key,
                name=e["name"],
                shape=int(e["shape"]),
                dmo=bool(e["dmo_property"]),
                particle_properties=tuple(e["particle_properties"]),
                dtype=np.dtype(_DTYPES[e["dtype"]]),
                unit=e["unit"],
                description=e["description"],
                compression=e["lossy_compression_filter"],
                physical=bool(e["output_physical"]),
                a_exponent=(
                    None if e["a_scale_exponent"] is None else float(e["a_scale_exponent"])
                ),
            )
            for key, e in data["properties"].items()
        }

    def __getitem__(self, key: str) -> PropertyDef:
        return self._props[key]

    def __contains__(self, key: str) -> bool:
        return key in self._props

    def __len__(self) -> int:
        return len(self._props)

    def keys(self):
        return self._props.keys()

    def by_output_name(self, name: str) -> PropertyDef:
        """The first property whose output dataset is ``name``."""
        for p in self._props.values():
            if p.name == name:
                return p
        raise KeyError(name)


@lru_cache(maxsize=1)
def _table_json() -> dict:
    path = resources.files("soap_tpu_torch.core").joinpath("property_table.json")
    with path.open() as f:
        return json.load(f)


@lru_cache(maxsize=1)
def full_property_table() -> PropertyTable:
    return PropertyTable(_table_json())


def footnotes() -> Dict[str, Tuple[str, ...]]:
    """Footnote file name -> the property keys whose rows cite it."""
    return {name: tuple(keys) for name, keys in _table_json()["footnotes"].items()}
