"""The property table's keys, output names, DMO flags and particle datasets.

A trimmed copy of ``soap_tpu/core/property_table.json`` (the reference's
``full_property_list``) as package data: per property key its output
dataset name, whether a dark-matter-only run computes it (every key a
DMO run skips is a hydro key), and the particle datasets it needs, the
fields ``build_specs`` (with ``by_output_name`` for parameter files),
``implemented_keys_for`` and
``pipeline/run.py::required_datasets`` read.
``tests/test_torch_host_mirror.py`` holds the copy to the original.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from importlib import resources
from typing import Dict, Tuple


@dataclass(frozen=True)
class PropertyDef:
    key: str  # internal name used by the slice classes
    name: str  # dataset name in the output file
    dmo: bool  # computed in dark-matter-only runs?
    particle_properties: Tuple[str, ...]  # "PartTypeN/<dataset>" it reads


class PropertyTable:
    """Dictionary-like access to the trimmed property list."""

    def __init__(self, data: dict):
        self._props: Dict[str, PropertyDef] = {
            key: PropertyDef(
                key, e["name"], bool(e["dmo_property"]),
                tuple(e["particle_properties"]),
            )
            for key, e in data["properties"].items()
        }

    def __getitem__(self, key: str) -> PropertyDef:
        return self._props[key]

    def __contains__(self, key: str) -> bool:
        return key in self._props

    def by_output_name(self, name: str) -> PropertyDef:
        """The first property whose output dataset is ``name``."""
        for p in self._props.values():
            if p.name == name:
                return p
        raise KeyError(name)


@lru_cache(maxsize=1)
def full_property_table() -> PropertyTable:
    path = resources.files("soap_tpu_torch.core").joinpath("property_table.json")
    with path.open() as f:
        return PropertyTable(json.load(f))
