"""The SOAP catalogue in memory: sorted, converted, unit-annotated.

The port's copy of the array and attribute logic of
``soap_tpu/io/catalogue_writer.py`` (reference
``SOAP/core/combine_chunks.py:206-404``), numpy only.
``make_catalogue`` builds a :class:`Catalogue`: every group's
attributes (the snapshot's ``Header``, ``Cosmology``, ``Units``,
``InternalCodeUnits``, ``PhysicalConstants/CGS``, the ``Code`` and
``Parameters`` provenance, the ``SWIFT`` copies, ``Cells/Meta-data``,
and each halo-type group's mask metadata) and every dataset in write
order (``Cells/*``, ``InputHalos/*`` and the other passthrough columns,
then each halo type's properties) with its attributes: the unit
conversion factors and exponents, description, lossy compression
filter and the ``Masked`` / ``Mask *`` metadata.  Halos are in the
spatial sort order (top-level cell, then catalogue index); a property
stored comoving is the engine's physical value over ``a**a_exponent``,
cast to the table's dtype.  The time stamps and the git hash are fields
of their own, so two catalogues compare without them.
``io/catalogue_writer.py::write_catalogue`` writes one with h5py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

import numpy as np

from soap_tpu_torch.core.registry import PropertyDef, PropertyTable, full_property_table
from soap_tpu_torch.core.units import UnitRegistry, attributes_from_unit


#: the ``Description`` of a per-property ``_time`` dataset, as the JAX
#: writer stores it
TIME_DESCRIPTION = (
    "Compute seconds attributed to this halo for this property's calculation group")


@dataclass
class CatalogueDataset:
    data: np.ndarray
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class Catalogue:
    """A SOAP catalogue file's content: ``groups`` maps each group path to
    its attributes and ``datasets`` each dataset path to its data and
    attributes, both in the order the writer creates them; the header's
    ``SnapshotDate``, ``SOAP git hash`` and ``SOAP date`` and the
    ``Code`` group's ``git_hash`` and ``Date`` come from ``git_hash``,
    ``snapshot_date`` and ``date``."""

    n_halos: int
    groups: Dict[str, Dict[str, object]]
    datasets: Dict[str, CatalogueDataset]
    git_hash: str = "unknown"
    snapshot_date: str = ""  # "%H:%M:%S %Y-%m-%d GMT"
    date: str = ""  # "%Y-%m-%d %H:%M:%S", local time


def spatial_sort_order(
    centres: np.ndarray,  # (H, 3) comoving
    index: np.ndarray,  # (H,) catalogue index
    boxsize: float,
    cells_per_dim: int,
) -> np.ndarray:
    """Sort halos by snapshot top-level cell, then catalogue index
    (``combine_chunks.py:33-61``)."""
    cell_size = boxsize / cells_per_dim
    ijk = np.floor(np.mod(centres, boxsize) / cell_size).astype(np.int64)
    ijk = np.clip(ijk, 0, cells_per_dim - 1)
    flat = (ijk[:, 0] * cells_per_dim + ijk[:, 1]) * cells_per_dim + ijk[:, 2]
    return np.lexsort((index, flat))


def convert_for_output(raw: np.ndarray, prop: PropertyDef, a: float) -> np.ndarray:
    """Physical internal-unit value -> stored catalogue value."""
    value = np.asarray(raw)
    if not prop.physical and prop.a_exponent is not None and prop.a_exponent != 0:
        value = value / a**prop.a_exponent
    return value.astype(prop.dtype, copy=False)


def property_attributes(
    prop: PropertyDef, reg: UnitRegistry, extra_attrs: Optional[Mapping[str, object]] = None
) -> Dict[str, object]:
    """A property dataset's attributes: its unit's (over ``a``'s
    exponent when stored comoving), description, compression filter,
    then ``extra_attrs``."""
    unit = reg.parse(prop.unit)
    if not prop.physical and prop.a_exponent:
        unit = unit * (reg.units["a"] ** prop.a_exponent)
    attrs = attributes_from_unit(unit, prop.physical, prop.a_exponent, reg)
    attrs["Description"] = np.bytes_(prop.description)
    attrs["Lossy compression filter"] = np.bytes_(prop.compression)
    attrs.update(extra_attrs or {})
    return attrs


def make_catalogue(
    snapshot_meta,
    reg: UnitRegistry,
    results: Dict[str, Dict[str, np.ndarray]],  # group -> key -> (H, ...)
    input_halos: Dict[str, np.ndarray],  # passthrough columns by table key
    order: np.ndarray,  # spatial sort permutation
    git_hash: str = "unknown",
    table: Optional[PropertyTable] = None,
    dataset_extra_attrs: Optional[Mapping[str, Mapping[str, object]]] = None,
    group_attrs: Optional[Mapping[str, Mapping[str, object]]] = None,
    run_parameters: Optional[Mapping[str, object]] = None,
    property_timings: Optional[Mapping[str, np.ndarray]] = None,  # group -> (H,) s
) -> Catalogue:
    """The catalogue ``soap_tpu/io/catalogue_writer.py::write_catalogue``
    writes for the same arguments (no ``used_parameters`` text): with
    ``property_timings``, each property of a timed group is followed by
    its ``<name>_time`` dataset, the group's per-halo seconds."""
    if table is None:
        table = full_property_table()
    a = reg.a
    n_halos = len(order)
    groups: Dict[str, Dict[str, object]] = {}
    datasets: Dict[str, CatalogueDataset] = {}

    # --- metadata groups (reference combine_chunks.py:206-316) ---
    n_part_type = int(np.asarray(snapshot_meta.header.get("NumPartTypes", [7])).ravel()[0])
    groups["Header"] = {
        **snapshot_meta.header,
        "Code": np.bytes_("SOAP"),
        "OutputType": np.bytes_("SOAP"),
        "NumFilesPerSnapshot": np.array([1], dtype="int32"),
        "ThisFile": np.array([0], dtype="int32"),
        "NumSubhalos_ThisFile": np.array([n_halos], dtype="int32"),
        "NumSubhalos_Total": np.array([n_halos], dtype="int32"),
        "NumPart_ThisFile": np.zeros(n_part_type, dtype="int32"),
        "NumPart_Total": np.zeros(n_part_type, dtype="uint32"),
        "NumPart_Total_HighWord": np.zeros(n_part_type, dtype="uint32"),
        "SubhaloTypes": sorted(
            {"InputHalos"}
            | set(results)
            | {
                "/".join((table[k].name if k in table else f"InputHalos/{k}")
                         .split("/")[:-1]) or "InputHalos"
                for k in input_halos
            }
        ),
    }
    groups["Cosmology"] = {k: [v] for k, v in snapshot_meta.cosmology_attrs.items()}
    groups["Units"] = {k: [v] for k, v in snapshot_meta.snap_units_cgs.items()}
    groups["InternalCodeUnits"] = {k: [v] for k, v in snapshot_meta.code_units_cgs.items()}
    groups["PhysicalConstants/CGS"] = {k: [v] for k, v in snapshot_meta.constants_cgs.items()}
    # run provenance (reference combine_chunks.py:216-248)
    groups["Code"] = {"Code": np.bytes_("SOAP")}
    groups["Parameters"] = dict(run_parameters or {})
    # full SWIFT metadata copy (reference swift_cells.py:736-751)
    groups["SWIFT/Header"] = dict(snapshot_meta.header)
    groups["SWIFT/Parameters"] = dict(snapshot_meta.parameters)

    # Cells: the catalogue indexed by the snapshot's top-level cells
    # (reference combine_chunks.py:302-316)
    dims = np.asarray(snapshot_meta.dimension, dtype=np.int64)
    nr_cells = int(np.prod(dims))
    cell_size = np.asarray(snapshot_meta.boxsize, dtype=np.float64) / dims
    cofp_sorted = np.mod(np.asarray(input_halos["cofp"])[order], snapshot_meta.boxsize)
    ijk = np.clip(np.floor(cofp_sorted / cell_size).astype(np.int64), 0, dims - 1)
    halo_cell = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    cell_counts = np.bincount(halo_cell, minlength=nr_cells)
    groups["Cells/Meta-data"] = {
        "dimension": dims, "nr_cells": np.array([nr_cells]), "size": cell_size * np.ones(3),
    }
    datasets["Cells/Centres"] = CatalogueDataset(np.asarray(snapshot_meta.cell_centres))
    datasets["Cells/Counts/Subhalos"] = CatalogueDataset(cell_counts)
    datasets["Cells/Files/Subhalos"] = CatalogueDataset(np.zeros(nr_cells, dtype="int32"))
    datasets["Cells/OffsetsInFile/Subhalos"] = CatalogueDataset(
        np.cumsum(cell_counts) - cell_counts)

    # --- InputHalos passthrough (keys present in the property table) ---
    for key, raw in input_halos.items():
        prop = table[key] if key in table else None
        data = np.asarray(raw)[order]
        if prop is None:
            datasets[f"InputHalos/{key}"] = CatalogueDataset(data)
            continue
        name = prop.name if "/" in prop.name else f"InputHalos/{prop.name}"
        datasets[name] = CatalogueDataset(
            data.astype(prop.dtype, copy=False), property_attributes(prop, reg))

    # --- computed halo-type groups ---
    extra = dataset_extra_attrs or {}
    for group, props in results.items():
        timings = (property_timings or {}).get(group)
        for key, raw in props.items():
            prop = table[key]
            full_name = f"{group}/{prop.name}"
            datasets[full_name] = CatalogueDataset(
                convert_for_output(np.asarray(raw)[order], prop, a),
                property_attributes(prop, reg, extra.get(full_name)),
            )
            if timings is not None:
                # (reference ``--record-property-timings``): every property
                # of a group shares its spec program's per-halo seconds
                datasets[f"{full_name}_time"] = CatalogueDataset(
                    np.asarray(timings, np.float32)[order],
                    {"Description": np.bytes_(TIME_DESCRIPTION)},
                )
        # per-variation mask metadata on the group itself
        # (reference combine_chunks.py:365-368)
        groups.setdefault(group, {}).update((group_attrs or {}).get(group, {}))

    return Catalogue(
        n_halos=n_halos,
        groups=groups,
        datasets=datasets,
        git_hash=git_hash,
        snapshot_date=time.strftime("%H:%M:%S %Y-%m-%d GMT", time.gmtime()),
        date=time.strftime("%Y-%m-%d %H:%M:%S"),
    )
