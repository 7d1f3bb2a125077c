"""A chunk's particle inputs on the host, then staged on a device.

The port's copies of ``soap_tpu/pipeline/chunks.py``'s
``required_datasets``, of its one-chunk read and of the host-side
``StellarAges`` derivation.  ``read_chunk_fields`` reads what the JAX
run reads from a snapshot and its membership file for one chunk: the
cells within ``READ_MARGIN`` search radii of any halo, each particle
type in ascending cell order, serially.  ``mock_fields`` builds what
that read hands over for a mock universe with every cell read, in
memory with no file and no h5py.  ``stage_chunk`` stages either on a
device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.io import swift_snapshot
from soap_tpu_torch.pipeline.chunk_data import ChunkData, stage_ptype
from soap_tpu_torch.pipeline.engine import READ_RADIUS_FACTOR, min_physical_radius
from soap_tpu_torch.utils.mock_data import MOCK_CELLS_PER_DIM

#: fields every run reads per particle type (the DMO tier)
BASE_FIELDS = ["Coordinates", "Masses", "Velocities", "GroupNr_bound", "FOFGroupIDs"]

#: factor applied to search radii when masking cells to read: leaves head
#: room for the engine's x1.5 retry ladder without re-reading
READ_MARGIN = 4.0


def required_datasets(specs, meta) -> Dict[str, List[str]]:
    """Union of the particle datasets the specs' keys need, from the
    property table's ``particle_properties``, restricted to datasets
    present in ``meta.datasets``."""
    table = full_property_table()
    out: Dict[str, List[str]] = {}
    for spec in specs:
        for key in spec.keys:
            if key not in table:
                continue
            for ds in table[key].particle_properties:
                ptype, name = ds.split("/", 1)
                if ptype in meta.datasets and name in meta.datasets[ptype]:
                    out.setdefault(ptype, [])
                    if name not in out[ptype]:
                        out[ptype].append(name)
    return out


def fields_per_type(specs, meta, ptypes: Sequence[str]) -> Dict[str, List[str]]:
    """Per particle type: the base fields it has, then the datasets the
    specs need, in the order the JAX run reads them."""
    out = {pt: [f for f in BASE_FIELDS if f in meta.datasets[pt]] for pt in ptypes}
    for pt, names in required_datasets(specs, meta).items():
        for n in names:
            if n not in out.get(pt, []):
                out.setdefault(pt, []).append(n)
    return out


def stellar_ages(
    birth_a: np.ndarray, age_table: Tuple[np.ndarray, np.ndarray], a: float
) -> np.ndarray:
    """Per-star age at scale factor ``a`` from the birth scale factor,
    through the a -> age table (internal time units), floored at 0."""
    age_a, age_t = age_table
    t_now = np.interp(float(a), age_a, age_t)
    return np.maximum(t_now - np.interp(birth_a, age_a, age_t), 0.0).astype(np.float32)


def read_chunk_fields(
    meta: swift_snapshot.SnapshotMetadata,
    cat,
    specs,
    ptypes: Sequence[str],
    age_table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Dict[str, Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """{ptype: (comoving positions (N, 3) f64 in [0, box), {dataset: array})}
    read from the snapshot and its extra inputs for the halos of ``cat``
    (a ``HaloCatalogue``), as ``mock_fields`` returns them: the cells
    within ``READ_MARGIN`` search radii of a halo (at least two retry
    steps past the largest fixed physical radius), plus half a cell;
    ``fields_per_type``'s datasets; the derived ``StellarAges`` when
    ``age_table`` is given."""
    floor_com = min_physical_radius(specs) / meta.a
    mask = meta.mask_cells_for_spheres(
        np.mod(cat.cofp, meta.boxsize),
        np.maximum(cat.search_radius * READ_MARGIN, floor_com * READ_RADIUS_FACTOR**2)
        + 0.5 * float(np.max(meta.cell_size)),
    )
    data = swift_snapshot.read_masked_cells(meta, mask, fields_per_type(specs, meta, ptypes))
    out = {}
    for pt in ptypes:
        fields = {
            name: arr for name, arr in data[pt].items()
            if name not in ("Coordinates", "__cells__")
        }
        if pt == "PartType4" and age_table is not None and "BirthScaleFactors" in fields:
            fields["StellarAges"] = stellar_ages(fields["BirthScaleFactors"], age_table, meta.a)
        out[pt] = (np.mod(data[pt]["Coordinates"], meta.boxsize), fields)
    return out


def _snapshot_order(pos: np.ndarray, boxsize: float) -> np.ndarray:
    """The permutation the mock snapshot stores a particle type in: a
    stable sort by top-level cell (row-major flat index)."""
    n = MOCK_CELLS_PER_DIM
    ijk = np.floor(pos / (boxsize / n)).astype(np.int64) % n
    flat = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
    return np.argsort(flat, kind="stable")


def mock_fields(
    uni,
    specs,
    meta,
    ptypes: Sequence[str],
    age_table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Dict[str, Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """{ptype: (comoving positions (N, 3) f64 in [0, box), {dataset: array})}
    for a mock universe, as the JAX run reads them from its snapshot and
    membership file with every cell selected: the snapshot's cell order,
    the stored dtypes, ``fields_per_type``'s datasets (``Coordinates``
    apart), ``GroupNr_bound`` from the bound particle lists, and the
    derived ``StellarAges`` when ``age_table`` is given."""
    stored = {
        "PartType1": {
            "Coordinates": uni.pos,
            "Velocities": uni.vel.astype(np.float32),
            "Masses": uni.mass.astype(np.float32),
            "ParticleIDs": uni.ids,
            "FOFGroupIDs": uni.fof_ids,
        }
    }
    stored.update(uni.extra_ptypes or {})
    # membership: the catalogue index of the halo each particle is bound to
    all_ids = np.concatenate([np.asarray(d["ParticleIDs"]) for d in stored.values()])
    id_to_halo = np.full(int(all_ids.max()) + 1, -1, np.int64)
    for hi, ids in enumerate(uni.bound_ids):
        id_to_halo[np.asarray(ids, np.int64)] = hi
    wanted = fields_per_type(specs, meta, ptypes)
    out = {}
    for pt in ptypes:
        data = stored[pt]
        order = _snapshot_order(np.asarray(data["Coordinates"]), uni.boxsize)
        fields = {}
        for name in wanted[pt]:
            if name == "Coordinates":
                continue
            if name == "GroupNr_bound":
                ids = np.asarray(data["ParticleIDs"], np.int64)[order]
                fields[name] = id_to_halo[ids]
            else:
                fields[name] = np.asarray(data[name])[order]
        if pt == "PartType4" and age_table is not None and "BirthScaleFactors" in fields:
            fields["StellarAges"] = stellar_ages(fields["BirthScaleFactors"], age_table, meta.a)
        pos = np.mod(np.asarray(data["Coordinates"])[order], uni.boxsize)
        out[pt] = (pos, fields)
    return out


def stage_chunk(
    host: Dict[str, Tuple[np.ndarray, Dict[str, np.ndarray]]],
    boxsize: float,
    device: torch.device,
) -> ChunkData:
    """``mock_fields``' output staged per particle type on ``device``."""
    return ChunkData(
        boxsize=float(boxsize),
        ptypes={
            pt: stage_ptype(pos, fields, boxsize, device)
            for pt, (pos, fields) in host.items()
        },
    )
