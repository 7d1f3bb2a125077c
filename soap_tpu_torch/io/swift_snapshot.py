"""SWIFT snapshot metadata and cell-masked particle reading, on the host.

The port's copy of ``soap_tpu/io/swift_snapshot.py`` (reference
``SOAP/core/swift_cells.py``): ``SnapshotMetadata`` reads a snapshot's
header, cosmology, units, constants, parameters, cell structure and
particle datasets, with "extra input" files (group membership) that add
or override datasets under their own cell layout, and a lower-redshift
reference snapshot for particle types absent at high redshift.
``plan_masked_read`` and ``read_masked_cells`` read the cells a mask
selects, in ascending cell order, with adjacent reads merged up to
``MAX_MERGED_READ_BYTES``.  Positions stay float64.

``h5py`` is imported inside the functions that open files, so importing
this module loads no h5py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from soap_tpu_torch.core.cosmology import Cosmology
from soap_tpu_torch.core.units import Unit, UnitRegistry, unit_from_attributes

#: Maximum size of a merged contiguous read, in bytes
#: (same strategy/size as reference ``swift_cells.py:502``).
MAX_MERGED_READ_BYTES = 20 * 1024 * 1024


def _scalar(v):
    arr = np.asarray(v)
    return arr.reshape(-1)[0] if arr.ndim else arr[()]


@dataclass
class DatasetInfo:
    """Shape/dtype/unit metadata for one particle dataset."""

    name: str
    dtype: np.dtype
    row_shape: Tuple[int, ...]  # shape of one particle's entry
    unit: Unit
    a_exponent: float
    attrs: Dict[str, object] = field(default_factory=dict)
    file_template: Optional[str] = None  # which file set holds it


class SnapshotMetadata:
    """Header/cosmology/units/cell metadata of a SWIFT snapshot.

    Attribute layout follows SWIFT output conventions as consumed by the
    reference (``SOAP/core/swift_cells.py:145-344``).
    """

    def __init__(
        self,
        snap_filename: str,
        extra_filenames: Sequence[str] = (),
        ref_filename: Optional[str] = None,
    ):
        self.snap_filename = snap_filename
        self.extra_filenames = list(extra_filenames)
        self.ref_filename = ref_filename
        import h5py

        fname = snap_filename.format(file_nr=0)
        with h5py.File(fname, "r") as f:
            self.snap_units_cgs = {
                k: float(_scalar(v)) for k, v in f["Units"].attrs.items()
            }
            self.code_units_cgs = {
                k: float(_scalar(v)) for k, v in f["InternalCodeUnits"].attrs.items()
            }
            self.cosmology_attrs = {
                k: float(_scalar(v)) for k, v in f["Cosmology"].attrs.items()
            }
            self.constants_cgs = {
                k: float(_scalar(v))
                for k, v in f["PhysicalConstants/CGS"].attrs.items()
            }
            self.constants_internal = {
                k: float(_scalar(v))
                for k, v in f["PhysicalConstants/InternalUnits"].attrs.items()
            }
            self.parameters = dict(f["Parameters"].attrs) if "Parameters" in f else {}
            self.header = {k: v for k, v in f["Header"].attrs.items()}

            self.a = float(self.cosmology_attrs.get("Scale-factor", 1.0))
            self.h = float(self.cosmology_attrs.get("h", 1.0))
            self.z = 1.0 / self.a - 1.0
            self.cosmology = Cosmology.from_attrs(self.cosmology_attrs)

            self.snipshot = (
                _decode(self.header.get("SelectOutput", b"")) == "Snipshot"
            )
            self.boxsize = float(_scalar(self.header["BoxSize"]))
            self.nr_files = int(_scalar(self.header["NumFilesPerSnapshot"]))

            # Cell structure
            self.nr_cells = int(_scalar(f["Cells/Meta-data"].attrs["nr_cells"]))
            self.dimension = np.asarray(
                f["Cells/Meta-data"].attrs["dimension"], dtype=np.int64
            ).reshape(3)
            self.cell_size = np.asarray(
                f["Cells/Meta-data"].attrs["size"], dtype=np.float64
            ).reshape(3)
            self.cell_centres = f["Cells/Centres"][...].astype(np.float64)
            self.ptypes: List[str] = list(f["Cells/Counts"].keys())
            self.cell_counts: Dict[str, np.ndarray] = {}
            self.cell_offsets: Dict[str, np.ndarray] = {}
            self.cell_files: Dict[str, np.ndarray] = {}
            for ptype in self.ptypes:
                self.cell_counts[ptype] = f["Cells/Counts"][ptype][...].astype(
                    np.int64
                )
                self.cell_offsets[ptype] = f["Cells/OffsetsInFile"][ptype][
                    ...
                ].astype(np.int64)
                if "Files" in f["Cells"]:
                    self.cell_files[ptype] = f["Cells/Files"][ptype][...].astype(
                        np.int32
                    )
                else:
                    self.cell_files[ptype] = np.zeros(self.nr_cells, np.int32)

        self.units = UnitRegistry.from_snapshot_metadata(self)

        # Derived cosmological densities, in internal (code) units converted
        # to snapshot units (reference: ``swift_cells.py:222-274``).
        code_density = self.units.units["code_mass"] / (
            self.units.units["code_length"] ** 3
        )
        snap_density = self.units.units["snap_mass"] / (
            self.units.units["snap_length"] ** 3
        )
        to_snap = code_density.conversion_to(snap_density)
        self.critical_density = (
            float(self.cosmology_attrs["Critical density [internal units]"])
            * to_snap
        )  # physical, snapshot units
        G_int = self.constants_internal["newton_G"]
        self.mean_density = self.cosmology.mean_density_internal(G_int) * to_snap
        self.virBN98 = self.cosmology.bn98_virial_multiple()

        # Softening lengths (physical, snapshot length units);
        # reference: ``swift_cells.py:234-247``.
        code_length = self.units.units["code_length"]
        snap_length = self.units.units["snap_length"]
        to_snap_l = code_length.conversion_to(snap_length)

        def _param(name, default=0.0):
            raw = self.parameters.get(name, default)
            return float(_scalar(raw) if not isinstance(raw, bytes) else raw)

        self.dark_matter_softening = (
            min(
                _param("Gravity:comoving_DM_softening") * self.a,
                _param("Gravity:max_physical_DM_softening"),
            )
            * to_snap_l
        )
        self.baryon_softening = (
            min(
                _param("Gravity:comoving_baryon_softening") * self.a,
                _param("Gravity:max_physical_baryon_softening"),
            )
            * to_snap_l
        )
        self.nu_softening = (
            min(
                _param("Gravity:comoving_nu_softening") * self.a,
                _param("Gravity:max_physical_nu_softening"),
            )
            * to_snap_l
        )
        self.AGN_delta_T = _param("EAGLEAGN:AGN_delta_T_K")

        # Lightcone observer position, defaults to box centre
        # (reference: ``swift_cells.py:291-307``).
        obs = self.parameters.get("Lightcone0:observer_position")
        if obs is not None:
            txt = _decode(obs)
            self.observer_position = np.array(
                [float(x) for x in txt.strip("[]").split(",")], dtype=np.float64
            )
        else:
            self.observer_position = np.full(3, 0.5 * self.boxsize)

        # Named-column metadata (SubgridScheme/NamedColumns): maps a
        # dataset name to its column labels (reference:
        # ``SOAP/core/snapshot_datasets.py:70-90``)
        self.named_columns: Dict[str, list] = {}
        with h5py.File(fname, "r") as f:
            if "SubgridScheme" in f and "NamedColumns" in f["SubgridScheme"]:
                for dset in f["SubgridScheme"]["NamedColumns"]:
                    self.named_columns[dset] = [
                        v.decode() if isinstance(v, bytes) else str(v)
                        for v in f["SubgridScheme"]["NamedColumns"][dset][:]
                    ]

        # Dataset metadata from snapshot + extra files
        self.datasets: Dict[str, Dict[str, DatasetInfo]] = {
            ptype: {} for ptype in self.ptypes
        }
        # per-file-set cell layouts: extra-input files may distribute the
        # same particles over files differently than the snapshot, so
        # read planning must use each template's own Cells metadata
        self.template_layouts: Dict[str, Dict[str, tuple]] = {
            self.snap_filename: {
                pt: (
                    self.cell_counts[pt],
                    self.cell_offsets[pt],
                    self.cell_files[pt],
                )
                for pt in self.ptypes
            }
        }
        self._scan_datasets(self.snap_filename)
        for extra in self.extra_filenames:
            self._scan_datasets(extra)
            self._scan_cell_layout(extra)

        # reference-snapshot mechanism for particle types absent at high z
        # (reference ``swift_cells.py:374-404,705-722``): dataset
        # names/dtypes/shapes/units come from a lower-z snapshot of the
        # same run; reads of these types return empty arrays
        self.ref_ptypes: List[str] = []
        if ref_filename is not None:
            self._register_reference_snapshot(ref_filename)

    def _register_reference_snapshot(self, ref_template: str):
        import h5py

        fname = ref_template.format(file_nr=0)
        with h5py.File(fname, "r") as f:
            ref_pts = list(f["Cells/Counts"].keys())
        missing = [
            pt
            for pt in ref_pts
            if pt not in self.ptypes or not self.datasets.get(pt)
        ]
        if not missing:
            return
        for pt in missing:
            if pt not in self.ptypes:
                self.ptypes.append(pt)
            self.cell_counts[pt] = np.zeros(self.nr_cells, np.int64)
            self.cell_offsets[pt] = np.zeros(self.nr_cells, np.int64)
            self.cell_files[pt] = np.zeros(self.nr_cells, np.int32)
            self.template_layouts[self.snap_filename][pt] = (
                self.cell_counts[pt],
                self.cell_offsets[pt],
                self.cell_files[pt],
            )
            self.datasets.setdefault(pt, {})
            self.ref_ptypes.append(pt)
        # dataset metadata from the reference file; file_template=None
        # marks the dataset as absent (reads yield empty arrays)
        with h5py.File(fname, "r") as f:
            for pt in missing:
                if pt not in f:
                    continue
                for name, ds in f[pt].items():
                    if not isinstance(ds, h5py.Dataset):
                        continue
                    attrs = dict(ds.attrs)
                    try:
                        unit = unit_from_attributes(attrs, self.units)
                        a_exp = float(_scalar(attrs["a-scale exponent"]))
                    except KeyError:
                        unit = Unit((0.0,) * 5, 1.0, 0.0)
                        a_exp = 0.0
                    self.datasets[pt].setdefault(
                        name,
                        DatasetInfo(
                            name=name,
                            dtype=ds.dtype,
                            row_shape=tuple(ds.shape[1:]),
                            unit=unit,
                            a_exponent=a_exp,
                            attrs=attrs,
                            file_template=None,
                        ),
                    )
            # named columns may also only exist in the reference snapshot
            if "SubgridScheme" in f and "NamedColumns" in f["SubgridScheme"]:
                for dset in f["SubgridScheme"]["NamedColumns"]:
                    self.named_columns.setdefault(
                        dset,
                        [
                            v.decode() if isinstance(v, bytes) else str(v)
                            for v in f["SubgridScheme"]["NamedColumns"][dset][:]
                        ],
                    )

    def _scan_cell_layout(self, file_template: str):
        import h5py

        fname = file_template.format(file_nr=0)
        layouts = {}
        with h5py.File(fname, "r") as f:
            if "Cells" in f and "Counts" in f["Cells"]:
                for pt in f["Cells/Counts"]:
                    layouts[pt] = (
                        f["Cells/Counts"][pt][...].astype(np.int64),
                        f["Cells/OffsetsInFile"][pt][...].astype(np.int64),
                        f["Cells/Files"][pt][...].astype(np.int32)
                        if "Files" in f["Cells"]
                        else np.zeros(self.nr_cells, np.int32),
                    )
        if layouts:
            self.template_layouts[file_template] = layouts
        else:
            # no cell metadata: assume the snapshot's layout
            self.template_layouts[file_template] = self.template_layouts[
                self.snap_filename
            ]

    # ------------------------------------------------------------------
    def _scan_datasets(self, file_template: str):
        """Record name/shape/dtype/unit for every particle dataset.

        Later file sets override earlier ones for identically named
        datasets — the reference's "extra input" mechanism
        (``swift_cells.py:350-372``).
        """
        import h5py

        fname = file_template.format(file_nr=0)
        with h5py.File(fname, "r") as f:
            for ptype in self.ptypes:
                if ptype not in f:
                    continue
                group = f[ptype]
                for name, ds in group.items():
                    if not isinstance(ds, h5py.Dataset):
                        continue
                    attrs = dict(ds.attrs)
                    try:
                        unit = unit_from_attributes(attrs, self.units)
                        a_exp = float(_scalar(attrs["a-scale exponent"]))
                    except KeyError:
                        unit = Unit((0.0,) * 5, 1.0, 0.0)
                        a_exp = 0.0
                    self.datasets[ptype][name] = DatasetInfo(
                        name=name,
                        dtype=ds.dtype,
                        row_shape=tuple(ds.shape[1:]),
                        unit=unit,
                        a_exponent=a_exp,
                        attrs=attrs,
                        file_template=file_template,
                    )

    # ------------------------------------------------------------------
    def cell_grid_index(self, pos: np.ndarray) -> np.ndarray:
        """Map positions to flat top-level-cell indices (row-major)."""
        dim = self.dimension
        ijk = np.floor(pos / self.cell_size[None, :]).astype(np.int64)
        ijk %= dim[None, :]
        return (ijk[:, 0] * dim[1] + ijk[:, 1]) * dim[2] + ijk[:, 2]

    def mask_cells_for_spheres(
        self,
        centres: np.ndarray,
        radii: np.ndarray,
        select: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """``mask_cells_for_spheres`` over this snapshot's cells."""
        return mask_cells_for_spheres(
            self.cell_centres, self.cell_size, self.boxsize, centres, radii, select
        )


def mask_cells_for_spheres(
    cell_centres: np.ndarray,  # (nr_cells, 3) comoving
    cell_size: np.ndarray,  # (3,) comoving
    boxsize: float,
    centres: np.ndarray,  # (H, 3) comoving
    radii: np.ndarray,  # (H,) or scalar, comoving
    select: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Boolean mask over cells intersecting any (centre, radius) AABB.

    Equivalent of the reference's ``mask_cells``
    (``SOAP/core/mask_cells.py:6-38``): each halo marks the cells whose
    centres lie within ``radius`` plus half a cell of its centre along
    each axis, with periodic wrapping.
    """
    mask = np.zeros(len(cell_centres), dtype=bool)
    if select is not None:
        centres = centres[select]
        radii = radii[select]
    if len(centres) == 0:
        return mask
    half = 0.5 * np.asarray(cell_size)
    for c, r in zip(centres, np.broadcast_to(radii, (len(centres),))):
        d = np.abs(cell_centres - c[None, :])
        d = np.minimum(d, boxsize - d)
        mask |= np.all(d <= (r + half)[None, :], axis=1)
    return mask


def _decode(v) -> str:
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return v.reshape(-1)[0].decode()
    return str(v)


# ----------------------------------------------------------------------
# Read planning and execution
# ----------------------------------------------------------------------


@dataclass
class ReadSegment:
    """One contiguous row range of one dataset in one file."""

    file_nr: int
    file_offset: int  # first row in the file
    mem_offset: int  # first row in the output array
    count: int


def plan_masked_read(
    meta: SnapshotMetadata,
    ptype: str,
    mask: np.ndarray,
    layout: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, List[ReadSegment], int]:
    """Build merged read segments for the masked cells of one ptype.

    Returns (selected cell indices in ascending cell order, segments,
    total rows).  Output rows follow the CANONICAL order — ascending cell
    index, so every file set holding the same particles in a different
    file layout produces identically ordered arrays (extra-input files
    may split particles across files differently than the snapshot).
    Reads are still issued in (file, offset) order with adjacent ranges
    merged up to ``MAX_MERGED_READ_BYTES``, the reference's strategy
    (``swift_cells.py:477-531``); a merge additionally requires the
    destination rows to be contiguous.
    """
    if layout is None:
        counts_all = meta.cell_counts[ptype]
        offsets_all = meta.cell_offsets[ptype]
        files_all = meta.cell_files[ptype]
    else:
        counts_all, offsets_all, files_all = layout
    idx = np.flatnonzero(mask)
    counts = counts_all[idx]
    keep = counts > 0
    idx, counts = idx[keep], counts[keep]
    offsets = offsets_all[idx]
    files = files_all[idx]
    # canonical destination rows: ascending cell index
    mem_offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    total = int(counts.sum())
    order = np.lexsort((offsets, files))

    segments: List[ReadSegment] = []
    bytes_per_row = 8 * 3  # conservative (float64 vec3) for the merge cap
    for i in order:
        if (
            segments
            and files[i] == segments[-1].file_nr
            and offsets[i] == segments[-1].file_offset + segments[-1].count
            and mem_offsets[i] == segments[-1].mem_offset + segments[-1].count
            and (segments[-1].count + counts[i]) * bytes_per_row
            <= MAX_MERGED_READ_BYTES
        ):
            segments[-1].count += int(counts[i])
        else:
            segments.append(
                ReadSegment(
                    int(files[i]),
                    int(offsets[i]),
                    int(mem_offsets[i]),
                    int(counts[i]),
                )
            )
    return idx, segments, total


def read_masked_cells(
    meta: SnapshotMetadata,
    mask: np.ndarray,
    properties: Mapping[str, Sequence[str]],
) -> Dict[str, Dict[str, np.ndarray]]:
    """Read the requested datasets for all cells selected by ``mask``.

    ``properties`` maps ptype -> dataset names.  Returns
    data[ptype][name] = contiguous numpy array over the selected cells, in
    (file, offset) read order — the same particle order for every dataset
    of a ptype, which downstream code relies on.

    Reference equivalent: ``read_masked_cells_to_shared_memory``
    (``swift_cells.py:548-734``) minus MPI and shared memory.
    """
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    # Plans are built PER FILE TEMPLATE (snapshot vs extra inputs may
    # have different file layouts); the canonical output row order
    # (ascending cell index) makes every template's arrays line up.
    for ptype, names in properties.items():
        if ptype not in meta.datasets:
            continue
        plans: Dict[str, Tuple[np.ndarray, List[ReadSegment], int]] = {}
        by_file: Dict[Tuple[str, int], List[Tuple[str, ReadSegment]]] = {}
        arrays: Dict[str, np.ndarray] = {}
        cell_idx = None
        for name in names:
            info = meta.datasets[ptype].get(name)
            if info is None:
                raise KeyError(f"dataset {ptype}/{name} not present in inputs")
            template = info.file_template
            if template is None:
                # absent ptype registered from the reference snapshot:
                # empty array with the right dtype/shape, no file access
                plans.setdefault(None, (np.zeros(0, np.int64), [], 0))
            elif template not in plans:
                layout = meta.template_layouts.get(template, {}).get(ptype)
                plans[template] = plan_masked_read(
                    meta, ptype, mask, layout=layout
                )
            t_cells, segments, total = plans[template]
            if cell_idx is None:
                cell_idx = t_cells
            arrays[name] = np.empty((total,) + info.row_shape, dtype=info.dtype)
            for seg in segments:
                by_file.setdefault((template, seg.file_nr), []).append(
                    (name, seg)
                )
        for (template, file_nr), work in sorted(by_file.items()):
            with h5py.File(template.format(file_nr=file_nr), "r") as f:
                group = f[ptype]
                for name, seg in work:
                    ds = group[name]
                    ds.read_direct(
                        arrays[name],
                        np.s_[seg.file_offset : seg.file_offset + seg.count],
                        np.s_[seg.mem_offset : seg.mem_offset + seg.count],
                    )
        out[ptype] = arrays
        out[ptype]["__cells__"] = cell_idx
    return out
