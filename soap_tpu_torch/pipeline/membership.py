"""Group-membership program: snapshot particle IDs -> bound-halo labels.

The port's copy of ``soap_tpu/pipeline/membership.py`` (reference
``SOAP/group_membership.py``): every particle ID of the snapshot is
matched against the halo finder's bound-particle lists, and membership
files get ``GroupNr_bound`` (the bound subhalo's index, -1 when
unbound), ``Rank_bound`` (the position in its bound list, -1) and,
optionally, ``SpecificPotentialEnergies`` and ``FOFGroupIDs``.

Output layouts:

 - ``{file_nr}`` in ``output_filename``: one membership file per
   snapshot file, each with that file's rows per particle type (the
   reference's layout);
 - otherwise one file whose rows follow the snapshot's canonical
   (ascending cell) order, with single-file cell metadata; also for a
   multi-file snapshot, since the entry reads membership through its
   cell layout.

The snapshot side is streamed in row batches of ``batch_rows`` (16Mi by
default) against a bound-ID index sorted once, so peak memory is the
halo catalogue plus a batch, whatever the snapshot's size.  The FOF join
holds the FOF snapshot's ID and group columns in memory.

This program is integer joins and file IO with no dense arithmetic, so
it runs on the host with numpy and never touches the GPU, as the
reference keeps it off its accelerator.  ``compute_membership`` and
``compute_fof_groups`` are the in-memory half and need no h5py; the
functions that open files import it.  Only HBTplus catalogues are read.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from soap_tpu_torch.io.halo_catalogue import GROUPNR_READERS

#: snapshot rows matched per batch (the IDs and labels of a batch are
#: small; this bounds peak memory)
BATCH = 16 * 1024 * 1024

#: SWIFT's "not in any FOF group" id (the FOF snapshot writes it for
#: ungrouped particles; unmatched snapshot particles get it too)
FOF_NULL_ID = 2147483647


class SortedIdJoin:
    """Sort-once, probe-many ID join: the haystack is argsorted once, and
    each probe is a vectorised binary search giving each needle's row in
    the haystack's own order, or -1 when it is absent.  As in the
    reference, int64 needles against a uint64 haystack (or the reverse)
    compare as float64, so IDs above 2^53 can miss without an error."""

    def __init__(self, ids: np.ndarray):
        self.n = len(ids)
        if self.n:
            self.order = np.argsort(ids, kind="stable")
            self.sorted_ids = np.asarray(ids)[self.order]

    def probe(self, needles: np.ndarray) -> np.ndarray:
        if self.n == 0 or len(needles) == 0:
            return np.full(len(needles), -1, dtype=np.int64)
        pos = np.searchsorted(self.sorted_ids, needles)
        pos = np.minimum(pos, self.n - 1)
        hit = self.sorted_ids[pos] == needles
        return np.where(hit, self.order[pos], -1)


class _Labeller:
    """Bound-membership labels for one batch of snapshot IDs."""

    def __init__(self, ids_bound, grnr_bound, rank_bound, pot_bound):
        self.join = SortedIdJoin(np.asarray(ids_bound))
        self.grnr = np.asarray(grnr_bound)
        self.rank = None if rank_bound is None else np.asarray(rank_bound)
        self.pot = None if pot_bound is None else np.asarray(pot_bound)

    def __call__(self, snap_ids: np.ndarray):
        rows = self.join.probe(snap_ids)
        hit = rows >= 0
        safe = np.maximum(rows, 0)
        grnr_dtype = self.grnr.dtype if self.grnr.size else np.int64
        grnr = np.where(hit, self.grnr[safe] if self.grnr.size else 0, -1).astype(
            grnr_dtype, copy=False
        )
        rank = np.where(
            hit, self.rank[safe] if self.rank is not None and self.rank.size else 0, -1
        ).astype(np.int32, copy=False)
        pot = None
        if self.pot is not None:
            pot = np.where(hit, self.pot[safe] if self.pot.size else 0.0, 0.0).astype(
                np.float64, copy=False
            )
        return grnr, rank, pot


class _FofLabeller:
    """FOFGroupIDs for one batch of snapshot IDs, matched from a separate
    FOF snapshot."""

    def __init__(self, fof_particle_ids, fof_group_ids):
        self.join = SortedIdJoin(np.asarray(fof_particle_ids))
        self.gids = np.asarray(fof_group_ids)

    def __call__(self, snap_ids: np.ndarray) -> np.ndarray:
        rows = self.join.probe(snap_ids)
        hit = rows >= 0
        safe = np.maximum(rows, 0)
        return np.where(
            hit, self.gids[safe] if self.gids.size else 0, FOF_NULL_ID
        ).astype(self.gids.dtype if self.gids.size else np.int64, copy=False)


def compute_membership(
    snap_ids: np.ndarray,
    ids_bound: np.ndarray,
    grnr_bound: np.ndarray,
    rank_bound: Optional[np.ndarray] = None,
    pot_bound: Optional[np.ndarray] = None,
    batch_rows: int = BATCH,
):
    """(GroupNr_bound, Rank_bound[, SpecificPotentialEnergies]) per
    particle, in memory, ``batch_rows`` snapshot IDs at a time."""
    lab = _Labeller(ids_bound, grnr_bound, rank_bound, pot_bound)
    grnr = np.empty(len(snap_ids), np.int64)
    rank = np.empty(len(snap_ids), np.int32)
    pot = np.empty(len(snap_ids), np.float64) if pot_bound is not None else None
    for a in range(0, len(snap_ids), batch_rows):
        b = min(a + batch_rows, len(snap_ids))
        g, r, p = lab(snap_ids[a:b])
        grnr[a:b] = g
        rank[a:b] = r
        if pot is not None:
            pot[a:b] = p
    return (grnr, rank) if pot is None else (grnr, rank, pot)


def compute_fof_groups(
    snap_ids: np.ndarray,
    fof_particle_ids: np.ndarray,
    fof_group_ids: np.ndarray,
    batch_rows: int = BATCH,
) -> np.ndarray:
    """Per-snapshot-particle FOFGroupIDs from a separate FOF snapshot's
    columns (``FOF_NULL_ID`` where a particle is not there)."""
    lab = _FofLabeller(fof_particle_ids, fof_group_ids)
    out = np.empty(
        len(snap_ids),
        np.asarray(fof_group_ids).dtype if len(fof_group_ids) else np.int64,
    )
    for a in range(0, len(snap_ids), batch_rows):
        b = min(a + batch_rows, len(snap_ids))
        out[a:b] = lab(snap_ids[a:b])
    return out


def _snapshot_files(snap_filename: str) -> List[str]:
    """All files of a (possibly multi-file) snapshot template."""
    import h5py

    first = snap_filename.format(file_nr=0)
    with h5py.File(first, "r") as f:
        n_files = int(np.asarray(f["Header"].attrs["NumFilesPerSnapshot"]).reshape(-1)[0])
    if "{file_nr}" not in snap_filename:
        return [snap_filename]
    return [snap_filename.format(file_nr=i) for i in range(n_files)]


# dataset attributes, as the reference's membership files carry them:
# dimensionless unit metadata and a description per dataset
_UNIT_ATTRS_DIMLESS = {
    "Conversion factor to CGS (not including cosmological corrections)": [1.0],
    "Conversion factor to physical CGS (including cosmological corrections)": [1.0],
    "U_I exponent": [0.0],
    "U_L exponent": [0.0],
    "U_M exponent": [0.0],
    "U_t exponent": [0.0],
    "U_T exponent": [0.0],
    "a-scale exponent": [0.0],
    "h-scale exponent": [0.0],
    "Property can be converted to comoving": [0],
    "Value stored as physical": [1],
}
# (km/s)^2 specific potential energies, in the halo finder's units
_UNIT_ATTRS_POT = dict(
    _UNIT_ATTRS_DIMLESS,
    **{
        "Conversion factor to CGS (not including cosmological corrections)": [1.0e10],
        "Conversion factor to physical CGS (including cosmological corrections)": [1.0e10],
        "U_L exponent": [2.0],
        "U_t exponent": [-2.0],
    },
)

_DESCRIPTIONS = {
    "GroupNr_bound": "Index of halo in which this particle is a bound "
    "member, or -1 if none",
    "Rank_bound": "Ranking by binding energy of the bound particles "
    "(first in halo=0), or -1 if not bound",
    "SpecificPotentialEnergies": "Specific potential energy of the bound "
    "particles, (km/s)^2; 0 for unbound particles",
    "FOFGroupIDs": "Friends-Of-Friends ID of the group the particles "
    f"belong to, matched from the FOF snapshot; {FOF_NULL_ID} if none",
}


def _create_labelled_dataset(group, name, n, dtype):
    ds = group.create_dataset(name, shape=(n,), dtype=dtype)
    ds.attrs["Description"] = np.bytes_(_DESCRIPTIONS[name])
    attrs = _UNIT_ATTRS_POT if name == "SpecificPotentialEnergies" else _UNIT_ATTRS_DIMLESS
    for k, v in attrs.items():
        ds.attrs[k] = np.array(v, dtype=np.float64 if isinstance(v[0], float) else np.int32)
    return ds


def _membership_header(snap0, provenance: Dict[str, object]):
    """Header attributes of a membership file, from the snapshot's first
    file (an open h5py file) and the run's provenance."""
    header = {}
    for attr in (
        "BoxSize",
        "Dimension",
        "NumFilesPerSnapshot",
        "NumPartTypes",
        "NumPart_Total",
        "NumPart_Total_HighWord",
        "Redshift",
        "RunName",
        "Scale-factor",
    ):
        if attr in snap0["Header"].attrs:
            header[attr] = snap0["Header"].attrs[attr]
    header["Code"] = "SOAP"
    header["OutputType"] = "Membership"
    header["SnapshotDate"] = time.strftime("%H:%M:%S %Y-%m-%d GMT", time.gmtime())
    header.update(provenance)
    return header


def _ptype_datasets(g, n, labeller, fof_lab, with_potentials):
    """The membership datasets of one particle type's group ``g``, ``n``
    rows each: (GroupNr_bound, Rank_bound, SpecificPotentialEnergies or
    None, FOFGroupIDs or None)."""
    ds_grnr = _create_labelled_dataset(g, "GroupNr_bound", n, labeller.grnr.dtype)
    ds_rank = _create_labelled_dataset(g, "Rank_bound", n, np.int32)
    ds_pot = (
        _create_labelled_dataset(g, "SpecificPotentialEnergies", n, np.float64)
        if with_potentials
        else None
    )
    ds_fof = (
        _create_labelled_dataset(
            g, "FOFGroupIDs", n, fof_lab.gids.dtype if fof_lab.gids.size else np.int64
        )
        if fof_lab is not None
        else None
    )
    return ds_grnr, ds_rank, ds_pot, ds_fof


def _label_rows(datasets, a, b, ids, labeller, fof_lab):
    """Label snapshot rows [a, b) with IDs ``ids``; returns GroupNr_bound."""
    ds_grnr, ds_rank, ds_pot, ds_fof = datasets
    grnr, rank, pot = labeller(ids)
    ds_grnr[a:b] = grnr
    ds_rank[a:b] = rank
    if ds_pot is not None:
        ds_pot[a:b] = pot
    if ds_fof is not None:
        ds_fof[a:b] = fof_lab(ids)
    return grnr


def _write_snapshot_layout(
    snap_filename: str,
    output_filename: str,
    ptypes,
    labeller: _Labeller,
    fof_labellers: Dict[str, _FofLabeller],
    with_potentials: bool,
    provenance: Dict[str, object],
    batch_rows: int,
    collect: bool,
) -> Dict[str, List[np.ndarray]]:
    """One membership file per snapshot file with that file's rows,
    written in row batches (no full column is held)."""
    import h5py

    files = _snapshot_files(snap_filename)
    multi_out = "{file_nr}" in output_filename
    assert multi_out or len(files) == 1, (
        "membership output for a multi-file snapshot needs {file_nr} in the output filename"
    )
    grnr_parts: Dict[str, List[np.ndarray]] = {}
    with h5py.File(files[0], "r") as snap0:
        header = _membership_header(snap0, provenance)
    for file_nr, fname in enumerate(files):
        out_name = output_filename.format(file_nr=file_nr) if multi_out else output_filename
        os.makedirs(os.path.dirname(os.path.abspath(out_name)), exist_ok=True)
        with h5py.File(fname, "r") as snap, h5py.File(out_name, "w") as out:
            hdr = out.create_group("Header")
            for k, v in header.items():
                hdr.attrs[k] = v
            if "NumPart_ThisFile" in snap["Header"].attrs:
                hdr.attrs["NumPart_ThisFile"] = snap["Header"].attrs["NumPart_ThisFile"]
            for ptype in ptypes:
                if ptype not in snap or "ParticleIDs" not in snap[ptype]:
                    continue
                src = snap[ptype]["ParticleIDs"]
                n = src.shape[0]
                fof_lab = fof_labellers.get(ptype)
                datasets = _ptype_datasets(
                    out.create_group(ptype), n, labeller, fof_lab, with_potentials)
                for a in range(0, n, batch_rows):
                    b = min(a + batch_rows, n)
                    grnr = _label_rows(datasets, a, b, src[a:b], labeller, fof_lab)
                    if collect:
                        grnr_parts.setdefault(ptype, []).append(grnr)
    return grnr_parts


def _cell_slabs(counts: np.ndarray, batch_rows: int) -> Iterator[Tuple[int, int]]:
    """Contiguous canonical-cell ranges whose row totals stay bounded."""
    n_cells = len(counts)
    i = 0
    while i < n_cells:
        j = i
        rows = 0
        while j < n_cells and (j == i or rows + counts[j] <= batch_rows):
            rows += counts[j]
            j += 1
        yield i, j
        i = j


def _write_monolithic(
    snap_filename: str,
    output_filename: str,
    ptypes,
    labeller: _Labeller,
    fof_labellers: Dict[str, _FofLabeller],
    with_potentials: bool,
    provenance: Dict[str, object],
    batch_rows: int,
    collect: bool,
) -> Dict[str, List[np.ndarray]]:
    """One membership file in the snapshot's canonical (ascending cell)
    order, with single-file cell metadata, written cell slab by cell
    slab."""
    import h5py

    from soap_tpu_torch.io.swift_snapshot import SnapshotMetadata, read_masked_cells

    meta = SnapshotMetadata(snap_filename)
    os.makedirs(os.path.dirname(os.path.abspath(output_filename)), exist_ok=True)
    grnr_parts: Dict[str, List[np.ndarray]] = {}
    with h5py.File(snap_filename.format(file_nr=0), "r") as snap, h5py.File(
        output_filename, "w"
    ) as out:
        if "Header" in snap:
            snap.copy("Header", out)
            out["Header"].attrs["NumFilesPerSnapshot"] = np.array([1], dtype=np.int32)
            for k, v in _membership_header(snap, provenance).items():
                if k not in out["Header"].attrs:
                    out["Header"].attrs[k] = v
            out["Header"].attrs["Code"] = "SOAP"
            out["Header"].attrs["OutputType"] = "Membership"
        # single-file cell metadata in canonical (ascending cell) order:
        # the membership rows follow it however the snapshot splits its
        # cells over files
        if "Cells" in snap:
            cells = out.create_group("Cells")
            snap.copy("Cells/Meta-data", cells, "Meta-data")
            snap.copy("Cells/Centres", cells, "Centres")
            for sub in ("Counts", "OffsetsInFile", "Files"):
                cells.create_group(sub)
            for pt in snap["Cells/Counts"]:
                counts = snap["Cells/Counts"][pt][...].astype(np.int64)
                cells["Counts"].create_dataset(pt, data=counts)
                cells["OffsetsInFile"].create_dataset(
                    pt, data=np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
                )
                cells["Files"].create_dataset(pt, data=np.zeros(len(counts), np.int32))
        for ptype in ptypes:
            if ptype not in meta.datasets or "ParticleIDs" not in meta.datasets[ptype]:
                continue
            counts = meta.cell_counts[ptype]
            n = int(counts.sum())
            row_offsets = np.concatenate([[0], np.cumsum(counts)])
            fof_lab = fof_labellers.get(ptype)
            datasets = _ptype_datasets(
                out.create_group(ptype), n, labeller, fof_lab, with_potentials)
            for c0, c1 in _cell_slabs(counts, batch_rows):
                mask = np.zeros(meta.nr_cells, bool)
                mask[c0:c1] = True
                ids = read_masked_cells(meta, mask, {ptype: ["ParticleIDs"]})[ptype][
                    "ParticleIDs"]
                a, b = int(row_offsets[c0]), int(row_offsets[c1])
                assert len(ids) == b - a
                grnr = _label_rows(datasets, a, b, ids, labeller, fof_lab)
                if collect:
                    grnr_parts.setdefault(ptype, []).append(grnr)
    return grnr_parts


def _read_fof_columns(fof_filename: str, ptype: str):
    """ParticleIDs and FOFGroupIDs of one particle type over all FOF
    files.  As in the reference, a type with ParticleIDs but no
    FOFGroupIDs raises KeyError."""
    import h5py

    ids, gids = [], []
    for fname in _snapshot_files(fof_filename):
        with h5py.File(fname, "r") as f:
            if ptype in f and "ParticleIDs" in f[ptype]:
                ids.append(f[ptype]["ParticleIDs"][...])
                gids.append(f[ptype]["FOFGroupIDs"][...])
    if not ids:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return np.concatenate(ids), np.concatenate(gids)


def run_group_membership(
    snap_filename: str,
    halo_basename: str,
    output_filename: str,
    halo_format: str = "HBTplus",
    ptypes=("PartType0", "PartType1", "PartType4", "PartType5", "PartType6"),
    with_potentials: bool = False,
    fof_filename: Optional[str] = None,
    batch_rows: Optional[int] = None,
    return_labels: bool = True,
) -> Dict[str, np.ndarray]:
    """The membership program on files.

    ``with_potentials`` writes the halo finder's binding potentials of
    the bound particles as ``SpecificPotentialEnergies`` in (km/s)^2,
    the dataset the entry reads for ``PotentialEnergyTotal``.
    ``fof_filename`` names a separate FOF snapshot whose FOFGroupIDs are
    matched onto the snapshot by ParticleIDs and written into the
    membership file, for snapshots without their own.  ``batch_rows``
    snapshot rows are labelled at a time (default ``BATCH``).

    Returns {ptype: GroupNr_bound} in output row order; with
    ``return_labels=False`` the labels live only in the files, and the
    run's memory stays bounded."""
    if halo_format not in GROUPNR_READERS:
        raise NotImplementedError(
            f"halo_format {halo_format!r}: the port's membership reads HBTplus only; the "
            "other finders' readers are ROADMAP section 1's finder item")
    batch = batch_rows or BATCH
    pot_bound = None
    if with_potentials and halo_format == "HBTplus":
        res = GROUPNR_READERS[halo_format](halo_basename, read_potential_energies=True)
        nr_halos, ids_bound, grnr_bound, rank_bound, pot_bound = res
    else:
        res = GROUPNR_READERS[halo_format](halo_basename)
        nr_halos, ids_bound, grnr_bound = res[:3]
        rank_bound = res[3] if len(res) > 3 else None
    labeller = _Labeller(ids_bound, grnr_bound, rank_bound, pot_bound)

    fof_labellers: Dict[str, _FofLabeller] = {}
    if fof_filename:
        for ptype in ptypes:
            fof_ids, fof_gids = _read_fof_columns(fof_filename, ptype)
            if len(fof_ids):
                fof_labellers[ptype] = _FofLabeller(fof_ids, fof_gids)

    provenance = {
        "halo_basename": halo_basename,
        "halo_format": halo_format,
        "swift_filename": snap_filename,
        "fof_filename": fof_filename or "",
    }
    writer = _write_snapshot_layout if "{file_nr}" in output_filename else _write_monolithic
    grnr_parts = writer(
        snap_filename,
        output_filename,
        ptypes,
        labeller,
        fof_labellers,
        with_potentials and pot_bound is not None,
        provenance,
        batch,
        return_labels,
    )
    return {
        pt: np.concatenate(parts) if len(parts) > 1 else parts[0]
        for pt, parts in grnr_parts.items()
    }
