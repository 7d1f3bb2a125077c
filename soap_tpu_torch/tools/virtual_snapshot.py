"""Virtual snapshots and empty catalogues.

The port's copy of ``soap_tpu/tools/virtual_snapshot.py``.

``make_virtual_snapshot`` (reference
``SOAP/compression/make_virtual_snapshot.py``): an HDF5 file whose
particle datasets are virtual views of the snapshot file, with the
membership file's datasets (GroupNr_bound, Rank_bound) added to each
PartType group, so downstream tools see one snapshot holding membership.
The sources are paths relative to the output file, as the reference's.

``create_empty_catalogue`` (reference
``SOAP/compression/create_empty_SOAP_catalogue.py``): a zero-halo
catalogue with the full dataset structure and each dataset's attributes,
for snapshots without halos.

h5py is imported inside the functions.
"""

from __future__ import annotations

import os

import numpy as np

from soap_tpu_torch.core.halo_types import implemented_keys_for
from soap_tpu_torch.core.registry import full_property_table


def make_virtual_snapshot(snapshot_file: str, membership_file: str, output_file: str) -> None:
    """Single-file layout: virtual datasets pointing at the snapshot and
    membership files (relative paths, like the reference)."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    rel_snap = os.path.relpath(snapshot_file, os.path.dirname(output_file) or ".")
    rel_mem = os.path.relpath(membership_file, os.path.dirname(output_file) or ".")

    def add_virtual(group, ptype, datasets, source):
        for name, ds in datasets.items():
            layout = h5py.VirtualLayout(shape=ds.shape, dtype=ds.dtype)
            layout[...] = h5py.VirtualSource(source, f"{ptype}/{name}", shape=ds.shape)
            v = group.create_virtual_dataset(name, layout)
            for k, val in ds.attrs.items():
                v.attrs[k] = val

    with h5py.File(snapshot_file, "r") as snap, h5py.File(membership_file, "r") as mem, \
            h5py.File(output_file, "w") as out:
        # global metadata groups are copied as they are
        for group in snap:
            if not group.startswith("PartType"):
                snap.copy(snap[group], out, group)
        for ptype in snap:
            if not ptype.startswith("PartType"):
                continue
            g = out.create_group(ptype)
            add_virtual(g, ptype, snap[ptype], rel_snap)
            if ptype in mem:
                add_virtual(g, ptype, mem[ptype], rel_mem)


def create_empty_catalogue(snapshot_file: str, output_file: str, dmo: bool = False) -> int:
    """Zero-halo catalogue with the full dataset structure; returns the
    number of (empty) datasets created."""
    import h5py

    from soap_tpu_torch.io.catalogue_writer import write_property
    from soap_tpu_torch.io.swift_snapshot import SnapshotMetadata

    meta = SnapshotMetadata(snapshot_file)
    table = full_property_table()
    reg = meta.units
    n = 0
    os.makedirs(os.path.dirname(os.path.abspath(output_file)) or ".", exist_ok=True)
    with h5py.File(output_file, "w") as f:
        hdr = f.create_group("Header")
        for k, v in meta.header.items():
            try:
                hdr.attrs[k] = v
            except TypeError:
                pass
        hdr.attrs["OutputType"] = np.bytes_("SOAP")
        hdr.attrs["NumberOfHalos"] = np.int64(0)
        cos = f.create_group("Cosmology")
        for k, v in meta.cosmology_attrs.items():
            cos.attrs[k] = [v]
        groups = {
            "BoundSubhalo": implemented_keys_for("BoundSubhalo", dmo),
            "SO/200_crit": implemented_keys_for("SO", dmo),
            "ExclusiveSphere/100kpc": implemented_keys_for("Aperture", dmo),
            "ProjectedAperture/100kpc/projz": implemented_keys_for("ProjectedAperture", dmo),
        }
        for group, keys in groups.items():
            for key in keys:
                p = table[key]
                shape = (0,) if p.shape == 1 else (0, p.shape)
                write_property(f, f"{group}/{p.name}", np.zeros(shape, p.dtype), p, reg)
                n += 1
        for key in ("cofp", "index", "is_central", "nr_bound_part"):
            p = table[key]
            shape = (0,) if p.shape == 1 else (0, p.shape)
            name = p.name if "/" in p.name else f"InputHalos/{p.name}"
            write_property(f, name, np.zeros(shape, p.dtype), p, reg)
            n += 1
    return n
