"""Write a :class:`~soap_tpu_torch.io.catalogue.Catalogue` as an HDF5 file.

A plain h5py dump of ``io/catalogue.py::make_catalogue``'s result: the
groups with their attributes, then the datasets with theirs, each in
the order ``soap_tpu/io/catalogue_writer.py::write_catalogue`` creates
them.  ``read_catalogue`` reads a catalogue file back.  Both import
``h5py`` inside, so importing this module loads no h5py.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from soap_tpu_torch.io.catalogue import Catalogue, CatalogueDataset


def _set_attr(group, path: str, key: str, value) -> None:
    """One attribute, with the JAX writer's handling of values h5py cannot
    store: the snapshot header's are dropped with a warning, the SWIFT
    copies' silently, and a run parameter is stored as its text."""
    try:
        group.attrs[key] = value
    except TypeError:
        if path == "Header":
            print(
                f"WARNING: dropping snapshot header attribute {key!r} "
                f"(unconvertible type {type(value).__name__})",
                file=sys.stderr,
                flush=True,
            )
        elif path == "Parameters":
            group.attrs[key] = np.bytes_(str(value))
        elif not path.startswith("SWIFT/"):
            raise


def write_catalogue(output_path: str, catalogue: Catalogue) -> None:
    """Write ``catalogue`` to ``output_path`` (its directory is made)."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    stamps = {
        "Header": {
            "SnapshotDate": np.bytes_(catalogue.snapshot_date),
            "SOAP git hash": np.bytes_(catalogue.git_hash),
            "SOAP date": np.bytes_(catalogue.date),
        },
        "Code": {
            "git_hash": np.bytes_(catalogue.git_hash),
            "Date": np.bytes_(catalogue.date),
        },
    }
    with h5py.File(output_path, "w") as f:
        # groups and attributes first: without creation-order tracking the
        # file holds the same as when a halo type's group attributes follow
        # its datasets, as in the JAX writer
        for path, attrs in catalogue.groups.items():
            g = f.require_group(path)
            for k, v in {**attrs, **stamps.get(path, {})}.items():
                _set_attr(g, path, k, v)
        for path, ds in catalogue.datasets.items():
            d = f.create_dataset(path, data=ds.data)
            for k, v in ds.attrs.items():
                d.attrs[k] = v


#: the time-stamp and git-hash attributes ``write_catalogue`` adds
_STAMPS = {
    ("Header", "SnapshotDate"): "snapshot_date",
    ("Header", "SOAP git hash"): "git_hash",
    ("Header", "SOAP date"): "date",
    ("Code", "git_hash"): "git_hash",
    ("Code", "Date"): "date",
}


def read_catalogue(path: str) -> Catalogue:
    """A catalogue file (this writer's or the JAX package's) back as a
    :class:`Catalogue`, groups and datasets in the file's order (by
    name), its time stamps and git hash in their fields."""
    import h5py

    groups, datasets, stamps = {}, {}, {}

    def visit(name, obj):
        attrs = {}
        for k, v in obj.attrs.items():
            if (name, k) in _STAMPS:
                stamps[_STAMPS[name, k]] = bytes(v).decode()
            else:
                attrs[k] = v
        if isinstance(obj, h5py.Dataset):
            datasets[name] = CatalogueDataset(obj[...], attrs)
        else:
            groups[name] = attrs

    with h5py.File(path, "r") as f:
        f.visititems(visit)
        n_halos = int(np.asarray(f["Header"].attrs["NumSubhalos_Total"]).ravel()[0])
    return Catalogue(n_halos=n_halos, groups=groups, datasets=datasets, **stamps)
