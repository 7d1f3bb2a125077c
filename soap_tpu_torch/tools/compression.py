"""Catalogue compression: SWIFT-style lossy HDF5 filter pipelines + GZIP.

The port's copy of ``soap_tpu/tools/compression.py`` (reference
``SOAP/compression/compress_soap_catalogue.py:22-101``): every dataset
carrying a ``Lossy compression filter`` attribute is rewritten with that
filter applied plus fletcher32 + GZIP-4, chunked at 1000 rows, and the
``Is Compressed`` attribute is set to True.

SWIFT's lossy filters are native HDF5 pipelines: H5Z_FILTER_NBIT over a
reduced-precision datatype for the FMantissa/DMantissa/Nbit families and
H5Z_FILTER_SCALEOFFSET (D-scale) for DScaleN
(``SOAP/compression/filters.yml``, ``extract_filters.py``).  They are
built with the h5py low-level API from the filter names, or taken as
they are from a SWIFT snapshot (``extract_filters``).  Files read back
with plain h5py, no plugins.

``apply_lossy_filter`` is the numeric emulation (numpy only) that
``compress_catalogue`` writes instead when a pipeline cannot be built,
as the JAX tool does.  h5py and yaml are imported inside the functions
that open files, so importing this module loads neither.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

CHUNK_ROWS = 1000  # reference compress_soap_catalogue.py:22

#: filter name -> (base kind, exponent bits, mantissa bits) for the n-bit
#: float family; precision = 1 + esize + msize (the extracted pipelines
#: of the reference's filters.yml)
_NBIT_FLOAT = {
    "FMantissa9": ("f4", 8, 9),
    "FMantissa13": ("f4", 8, 13),
    "HalfFloat": ("f4", 5, 10),
    "BFloat16": ("f4", 8, 7),
    "DMantissa9": ("f8", 11, 9),
    "DMantissa13": ("f8", 11, 13),
    "DMantissa21": ("f8", 11, 21),
}

#: filter name -> stored bits for the integer n-bit family
_NBIT_INT = {"Nbit36": 36, "Nbit40": 40, "Nbit48": 48, "Nbit56": 56}


def _nbit_float_type(base: str, esize: int, msize: int):
    import h5py

    t = (h5py.h5t.IEEE_F32LE if base == "f4" else h5py.h5t.IEEE_F64LE).copy()
    prec = 1 + esize + msize
    t.set_fields(prec - 1, msize, esize, 0, msize)
    t.set_precision(prec)
    t.set_offset(0)
    return t


def _nbit_int_type(dtype: np.dtype, bits: int):
    import h5py

    t = h5py.h5t.py_create(dtype).copy()
    t.set_precision(bits)
    t.set_offset(0)
    return t


def _filter_pipeline_type(filter_name: str, dtype: np.dtype) -> Optional[Tuple[object, np.dtype,
                                                                                Optional[int]]]:
    """(HDF5 storage type, cast dtype, scaleoffset digits) for a filter,
    or None when the filter does not apply to this dtype (a float filter
    on integer data): the dataset is then stored lossless."""
    import h5py

    if filter_name in _NBIT_FLOAT:
        if dtype.kind != "f":
            return None
        base, esize, msize = _NBIT_FLOAT[filter_name]
        return _nbit_float_type(base, esize, msize), np.dtype(base), None
    if filter_name in _NBIT_INT:
        if dtype.kind not in "iu":
            return None
        cast = np.dtype("i8" if dtype.kind == "i" else "u8")
        return _nbit_int_type(cast, _NBIT_INT[filter_name]), cast, None
    if filter_name.startswith("DScale"):
        if dtype.kind != "f":
            return None
        digits = int(filter_name[len("DScale"):])
        return h5py.h5t.py_create(dtype).copy(), dtype, digits
    return None


def _create_dataset(f, name: str, h5type, plist, data: np.ndarray):
    """Create ``name`` (its parent groups too) with a storage type and a
    creation property list, and write ``data``."""
    import h5py

    space = h5py.h5s.create_simple(data.shape, data.shape)
    parent = f.require_group(name.rsplit("/", 1)[0]) if "/" in name else f
    h5py.h5d.create(parent.id, name.rsplit("/", 1)[-1].encode("utf-8"), h5type, space,
                    plist, None).close()
    ds = f[name]
    ds[...] = data
    return ds


def _create_lossy_dataset(f, name: str, data: np.ndarray, filter_name: str, gzip_level: int):
    """Create ``name`` with the SWIFT filter pipeline built from its name;
    None when the filter does not apply.  Pipeline order as the reference
    (``compress_soap_catalogue.py:88-101``): lossy filter, fletcher32
    checksum, deflate."""
    import h5py

    spec = _filter_pipeline_type(filter_name, data.dtype)
    if spec is None or data.ndim == 0 or data.shape[0] == 0:
        return None
    h5type, cast, scale_digits = spec
    data = np.ascontiguousarray(data.astype(cast, copy=False))
    plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    plist.set_chunk((min(data.shape[0], CHUNK_ROWS),) + data.shape[1:])
    if scale_digits is not None:
        plist.set_scaleoffset(h5py.h5z.SO_FLOAT_DSCALE, scale_digits)
    else:
        plist.set_filter(h5py.h5z.FILTER_NBIT, h5py.h5z.FLAG_OPTIONAL, ())
    plist.set_fletcher32()
    plist.set_deflate(gzip_level)
    return _create_dataset(f, name, h5type, plist, data)


def _round_mantissa(data: np.ndarray, keep_bits: int) -> np.ndarray:
    """Keep ``keep_bits`` mantissa bits (round-to-nearest) in float data."""
    if data.dtype == np.float32:
        u = data.view(np.uint32).copy()
        drop = 23 - keep_bits
        if drop <= 0:
            return data
        half = np.uint32(1 << (drop - 1))
        mask = np.uint32(~((1 << drop) - 1) & 0xFFFFFFFF)
        u = ((u + half) & mask).astype(np.uint32)
        return u.view(np.float32)
    if data.dtype == np.float64:
        u = data.view(np.uint64).copy()
        drop = 52 - keep_bits
        if drop <= 0:
            return data
        half = np.uint64(1 << (drop - 1))
        mask = np.uint64(~np.uint64((1 << drop) - 1))
        u = ((u + half) & mask).astype(np.uint64)
        return u.view(np.float64)
    return data


def apply_lossy_filter(data: np.ndarray, filter_name: str) -> np.ndarray:
    """Numerically emulate a SWIFT lossy filter (the fallback path)."""
    if filter_name in ("None", "", None):
        return data
    if filter_name in _NBIT_FLOAT and data.dtype.kind == "f":
        return _round_mantissa(data, _NBIT_FLOAT[filter_name][2])
    if filter_name in _NBIT_INT and data.dtype.kind in "iu":
        bits = _NBIT_INT[filter_name]
        # storage keeps the low `bits` bits; values within range survive
        lo = -(1 << (bits - 1)) if data.dtype.kind == "i" else 0
        hi = (1 << (bits - 1)) - 1 if data.dtype.kind == "i" else (1 << bits) - 1
        return np.clip(data, lo, hi)
    if filter_name.startswith("DScale") and data.dtype.kind == "f":
        digits = int(filter_name[len("DScale"):])
        return np.round(data, digits)
    return data


def _relaxed_fapl():
    """File-access plist with relaxed datatype integrity checks, or None.

    HDF5 >= 1.14.4 rejects n-bit float types whose precision is much
    smaller than their storage size (DMantissa9: 21 of 64 bits, what
    reference-compressed catalogues hold) unless
    ``H5Pset_relax_file_integrity_checks`` is set; h5py does not expose
    it, so it is called through ctypes (best effort).
    """
    import h5py

    try:
        import ctypes
        import glob

        libs = glob.glob(
            os.path.join(os.path.dirname(h5py.__file__), "..", "h5py.libs", "libhdf5-*.so*"))
        fn = ctypes.CDLL(libs[0]).H5Pset_relax_file_integrity_checks
        fn.argtypes = [ctypes.c_int64, ctypes.c_uint64]
        fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
        if fn(fapl.id, 0x0001) < 0:  # H5F_RFIC_UNUSUAL_NUM_UNUSED_NUMERIC_BITS
            return None
        return fapl
    except Exception:
        return None


def open_relaxed(path: str, mode: str = "r"):
    """Open a (possibly lossy-compressed) catalogue as an ``h5py.File``.

    Needed for files carrying DMantissa9-style reduced-precision types
    (this tool's and the reference's) under HDF5 >= 1.14.4; mode ``"w"``
    creates the file.
    """
    import h5py

    fapl = _relaxed_fapl()
    if fapl is None:
        return h5py.File(path, mode)
    flags = {"r": h5py.h5f.ACC_RDONLY, "r+": h5py.h5f.ACC_RDWR}.get(mode)
    if flags is None:
        fid = h5py.h5f.create(path.encode("utf-8"), h5py.h5f.ACC_TRUNC, fapl=fapl)
    else:
        fid = h5py.h5f.open(path.encode("utf-8"), flags, fapl=fapl)
    return h5py.File(fid)


def lossy_filter_name(attrs) -> str:
    """A dataset's ``Lossy compression filter`` attribute as text."""
    name = attrs.get("Lossy compression filter", b"None")
    return name.decode() if isinstance(name, bytes) else name


def extract_filters(snapshot_file: str) -> dict:
    """The serialized lossy filter pipelines of a SWIFT file.

    The reference's ``compression/extract_filters.py``: for each distinct
    ``Lossy compression filter`` attribute of a particle dataset, the raw
    HDF5 filter tuples and the encoded storage datatype, with a
    fletcher32 checksum filter appended.  The result feeds
    ``compress_catalogue(filters_file=...)`` for the pipelines of
    reference-compressed catalogues.
    """
    import h5py

    filters: dict = {}
    with open_relaxed(snapshot_file) as f:
        for i in (0, 1, 4, 5, 6):
            gname = f"PartType{i}"
            if gname not in f:
                continue
            group = f[gname]
            for prop in group:
                if not isinstance(group[prop], h5py.Dataset):
                    continue
                fname = lossy_filter_name(group[prop].attrs)
                if fname in filters or fname in ("None", ""):
                    continue
                dset = h5py.h5d.open(group.id, prop.encode("utf-8"))
                plist = dset.get_create_plist()
                if plist.get_nfilters() < 1:
                    continue
                lossy = list(plist.get_filter(0))
                lossy[2] = [int(v) for v in lossy[2]]
                lossy[3] = lossy[3].decode() if isinstance(lossy[3], bytes) else lossy[3]
                filters[fname] = {
                    "filters": [[int(lossy[0]), int(lossy[1]), lossy[2], lossy[3]]],
                    "type": dset.get_type().encode(),
                }
    fletcher = [int(h5py.h5z.FILTER_FLETCHER32), 0, [], "fletcher32"]
    for fname in filters:
        filters[fname]["filters"].append(fletcher)
    return filters


def write_filters_yaml(snapshot_file: str, output_yaml: str) -> dict:
    """Extract filters and save them as YAML (reference filters.yml)."""
    import yaml

    filters = extract_filters(snapshot_file)
    os.makedirs(os.path.dirname(os.path.abspath(output_yaml)), exist_ok=True)
    with open(output_yaml, "w") as f:
        yaml.safe_dump(filters, f)
    return filters


def load_filters_yaml(filters_file: str) -> dict:
    import yaml

    with open(filters_file) as f:
        return yaml.safe_load(f) or {}


def _create_extracted_dataset(f, name: str, data: np.ndarray, fprops: dict, gzip_level: int):
    """Create ``name`` with an extracted filter pipeline (reference
    ``compress_soap_catalogue.py:88-101`` create_lossy_dataset)."""
    import h5py

    if data.ndim == 0 or data.shape[0] == 0:
        return None
    h5type = h5py.h5t.decode(bytes(fprops["type"]))
    plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    plist.set_chunk((min(data.shape[0], CHUNK_ROWS),) + data.shape[1:])
    for filt in fprops["filters"]:
        plist.set_filter(int(filt[0]), int(filt[1]), tuple(filt[2]))
    plist.set_deflate(gzip_level)
    return _create_dataset(f, name, h5type, plist, np.ascontiguousarray(data))


def compress_catalogue(input_path: str, output_path: str, gzip_level: int = 4,
                       filters_file: Optional[str] = None) -> int:
    """Write a compressed copy of a catalogue; returns datasets rewritten.

    With ``filters_file`` (YAML from ``extract_filters``), datasets use
    the filter pipelines extracted from a SWIFT snapshot; without it,
    pipelines are built from the filter names.  Where building one
    raises, the dataset is written through ``apply_lossy_filter`` and
    plain GZIP instead, as the JAX tool does (its ``:354-365``).
    """
    import h5py

    n_done = 0
    extracted = load_filters_yaml(filters_file) if filters_file else {}
    with h5py.File(input_path, "r") as src, open_relaxed(output_path, mode="w") as dst:
        def copy_attrs(s, d):
            for k, v in s.attrs.items():
                d.attrs[k] = v

        copy_attrs(src, dst)

        def visit(name, obj):
            nonlocal n_done
            if isinstance(obj, h5py.Group):
                copy_attrs(obj, dst.require_group(name))
                return
            data = obj[...]
            filt = lossy_filter_name(obj.attrs)
            ds = None
            if filt not in ("None", ""):
                try:
                    if filt in extracted:
                        ds = _create_extracted_dataset(dst, name, data, extracted[filt],
                                                       gzip_level)
                    else:
                        ds = _create_lossy_dataset(dst, name, data, filt, gzip_level)
                except Exception:
                    ds = None
                if ds is None:
                    data = apply_lossy_filter(data, filt)
            if ds is None:
                chunks = None
                if data.shape and data.shape[0] > CHUNK_ROWS:
                    chunks = (CHUNK_ROWS,) + data.shape[1:]
                ds = dst.create_dataset(name, data=data, compression="gzip",
                                        compression_opts=gzip_level, shuffle=True, chunks=chunks)
            copy_attrs(obj, ds)
            ds.attrs["Is Compressed"] = True
            n_done += 1

        src.visititems(visit)
    return n_done
