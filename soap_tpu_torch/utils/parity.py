"""How one engine's results are held to another's, key by key.

Used where the port's engine is compared with the JAX engine on the CPU
(``tests/test_torch_engine_*.py``) and where its GPU run is compared with
its CPU run (``chip_smoke.py``); ``catalogue_differences`` holds whole
catalogues to each other the same way (``tests/test_torch_entry_*.py``,
``chip_smoke.py`` phase 5e).  The classes follow what the two sides'
summation orders explain, as measured on the test mocks (``CHANGES.md``):

- particle counts are equal;
- ``TIGHT`` keys (the SO solution's radius and mass, masses summed per
  type, half-mass radii) within rtol 1e-5 (measured <= 9.5e-7);
- the ``is_loose`` keys within rtol 1e-5 plus 1e-4 of the key's largest
  magnitude: the iterative inertia tensors (up to 4.3e-5 of the scale;
  the port's loop sums its moments in float64, the JAX loop in float32)
  and the luminosity-weighted stellar kappa (3.6e-5);
- every other key within rtol 1e-5 plus 1e-5 of its largest magnitude
  (measured <= 5.9e-6 of the scale).
"""

from __future__ import annotations

import numpy as np

COUNTS = ("Ngas", "Ndm", "Nstar", "Nbh")
TIGHT = ("r", "Mtot", "Mgas", "Mdm", "Mstar", "Mbh_dynamical", "HalfMassRadiusTot",
         "HalfMassRadiusDM")
RTOL = 1e-5
ATOL = 1e-5  # of the key's largest magnitude
LOOSE_ATOL = 1e-4


def is_loose(key: str) -> bool:
    """The keys held at LOOSE_ATOL: iterative inertia tensors and the
    luminosity-weighted stellar kappa."""
    iterative_inertia = "InertiaTensor" in key and "Noniterative" not in key
    return iterative_inertia or key == "kappa_corot_star_luminosity_weighted"


def key_close(ref, got, key: str) -> bool:
    """``got`` holds to ``ref`` under ``key``'s class (same shape, finite)."""
    a = np.asarray(ref, np.float64)
    b = np.asarray(got, np.float64)
    if a.shape != b.shape or not np.isfinite(b).all():
        return False
    if key in COUNTS:
        return np.array_equal(a, b)
    if key in TIGHT:
        return np.allclose(b, a, rtol=RTOL, atol=0.0)
    scale = max(np.abs(a).max() if a.size else 1.0, 1e-30)
    atol = LOOSE_ATOL if is_loose(key) else ATOL
    return np.allclose(b, a, rtol=RTOL, atol=atol * scale)


def scaled_error(ref, got) -> float:
    """Largest |got - ref| over the largest |ref|."""
    a = np.asarray(ref, np.float64)
    b = np.asarray(got, np.float64)
    if not a.size:
        return 0.0
    return float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30))


#: catalogue groups whose datasets are inputs or host-side integer work,
#: held exactly
EXACT_GROUPS = ("Cells", "InputHalos", "HBTplus", "SOAP", "FOF")


def is_timing(path: str) -> bool:
    """A catalogue dataset of measured wall seconds (per-halo
    ``process_time``, per-property ``<name>_time``): two runs agree on
    its name, dtype, shape and attributes, not on its values."""
    return path == "InputHalos/process_time" or path.endswith("_time")


def _same_value(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "O":  # variable-length strings, as h5py reads them
        return a.tolist() == b.tolist()
    return a.tobytes() == b.tobytes()


def catalogue_differences(ref, got, groups=None) -> list:
    """Where catalogue ``got`` departs from ``ref`` (two
    ``io/catalogue.py::Catalogue`` objects; their time stamps and git
    hashes are not compared): the same groups with the same attributes,
    the same datasets in the same order with the same dtypes, shapes and
    attributes, equal data for the passthrough, cell and ``SOAP/*``
    groups and every integer dataset, and each float property within its
    key's class (``key_close``); timing datasets (``is_timing``) by name,
    dtype, shape and attributes only.  ``groups`` limits the comparison
    to the groups and datasets under those top-level names.  Returns the
    differences as text (empty when none)."""
    from soap_tpu_torch.core.registry import full_property_table

    def chosen(items):
        return {k: v for k, v in items.items()
                if groups is None or k.split("/")[0] in groups}

    table = full_property_table()
    out = []
    ref_groups, got_groups = chosen(ref.groups), chosen(got.groups)
    ref_data, got_data = chosen(ref.datasets), chosen(got.datasets)
    if ref.n_halos != got.n_halos:
        out.append(f"{got.n_halos} halos, not {ref.n_halos}")
    if list(ref_groups) != list(got_groups):
        out.append(f"groups {sorted(set(ref_groups) ^ set(got_groups))} differ")
    for path, attrs in ref_groups.items():
        other = got_groups.get(path, {})
        for k in sorted(set(attrs) | set(other)):
            if k not in attrs or k not in other or not _same_value(attrs[k], other[k]):
                out.append(f"attribute {path}:{k} differs")
    if list(ref_data) != list(got_data):
        out.append(f"datasets {sorted(set(ref_data) ^ set(got_data))} differ")
    for path, ds in ref_data.items():
        if path not in got_data:
            continue
        g = got_data[path]
        a, b = np.asarray(ds.data), np.asarray(g.data)
        if a.dtype != b.dtype or a.shape != b.shape:
            out.append(f"{path}: {b.dtype} {b.shape}, not {a.dtype} {a.shape}")
            continue
        for k in sorted(set(ds.attrs) | set(g.attrs)):
            if k not in ds.attrs or k not in g.attrs or not _same_value(ds.attrs[k], g.attrs[k]):
                out.append(f"attribute {path}:{k} differs")
        if is_timing(path):
            continue
        if path.split("/")[0] in EXACT_GROUPS or a.dtype.kind not in "fc":
            if not _same_value(a, b):
                out.append(f"{path}: not equal")
        else:
            key = table.by_output_name(path.rsplit("/", 1)[1]).key
            if not key_close(a, b, key):
                out.append(f"{path} ({key}): scaled error {scaled_error(a, b):.3e}")
    return out
