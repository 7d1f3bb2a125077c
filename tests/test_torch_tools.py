"""The port's file tools against the JAX tools, on the same files.

Compression (built and extracted filter pipelines), comparison, the
property-table documentation, virtual snapshots, empty catalogues and
the timing report.  Both sides are numpy on the same inputs, so text is
byte-equal and every HDF5 output equal dataset by dataset: data bit for
bit, dtype and stored type, shape and chunks, attributes, and the filter
pipeline of each dataset's creation property list.  The inputs come from
the JAX package's mock writer, the committed DMO golden catalogue and
the JAX tool tests' own file writers, from fixed seeds.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.tools import compare as jax_compare
from soap_tpu.tools import compression as jax_compression
from soap_tpu.tools import docs as jax_docs
from soap_tpu.tools import timing_analysis as jax_timing
from soap_tpu.tools import virtual_snapshot as jax_virtual
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.pipeline import run
from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.tools import compare, compression, docs, timing_analysis, virtual_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DMO = os.path.join(REPO, "tests", "golden", "e2e_dmo_seed11.hdf5")


def _value(v):
    """An attribute or dataset value as (dtype, bytes) or, for object
    arrays (variable-length strings), as a list."""
    a = np.asarray(v)
    if a.dtype.kind == "O":
        return ("O", a.shape, a.tolist())
    return (a.dtype.str, a.shape, a.tobytes())


def _pipeline(plist):
    """A creation property list's filters as (id, flags, parameters,
    name).  Exception: of scale-offset's 20 parameters only those HDF5
    defines are kept (scale type and factor, chunk elements, the type's
    class, size, sign and order, whether a fill value is set, and the
    fill value's 4-byte words): libhdf5 leaves the rest uninitialised, so
    they differ between two runs of one tool."""
    out = []
    for i in range(plist.get_nfilters()):
        code, flags, values, name = plist.get_filter(i)
        if code == h5py.h5z.FILTER_SCALEOFFSET:
            values = values[:8 + -(-values[4] // 4)]
        out.append((code, flags, values, name))
    return out


def h5_content(path):
    """Every object of an HDF5 file: a group's attributes; a dataset's
    dtype, stored type, shape, chunks, filter pipeline, virtual sources,
    data (as bytes) and attributes."""
    out = {}
    with jax_compression.open_relaxed(path) as f:
        def visit(name, obj):
            attrs = {k: _value(obj.attrs[k]) for k in obj.attrs}
            if not isinstance(obj, h5py.Dataset):
                out[name] = ("group", attrs)
                return
            filters = _pipeline(obj.id.get_create_plist())
            sources = ([(s.file_name, s.dset_name) for s in obj.virtual_sources()]
                       if obj.is_virtual else None)
            out[name] = ("dataset", obj.dtype.str, obj.id.get_type().encode(), obj.shape,
                         obj.chunks, filters, sources, _value(obj[()]), attrs)

        out["/"] = ("group", {k: _value(f.attrs[k]) for k in f.attrs})
        f.visititems(visit)
    return out


def assert_same_h5(got, want):
    a, b = h5_content(got), h5_content(want)
    assert list(a) == list(b)
    for name in b:
        assert a[name] == b[name], name


def filter_ids(path, name):
    with compression.open_relaxed(path) as f:
        plist = h5py.h5d.open(f.id, name.encode()).get_create_plist()
        return [plist.get_filter(i)[0] for i in range(plist.get_nfilters())]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lossy_catalogue(path):
    """Datasets under every filter family: n-bit floats and ints, D-scale,
    no filter, a float filter on integers, an unknown filter, a 2D
    dataset longer than one chunk and an empty one."""
    rng = np.random.default_rng(5)
    with h5py.File(path, "w") as f:
        f.attrs["Version"] = np.bytes_("test")
        f.create_group("A").attrs["Note"] = 3
        for name, data, filt in (
            ("A/F9", (rng.normal(size=2000) * 1e4).astype(np.float32), "FMantissa9"),
            ("A/F13", rng.normal(size=(2500, 3)).astype(np.float32), "FMantissa13"),
            ("A/D9", rng.normal(size=2000) * 1e-3, "DMantissa9"),
            ("A/S5", rng.normal(size=2000) * 1e-3, "DScale5"),
            ("A/S1", rng.normal(size=(1200, 6)).astype(np.float32), "DScale1"),
            ("A/N40", rng.integers(0, 2**38, size=2000), "Nbit40"),
            ("B/Plain", np.arange(1500, dtype=np.uint32), "None"),
            ("B/FloatFilterOnInt", np.arange(50, dtype=np.int32), "FMantissa9"),
            ("B/Unknown", rng.random(40), "NoSuchFilter"),
            ("B/Empty", np.zeros(0, np.float32), "FMantissa9"),
        ):
            d = f.create_dataset(name, data=data)
            d.attrs["Lossy compression filter"] = np.bytes_(filt)
            d.attrs["Description"] = np.bytes_(f"{name} data")


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """The synthetic catalogue and the DMO golden, each compressed by both
    tools: {source: (input, port's file, JAX's file, port's count, JAX's)}."""
    tmp = tmp_path_factory.mktemp("packed")
    synthetic = str(tmp / "cat.hdf5")
    _lossy_catalogue(synthetic)
    out = {}
    for source, src in (("synthetic", synthetic), ("golden_dmo", GOLDEN_DMO)):
        ours, theirs = str(tmp / f"{source}_port.hdf5"), str(tmp / f"{source}_jax.hdf5")
        out[source] = (src, ours, theirs, compression.compress_catalogue(src, ours),
                       jax_compression.compress_catalogue(src, theirs))
    return out


@pytest.mark.parametrize("source", ["synthetic", "golden_dmo"])
def test_compress_matches_and_carries_real_pipelines(packed, source):
    """Both tools' compressed files are equal dataset by dataset, and the
    port's datasets carry the real n-bit or scale-offset pipelines (the
    reference's filter ids: nbit 5 / scaleoffset 6, fletcher32 3,
    deflate 1), not the numeric emulation."""
    src, ours, theirs, n_ours, n_theirs = packed[source]
    assert n_ours == n_theirs
    assert_same_h5(ours, theirs)
    if source == "synthetic":
        for name, ids in (("A/F9", [5, 3, 1]), ("A/F13", [5, 3, 1]), ("A/D9", [5, 3, 1]),
                          ("A/S5", [6, 3, 1]), ("A/S1", [6, 3, 1]), ("A/N40", [5, 3, 1]),
                          ("B/Plain", [2, 1]), ("B/FloatFilterOnInt", [2, 1]),
                          ("B/Unknown", [2, 1])):
            assert filter_ids(ours, name) == ids, name
        with compression.open_relaxed(ours) as f, h5py.File(src, "r") as s:
            np.testing.assert_array_equal(f["A/N40"][...], s["A/N40"][...])
            np.testing.assert_allclose(f["A/F9"][...], s["A/F9"][...], rtol=2.0**-9)
            assert f["A/D9"].id.get_type().get_precision() == 21
    else:
        with h5py.File(src, "r") as s:
            filt = s["BoundSubhalo/TotalMass"].attrs["Lossy compression filter"]
        assert filt == b"FMantissa9" and filter_ids(ours, "BoundSubhalo/TotalMass") == [5, 3, 1]
        assert filter_ids(ours, "SO/200_crit/CentreOfMass")[0] == 6  # DScale6


def test_extract_filters_and_compress_with_them(tmp_path):
    """extract-filters on a snapshot with real lossy pipelines: equal
    dictionaries and YAML files; a catalogue compressed with them: equal
    files (the JAX tool test's flow)."""
    snap = str(tmp_path / "snap.hdf5")
    rng = np.random.default_rng(2)
    with compression.open_relaxed(snap, mode="w") as f:
        f.create_group("PartType1")
        for name, data, filt in (("Coordinates", rng.random((100, 3)), "DMantissa9"),
                                 ("Masses", rng.random(100).astype(np.float32), "FMantissa9"),
                                 ("ParticleIDs", np.arange(100), "Nbit40")):
            ds = compression._create_lossy_dataset(f, f"PartType1/{name}", data, filt, 4)
            ds.attrs["Lossy compression filter"] = np.bytes_(filt)
    yml = {w: str(tmp_path / f"filters_{w}.yml") for w in ("port", "jax")}
    got = compression.write_filters_yaml(snap, yml["port"])
    assert got == jax_compression.write_filters_yaml(snap, yml["jax"])
    assert set(got) == {"DMantissa9", "FMantissa9", "Nbit40"}
    with open(yml["port"], "rb") as a, open(yml["jax"], "rb") as b:
        assert a.read() == b.read()
    cat = str(tmp_path / "cat.hdf5")
    with h5py.File(cat, "w") as f:
        d = f.create_dataset("SO/200_crit/CentreOfMass", data=rng.random((50, 3)) * 100.0)
        d.attrs["Lossy compression filter"] = np.bytes_("DMantissa9")
        d = f.create_dataset("BoundSubhalo/TotalMass", data=rng.random(50).astype(np.float32))
        d.attrs["Lossy compression filter"] = np.bytes_("FMantissa9")
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    assert compression.compress_catalogue(cat, ours, filters_file=yml["port"]) == \
        jax_compression.compress_catalogue(cat, theirs, filters_file=yml["jax"]) == 2
    assert_same_h5(ours, theirs)
    assert filter_ids(ours, "SO/200_crit/CentreOfMass") == [5, 3, 1]


@pytest.mark.parametrize("exact", [False, True], ids=["filter_tolerance", "exact"])
def test_compare_matches(tmp_path, packed, exact):
    """The comparison of the golden catalogue with its compressed copy,
    with another catalogue, with one that lacks a dataset and with one of
    another shape: equal counts, differences and reports."""
    packed = packed["golden_dmo"][1]
    other = str(tmp_path / "other.hdf5")
    with h5py.File(other, "w") as f:
        f["BoundSubhalo/TotalMass"] = np.ones(3, np.float32)
        f["X"] = np.ones(4)
    with h5py.File(GOLDEN_DMO, "r") as s:
        n = s["BoundSubhalo/TotalMass"].shape[0]
    with h5py.File(other, "a") as f:
        f["BoundSubhalo/Ndm"] = np.zeros(n, np.uint32)
    kw = dict(use_compression_tolerance=not exact)
    for a, b in ((GOLDEN_DMO, packed), (GOLDEN_DMO, other), (other, other)):
        ours, theirs = compare.compare_catalogues(a, b, **kw), \
            jax_compare.compare_catalogues(a, b, **kw)
        assert ours.report() == theirs.report()
        assert (ours.identical, ours.n_compared) == (theirs.identical, theirs.n_compared)
    # the compressed copy is equal at filter tolerance, not exactly
    assert compare.compare_catalogues(GOLDEN_DMO, packed, **kw).identical != exact
    assert compare.compare_catalogues(GOLDEN_DMO, packed, scale_atol=1e-2).report() == \
        jax_compare.compare_catalogues(GOLDEN_DMO, packed, scale_atol=1e-2).report()


@pytest.mark.parametrize("ext", ["rst", "tex"])
def test_property_table_docs_byte_equal(tmp_path, ext):
    """One row per property of the table, with the 32 footnotes,
    byte-equal to the JAX generator's text and file."""
    gen, jax_gen = ((docs.generate_rst, jax_docs.generate_rst) if ext == "rst"
                    else (docs.generate_latex, jax_docs.generate_latex))
    ours, theirs = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    text = gen(ours)
    assert text == jax_gen(theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    row = "   * - ``" if ext == "rst" else r"\texttt{"
    assert sum(line.startswith(row) for line in text.splitlines()) == len(full_property_table())


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tools_sim"))
    sim = make_mock_simulation(tmp, n_halos=4, n_field=2000, boxsize=15.0, seed=9)
    mem = os.path.join(tmp, "mem.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], mem)
    return dict(sim, tmp=tmp, membership=mem)


def test_virtual_snapshot_matches(sim, tmp_path):
    """Virtual datasets with the same relative sources, resolving to the
    snapshot's and the membership file's data, and the same copied
    metadata groups."""
    out = tmp_path / "out"
    ours, theirs = str(out / "port_virtual.hdf5"), str(out / "jax_virtual.hdf5")
    virtual_snapshot.make_virtual_snapshot(sim["snapshot"], sim["membership"], ours)
    jax_virtual.make_virtual_snapshot(sim["snapshot"], sim["membership"], theirs)
    assert_same_h5(ours, theirs)
    with h5py.File(ours, "r") as f, h5py.File(sim["membership"], "r") as m:
        ds = f["PartType1/GroupNr_bound"]
        assert ds.is_virtual
        assert ds.virtual_sources()[0].file_name == os.path.relpath(sim["membership"], out)
        np.testing.assert_array_equal(ds[...], m["PartType1/GroupNr_bound"][...])


@pytest.mark.parametrize("dmo", [True, False], ids=["dmo", "hydro"])
def test_empty_catalogue_matches(sim, tmp_path, dmo):
    """The zero-halo catalogue: the same datasets, each with the units,
    description and compression attributes of a full catalogue's."""
    ours, theirs = str(tmp_path / "port_empty.hdf5"), str(tmp_path / "jax_empty.hdf5")
    n = virtual_snapshot.create_empty_catalogue(sim["snapshot"], ours, dmo=dmo)
    assert n == jax_virtual.create_empty_catalogue(sim["snapshot"], theirs, dmo=dmo)
    assert_same_h5(ours, theirs)
    with h5py.File(ours, "r") as f:
        ds = f["BoundSubhalo/TotalMass"]
        assert ds.shape == (0,) and ds.attrs["Lossy compression filter"] == b"FMantissa9"
        assert "Conversion factor to CGS (not including cosmological corrections)" in ds.attrs


def test_timing_report_on_port_catalogue(sim, tmp_path):
    """The port's entry with halo and property timings over two chunks;
    both tools' statistics, per-group seconds and report text equal, and
    the array halves give the same from the arrays."""
    path = str(tmp_path / "timed.hdf5")
    specs = [HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "Ndm")),
             HaloTypeSpec(kind="SO", group="SO/200_crit", keys=("r", "Mtot"), so_type="crit",
                          so_multiple=200.0, centrals_only=True)]
    run.compute_halo_properties(sim["snapshot"], sim["membership"], sim["hbt_basename"], path,
                                specs=specs, nr_chunks=2, record_halo_timings=True,
                                record_property_timings=True, device="cpu", verbose=False)
    stats = timing_analysis.analyze(path)
    assert stats == jax_timing.analyze(path)
    per_group = timing_analysis.analyze_properties(path)
    assert per_group == jax_timing.analyze_properties(path)
    assert list(per_group) and all(v > 0 for v in per_group.values())
    assert timing_analysis.analyze_properties(path, top=1) == jax_timing.analyze_properties(
        path, top=1)
    text = timing_analysis.report(path)
    assert text == jax_timing.report(path)
    assert "per-calculation time" in text
    with h5py.File(path, "r") as f:
        arrays = timing_analysis.timing_stats(f["InputHalos/process_time"][...],
                                              f["InputHalos/n_loop"][...],
                                              f["InputHalos/NumberOfBoundParticles"][...])
        found = []
        f.visititems(lambda n, o: found.append((n, o[()])) if isinstance(o, h5py.Dataset)
                     else None)
    assert arrays == stats and timing_analysis.group_seconds(found) == per_group
    assert timing_analysis.format_report(arrays, per_group) == text
    # a catalogue without timings raises as the JAX tool does
    with pytest.raises(KeyError):
        timing_analysis.analyze(GOLDEN_DMO)
