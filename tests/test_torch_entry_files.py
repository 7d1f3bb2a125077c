"""The entry's file half in the port against the JAX package's readers.

On the written DMO (seed 11) and hydro (seed 61) mocks with their
membership files: the HBTplus reader and ``mock_catalogue``, the
snapshot metadata (from the file and from ``mock_metadata``), the
one-chunk particle read, the parameter mirror, the FOF reader and the
catalogue writer, each against its JAX original, exactly; and every
argument the one-chunk entry does not cover raises.
"""

import copy
import dataclasses
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

from soap_tpu.core.params import ParameterFile as JaxParameterFile
from soap_tpu.io import swift_snapshot as jax_snap
from soap_tpu.io.fof_catalogue import read_fof_groups as jax_read_fof
from soap_tpu.io.halo_catalogue import read_hbtplus_catalogue as jax_read_hbt
from soap_tpu.pipeline import chunks as jax_chunks
from soap_tpu.pipeline.engine import READ_RADIUS_FACTOR, min_physical_radius
from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.pipeline.run import make_context as jax_make_context
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu.utils import mock_data as jax_mock
from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
from soap_tpu_torch.io import swift_snapshot
from soap_tpu_torch.io.catalogue_writer import read_catalogue, write_catalogue
from soap_tpu_torch.io.fof_catalogue import read_fof_groups
from soap_tpu_torch.io.halo_catalogue import read_hbtplus_catalogue
from soap_tpu_torch.pipeline import chunks, run
from soap_tpu_torch.utils import mock_data
from soap_tpu_torch.utils.parity import catalogue_differences

MOCKS = {
    "dmo": dict(n_halos=8, n_field=5000, boxsize=20.0, seed=11),
    "hydro": dict(n_halos=5, n_field=3000, boxsize=18.0, seed=61, hydro=True),
}


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """Each mock written by the JAX package (snapshot, HBTplus catalogue,
    membership), with both packages' metadata of snapshot + membership."""
    out = {}
    for name, kw in MOCKS.items():
        tmp = str(tmp_path_factory.mktemp(name))
        sim = jax_mock.make_mock_simulation(tmp, **kw)
        mem = os.path.join(tmp, "membership.hdf5")
        run_group_membership(sim["snapshot"], sim["hbt_basename"], mem)
        out[name] = dict(
            sim, tmp=tmp, membership=mem, hydro=kw.get("hydro", False),
            jax=jax_snap.SnapshotMetadata(sim["snapshot"], [mem]),
            port=swift_snapshot.SnapshotMetadata(sim["snapshot"], [mem]),
            uni=mock_data.build_mock_universe(**kw),
        )
    return out


def _same_array(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _same_catalogue(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "passthrough":
            assert list(a) == list(b)
            for k in b:
                _same_array(a[k], b[k], k)
        elif isinstance(b, np.ndarray):
            _same_array(a, b, f.name)
        else:
            assert a == b, f.name


# ----------------------------------------------------------- catalogues

@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_read_hbtplus_catalogue_matches(sims, mock):
    s = sims[mock]
    h = s["jax"].h
    _same_catalogue(read_hbtplus_catalogue(s["hbt_basename"], h), jax_read_hbt(s["hbt_basename"], h))
    _same_catalogue(read_hbtplus_catalogue(s["hbt_basename"], h, keep_orphans=True),
                    jax_read_hbt(s["hbt_basename"], h, keep_orphans=True))


@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_mock_catalogue_matches_reader(sims, mock):
    s = sims[mock]
    _same_catalogue(run.mock_catalogue(s["uni"]), jax_read_hbt(s["hbt_basename"], s["jax"].h))


def test_hbtplus_sorted_layout_and_missing_catalogue(sims, tmp_path):
    """The sorted single-file layout (one dataset per Subhalos field, a
    Particles group) reads as the JAX reader reads it; a missing
    catalogue raises FileNotFoundError in both."""
    s = sims["dmo"]
    with h5py.File(s["hbt_basename"] + ".0.hdf5", "r") as f:
        subs = f["Subhalos"][...]
    path = str(tmp_path / "sorted.hdf5")
    with h5py.File(path, "w") as f:
        for name in subs.dtype.names:
            f.create_dataset(f"Subhalos/{name}", data=subs[name])
        f.create_dataset("Particles/ParticleIDs", data=np.arange(3, dtype=np.uint64))
    _same_catalogue(read_hbtplus_catalogue(path, 0.7), jax_read_hbt(path, 0.7))
    for reader in (read_hbtplus_catalogue, jax_read_hbt):
        with pytest.raises(FileNotFoundError):
            reader(str(tmp_path / "nothing"), 0.7)


# ------------------------------------------------------------- metadata

#: SnapshotMetadata's fields the entry reads (make_context, the reads,
#: the sort and the catalogue)
META_FIELDS = (
    "a", "z", "h", "boxsize", "critical_density", "mean_density", "virBN98",
    "dark_matter_softening", "baryon_softening", "nu_softening", "AGN_delta_T",
    "cosmology_attrs", "snap_units_cgs", "code_units_cgs", "constants_cgs",
    "named_columns", "ptypes", "nr_cells", "nr_files", "snipshot",
)
ARRAY_FIELDS = ("observer_position", "dimension", "cell_size", "cell_centres")


def _same_attrs(got, want):
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        _same_array(got[k], want[k], k)


def _same_units(got, want):
    assert {k: dataclasses.astuple(u) for k, u in got.units.items()} == {
        k: dataclasses.astuple(u) for k, u in want.units.items()}


@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_snapshot_metadata_matches(sims, mock):
    ours, theirs = sims[mock]["port"], sims[mock]["jax"]
    for name in META_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
    for name in ARRAY_FIELDS:
        _same_array(getattr(ours, name), getattr(theirs, name), name)
    _same_attrs(ours.header, theirs.header)
    _same_attrs(ours.parameters, theirs.parameters)
    _same_units(ours.units, theirs.units)
    assert dataclasses.asdict(ours.cosmology) == dataclasses.asdict(theirs.cosmology)
    assert list(ours.datasets) == list(theirs.datasets)
    for pt, names in theirs.datasets.items():
        assert list(ours.datasets[pt]) == list(names), pt
        for name, info in names.items():
            mine = ours.datasets[pt][name]
            assert (mine.name, mine.dtype, mine.row_shape, mine.a_exponent, mine.file_template) \
                == (info.name, info.dtype, info.row_shape, info.a_exponent, info.file_template)
            assert dataclasses.astuple(mine.unit) == dataclasses.astuple(info.unit)
    assert list(ours.template_layouts) == list(theirs.template_layouts)
    for template, layouts in theirs.template_layouts.items():
        for pt, arrays in layouts.items():
            for a, b in zip(ours.template_layouts[template][pt], arrays):
                _same_array(a, b, (template, pt))


@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_mock_metadata_entry_fields_match(sims, mock):
    """``mock_metadata`` carries the fields the sort and the catalogue read
    as ``SnapshotMetadata`` reads them from the written mock."""
    ours, theirs = run.mock_metadata(sims[mock]["uni"]), sims[mock]["jax"]
    assert (ours.code_units_cgs, ours.nr_cells) == (theirs.code_units_cgs, theirs.nr_cells)
    for name in ("dimension", "cell_size", "cell_centres"):
        _same_array(getattr(ours, name), getattr(theirs, name), name)
    _same_attrs(ours.header, theirs.header)
    _same_attrs(ours.parameters, theirs.parameters)
    _same_units(ours.units, theirs.units)


# --------------------------------------------------------- particle read

def _jax_read(s, cat, specs, ptypes):
    """What the JAX run reads and hands its staging for these halos
    (``soap_tpu/pipeline/chunks.py::process_chunks``' read function)."""
    meta = s["jax"]
    ctx = jax_make_context(meta, ptypes, not s["hydro"])
    floor_com = min_physical_radius(specs) / ctx.a
    mask = meta.mask_cells_for_spheres(
        np.mod(cat.cofp, meta.boxsize),
        np.maximum(cat.search_radius * jax_chunks.READ_MARGIN,
                   floor_com * READ_RADIUS_FACTOR**2) + 0.5 * float(np.max(meta.cell_size)),
    )
    wanted = {pt: [f for f in jax_chunks.BASE_FIELDS if f in meta.datasets[pt]] for pt in ptypes}
    for pt, names in jax_chunks.required_datasets(specs, meta).items():
        for n in names:
            if n not in wanted.get(pt, []):
                wanted.setdefault(pt, []).append(n)
    return mask, jax_snap.read_masked_cells(meta, mask, wanted)


@pytest.mark.parametrize("halos", ["all", "two"])
@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_read_chunk_fields_matches(sims, mock, halos):
    """The port's one-chunk read against the JAX read under the JAX mask,
    array for array (every halo, or two, which leave cells unread)."""
    s = sims[mock]
    dmo = not s["hydro"]
    params = None if dmo else ParameterFile(parameter_file_path("COLIBRE_THERMAL"))
    jparams = None if dmo else JaxParameterFile(
        parameter_dictionary=copy.deepcopy(params.parameters))
    ptypes, specs = run.entry_plan(s["port"], dmo, params)
    jspecs = jax_build_specs(jparams, dmo, bn98_value=s["jax"].virBN98)
    jcat = jax_read_hbt(s["hbt_basename"], s["jax"].h)
    cat = read_hbtplus_catalogue(s["hbt_basename"], s["jax"].h)
    if halos == "two":
        # the two smallest halos and the bound subhalo alone: no fixed
        # aperture floors the read radius, so cells stay unread
        keep = np.isin(np.arange(cat.nr_halos), np.argsort(cat.search_radius)[:2])
        cat, jcat = cat.select(keep), jcat.select(keep)
        specs = [sp for sp in specs if sp.kind == "bound"]
        jspecs = [sp for sp in jspecs if sp.kind == "bound"]
    mask, want = _jax_read(s, jcat, jspecs, ptypes)
    assert halos == "all" or not mask.all()
    ages = run.age_table(s["port"])
    got = chunks.read_chunk_fields(s["port"], cat, specs, ptypes, ages)
    assert list(got) == ptypes
    for pt in ptypes:
        pos, fields = got[pt]
        _same_array(pos, np.mod(want[pt]["Coordinates"], s["jax"].boxsize), pt)
        names = [n for n in want[pt] if n not in ("Coordinates", "__cells__")]
        if pt == "PartType4":
            names.append("StellarAges")
        assert list(fields) == names, pt
        for name in names:
            if name == "StellarAges":
                age_a, age_t = ages
                t_now = np.interp(float(s["jax"].a), age_a, age_t)
                ref = np.maximum(t_now - np.interp(want[pt]["BirthScaleFactors"], age_a, age_t),
                                 0.0).astype(np.float32)
            else:
                ref = want[pt][name]
            _same_array(fields[name], ref, f"{pt}/{name}")


@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_mock_fields_equal_file_read(sims, mock):
    """With every cell read, ``mock_fields`` hands staging the same arrays
    as the read of the written files: the entry's in-memory half sees the
    same inputs on a mock as on files."""
    s = sims[mock]
    dmo = not s["hydro"]
    meta = s["port"]
    ptypes, specs = run.entry_plan(meta, dmo)
    ages = run.age_table(meta)
    cat = read_hbtplus_catalogue(s["hbt_basename"], meta.h)
    read = chunks.read_chunk_fields(meta, cat, specs, ptypes, ages)
    mock_ = chunks.mock_fields(s["uni"], specs, run.mock_metadata(s["uni"]), ptypes, ages)
    assert list(read) == list(mock_)
    for pt in read:
        _same_array(mock_[pt][0], read[pt][0], pt)
        assert list(mock_[pt][1]) == list(read[pt][1])
        for name, arr in read[pt][1].items():
            _same_array(mock_[pt][1][name], arr, f"{pt}/{name}")


def test_multifile_read_matches(sims, tmp_path):
    """A snapshot split over three files, the membership in one: the read
    plans and the reads, against the JAX package's."""
    s = sims["hydro"]
    template = str(tmp_path / "snap.{file_nr}.hdf5")
    jax_mock.split_snapshot_files(s["snapshot"], template, 3)
    ours = swift_snapshot.SnapshotMetadata(template, [s["membership"]])
    theirs = jax_snap.SnapshotMetadata(template, [s["membership"]])
    rng = np.random.default_rng(4)
    mask = rng.random(ours.nr_cells) < 0.6
    props = {"PartType0": ["Coordinates", "Masses", "GroupNr_bound"],
             "PartType1": ["Coordinates", "GroupNr_bound"], "PartType5": ["Masses"]}
    for pt in props:
        a = swift_snapshot.plan_masked_read(ours, pt, mask)
        b = jax_snap.plan_masked_read(theirs, pt, mask)
        _same_array(a[0], b[0])
        assert [dataclasses.astuple(x) for x in a[1]] == [dataclasses.astuple(x) for x in b[1]]
        assert a[2] == b[2]
    got = swift_snapshot.read_masked_cells(ours, mask, props)
    want = jax_snap.read_masked_cells(theirs, mask, props)
    for pt in props:
        assert list(got[pt]) == list(want[pt])
        for name in want[pt]:
            _same_array(got[pt][name], want[pt][name], f"{pt}/{name}")
    with pytest.raises(KeyError):
        swift_snapshot.read_masked_cells(ours, mask, {"PartType1": ["Nothing"]})


def test_reference_snapshot_matches(sims, tmp_path):
    """A snapshot without stars and black holes takes their datasets'
    metadata from a reference snapshot, and reads them as empty arrays,
    as the JAX reader does."""
    s = sims["hydro"]
    highz = str(tmp_path / "snapshot_highz.hdf5")
    shutil.copy(s["snapshot"], highz)
    with h5py.File(highz, "r+") as f:
        for pt in ("PartType4", "PartType5"):
            del f[pt]
            for grp in ("Cells/Counts", "Cells/OffsetsInFile", "Cells/Files"):
                del f[f"{grp}/{pt}"]
    ours = swift_snapshot.SnapshotMetadata(highz, ref_filename=s["snapshot"])
    theirs = jax_snap.SnapshotMetadata(highz, ref_filename=s["snapshot"])
    assert (ours.ptypes, ours.ref_ptypes) == (theirs.ptypes, theirs.ref_ptypes)
    assert ours.ref_ptypes == ["PartType4", "PartType5"]
    for pt in ("PartType4", "PartType5"):
        assert {n: (i.dtype, i.row_shape, i.file_template) for n, i in ours.datasets[pt].items()} \
            == {n: (i.dtype, i.row_shape, i.file_template) for n, i in theirs.datasets[pt].items()}
    props = {"PartType1": ["Coordinates", "Masses"],
             "PartType4": ["Coordinates", "Masses", "InitialMasses"]}
    mask = np.ones(ours.nr_cells, bool)
    got = swift_snapshot.read_masked_cells(ours, mask, props)
    want = jax_snap.read_masked_cells(theirs, mask, props)
    for pt in props:
        for name in want[pt]:
            _same_array(got[pt][name], want[pt][name], f"{pt}/{name}")
    assert len(got["PartType4"]["Masses"]) == 0 < len(got["PartType1"]["Masses"])


# -------------------------------------------------- parameters, FOF, file

def test_write_parameters_matches(tmp_path):
    """The ``SOAP.used_parameters.yml`` mirror after the property queries
    wrote their defaults, byte for byte."""
    ours = ParameterFile(parameter_file_path("FLAMINGO"))
    theirs = JaxParameterFile(parameter_dictionary=copy.deepcopy(ours.parameters))
    for p in (ours, theirs):
        p.get_property_filters("SubhaloProperties", ["TotalMass", "NotAProperty"])
    ours.write_parameters(str(tmp_path / "ours.yml"))
    theirs.write_parameters(str(tmp_path / "theirs.yml"))
    assert (tmp_path / "ours.yml").read_bytes() == (tmp_path / "theirs.yml").read_bytes()


@pytest.mark.parametrize("columns", [("Sizes", "Radii"), ()])
def test_read_fof_groups_matches(tmp_path, columns):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "fof_0077.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("Groups/GroupIDs", data=np.arange(1, 21, dtype=np.int32))
        f.create_dataset("Groups/Centres", data=rng.random((20, 3)).astype(np.float32))
        f.create_dataset("Groups/Masses", data=rng.random(20).astype(np.float32))
        for c in columns:
            f.create_dataset(f"Groups/{c}", data=rng.random(20) * 100)
    got, want = read_fof_groups(path), jax_read_fof(path)
    assert list(got) == list(want)
    for k in want:
        _same_array(got[k], want[k], k)


@pytest.fixture(scope="module")
def mem_dmo(sims, tmp_path_factory):
    """The in-memory half on the DMO mock's ``mock_metadata``,
    ``mock_catalogue`` and ``mock_fields`` with a short list, written."""
    s = sims["dmo"]
    meta = run.mock_metadata(s["uni"])
    specs = [sp for sp in run.entry_plan(meta, True)[1]
             if sp.group in ("BoundSubhalo", "SO/200_crit", "ExclusiveSphere/50kpc")]
    ptypes, specs = run.entry_plan(meta, True, None, specs)
    out = run.build_catalogue(meta, run.mock_catalogue(s["uni"]),
                              chunks.mock_fields(s["uni"], specs, meta, ptypes), specs,
                              device="cpu")
    path = str(tmp_path_factory.mktemp("mem") / "out" / "cat.hdf5")
    write_catalogue(path, out.catalogue)
    return out, specs, path


def test_catalogue_file_round_trip(mem_dmo):
    """A catalogue written and read back holds what was in memory: every
    group's attributes, every dataset with its attributes, the stamps."""
    cat, path = mem_dmo[0].catalogue, mem_dmo[2]
    back = read_catalogue(path)
    assert (back.n_halos, back.git_hash, back.date, back.snapshot_date) == (
        cat.n_halos, cat.git_hash, cat.date, cat.snapshot_date)
    assert sorted(back.datasets) == sorted(cat.datasets)
    for path_, ds in cat.datasets.items():
        _same_array(back.datasets[path_].data, ds.data, path_)
        assert sorted(back.datasets[path_].attrs) == sorted(ds.attrs), path_
    for group, attrs in cat.groups.items():
        assert sorted(back.groups[group]) == sorted(attrs), group
    assert catalogue_differences(back, read_catalogue(path)) == []


def test_in_memory_half_equals_file_half(sims, mem_dmo, tmp_path):
    """``build_catalogue`` on the mock's inputs writes the file run's
    catalogue (the input names under ``Parameters`` apart)."""
    s = sims["dmo"]
    mem, specs, path = mem_dmo
    run.compute_halo_properties(
        s["snapshot"], s["membership"], s["hbt_basename"], str(tmp_path / "file.hdf5"),
        specs=specs, device="cpu", verbose=False)
    ours, theirs = read_catalogue(path), read_catalogue(str(tmp_path / "file.hdf5"))
    for name in ("swift_filename", "membership_filename", "halo_basename"):
        ours.groups["Parameters"][name] = theirs.groups["Parameters"][name]
    assert catalogue_differences(theirs, ours) == []
    assert mem.engine_seconds > 0 and mem.post_seconds > 0


@pytest.mark.parametrize("arg", [
    dict(nr_chunks=2), dict(scratch_dir="scratch"), dict(host_count=2),
    dict(record_halo_timings=True), dict(record_property_timings=True),
    dict(halo_format="NoSuchFinder"),
])
def test_unsupported_arguments_raise(sims, tmp_path, arg):
    """A finder no reader knows, and a multi-host run without a scratch
    directory, raise ValueError before writing (the four other finders
    run: ``tests/test_torch_finder_entry.py``); the chunk, scratch and
    timing arguments the port once refused now run and write the
    catalogue with what they add."""
    s = sims["dmo"]
    out = tmp_path / "out.hdf5"
    kw = dict(arg, scratch_dir=str(tmp_path / arg["scratch_dir"])) if "scratch_dir" in arg \
        else arg
    if "halo_format" in arg or "host_count" in arg:
        with pytest.raises(ValueError):
            run.compute_halo_properties(
                s["snapshot"], s["membership"], s["hbt_basename"], str(out),
                device="cpu", verbose=False, **kw)
        assert not os.path.exists(out)
        if "halo_format" in arg:
            meta = run.mock_metadata(s["uni"])
            with pytest.raises(ValueError, match="HBTplus, VR, Gadget4, SubfindEagle, Rockstar"):
                run.build_catalogue(meta, run.mock_catalogue(s["uni"]), {}, [], device="cpu",
                                    halo_format=arg["halo_format"])
        return
    # one torch thread: beside other test workers the default pool makes
    # the per-spec programs of record_property_timings many times slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = run.compute_halo_properties(
            s["snapshot"], s["membership"], s["hbt_basename"], str(out), device="cpu",
            verbose=False, **kw)
    finally:
        torch.set_num_threads(threads)
    names = set(read_catalogue(str(out)).datasets)
    assert len(got.chunks) == arg.get("nr_chunks", 1)
    if "scratch_dir" in kw:
        assert os.listdir(kw["scratch_dir"]) == ["chunk_0.hdf5"]
    if "record_halo_timings" in arg:
        assert {"InputHalos/process_time", "InputHalos/n_loop"} <= names
    if "record_property_timings" in arg:
        assert "BoundSubhalo/TotalMass_time" in names
