"""The entry's host modules in the port against the JAX package's.

Each port copy (``core/units.py``, the extended property table,
``core/category_filter.py``, ``pipeline/run.py``'s category filters and
disabled-key drop, ``pipeline/derived.py``, ``io/catalogue.py``'s sort,
``io/fof_catalogue.py``'s join) is held to its original on the same
seeded numpy inputs, exactly.  No engine runs here.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from soap_tpu.core import category_filter as jax_cf
from soap_tpu.core import units as jax_units
from soap_tpu.core.params import ParameterFile as JaxParameterFile
from soap_tpu.core.registry import COMPRESSION_DESCRIPTION as JAX_COMPRESSION
from soap_tpu.core.registry import full_property_table as jax_table
from soap_tpu.io.catalogue_writer import spatial_sort_order as jax_sort
from soap_tpu.io.fof_catalogue import fof_join as jax_fof_join
from soap_tpu.io.swift_snapshot import SnapshotMetadata as JaxSnapshotMetadata
from soap_tpu.pipeline import derived as jax_derived
from soap_tpu.pipeline import run as jax_run
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu.utils import mock_data as jax_mock
from soap_tpu_torch.core import category_filter as cf
from soap_tpu_torch.core import units
from soap_tpu_torch.core.params import PARAMETER_FILES, ParameterFile, parameter_file_path
from soap_tpu_torch.core.registry import COMPRESSION_DESCRIPTION, full_property_table
from soap_tpu_torch.io.catalogue import property_attributes, spatial_sort_order
from soap_tpu_torch.io.fof_catalogue import fof_join
from soap_tpu_torch.io.swift_snapshot import SnapshotMetadata
from soap_tpu_torch.pipeline import derived
from soap_tpu_torch.pipeline import run
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils import mock_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the two written mocks: the DMO end-to-end test's and the COLIBRE test's
MOCKS = {
    "dmo": dict(n_halos=8, n_field=5000, boxsize=20.0, seed=11),
    "hydro": dict(n_halos=5, n_field=3000, boxsize=18.0, seed=61, hydro=True),
}
TABLE_FIELDS = ("name", "dmo", "particle_properties", "dtype", "unit", "description",
                "compression", "physical", "a_exponent")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each mock's snapshot, written by the JAX package, read back by both
    packages' ``SnapshotMetadata``, beside the port's ``mock_metadata``."""
    out = {}
    for name, kw in MOCKS.items():
        tmp = str(tmp_path_factory.mktemp(name))
        sim = jax_mock.make_mock_simulation(tmp, **kw)
        out[name] = dict(
            jax=JaxSnapshotMetadata(sim["snapshot"]), port=SnapshotMetadata(sim["snapshot"]),
            mock=run.mock_metadata(mock_data.build_mock_universe(**kw)),
        )
    return out


# ---------------------------------------------------------------- units

@pytest.mark.parametrize("mock", sorted(MOCKS))
@pytest.mark.parametrize("source", ["port", "mock"])
def test_unit_registry_matches(written, mock, source):
    theirs = jax_units.UnitRegistry.from_snapshot_metadata(written[mock]["jax"])
    ours = units.UnitRegistry.from_snapshot_metadata(written[mock][source])
    assert (ours.a, ours.h, ours.constants_cgs) == (theirs.a, theirs.h, theirs.constants_cgs)
    assert {k: dataclasses.astuple(u) for k, u in ours.units.items()} == {
        k: dataclasses.astuple(u) for k, u in theirs.units.items()
    }


@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_every_property_unit_and_attributes_match(written, mock):
    """Every property of the table: its parsed unit, and its dataset
    attributes as the JAX writer's ``write_property`` makes them."""
    theirs = jax_units.UnitRegistry.from_snapshot_metadata(written[mock]["jax"])
    ours = written[mock]["mock"].units
    jt = jax_table()
    for key, jp in jt.items():
        p = full_property_table()[key]
        assert dataclasses.astuple(ours.parse(p.unit)) == dataclasses.astuple(
            theirs.parse(jp.unit)), key
        unit = theirs.parse(jp.unit)
        if not jp.physical and jp.a_exponent:
            unit = unit * (theirs.units["a"] ** jp.a_exponent)
        want = jax_units.attributes_from_unit(unit, jp.physical, jp.a_exponent, theirs)
        want["Description"] = np.bytes_(jp.description)
        want["Lossy compression filter"] = np.bytes_(jp.compression)
        got = property_attributes(p, ours, {"Masked": False})
        assert got.pop("Masked") is False
        assert list(got) == list(want), key
        for k in want:
            assert type(got[k]) is type(want[k]) and got[k] == want[k], (key, k)


@pytest.mark.parametrize("mock", sorted(MOCKS))
def test_unit_from_attributes_matches(written, mock):
    """The unit of every particle dataset of the snapshot, from its
    attributes, as each package reads it."""
    theirs, ours = written[mock]["jax"], written[mock]["port"]
    n = 0
    for pt, names in theirs.datasets.items():
        for name, info in names.items():
            got = units.unit_from_attributes(info.attrs, ours.units)
            want = jax_units.unit_from_attributes(info.attrs, theirs.units)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), (pt, name)
            assert dataclasses.astuple(ours.datasets[pt][name].unit) == dataclasses.astuple(
                info.unit)
            n += 1
    assert n >= 5


def test_unit_algebra_and_parse_errors():
    ucgs = {"Unit length in cgs (U_L)": 3.0e24, "Unit mass in cgs (U_M)": 2e43,
            "Unit time in cgs (U_t)": 3e19}
    reg = units.UnitRegistry(ucgs, ucgs, 0.5, 0.7)
    jreg = jax_units.UnitRegistry(ucgs, ucgs, 0.5, 0.7)
    for expr in ("snap_mass*snap_length**2/snap_time**2", "(snap_length/snap_time)**0.5",
                 "km/s", "a", "2*snap_mass", "newton_G*Msun/Mpc"):
        assert dataclasses.astuple(reg.parse(expr)) == dataclasses.astuple(jreg.parse(expr))
    for bad in ("furlong", "snap_mass snap_time", "snap_mass $"):
        with pytest.raises(ValueError):
            reg.parse(bad)
    with pytest.raises(ValueError):
        reg["snap_mass"].conversion_to(reg["snap_time"])


# ------------------------------------------------------- property table

@pytest.mark.parametrize("field", TABLE_FIELDS)
def test_property_table_field_matches(field):
    ours, theirs = full_property_table(), jax_table()
    for key, p in theirs.items():
        assert getattr(ours[key], field) == getattr(p, field), key
    assert COMPRESSION_DESCRIPTION == JAX_COMPRESSION


# ----------------------------------------------------- category filters

def _filters(name):
    if name == "defaults":
        return None, None
    port = ParameterFile(parameter_file_path(name))
    return (port.get_filters(cf.DEFAULT_FILTERS),
            JaxParameterFile(parameter_dictionary=copy.deepcopy(port.parameters))
            .get_filters(jax_cf.DEFAULT_FILTERS))


def _counts(n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 250, n) for k in ("Ngas", "Ndm", "Nstar", "Nbh")}


@pytest.mark.parametrize("dmo", [True, False])
@pytest.mark.parametrize("name", ("defaults",) + PARAMETER_FILES)
def test_category_filter_matches(name, dmo):
    ours_f, theirs_f = _filters(name)
    ours, theirs = cf.CategoryFilter(ours_f, dmo), jax_cf.CategoryFilter(theirs_f, dmo)
    assert ours.filters == theirs.filters
    sub = _counts(300, 5)
    del sub["Nbh"]  # a missing count reads as zero
    got, want = ours.category_masks(sub, 300), theirs.category_masks(sub, 300)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for category in [None, "basic", "nonexistent"] + list(theirs.filters):
        assert repr(ours.filter_metadata(category)) == repr(theirs.filter_metadata(category))
    assert cf.DEFAULT_FILTERS == jax_cf.DEFAULT_FILTERS


def _synthetic_results(specs, n, seed):
    """Random results keyed by a spec list: counts as integers, vectors
    and tensors by the property's shape."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(REPO, "soap_tpu", "core", "property_table.json")) as f:
        shapes = json.load(f)["properties"]
    out = {}
    for s in specs:
        g = out.setdefault(s.group, {})
        for k in s.keys:
            if k in ("Ngas", "Ndm", "Nstar", "Nbh"):
                g[k] = rng.integers(0, 250, n).astype(np.int32)
            else:
                width = int(shapes[k]["shape"])
                g[k] = rng.normal(size=(n,) if width == 1 else (n, width)).astype(np.float32)
    return out


@pytest.mark.parametrize("dmo", [True, False])
@pytest.mark.parametrize("name", PARAMETER_FILES)
def test_apply_category_filters_and_drop_match(name, dmo):
    """Both packages' filters and drops on the same results, keyed by the
    file's spec list: the zeroed values, the attributes, the kept keys and
    the queries' writes into the parameter dictionary."""
    port = ParameterFile(parameter_file_path(name))
    jax_params = JaxParameterFile(parameter_dictionary=copy.deepcopy(port.parameters))
    specs = build_specs(port, dmo, 100.0)
    jspecs = jax_build_specs(jax_params, dmo, 100.0)
    assert port.property_filters == jax_params.property_filters
    res = _synthetic_results(specs, 64, 17)
    jres = copy.deepcopy(res)
    ours = run.apply_category_filters(
        res, cf.CategoryFilter(port.get_filters(cf.DEFAULT_FILTERS), dmo), port, 64, specs)
    theirs = jax_run.apply_category_filters(
        jres, jax_cf.CategoryFilter(jax_params.get_filters(jax_cf.DEFAULT_FILTERS), dmo),
        jax_params, 64, jspecs)
    assert repr(ours) == repr(theirs)
    run.drop_disabled_keys(res, port)
    jax_run.drop_disabled_keys(jres, jax_params)
    assert {g: list(d) for g, d in res.items()} == {g: list(d) for g, d in jres.items()}
    for g in jres:
        for k in jres[g]:
            assert res[g][k].dtype == jres[g][k].dtype
            assert np.array_equal(res[g][k], jres[g][k]), (g, k)
    assert port.parameters == jax_params.parameters
    run.drop_disabled_keys(res, None)  # no file: nothing dropped


def test_group_to_base_matches():
    assert run.GROUP_TO_BASE == jax_run.GROUP_TO_BASE


# ------------------------------------------------------------- derived

def _same(got, want):
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_derived_match_random(seed):
    rng = np.random.default_rng(seed)
    hay = rng.permutation(rng.choice(10**6, 500, replace=False)).astype(np.int64)
    needles = np.concatenate([rng.choice(hay, 300), rng.integers(-5, 10**6, 200)])
    _same(derived.match(needles, hay), jax_derived.match(needles, hay))
    _same(derived.match(needles, hay[:0]), jax_derived.match(needles, hay[:0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_derived_host_and_rank_random(seed):
    rng = np.random.default_rng(seed)
    n = 400
    host = rng.integers(-1, 60, n).astype(np.int64)
    central = np.zeros(n, bool)
    for h in np.unique(host[host >= 0]):
        central[rng.choice(np.flatnonzero(host == h))] = True
    track = rng.permutation(n).astype(np.int64) + 1000
    mass = rng.choice([1.0, 2.0, 3.0, 5.0], n).astype(np.float32)  # ties
    _same(derived.host_halo_index(host, central), jax_derived.host_halo_index(host, central))
    _same(derived.subhalo_rank_by_bound_mass(host, track, mass),
          jax_derived.subhalo_rank_by_bound_mass(host, track, mass))


@pytest.mark.parametrize("seed", [0, 1])
def test_derived_reduced_snapshot_random(seed):
    rng = np.random.default_rng(seed)
    mass = 10.0 ** rng.uniform(9, 14.5, 2000)
    mass[rng.random(2000) < 0.1] = 0.0  # masked halos
    for kw in (dict(halos_per_bin=10, bin_size_dex=0.5, min_halo_mass_msun=1e11),
               dict(halos_per_bin=200, bin_size_dex=0.1, min_halo_mass_msun=1e10, seed=3)):
        _same(derived.included_in_reduced_snapshot(mass, **kw),
              jax_derived.included_in_reduced_snapshot(mass, **kw))
    zero = np.zeros(5)
    _same(derived.included_in_reduced_snapshot(zero, 1, 0.5, 1e10),
          jax_derived.included_in_reduced_snapshot(zero, 1, 0.5, 1e10))


@pytest.mark.parametrize("seed", [0, 1])
def test_derived_progenitor_random(seed):
    rng = np.random.default_rng(seed)
    track = rng.permutation(300).astype(np.int64)
    other = rng.permutation(np.concatenate([track[:200], 1000 + np.arange(50)]))
    _same(derived.progenitor_descendant_index(track, other),
          jax_derived.progenitor_descendant_index(track, other))
    _same(derived.progenitor_descendant_index(track, None),
          jax_derived.progenitor_descendant_index(track, None))


def test_derived_edge_cases():
    """``tests/test_derived.py``'s cases, through both packages."""
    hay = np.array([10, 3, 7, 5], dtype=np.int64)
    needles = np.array([5, 10, 99, 3], dtype=np.int64)
    _same(derived.match(needles, hay), jax_derived.match(needles, hay))
    np.testing.assert_array_equal(derived.match(needles, hay), [3, 0, -1, 1])
    host = np.array([1, 1, 2, -1, 2], dtype=np.int64)
    central = np.array([True, False, True, False, False])
    _same(derived.host_halo_index(host, central), jax_derived.host_halo_index(host, central))
    np.testing.assert_array_equal(derived.host_halo_index(host, central), [0, 0, 2, -1, 2])
    host = np.array([5, 5, 5, 9, -1], dtype=np.int64)
    track = np.array([100, 101, 102, 103, 104], dtype=np.int64)
    mass = np.array([10.0, 30.0, 20.0, 5.0, 1.0])
    _same(derived.subhalo_rank_by_bound_mass(host, track, mass),
          jax_derived.subhalo_rank_by_bound_mass(host, track, mass))
    np.testing.assert_array_equal(derived.subhalo_rank_by_bound_mass(host, track, mass),
                                  [2, 0, 1, 0, 0])
    track = np.array([7, 8, 9], dtype=np.int64)
    prev = np.array([9, 5, 7], dtype=np.int64)
    np.testing.assert_array_equal(derived.progenitor_descendant_index(track, prev), [2, -1, 0])
    empty = np.zeros(0, np.int64)
    _same(derived.host_halo_index(empty, empty.astype(bool)),
          jax_derived.host_halo_index(empty, empty.astype(bool)))
    _same(derived.subhalo_rank_by_bound_mass(empty, empty, empty.astype(float)),
          jax_derived.subhalo_rank_by_bound_mass(empty, empty, empty.astype(float)))


# ------------------------------------------------------- sort and FOF

@pytest.mark.parametrize("cells", [1, 4, 16])
def test_spatial_sort_order_with_ties(cells):
    """Many halos share a cell (and some a centre): the order falls back
    on the catalogue index; centres outside the box wrap, and centres on
    the upper edge stay in the last cell."""
    rng = np.random.default_rng(cells)
    box = 20.0
    centres = rng.uniform(-5.0, 25.0, (500, 3))
    centres[::7] = centres[3]
    centres[::11] = box
    index = rng.permutation(500).astype(np.int64)
    _same(spatial_sort_order(centres, index, box, cells), jax_sort(centres, index, box, cells))


@pytest.mark.parametrize("columns", [("Sizes", "Radii"), ()])
def test_fof_join_matches(columns):
    rng = np.random.default_rng(9)
    ids = rng.permutation(100).astype(np.int64) + 1
    fof = {"GroupIDs": ids, "Centres": rng.random((100, 3)), "Masses": rng.random(100)}
    if columns:
        fof["Sizes"] = rng.integers(1, 1000, 100).astype(np.int64)
        fof["Radii"] = rng.random(100)
    host = rng.choice(np.concatenate([ids, [-1]]), 250)
    central = rng.random(250) < 0.4
    got, want = fof_join(fof, host, central), jax_fof_join(fof, host, central)
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])
    bad = host.copy()
    bad[central] = 10**6
    with pytest.raises(RuntimeError):
        fof_join(fof, bad, central)
