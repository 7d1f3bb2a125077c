"""The port's copies of host code stay equal to the JAX package's.

``soap_tpu_torch`` must run where JAX and h5py are absent, so it carries
copies of ``HaloContext``, ``HaloTypeSpec``, the property key lists and
table, ``build_specs`` and the mock-universe generator instead of
importing them; these tests hold the copies to the originals.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from soap_tpu.core import halo_types as jax_halo_types
from soap_tpu.models import context as jax_context
from soap_tpu.pipeline import engine as jax_engine
from soap_tpu.pipeline import specs as jax_specs
from soap_tpu.utils import mock_data as jax_mock
from soap_tpu_torch.core import halo_types as torch_halo_types
from soap_tpu_torch.models import context as torch_context
from soap_tpu_torch.pipeline import engine as torch_engine
from soap_tpu_torch.pipeline import specs as torch_specs
from soap_tpu_torch.utils import mock_data as torch_mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize(
    "ours,theirs",
    [
        (torch_context.HaloContext, jax_context.HaloContext),
        (torch_engine.HaloTypeSpec, jax_engine.HaloTypeSpec),
    ],
    ids=["HaloContext", "HaloTypeSpec"],
)
def test_dataclass_mirrors_original(ours, theirs):
    assert _fields(ours) == _fields(theirs)


def test_context_helpers_and_ptype_order_match():
    assert torch_context.PTYPE_ORDER == jax_context.PTYPE_ORDER
    kw = dict(a=0.5, z=1.0, G=43.0, boxsize=10.0, critical_density=2.0,
              mean_density=1.0, ptypes=("PartType0", "PartType1"),
              capacities=(128, 256))
    ours, theirs = torch_context.HaloContext(**kw), jax_context.HaloContext(**kw)
    assert ours.segment("PartType1") == theirs.segment("PartType1") == (128, 384)
    assert ours.total_capacity == theirs.total_capacity
    spec = dict(kind="SO", group="SO/200_mean", keys=("r",), so_type="mean",
                so_multiple=200.0)
    assert torch_engine.HaloTypeSpec(**spec).target_density(ours) == \
        jax_engine.HaloTypeSpec(**spec).target_density(theirs)


def test_unit_constants_match():
    for name in ("MPC_CM", "MSUN_G", "UNIT_MASS_G", "UNIT_TIME_S", "G_INTERNAL"):
        assert getattr(torch_mock, name) == getattr(jax_mock, name), name


def _same_array(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("seed", [7, 11])
def test_mock_universe_byte_identical(seed, hydro=False):
    kw = dict(n_halos=6, n_field=3000, boxsize=20.0, seed=seed, n_satellites=2, hydro=hydro)
    ours = torch_mock.build_mock_universe(**kw)
    theirs = jax_mock.build_mock_universe(**kw)
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name == "bound_ids":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        elif f.name == "extra_ptypes" and hydro:
            assert list(a) == list(b) == ["PartType0", "PartType4", "PartType5"]
            for pt in b:
                assert list(a[pt]) == list(b[pt]), pt
                for name in b[pt]:
                    _same_array(np.asarray(a[pt][name]), np.asarray(b[pt][name]), f"{pt}/{name}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("seed", [7, 11])
def test_hydro_mock_universe_byte_identical(seed):
    test_mock_universe_byte_identical(seed, hydro=True)


def test_port_imports_no_jax_soap_tpu_or_h5py():
    """Importing the port, building its spec lists (the defaults and a
    shipped JSON parameter file's) and a context from that file, and
    running the entry's in-memory half (``build_catalogue``) on the CPU
    with that file's list, and over three chunks with the in-memory
    reader and read-ahead, and the membership program's in-memory join
    (``compute_membership``), importing the finder readers, the command
    line and the X-ray calculator, building each other finder's
    catalogue from its array half (and Rockstar's from its files),
    interpolating a mock X-ray table built in memory, importing the
    multi-device module and the graft entry, running the graft entry's
    halo function and the chunk loop over two CPU workers, importing every
    tool module and listing the command line's sixteen subcommands, and
    running the tools' array halves (the membership label check and its
    rejection, the birth-halo lookup, halo matching, FOF radii,
    ``build_matrix``, the hydrogen fractions, the timing statistics and
    report, the lossy-filter emulation and both documentation
    generators), loads no jax, soap_tpu, h5py or yaml; the import primes
    the CPU math library."""
    code = (
        "import sys\n"
        "import soap_tpu_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'soap_tpu', 'h5py', 'yaml')]\n"
        "assert not bad, bad\n"
        "from soap_tpu_torch.ops import cpu_math\n"
        "assert cpu_math._primed\n"
        "import soap_tpu_torch.pipeline.engine, soap_tpu_torch.ops.inertia_loop\n"
        "import soap_tpu_torch.pipeline.specs, soap_tpu_torch.utils.mock_data\n"
        "import soap_tpu_torch.ops.kinematics, soap_tpu_torch.core.registry\n"
        "import soap_tpu_torch.pipeline.run, soap_tpu_torch.pipeline.chunks\n"
        "import soap_tpu_torch.models.chemistry, soap_tpu_torch.core.cosmology\n"
        "specs = soap_tpu_torch.pipeline.specs.build_specs(None, True, 100.0)\n"
        "assert sum(len(s.keys) for s in specs) == 508\n"
        "specs = soap_tpu_torch.pipeline.specs.build_specs(None, False, 100.0)\n"
        "assert sum(len(s.keys) for s in specs) == 4729\n"
        "from soap_tpu_torch.core.params import ParameterFile, parameter_file_path\n"
        "params = ParameterFile(parameter_file_path('COLIBRE_THERMAL'))\n"
        "specs = soap_tpu_torch.pipeline.specs.build_specs(params, False, 100.0)\n"
        "assert sum(len(s.keys) for s in specs) == 4114\n"
        "from soap_tpu_torch.utils.mock_data import build_mock_universe\n"
        "uni = build_mock_universe(n_halos=2, n_field=200, boxsize=8.0, seed=3, hydro=True)\n"
        "meta = soap_tpu_torch.pipeline.run.mock_metadata(uni)\n"
        "soap_tpu_torch.pipeline.run.make_context(meta, ['PartType0'], False, params)\n"
        "import soap_tpu_torch.io.catalogue_writer, soap_tpu_torch.io.swift_snapshot\n"
        "import soap_tpu_torch.io.fof_catalogue, soap_tpu_torch.io.halo_catalogue\n"
        "from soap_tpu_torch.pipeline import run\n"
        "from soap_tpu_torch.pipeline.chunks import mock_fields\n"
        "ptypes, specs = run.entry_plan(meta, False, params)\n"
        "host = mock_fields(uni, specs, meta, ptypes, run.age_table(meta))\n"
        # one thread: a 2-halo run is fastest so, and the test runs
        # beside other test processes
        "import torch; torch.set_num_threads(1)\n"
        "out = run.build_catalogue(meta, run.mock_catalogue(uni), host, specs, params, False,\n"
        "                          device='cpu')\n"
        "assert out.catalogue.n_halos == 2\n"
        "assert 'SOAP/HostHaloIndex' in out.catalogue.datasets\n"
        # the chunk loop in memory: three chunks, read-ahead on
        "uni = build_mock_universe(n_halos=6, n_field=600, boxsize=24.0, seed=5)\n"
        "meta = run.mock_metadata(uni)\n"
        "ptypes, specs = run.entry_plan(meta, True, None)\n"
        "host = mock_fields(uni, specs, meta, ptypes, run.age_table(meta))\n"
        "out = run.build_catalogue(meta, run.mock_catalogue(uni), host, specs, device='cpu',\n"
        "                          nr_chunks=3, prefetch=True)\n"
        "assert len(out.chunks) == 3 and out.catalogue.n_halos == 6\n"
        # the membership program's in-memory half, labels as the mock's
        "from soap_tpu_torch.pipeline.membership import compute_membership\n"
        "import numpy as np\n"
        "ids = np.concatenate(uni.bound_ids)\n"
        "grnr = np.repeat(np.arange(uni.n_halos), [len(b) for b in uni.bound_ids])\n"
        "g, r = compute_membership(uni.ids, ids, grnr, batch_rows=100)\n"
        "assert (g >= 0).sum() == len(ids) and (r[g < 0] == -1).all()\n"
        # the other finders, the command line and the X-ray calculator
        "import soap_tpu_torch.io.finder_readers, soap_tpu_torch.cli, tempfile\n"
        "import soap_tpu_torch.tools.xray_calculator as xc\n"
        "from soap_tpu_torch.utils import mock_finders\n"
        "cat = run.mock_catalogue(uni)\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    for f in ('VR', 'Gadget4', 'SubfindEagle', 'Rockstar', 'RockstarBinary'):\n"
        "        got = mock_finders.finder_catalogue(f, cat, uni.h, uni.a, tmp)\n"
        "        assert (got.nr_bound_part == cat.nr_bound_part).all(), f\n"
        "soap_tpu_torch.cli.build_parser().parse_args(['membership', '--halo-format', 'VR'])\n"
        "bins, tables = xc.mock_table_5d()\n"
        "calc = xc.XrayCalculator.from_arrays(0.1, bins, tables, ['ROSAT'], ['photons_observed'],\n"
        "                                     'cpu')\n"
        "lum = calc.interpolate(np.full(4, 1e-26), np.full(4, 1e7), np.full((4, 9), 0.01),\n"
        "                       np.full(4, 1e39), ['ROSAT'], ['photons_observed'])\n"
        "assert lum.shape == (4, 1) and (lum > 0).all()\n"
        # halo batches over several devices, and the graft entry
        "import soap_tpu_torch.parallel.sharded, soap_tpu_torch.graft_entry\n"
        "fn, (parts, scalars) = soap_tpu_torch.graft_entry.entry('cpu')\n"
        "assert 'BoundSubhalo' in fn(parts, scalars)\n"
        "out = run.build_catalogue(meta, cat, host, specs, device=['cpu', 'cpu'], nr_chunks=2)\n"
        "assert len(out.chunks) == 2 and out.catalogue.n_halos == 6\n"
        # the tools and their array halves
        "from soap_tpu_torch.tools import (compare, compression, convert_eagle, docs,\n"
        "    fof_radii, hydrogen_phases, match_membership, membership_checks, reorder_fof,\n"
        "    timing_analysis, track_evolution, virtual_snapshot)\n"
        "assert len(soap_tpu_torch.cli.subcommands(soap_tpu_torch.cli.build_parser())) == 16\n"
        "ids, grnr, rank = uni.ids, g, r\n"
        "bids = np.concatenate(uni.bound_ids)\n"
        "bgrnr = np.repeat(np.arange(uni.n_halos), [len(b) for b in uni.bound_ids])\n"
        "st = membership_checks.check_labels(ids, grnr, rank, uni.n_halos, bids, bgrnr)\n"
        "assert st['n_labelled'] == len(bids)\n"
        "bad = grnr.copy(); bad[np.flatnonzero(bad == 1)[0]] = 2\n"
        "try:\n"
        "    membership_checks.check_labels(ids, bad, rank, uni.n_halos, bids, bgrnr)\n"
        "    raise AssertionError('a corrupted label passed')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "b = membership_checks.birth_halo_index(ids[:5], np.zeros(5), [0.5],\n"
        "                                       lambda i: (ids, grnr))\n"
        "assert (b == grnr[:5]).all()\n"
        "pids = ids[grnr >= 0]\n"
        "d = dict(particle_ids=pids, halo_ids=grnr[grnr >= 0].astype(np.int64),\n"
        "         rank_bound=rank[grnr >= 0])\n"
        "c = match_membership.MatchCatalogue(np.arange(uni.n_halos), np.ones(uni.n_halos, bool),\n"
        "                                    -np.ones(uni.n_halos, np.int64))\n"
        "m = match_membership.match_halos(d, d, c, c)\n"
        "assert (m['MatchIndex1to2'] == np.arange(uni.n_halos)).all()\n"
        "assert m['Consistent2to1'].all()\n"
        "radii = fof_radii.fof_max_radii(np.arange(1, 7), uni.halo_pos, uni.boxsize,\n"
        "                                [(uni.fof_ids, uni.pos)])\n"
        "assert (radii > 0).all()\n"
        "assert fof_radii.build_matrix(np.ones((3, 6))).shape == (3, 3, 3)\n"
        "hi, hii, h2 = hydrogen_phases.hydrogen_fractions(np.full(4, 1e4), np.full(4, 1e3),\n"
        "    np.full(4, 0.75), None, meta.snap_units_cgs, meta.a, meta.z)\n"
        "assert np.allclose(hi + hii + 2 * h2, 1.0, rtol=0, atol=1e-12)\n"
        "stats = timing_analysis.timing_stats(np.linspace(0.1, 1, 50), np.ones(50), np.arange(1, 51))\n"
        "per = timing_analysis.group_seconds([('SO/r_time', np.ones(3))])\n"
        "assert 'per-calculation' in timing_analysis.format_report(stats, per)\n"
        "x = compression.apply_lossy_filter(np.linspace(1, 2, 9, dtype=np.float32), 'FMantissa9')\n"
        "assert x.dtype == np.float32\n"
        "assert docs.generate_rst().count('   * - ``') == docs.generate_latex().count('\\\\texttt{') // 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'soap_tpu', 'h5py', 'yaml')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _json(package, name):
    with open(os.path.join(REPO, *package.split("."), name)) as f:
        return json.load(f)


def test_property_data_mirrors_original():
    """The key lists, and the property table whole: every entry with its
    per-halo shape, and the footnotes; the registry serves both as the
    JAX registry does."""
    from soap_tpu.core.registry import full_property_table as jax_table
    from soap_tpu_torch.core.registry import footnotes, full_property_table

    assert _json("soap_tpu_torch.core", "halo_type_property_keys.json") == _json(
        "soap_tpu.core", "halo_type_property_keys.json"
    )
    theirs = _json("soap_tpu.core", "property_table.json")
    ours = _json("soap_tpu_torch.core", "property_table.json")
    assert list(ours["properties"]) == list(theirs["properties"])
    for key, e in theirs["properties"].items():
        assert ours["properties"][key] == e, key
    assert ours["footnotes"] == theirs["footnotes"] and len(ours["footnotes"]) == 32
    assert footnotes() == {k: tuple(v) for k, v in theirs["footnotes"].items()}
    table, jtable = full_property_table(), jax_table()
    assert list(table.keys()) == list(jtable.keys()) and len(table) == len(jtable) == 304
    for key in jtable.keys():
        assert table[key].shape == jtable[key].shape, key


@pytest.mark.parametrize(
    "halo_type", ["BoundSubhalo", "SO", "Aperture", "ProjectedAperture"]
)
def test_implemented_dmo_keys_match(halo_type, dmo=True):
    ours = torch_halo_types.implemented_keys_for(halo_type, dmo)
    assert ours and ours == jax_halo_types.implemented_keys_for(halo_type, dmo)


@pytest.mark.parametrize(
    "halo_type", ["BoundSubhalo", "SO", "Aperture", "ProjectedAperture"]
)
def test_implemented_hydro_keys_match(halo_type):
    test_implemented_dmo_keys_match(halo_type, dmo=False)


def test_build_specs_matches_original():
    ours = torch_specs.build_specs(None, True, 123.5)
    theirs = jax_specs.build_specs(None, True, 123.5)
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in theirs]
    assert (len(ours), sum(len(s.keys) for s in ours)) == (38, 508)
    # a parameter file builds its own list (tests/test_torch_params.py
    # holds every shipped file's to the JAX builder's)
    from soap_tpu.core.params import ParameterFile as JaxParameterFile
    from soap_tpu_torch.core.params import ParameterFile

    raw = {"SOProperties": {"variations": {"200_crit": {"type": "crit", "value": 200.0}}}}
    ours = torch_specs.build_specs(ParameterFile(parameter_dictionary=json.loads(
        json.dumps(raw))), True, 123.5)
    theirs = jax_specs.build_specs(JaxParameterFile(parameter_dictionary=json.loads(
        json.dumps(raw))), True, 123.5)
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in theirs]
    assert [s.group for s in ours if s.kind == "SO"] == ["SO/200_crit"]
    ours = torch_specs.build_specs(None, False, 123.5)
    theirs = jax_specs.build_specs(None, False, 123.5)
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in theirs]
    assert (len(ours), sum(len(s.keys) for s in ours)) == (38, 4729)


def test_mock_metadata_values_match():
    assert torch_mock._FIELD_UNITS == jax_mock._FIELD_UNITS
    assert torch_mock.NAMED_COLUMNS == jax_mock.NAMED_COLUMNS


@pytest.fixture(scope="module")
def written_hydro_mock(tmp_path_factory):
    """A hydro mock written by the JAX package (snapshot, HBT catalogue,
    membership) and read back as its ``SnapshotMetadata``."""
    from soap_tpu.io.swift_snapshot import SnapshotMetadata
    from soap_tpu.pipeline.membership import run_group_membership

    tmp = str(tmp_path_factory.mktemp("hydro_mock"))
    kw = dict(n_halos=5, n_field=2000, boxsize=16.0, seed=61, hydro=True, n_satellites=1)
    sim = jax_mock.make_mock_simulation(tmp, **kw)
    mem = os.path.join(tmp, "membership.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], mem)
    return dict(
        uni=torch_mock.build_mock_universe(**kw), snapshot=sim["snapshot"], membership=mem,
        meta=SnapshotMetadata(sim["snapshot"], [mem]),
    )


def test_snapshot_attrs_match_written_snapshot(written_hydro_mock):
    import h5py

    attrs = torch_mock.snapshot_attrs(written_hydro_mock["uni"])
    with h5py.File(written_hydro_mock["snapshot"], "r") as f:
        for group, values in attrs.items():
            stored = {k: float(np.asarray(v).reshape(-1)[0]) for k, v in f[group].attrs.items()}
            assert values == stored, group
        for name, value in torch_mock.MOCK_PARAMETERS.items():
            assert float(f["Parameters"].attrs[name]) == value, name


def test_mock_metadata_matches_snapshot_metadata(written_hydro_mock):
    from soap_tpu_torch.pipeline import run as torch_run

    theirs = written_hydro_mock["meta"]
    ours = torch_run.mock_metadata(written_hydro_mock["uni"])
    for name in ("a", "z", "h", "boxsize", "critical_density", "mean_density", "virBN98",
                 "dark_matter_softening", "baryon_softening", "nu_softening", "AGN_delta_T",
                 "cosmology_attrs", "snap_units_cgs", "constants_cgs", "named_columns",
                 "ptypes"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert dataclasses.asdict(ours.cosmology) == dataclasses.asdict(theirs.cosmology)
    np.testing.assert_array_equal(ours.observer_position, theirs.observer_position)
    assert {pt: sorted(d) for pt, d in ours.datasets.items()} == {
        pt: sorted(d) for pt, d in theirs.datasets.items()
    }
    for pt, d in theirs.datasets.items():
        assert {n: info.row_shape for n, info in d.items()} == ours.datasets[pt], pt


def test_cosmology_matches(written_hydro_mock):
    from soap_tpu_torch.core.cosmology import Cosmology

    theirs = written_hydro_mock["meta"].cosmology
    ours = Cosmology.from_attrs(written_hydro_mock["meta"].cosmology_attrs)
    a = np.linspace(0.05, 1.0, 7)
    np.testing.assert_array_equal(ours.E(a), theirs.E(a))
    for x, y in zip(ours.age_table(n=64), theirs.age_table(n=64)):
        np.testing.assert_array_equal(x, y)
    assert ours.bn98_virial_multiple() == theirs.bn98_virial_multiple()


@pytest.mark.parametrize("dmo", [True, False], ids=["dmo", "hydro"])
def test_make_context_and_required_datasets_match(written_hydro_mock, dmo):
    from soap_tpu.pipeline.chunks import required_datasets as jax_required
    from soap_tpu.pipeline.run import make_context as jax_make_context
    from soap_tpu_torch.pipeline import chunks as torch_chunks
    from soap_tpu_torch.pipeline import run as torch_run

    theirs = written_hydro_mock["meta"]
    ours = torch_run.mock_metadata(written_hydro_mock["uni"])
    ptypes = ["PartType1"] if dmo else ["PartType0", "PartType1", "PartType4", "PartType5"]
    assert dataclasses.asdict(torch_run.make_context(ours, ptypes, dmo)) == \
        dataclasses.asdict(jax_make_context(theirs, ptypes, dmo))
    specs = torch_specs.build_specs(None, dmo, ours.virBN98)
    got = torch_chunks.required_datasets(specs, ours)
    assert got == jax_required(jax_specs.build_specs(None, dmo, theirs.virBN98), theirs)
    assert ("Temperatures" in got.get("PartType0", ())) != dmo


@pytest.mark.parametrize("name", ["COLIBRE_THERMAL", "FLAMINGO", "EAGLE"])
def test_make_context_with_parameter_file_matches(written_hydro_mock, name):
    """A parameter file's recently-heated and cold dense gas filters and
    defined constants reach the context as in the JAX ``make_context``,
    and its list needs the datasets the JAX run reads."""
    from soap_tpu.core.params import ParameterFile as JaxParameterFile
    from soap_tpu.pipeline.chunks import required_datasets as jax_required
    from soap_tpu.pipeline.run import make_context as jax_make_context
    from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
    from soap_tpu_torch.pipeline import chunks as torch_chunks
    from soap_tpu_torch.pipeline import run as torch_run

    theirs = written_hydro_mock["meta"]
    ours = torch_run.mock_metadata(written_hydro_mock["uni"])
    params = ParameterFile(parameter_file_path(name))
    jparams = JaxParameterFile(os.path.join(REPO, "parameter_files", f"{name}.yml"))
    ptypes = ["PartType0", "PartType1", "PartType4", "PartType5"]
    got = dataclasses.asdict(torch_run.make_context(ours, ptypes, False, params))
    assert got == dataclasses.asdict(jax_make_context(theirs, ptypes, False, jparams))
    # COLIBRE and EAGLE set Fe_H_sun and the cold dense gas filter;
    # FLAMINGO's values are the defaults
    default = dataclasses.asdict(torch_run.make_context(ours, ptypes, False))
    assert (got == default) == (name == "FLAMINGO")
    specs = torch_specs.build_specs(params, False, ours.virBN98)
    assert torch_chunks.required_datasets(specs, ours) == jax_required(
        jax_specs.build_specs(jparams, False, theirs.virBN98), theirs
    )


def test_domain_mirrors_original():
    """The copied Peano–Hilbert chunking (``tests/test_torch_domain.py``
    holds it to both of the JAX package's paths at every size)."""
    from soap_tpu.parallel.domain import peano_decomposition as jax_peano
    from soap_tpu_torch.parallel.domain import peano_decomposition

    centres = np.random.default_rng(2).random((500, 3)) * 30.0
    np.testing.assert_array_equal(peano_decomposition(centres, 30.0, 5),
                                  jax_peano(centres, 30.0, 5))


def test_scratch_layout_mirrors_original(tmp_path):
    """A chunk scratch file of the port has the JAX package's layout:
    the same datasets, dtypes, shapes and attributes, the version
    attribute naming the writing package; each package reads the
    other's file back."""
    import h5py

    from soap_tpu.pipeline.chunks import _try_load_scratch as jax_load
    from soap_tpu.pipeline.chunks import _write_scratch as jax_write
    from soap_tpu_torch.pipeline import chunks as torch_chunks

    args = [dict(kind="bound", group="BoundSubhalo", keys=("Mtot", "com")),
            dict(kind="SO", group="SO/200_crit", keys=("r",), so_type="crit", so_multiple=200.0)]
    ours = [torch_engine.HaloTypeSpec(**a) for a in args]
    theirs = [jax_engine.HaloTypeSpec(**a) for a in args]
    rows = np.array([3, 5, 8])
    rng = np.random.default_rng(1)
    results = {"BoundSubhalo": {"Mtot": rng.random(3).astype(np.float32),
                                "com": rng.random((3, 3)).astype(np.float32)},
               "SO/200_crit": {"r": rng.random(3).astype(np.float32)}}
    paths = {name: str(tmp_path / f"{name}.hdf5") for name in ("port", "jax")}
    torch_chunks.write_scratch(paths["port"], ours, rows, results)
    jax_write(paths["jax"], theirs, rows, results)

    def layout(path):
        out = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: out.setdefault(n, (o.dtype.str, o.shape))
                         if isinstance(o, h5py.Dataset) else None)
            attrs = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
        return out, attrs

    (ds_p, at_p), (ds_j, at_j) = layout(paths["port"]), layout(paths["jax"])
    assert ds_p == ds_j
    assert at_p.pop("soap_tpu_version").startswith(b"soap_tpu_torch ")
    assert at_j.pop("soap_tpu_version") == b"0.1.0"
    assert at_p == at_j
    assert not os.path.exists(paths["port"] + ".tmp")
    for got in (jax_load(paths["port"], theirs, rows),
                torch_chunks.try_load_scratch(paths["jax"], ours, rows)):
        for group, props in results.items():
            for key, arr in props.items():
                assert got[group][key].tobytes() == arr.tobytes()
    assert torch_chunks.try_load_scratch(paths["port"], ours, rows[::-1]) is None


def test_lock_format_mirrors_original(tmp_path):
    """The combine lock: each package reads the other's lock as held by
    a live process and takes over the other's stale one."""
    import subprocess

    from soap_tpu.parallel import multihost as jax_multihost
    from soap_tpu_torch.parallel import multihost

    d = str(tmp_path)
    assert multihost.claim_combine(d)
    with open(os.path.join(d, "combine.lock")) as f:
        assert f.read() == multihost.lock_line()
    assert not jax_multihost.claim_combine(d)
    jax_multihost.release_combine(d)
    assert jax_multihost.claim_combine(d)
    assert not multihost.claim_combine(d)
    # a stale lock (a dead pid of this host) in the JAX package's format
    p = subprocess.Popen(["sleep", "0.01"])
    p.wait()
    with open(os.path.join(d, "combine.lock"), "w") as f:
        f.write(multihost.lock_line().replace(f"pid={os.getpid()}", f"pid={p.pid}"))
    assert multihost.claim_combine(d)
