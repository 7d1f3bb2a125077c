"""Per-halo and per-property timings of the port's entry.

On the JAX end-to-end timing test's mock (6 halos, seed 31) with its
list (BoundSubhalo and SO/200_crit), over two chunks: the halo-timing
datasets are written, ``n_loop`` equals the JAX entry's exactly, every
property of a spec carries the spec's ``_time`` dataset, the JAX
``tools/timing_analysis`` reads the port's file, and the per-spec
programs' results equal the fused run's; on a mock in memory with the
full DMO list (families, radius multiples, both passes), spec-timing
mode equals the normal run under ``utils/parity.py``.
"""

import os

import numpy as np
import pytest
import torch

from soap_tpu.pipeline.engine import HaloTypeSpec as JaxSpec
from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.pipeline.run import compute_halo_properties as jax_compute
from soap_tpu.tools.timing_analysis import analyze, analyze_properties
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch.io.catalogue import TIME_DESCRIPTION
from soap_tpu_torch.io.catalogue_writer import read_catalogue
from soap_tpu_torch.pipeline import chunks, run
from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.mock_data import build_mock_universe
from soap_tpu_torch.utils.parity import catalogue_differences, is_timing, key_close

SPEC_ARGS = [
    dict(kind="bound", group="BoundSubhalo", keys=("Mtot", "Ndm")),
    dict(kind="SO", group="SO/200_crit", keys=("r", "Mtot"), so_type="crit",
         so_multiple=200.0, centrals_only=True),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's small CPU runs: the default pool
    oversubscribes the cores beside the other test workers, which makes
    runs of many small ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_timings"))
    sim = make_mock_simulation(tmp, n_halos=6, n_field=4000, boxsize=18.0, seed=31)
    mem = os.path.join(tmp, "mem.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], mem)
    common = dict(snapshot_file=sim["snapshot"], membership_file=mem,
                  halo_basename=sim["hbt_basename"], dmo=True, nr_chunks=2, verbose=False)
    specs = [HaloTypeSpec(**a) for a in SPEC_ARGS]
    out = {}
    for name, kw in (("plain", {}), ("halo", dict(record_halo_timings=True)),
                     ("both", dict(record_halo_timings=True, record_property_timings=True))):
        path = os.path.join(tmp, f"port_{name}.hdf5")
        out[name] = (run.compute_halo_properties(output_file=path, specs=specs, device="cpu",
                                                 **common, **kw), path)
    path = os.path.join(tmp, "jax_halo.hdf5")
    jax_compute(output_file=path, specs=[JaxSpec(**a) for a in SPEC_ARGS],
                record_halo_timings=True, **common)
    out["jax"] = (None, path)
    return out


def test_halo_timing_datasets(runs):
    got, path = runs["halo"]
    cat = read_catalogue(path)
    t = got.stats.halo_timings()
    assert len(t["index"]) == 6 and (t["process_time"] > 0).all() and (t["n_loop"] >= 1).all()
    for name in ("process_time", "n_loop", "n_process"):
        assert cat.datasets[f"InputHalos/{name}"].data.shape == (6,), name
    assert cat.datasets["InputHalos/process_time"].data.dtype == np.float32
    assert (cat.datasets["InputHalos/n_process"].data == 1).all()
    assert cat.datasets["InputHalos/process_time"].data.sum() > 0
    stats = analyze(path)  # the JAX timing tool reads the port's file
    assert stats["n_halos"] == 6 and stats["total_seconds"] > 0


def test_n_loop_matches_jax(runs):
    ours = read_catalogue(runs["halo"][1])
    theirs = read_catalogue(runs["jax"][1])
    for name in ("n_loop", "n_process"):
        a, b = theirs.datasets[f"InputHalos/{name}"].data, ours.datasets[f"InputHalos/{name}"].data
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=name)
    # the two files hold the same datasets, timings by name only
    assert catalogue_differences(theirs, ours) == []


def test_property_time_datasets(runs):
    cat = read_catalogue(runs["both"][1])
    t_mass = cat.datasets["BoundSubhalo/TotalMass_time"]
    t_n = cat.datasets["BoundSubhalo/NumberOfDarkMatterParticles_time"].data
    t_so = cat.datasets["SO/200_crit/TotalMass_time"].data
    assert t_mass.attrs["Description"].decode() == TIME_DESCRIPTION
    assert t_mass.data.dtype == np.float32 and (t_mass.data >= 0).all()
    assert t_mass.data.sum() > 0 and t_so.sum() > 0
    np.testing.assert_array_equal(t_mass.data, t_n)  # one program per spec
    np.testing.assert_array_equal(
        t_so, cat.datasets["SO/200_crit/SORadius_time"].data)
    per_prop = analyze_properties(runs["both"][1])
    assert per_prop["BoundSubhalo"] > 0 and per_prop["SO/200_crit"] > 0
    stats = runs["both"][0].stats
    assert set(stats.spec_seconds) == {"BoundSubhalo", "SO/200_crit"}


def test_spec_timing_results_equal_fused(runs):
    plain, timed = runs["plain"][0], runs["both"][0]
    for group, props in plain.results.items():
        for key, arr in props.items():
            assert key_close(arr, timed.results[group][key], key), f"{group}/{key}"
    a, b = read_catalogue(runs["plain"][1]), read_catalogue(runs["both"][1])
    extra = [p for p in b.datasets if p not in a.datasets]
    assert extra and all(is_timing(p) or p in ("InputHalos/n_loop", "InputHalos/n_process")
                         for p in extra)
    for p in extra:
        del b.datasets[p]
    assert catalogue_differences(a, b) == []


def test_spec_timing_full_list_equals_fused():
    """The default DMO list (families split into lone specs, radius
    multiples with their parent, both passes, no truncation) in
    spec-timing mode against the fused run, in memory."""
    uni = build_mock_universe(n_halos=6, n_field=3000, boxsize=18.0, seed=31, n_satellites=1)
    meta = run.mock_metadata(uni)
    ptypes, specs = run.entry_plan(meta, True, None, build_specs(None, True, meta.virBN98))
    host = chunks.mock_fields(uni, specs, meta, ptypes)
    out = {}
    for timed in (False, True):
        out[timed] = run.build_catalogue(meta, run.mock_catalogue(uni), host, specs,
                                         device="cpu", record_property_timings=timed)
    stats = out[True].stats
    # every spec is timed but the apertures copied from a smaller one
    assert {s.group for s in specs if s.copy_from is None} <= set(stats.spec_seconds)
    assert set(stats.spec_seconds) <= {s.group for s in specs}
    assert stats.n_truncated_tiles == 0 and out[False].stats.n_truncated_tiles > 0
    for group, props in out[False].results.items():
        for key, arr in props.items():
            assert key_close(arr, out[True].results[group][key], key), f"{group}/{key}"
    names = [p for p in out[True].catalogue.datasets if p.endswith("_time")]
    assert len(names) == sum(len(out[False].results[g]) for g in stats.property_timings())
