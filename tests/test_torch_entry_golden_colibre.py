"""The port's entry on hydro parameter files.

COLIBRE_THERMAL on the seed-61 hydro mock, built as
``tests/test_colibre_params.py`` builds it (the yml through yaml and
``substitute_parameters``, ``min_read_radius_cmpc`` 0.005), through the
port's ``compute_halo_properties`` on the CPU and held to
``tests/golden/e2e_colibre_seed61.hdf5`` under that test's call; the
``SOAP.used_parameters.yml`` mirror beside it; and FLAMINGO's file on
the same mock in memory, where the category filters run at their
limits and ``SOAP/IncludedInReducedSnapshot`` comes from
``calculations.reduced_snapshots`` (its BoundSubhalo and SO/200_crit).
"""

import copy
import os

import h5py
import numpy as np
import pytest
import yaml

from soap_tpu.pipeline.derived import included_in_reduced_snapshot
from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.tools.compare import compare_catalogues
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch.core.params import ParameterFile, parameter_file_path, substitute_parameters
from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.pipeline import run
from soap_tpu_torch.pipeline.chunks import mock_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "e2e_colibre_seed61.hdf5")


@pytest.fixture(scope="module")
def colibre_catalogue(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("torch_colibre_e2e"))
    sim = make_mock_simulation(workdir, n_halos=5, n_field=3000, boxsize=18.0, seed=61, hydro=True)
    with open(os.path.join(REPO, "parameter_files", "COLIBRE_THERMAL.yml")) as f:
        raw = yaml.safe_load(f)
    raw.setdefault("calculations", {})["min_read_radius_cmpc"] = 0.005
    raw = substitute_parameters(
        raw, {"sim_dir": workdir, "output_dir": workdir, "scratch_dir": workdir})
    params = ParameterFile(parameter_dictionary=raw)
    membership = os.path.join(workdir, "membership.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], membership)
    output = os.path.join(workdir, "halo_properties.hdf5")
    out = run.compute_halo_properties(
        snapshot_file=sim["snapshot"], membership_file=membership,
        halo_basename=sim["hbt_basename"], output_file=output, parameter_file=params,
        dmo=False, verbose=False, device="cpu",
    )
    return output, params, out, sim


def test_hydro_golden_catalogue_regression(colibre_catalogue):
    """The JAX package's hydro golden test, on the port's catalogue."""
    output = colibre_catalogue[0]
    res = compare_catalogues(
        GOLDEN, output, use_compression_tolerance=True,
        rtol=1.0e-3, atol=1.0e-30, scale_atol=5.0e-3,
    )
    assert res.n_compared > 400, res.n_compared
    assert res.identical, res.report()


def test_colibre_catalogue_structure(colibre_catalogue):
    """The golden's datasets with their dtypes, shapes and attribute names
    (the category masks among them); no disabled aperture property."""
    output, params, _, _ = colibre_catalogue
    disabled = {n for n, v in params.property_filters.get("ApertureProperties", {}).items()
                if v is False}
    assert disabled
    with h5py.File(output, "r") as f, h5py.File(GOLDEN, "r") as g:
        assert f["Header"].attrs["NumSubhalos_Total"][0] == 5
        assert (np.asarray(f["BoundSubhalo/TotalMass"]) > 0).all()
        names, golden = [], []
        f.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        g.visititems(lambda n, o: golden.append(n) if isinstance(o, h5py.Dataset) else None)
        assert names == golden
        for name in names:
            assert f[name].dtype == g[name].dtype and f[name].shape == g[name].shape, name
            assert sorted(f[name].attrs) == sorted(g[name].attrs), name
            if name.startswith(("ExclusiveSphere", "InclusiveSphere")):
                assert name.rsplit("/", 1)[1] not in disabled, name
        assert any(f[n].attrs["Masked"] for n in names if "Masked" in f[n].attrs)


def test_used_parameters_mirror(colibre_catalogue):
    """``SOAP.used_parameters.yml`` beside the catalogue is the parameter
    dictionary with the property queries' defaults filled in."""
    output, params, _, _ = colibre_catalogue
    path = os.path.join(os.path.dirname(output), "SOAP.used_parameters.yml")
    with open(path) as f:
        assert yaml.safe_load(f) == params.parameters


@pytest.fixture(scope="module")
def flamingo():
    from soap_tpu_torch.utils.mock_data import build_mock_universe

    uni = build_mock_universe(n_halos=5, n_field=3000, boxsize=18.0, seed=61, hydro=True)
    params = ParameterFile(parameter_file_path("FLAMINGO"))
    raw = copy.deepcopy(params.parameters)
    # every halo in one mass bin of two, so the sampling keeps a subset
    raw["calculations"]["reduced_snapshots"] = dict(
        min_halo_mass=1.0e10, halo_bin_size_dex=6.0, halos_per_bin=2)
    params = ParameterFile(parameter_dictionary=raw)
    meta = run.mock_metadata(uni)
    # the two groups the flag and the filters read, to keep the run short
    specs = [s for s in run.entry_plan(meta, False, params)[1]
             if s.group in ("BoundSubhalo", "SO/200_crit")]
    ptypes, specs = run.entry_plan(meta, False, params, specs)
    out = run.build_catalogue(meta, run.mock_catalogue(uni), mock_fields(
        uni, specs, meta, ptypes, run.age_table(meta)), specs, params, False, device="cpu")
    return out, params, meta


def test_flamingo_reduced_snapshot_flag(flamingo):
    out, params, meta = flamingo
    rs = params.get_parameters()["calculations"]["reduced_snapshots"]
    mass = out.results["SO/200_crit"]["Mtot"][out.order] * (
        meta.snap_units_cgs["Unit mass in cgs (U_M)"] / 1.98841e33)
    want = included_in_reduced_snapshot(
        mass, int(rs["halos_per_bin"]), float(rs["halo_bin_size_dex"]), float(rs["min_halo_mass"]))
    got = out.catalogue.datasets["SOAP/IncludedInReducedSnapshot"]
    np.testing.assert_array_equal(got.data, want)
    assert got.data.dtype == full_property_table()["SOAP/IncludedInReducedSnapshot"].dtype
    assert 0 < got.data.sum() < len(want)


def test_flamingo_filters_and_drops(flamingo):
    """FLAMINGO's categories mask halos below 100 particles and record the
    mask in each dataset; its disabled keys are not written."""
    out, params, _ = flamingo
    table = full_property_table()
    cat = out.catalogue
    masked = [p for p, d in cat.datasets.items() if d.attrs.get("Masked") is True]
    assert masked
    for p in masked:
        assert cat.datasets[p].attrs["Mask Threshold"] == 100
    for group, props in out.results.items():
        base = run.GROUP_TO_BASE.get(group.split("/")[0])
        chosen = params.property_filters.get(base or "", {})
        for key in props:
            assert chosen.get(table[key].name) is not False, (group, key)
            assert f"{group}/{table[key].name}" in cat.datasets
