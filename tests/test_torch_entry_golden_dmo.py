"""The port's entry on the full DMO list against the committed golden.

``tests/test_end_to_end.py``'s run (the seed-11 DMO mock written by the
JAX package, its membership, the default DMO list of 38 calculations
and 508 keys) through the port's ``compute_halo_properties`` on the
CPU, held to ``tests/golden/e2e_dmo_seed11.hdf5`` under that test's
call, and the JAX test's structure and value checks on the port's file.
"""

import os

import h5py
import numpy as np
import pytest

from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.tools.compare import compare_catalogues
from soap_tpu.utils import mock_data as jax_mock
from soap_tpu_torch.pipeline import run
from soap_tpu_torch.utils.mock_data import G_INTERNAL

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "e2e_dmo_seed11.hdf5")


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    tmpdir = str(tmp_path_factory.mktemp("torch_e2e"))
    sim = jax_mock.make_mock_simulation(tmpdir, n_halos=8, n_field=5000, boxsize=20.0, seed=11)
    membership = f"{tmpdir}/membership_0077.hdf5"
    run_group_membership(sim["snapshot"], sim["hbt_basename"], membership)
    catalogue = f"{tmpdir}/halo_properties_0077.hdf5"
    out = run.compute_halo_properties(
        snapshot_file=sim["snapshot"], membership_file=membership,
        halo_basename=sim["hbt_basename"], output_file=catalogue, dmo=True, verbose=False,
        device="cpu",
    )
    return sim, out, catalogue


def test_golden_catalogue_regression(e2e):
    """The JAX package's golden test, on the port's catalogue."""
    res = compare_catalogues(
        GOLDEN, e2e[2], use_compression_tolerance=True,
        rtol=1.0e-3, atol=1.0e-30, scale_atol=5.0e-3,
    )
    assert res.n_compared > 400, res.n_compared
    assert res.identical, res.report()


def test_catalogue_structure(e2e):
    _, out, catalogue = e2e
    with h5py.File(catalogue, "r") as f, h5py.File(GOLDEN, "r") as g:
        for name in ("BoundSubhalo/TotalMass", "SO/200_crit/SORadius",
                     "ExclusiveSphere/100kpc/TotalMass", "ProjectedAperture/50kpc/projz/TotalMass",
                     "InputHalos/HaloCentre", "InputHalos/HaloCatalogueIndex", "HBTplus/TrackId",
                     "SOAP/HostHaloIndex", "SOAP/SubhaloRankByBoundMass", "Cells/Centres"):
            assert name in f, name
        ds = f["BoundSubhalo/TotalMass"]
        assert ds.attrs["Value stored as physical"][0] == 1 and ds.dtype == np.float32
        names = []
        f.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        for name in names:
            assert f[name].dtype == g[name].dtype and f[name].shape == g[name].shape, name
            assert sorted(f[name].attrs) == sorted(g[name].attrs), name
        assert f["Header"].attrs["NumSubhalos_Total"][0] == 8
    assert sum(len(d) for d in out.results.values()) == 508


def test_catalogue_values(e2e):
    """``tests/test_end_to_end.py::test_catalogue_values`` on the port's file."""
    sim, _, catalogue = e2e
    uni = sim["universe"]
    with h5py.File(catalogue, "r") as f:
        mtot = f["BoundSubhalo/TotalMass"][...]
        ndm = f["BoundSubhalo/NumberOfDarkMatterParticles"][...]
        idx = f["InputHalos/HaloCatalogueIndex"][...]
        so_r = f["SO/200_crit/SORadius"][...]
        m50, m300, m3000 = (f[f"ExclusiveSphere/{r}kpc/TotalMass"][...] for r in (50, 300, 3000))
    nbound = uni.halo_nbound[idx]
    np.testing.assert_array_equal(ndm, nbound)
    np.testing.assert_allclose(mtot, nbound * uni.mass[0], rtol=1e-5)
    rho_crit = 3.0 * (100.0 * uni.h) ** 2 / (8.0 * np.pi * G_INTERNAL) * (
        uni.omega_m / uni.a**3 + uni.omega_lambda)
    r200 = (3.0 * nbound * uni.mass[0] / (4.0 * np.pi * 200.0 * rho_crit)) ** (1.0 / 3.0)
    assert np.all(so_r / r200 > 0.7) and np.all(so_r / r200 < 1.5)
    assert np.all(m50 <= m300 + 1e-3) and np.all(m300 <= m3000 + 1e-3)
    np.testing.assert_allclose(m3000, mtot, rtol=1e-4)
