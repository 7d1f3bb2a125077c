"""The port's X-ray recalculation against the JAX package's.

``soap_tpu_torch/tools/xray_calculator.py`` against
``soap_tpu/tools/xray_calculator.py`` on the CPU: the twins of the four
X-ray tests of ``tests/test_fof_xray.py`` (the bilinear interpolation on
a grid, the full-table calculator on particles partly outside the
table, the full-table and the simple-table recalculation of a mock
snapshot), each holding the port to the JAX function on the same mock
table and particles at rtol 1e-12 (both compute in float64).  The mock
table's arrays (``mock_table_5d``) and files equal the JAX writer's, and
a calculator built from the arrays equals one built from the file.
"""

import h5py
import numpy as np
import pytest

from soap_tpu.tools import xray_calculator as jxc
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch.tools import xray_calculator as xc

RTOL = 1e-12


def _particles(n=64, seed=11):
    """test_fof_xray.py's particles: temperatures partly outside the
    mock table's [5, 9.5]."""
    rng = np.random.default_rng(seed)
    T = 10.0 ** rng.uniform(4.5, 10.0, n)
    rho = 10.0 ** rng.uniform(-30.0, -20.0, n)
    m = 10.0 ** rng.uniform(38.0, 40.0, n)
    mf = np.zeros((n, 9))
    mf[:, 0] = rng.uniform(0.7, 0.76, n)
    mf[:, 1] = rng.uniform(0.23, 0.29, n)
    mf[:, 2:] = rng.uniform(1e-5, 0.01, (n, 7))
    return rho, T, mf, m


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (np.asarray(obj[()]), dict(obj.attrs))
        f.visititems(visit)
    return out


def _same_files(got, want):
    a, b = _h5_items(got), _h5_items(want)
    assert sorted(a) == sorted(b)
    for name in b:
        assert a[name][0].dtype == b[name][0].dtype, name
        assert np.array_equal(a[name][0], b[name][0]), name
        assert sorted(a[name][1]) == sorted(b[name][1]), name
        for k in b[name][1]:
            assert np.array_equal(a[name][1][k], b[name][1][k]), (name, k)


def test_bilinear_interp_exact_on_grid():
    t = np.linspace(4, 8, 5)
    n = np.linspace(-4, 0, 5)
    tbl = t[:, None] * 2.0 + n[None, :]
    rng = np.random.default_rng(2)
    log_t = np.concatenate([[5.0, 6.5, 3.0, 9.0], rng.uniform(3.5, 8.5, 60)])
    log_n = np.concatenate([[-2.0, -1.5, -5.0, 1.0], rng.uniform(-4.5, 0.5, 60)])
    got = xc.bilinear_interp(tbl, t, n, log_t, log_n, device="cpu")
    want = jxc.bilinear_interp(tbl, t, n, log_t, log_n)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[:2], [5.0 * 2 - 2.0, 6.5 * 2 - 1.5], rtol=1e-6)


def test_xray_calculator_5d_matches_oracle(tmp_path):
    """The full-table calculator against the JAX one, band by band and
    for several bands at once, with the mask of particles outside the
    table; the mock table's arrays and file against the JAX writer's."""
    table, jax_table = str(tmp_path / "xray_table_5d.hdf5"), str(tmp_path / "jax_5d.hdf5")
    xc.write_mock_table_5d(table)
    jxc.write_mock_table_5d(jax_table)
    _same_files(table, jax_table)
    bins, tables = xc.mock_table_5d()
    rho, T, mf, m = _particles()
    z_now = 0.35
    cases = [(["erosita-low"], ["energies_intrinsic"]), (["ROSAT"], ["photons_observed"]),
             (list(xc.DEFAULT_BANDS), ["energies_observed"] * 3)]
    for bands, otypes in cases:
        calc = xc.XrayCalculator(z_now, table, bands, otypes, device="cpu")
        theirs = jxc.XrayCalculator(z_now, table, bands, otypes)
        assert (calc.dx_z, calc.z_now) == (theirs.dx_z, theirs.z_now)
        for band, otype in zip(bands, otypes):
            assert np.array_equal(calc.tables[band][otype], theirs.tables[band][otype])
        got = calc.interpolate(rho, T, mf, m, bands, otypes)
        want = theirs.interpolate(rho, T, mf, m, bands, otypes)
        assert got.dtype == np.float64 and got.shape == want.shape == (len(rho), len(bands))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        assert (want == 0).any() and (want > 0).any()
        np.testing.assert_array_equal(got == 0, want == 0)
        arrays = xc.XrayCalculator.from_arrays(z_now, bins, tables, bands, otypes, "cpu")
        np.testing.assert_array_equal(arrays.interpolate(rho, T, mf, m, bands, otypes), got)
    ats, log_he = calc.abundance_to_solar(mf)
    want_ats, want_he = theirs.abundance_to_solar(mf)
    np.testing.assert_allclose(ats.numpy(), want_ats, rtol=RTOL, atol=0)
    np.testing.assert_allclose(log_he.numpy(), want_he, rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def hydro_snapshot(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xray_snap")
    return make_mock_simulation(str(tmp), n_halos=3, n_field=1200, boxsize=12.0, seed=4,
                                hydro=True)["snapshot"]


def test_xray_recalculate_full_table(tmp_path, hydro_snapshot):
    table = str(tmp_path / "xray_table_5d.hdf5")
    xc.write_mock_table_5d(table)
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    got = xc.compute_xray_luminosities(hydro_snapshot, table, ours, device="cpu")
    want = jxc.compute_xray_luminosities(hydro_snapshot, table, theirs)
    assert list(got) == list(want) == [
        "XrayLuminositiesRestframe", "XrayPhotonLuminositiesRestframe",
        "XrayLuminosities", "XrayPhotonLuminosities",
    ]
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32
        assert got[name].shape == want[name].shape and got[name].shape[1] == 3
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=0)
        assert np.isfinite(got[name]).all() and (got[name] >= 0).all()
    with h5py.File(ours, "r") as f:
        assert "Cells" in f
        for name in want:
            np.testing.assert_allclose(f[f"PartType0/{name}"][...], want[name], rtol=RTOL,
                                       atol=0)
            assert f[f"PartType0/{name}"].attrs["Description"] == \
                np.bytes_(f"{name} in bands {list(xc.DEFAULT_BANDS)}")


def test_xray_calculator_end_to_end(tmp_path, hydro_snapshot):
    """The simple (z, T, nH) table: the port's recalculation against the
    JAX one, and hotter gas emitting more."""
    table = str(tmp_path / "xray_table.hdf5")
    xc.write_mock_table(table)
    jax_table = str(tmp_path / "jax_table.hdf5")
    jxc.write_mock_table(jax_table)
    _same_files(table, jax_table)
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    lum = xc.compute_xray_luminosities(hydro_snapshot, table, ours, device="cpu")[
        "XrayLuminosities"]
    want = jxc.compute_xray_luminosities(hydro_snapshot, table, theirs)["XrayLuminosities"]
    assert lum.dtype == want.dtype and lum.shape == want.shape and lum.shape[1] == 3
    np.testing.assert_allclose(lum, want, rtol=RTOL, atol=0)
    assert np.isfinite(lum).all() and (lum >= 0).all()
    with h5py.File(hydro_snapshot, "r") as f:
        T = f["PartType0/Temperatures"][...]
    hot = T > np.percentile(T, 90)
    cold = T < np.percentile(T, 10)
    assert np.median(lum[hot, 0]) > np.median(lum[cold, 0])
    _same_files(ours, theirs)
