"""The hydro property tail of the port against independent float64
oracles: the twin of ``tests/test_hydro_oracles.py`` on
``soap_tpu_torch``.

The same mock (5 halos, seed 1234) goes through the port's membership
program (``soap_tpu_torch/pipeline/membership.py``) and the port's entry
on the CPU (``compute_halo_properties(device="cpu")``) with the SO/200_crit
keys of the JAX test; the JAX test's own oracles then hold the port's
results, at its tolerances: temperatures with the AGN and cooling
exclusions, Compton Y, X-ray band sums, the spectroscopic-like
temperature and DopplerB, and the shell flow rates (float64 numpy from
the raw mock arrays and the port's SO radius).
"""

import os

import h5py
import pytest
import torch

import test_hydro_oracles as oracles
from soap_tpu.utils import mock_data
from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.pipeline.membership import run_group_membership
from soap_tpu_torch.pipeline.run import compute_halo_properties

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def so_run(tmp_path_factory):
    tmpdir = str(tmp_path_factory.mktemp("hydro_oracles_port"))
    sim = mock_data.make_mock_simulation(
        tmpdir, n_halos=5, n_field=4000, boxsize=22.0, seed=1234, hydro=True
    )
    membership = os.path.join(tmpdir, "membership.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], membership)
    with h5py.File(membership, "r") as f:
        assert f["Header"].attrs["OutputType"] == "Membership"
    specs = [
        HaloTypeSpec(
            kind="SO", group="SO/200_crit", keys=oracles.SO_KEYS,
            so_type="crit", so_multiple=200.0, centrals_only=True,
        )
    ]
    run = compute_halo_properties(
        snapshot_file=sim["snapshot"], membership_file=membership,
        halo_basename=sim["hbt_basename"], output_file=None,
        dmo=False, specs=specs, verbose=False, device="cpu",
    )
    return sim, run


def test_temperatures_compY_xray_oracles(so_run):
    oracles.test_temperatures_compY_xray_oracles(so_run)


def test_flow_rate_oracles(so_run):
    oracles.test_flow_rate_oracles(so_run)
