"""FOFGroupIDs through a separate FOF snapshot, in the port: the twin of
``tests/test_fof_membership.py`` on ``soap_tpu_torch``.

A snapshot stripped of its own FOFGroupIDs must give the same
FOF-dependent catalogue (Mfrac_satellites, Mfrac_external) through the
port's entry when the port's membership program matches a separate FOF
snapshot's FOFGroupIDs onto it: the membership file carries the dataset
into the entry.
"""

import os

import h5py
import numpy as np
import torch

from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.pipeline.membership import (
    FOF_NULL_ID,
    compute_fof_groups,
    run_group_membership,
)
from soap_tpu_torch.pipeline.run import compute_halo_properties
from test_fof_membership import _strip_dataset, _write_fof_snapshot

torch.set_num_threads(1)


def test_compute_fof_groups_matching():
    rng = np.random.default_rng(5)
    fof_ids = rng.permutation(1000)[:600].astype(np.int64)
    fof_groups = rng.integers(1, 40, 600).astype(np.int32)
    snap_ids = rng.permutation(1000).astype(np.int64)
    out = compute_fof_groups(snap_ids, fof_ids, fof_groups)
    lookup = dict(zip(fof_ids.tolist(), fof_groups.tolist()))
    expected = np.array([lookup.get(i, FOF_NULL_ID) for i in snap_ids.tolist()], out.dtype)
    np.testing.assert_array_equal(out, expected)


def test_fof_snapshot_membership_end_to_end(tmp_path):
    from soap_tpu.utils import mock_data

    tmpdir = str(tmp_path)
    sim = mock_data.make_mock_simulation(
        tmpdir, n_halos=6, n_field=4000, boxsize=18.0, seed=77, n_satellites=2,
    )
    snap = sim["snapshot"]
    specs = [
        HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "Ndm")),
        HaloTypeSpec(
            kind="SO", group="SO/200_crit",
            keys=("r", "Mtot", "Mfrac_satellites", "Mfrac_external"),
            so_type="crit", so_multiple=200.0, centrals_only=True,
        ),
    ]

    def entry(snapshot, membership):
        return compute_halo_properties(
            snapshot_file=snapshot, membership_file=membership,
            halo_basename=sim["hbt_basename"], output_file=None, dmo=True,
            specs=specs, verbose=False, device="cpu",
        )

    # run A: FOFGroupIDs in the snapshot itself
    mem_a = os.path.join(tmpdir, "mem_a.hdf5")
    run_group_membership(snap, sim["hbt_basename"], mem_a)
    run_a = entry(snap, mem_a)

    # run B: the snapshot without FOFGroupIDs, and a separate FOF snapshot
    stripped = os.path.join(tmpdir, "snap_stripped.hdf5")
    _strip_dataset(snap, stripped, "PartType1", "FOFGroupIDs")
    fof_snap = os.path.join(tmpdir, "fof_snap.hdf5")
    _write_fof_snapshot(snap, fof_snap, seed=123)
    mem_b = os.path.join(tmpdir, "mem_b.hdf5")
    run_group_membership(stripped, sim["hbt_basename"], mem_b, fof_filename=fof_snap)
    with h5py.File(mem_b, "r") as f:
        assert "FOFGroupIDs" in f["PartType1"], "membership file must carry FOFGroupIDs"
        mem_fof = f["PartType1/FOFGroupIDs"][...]
    with h5py.File(snap, "r") as f:
        np.testing.assert_array_equal(mem_fof, f["PartType1/FOFGroupIDs"][...])
    run_b = entry(stripped, mem_b)

    for key in ("Mfrac_satellites", "Mfrac_external", "Mtot", "r"):
        a = np.asarray(run_a.results["SO/200_crit"][key])
        b = np.asarray(run_b.results["SO/200_crit"][key])
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert np.asarray(run_a.results["SO/200_crit"]["Mfrac_satellites"]).sum() > 0, (
        "mock must actually exercise the satellite split")
