"""Per-file membership layout and the streaming join, in the port: the
twin of ``tests/test_membership_layout.py`` on ``soap_tpu_torch``.

The port's membership program writes one file per snapshot file with
that file's rows (``{file_nr}`` in the output name), labels equal to the
monolithic run's when joined back by particle ID, and the port's entry
reads either layout to the same catalogue; the per-file writer refuses
a single output name for a multi-file snapshot; peak memory does not
grow with the snapshot (a slow test, as in the JAX suite); and
``with_potentials`` writes SpecificPotentialEnergies in (km/s)^2.
"""

import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from soap_tpu.utils import mock_data
from soap_tpu_torch.io.swift_snapshot import SnapshotMetadata, read_masked_cells
from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.pipeline.membership import _write_snapshot_layout, run_group_membership
from soap_tpu_torch.pipeline.run import compute_halo_properties
from test_membership_layout import _make_big_snapshot

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = [
    HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "Ndm", "com")),
    HaloTypeSpec(
        kind="SO", group="SO/200_crit", keys=("r", "Mtot"),
        so_type="crit", so_multiple=200.0, centrals_only=True,
    ),
]


def _entry(snapshot, membership, hbt):
    return compute_halo_properties(snapshot, membership, hbt, None, dmo=True, specs=SPECS,
                                   verbose=False, device="cpu")


def test_per_file_layout_mirrors_snapshot_split(tmp_path):
    sim = mock_data.make_mock_simulation(
        str(tmp_path), n_halos=6, n_field=4000, boxsize=20.0, seed=55
    )
    template = str(tmp_path / "multi" / "snap_0077.{file_nr}.hdf5")
    mock_data.split_snapshot_files(sim["snapshot"], template, n_files=3)

    mem_template = str(tmp_path / "multi" / "mem_0077.{file_nr}.hdf5")
    run_group_membership(template, sim["hbt_basename"], mem_template, batch_rows=1000)
    mem_mono = str(tmp_path / "mem_mono.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], mem_mono)

    # one membership file per snapshot file, with its row counts
    by_id = {}
    for file_nr in range(3):
        mfile = mem_template.format(file_nr=file_nr)
        sfile = template.format(file_nr=file_nr)
        assert os.path.exists(mfile)
        with h5py.File(mfile, "r") as m, h5py.File(sfile, "r") as s:
            assert m["Header"].attrs["OutputType"] == "Membership"
            for ptype in s:
                if not ptype.startswith("PartType") or "ParticleIDs" not in s[ptype]:
                    continue
                n_snap = s[ptype]["ParticleIDs"].shape[0]
                grnr = m[ptype]["GroupNr_bound"]
                assert grnr.shape[0] == n_snap, (ptype, file_nr)
                assert m[ptype]["Rank_bound"].shape[0] == n_snap
                assert "a-scale exponent" in grnr.attrs
                for pid, g in zip(s[ptype]["ParticleIDs"][...], grnr[...]):
                    by_id[int(pid)] = int(g)

    # the per-file labels equal the monolithic (canonical-order) run's
    meta = SnapshotMetadata(sim["snapshot"])
    mono_ids = {}
    with h5py.File(mem_mono, "r") as m:
        for ptype in m:
            if not ptype.startswith("PartType"):
                continue
            mask = np.ones(meta.nr_cells, bool)
            ids = read_masked_cells(meta, mask, {ptype: ["ParticleIDs"]})[ptype]["ParticleIDs"]
            for pid, g in zip(ids, m[ptype]["GroupNr_bound"][...]):
                mono_ids[int(pid)] = int(g)
    assert by_id == mono_ids

    # the entry reads the per-file membership to the same catalogue
    mono = _entry(sim["snapshot"], mem_mono, sim["hbt_basename"])
    split = _entry(template, mem_template, sim["hbt_basename"])
    for group in ("BoundSubhalo", "SO/200_crit"):
        for key in mono.results[group]:
            np.testing.assert_allclose(
                split.results[group][key], mono.results[group][key], rtol=1e-5,
                err_msg=f"{group}/{key}",
            )


def test_multifile_snapshot_requires_file_nr_in_output_or_monolithic(tmp_path):
    """The per-file writer refuses a single output name for a two-file
    snapshot (``run_group_membership`` picks the monolithic writer for
    such a name, so only the writer's own assert guards it)."""
    sim = mock_data.make_mock_simulation(
        str(tmp_path), n_halos=4, n_field=1000, boxsize=20.0, seed=7
    )
    template = str(tmp_path / "multi" / "snap_0077.{file_nr}.hdf5")
    mock_data.split_snapshot_files(sim["snapshot"], template, n_files=2)
    with pytest.raises(AssertionError):
        _write_snapshot_layout(template, str(tmp_path / "single_out.hdf5"), ("PartType1",),
                               None, {}, False, {}, 1000, False)


_RSS_SCRIPT = r"""
import resource, sys
from soap_tpu_torch.pipeline.membership import run_group_membership
run_group_membership(
    sys.argv[1], sys.argv[2], sys.argv[3],
    ptypes=("PartType1",),
    batch_rows=1 << 20,
    return_labels=False,
)
print("MAXRSS_KB", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
"""


def _run_membership_rss(snap_template, hbt_basename, out_template):
    r = subprocess.run(
        [sys.executable, "-c", _RSS_SCRIPT, snap_template, hbt_basename, out_template],
        capture_output=True, text=True, timeout=600, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    m = re.search(r"MAXRSS_KB (\d+)", r.stdout)
    assert m, r.stdout
    return int(m.group(1)) / 1024.0  # MB


@pytest.mark.slow
def test_membership_rss_independent_of_snapshot_size(tmp_path):
    """The streaming join: peak RSS must not grow with the snapshot
    (24M against 2M rows: ~176 MB of IDs and ~270 MB of labels that an
    in-core join would hold)."""
    sim = mock_data.make_mock_simulation(
        str(tmp_path), n_halos=4, n_field=1000, boxsize=20.0, seed=3
    )
    small = str(tmp_path / "small" / "snap.{file_nr}.hdf5")
    big = str(tmp_path / "big" / "snap.{file_nr}.hdf5")
    _make_big_snapshot(small, 2 * 1024 * 1024, 2)
    _make_big_snapshot(big, 24 * 1024 * 1024, 2)
    rss_small = _run_membership_rss(
        small, sim["hbt_basename"], str(tmp_path / "small" / "mem.{file_nr}.hdf5"))
    rss_big = _run_membership_rss(
        big, sim["hbt_basename"], str(tmp_path / "big" / "mem.{file_nr}.hdf5"))
    assert rss_big - rss_small < 200.0, (
        f"membership RSS grew with snapshot size: {rss_small:.0f} MB -> {rss_big:.0f} MB")


def test_membership_potentials_dataset(tmp_path):
    """``with_potentials`` writes SpecificPotentialEnergies, the dataset
    the entry reads for PotentialEnergyTotal, with (km/s)^2 unit
    attributes; unbound particles get 0."""
    sim = mock_data.make_mock_simulation(
        str(tmp_path), n_halos=4, n_field=1500, boxsize=20.0, seed=9
    )
    uni = sim["universe"]
    rng = np.random.default_rng(2)
    pots = [(-rng.uniform(1, 10, len(ids))) for ids in uni.bound_ids]
    with h5py.File(sim["hbt_basename"] + ".0.hdf5", "a") as f:
        ds = f.create_dataset("PotentialEnergies", (uni.n_halos,),
                              dtype=h5py.vlen_dtype(np.float64))
        for i, p in enumerate(pots):
            ds[i] = p
    mem = str(tmp_path / "mem_pot.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], mem, with_potentials=True)
    meta = SnapshotMetadata(sim["snapshot"])
    mask = np.ones(meta.nr_cells, bool)
    ids = read_masked_cells(meta, mask, {"PartType1": ["ParticleIDs"]})["PartType1"][
        "ParticleIDs"]
    by_id = {}
    for hids, hpots in zip(uni.bound_ids, pots):
        for pid, p in zip(hids, hpots):
            by_id[int(pid)] = p
    with h5py.File(mem, "r") as f:
        g = f["PartType1"]
        assert "SpecificPotentialEnergies" in g
        got = g["SpecificPotentialEnergies"][...]
        assert float(g["SpecificPotentialEnergies"].attrs["U_L exponent"][0]) == 2.0
        grnr = g["GroupNr_bound"][...]
        want = np.array([by_id.get(int(p), 0.0) for p in ids])
        np.testing.assert_allclose(got, want)
        assert (got[grnr < 0] == 0.0).all()
        assert (got[grnr >= 0] < 0.0).all()
