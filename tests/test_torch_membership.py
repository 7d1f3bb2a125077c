"""The port's group-membership program against the JAX package's.

``soap_tpu_torch/pipeline/membership.py`` against
``soap_tpu/pipeline/membership.py``: the in-memory joins on seeded IDs
(empty haystacks and needles included), the HBTplus bound-list reader in
both layouts (with potentials), and the membership files both programs
write from the JAX package's mock simulation, dataset for dataset and
attribute for attribute, in the monolithic and the per-file layout,
with potentials, with a separate FOF snapshot and from a multi-file
snapshot.  Two faults of the reference are ported as they are and
pinned here: int64 needles against uint64 IDs above 2^53 miss, and a
FOF snapshot type without FOFGroupIDs raises KeyError.
"""

import os
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest

from soap_tpu.io.halo_catalogue import read_hbtplus_groupnr as jax_groupnr
from soap_tpu.pipeline import membership as jax_mem
from soap_tpu.utils import mock_data as jax_mock
from soap_tpu_torch.io.halo_catalogue import GROUPNR_READERS, read_hbtplus_groupnr
from soap_tpu_torch.pipeline import membership as mem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (snapshot IDs, bound IDs, with rank, with potentials, ID dtype)
JOIN_CASES = {
    "typical": (5000, 1200, True, True, np.uint64),
    "no-rank": (3000, 700, False, False, np.int64),
    "empty-haystack": (400, 0, True, True, np.uint64),
    "empty-needles": (0, 300, True, False, np.uint64),
    "both-empty": (0, 0, False, False, np.int64),
}


def _join_inputs(n_snap, n_bound, seed):
    rng = np.random.default_rng(seed)
    universe = rng.permutation(4 * max(n_snap, n_bound, 1))
    snap_ids = universe[:n_snap]
    bound = rng.choice(universe, n_bound, replace=False)
    grnr = rng.integers(0, 50, n_bound).astype(np.int64)
    rank = rng.integers(0, 1000, n_bound).astype(np.int32)
    pot = -rng.uniform(1.0, 10.0, n_bound)
    return snap_ids, bound, grnr, rank, pot


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.mark.parametrize("case", list(JOIN_CASES))
@pytest.mark.parametrize("batch_rows", [64, mem.BATCH])
def test_compute_membership_matches_jax(case, batch_rows):
    n_snap, n_bound, with_rank, with_pot, dtype = JOIN_CASES[case]
    snap_ids, bound, grnr, rank, pot = _join_inputs(n_snap, n_bound, 3)
    args = (snap_ids.astype(dtype), bound.astype(dtype), grnr,
            rank if with_rank else None, pot if with_pot else None)
    want = jax_mem.compute_membership(*args)
    got = mem.compute_membership(*args, batch_rows=batch_rows)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w, case)
    if n_snap and n_bound:
        assert (got[0] >= 0).any() and (got[0] < 0).any()


@pytest.mark.parametrize("n_fof", [600, 0])
def test_compute_fof_groups_matches_jax(n_fof):
    rng = np.random.default_rng(5)
    fof_ids = rng.permutation(1000)[:n_fof].astype(np.int64)
    fof_groups = rng.integers(1, 40, n_fof).astype(np.int32)
    snap_ids = rng.permutation(1000).astype(np.int64)
    want = jax_mem.compute_fof_groups(snap_ids, fof_ids, fof_groups)
    _same(mem.compute_fof_groups(snap_ids, fof_ids, fof_groups), want)
    _same(mem.compute_fof_groups(snap_ids, fof_ids, fof_groups, batch_rows=7), want)
    assert mem.FOF_NULL_ID == jax_mem.FOF_NULL_ID


def test_ids_above_2_53_miss_across_signedness():
    """Reference fault, ported as it is: ``SortedIdJoin.probe`` with int64
    needles against a uint64 haystack searches in float64, so an ID
    above 2^53 that rounds onto its neighbour misses, with no error."""
    big = 2**53
    hay = np.array([big, big + 1], np.uint64)
    needles = np.array([big + 1], np.int64)
    got = mem.SortedIdJoin(hay).probe(needles)
    _same(got, jax_mem.SortedIdJoin(hay).probe(needles))
    assert got.tolist() == [-1]
    # the same IDs in one dtype match
    assert mem.SortedIdJoin(hay).probe(needles.astype(np.uint64)).tolist() == [1]


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The JAX package's mock (6 halos, two satellites), with potentials
    in its HBTplus file, a copy in the sorted HBTplus layout, the
    snapshot split over three files, and a FOF snapshot (rows shuffled,
    only ParticleIDs and FOFGroupIDs)."""
    tmp = str(tmp_path_factory.mktemp("membership"))
    out = jax_mock.make_mock_simulation(tmp, n_halos=6, n_field=3000, boxsize=20.0,
                                        seed=55, n_satellites=2)
    uni = out["universe"]
    rng = np.random.default_rng(2)
    pots = [-rng.uniform(1, 10, len(ids)) for ids in uni.bound_ids]
    with h5py.File(out["hbt_basename"] + ".0.hdf5", "a") as f:
        ds = f.create_dataset("PotentialEnergies", (uni.n_halos,),
                              dtype=h5py.vlen_dtype(np.float64))
        for i, p in enumerate(pots):
            ds[i] = p
    sorted_file = os.path.join(tmp, "hbt_sorted.hdf5")
    with h5py.File(sorted_file, "w") as f:
        f.create_dataset("Particles/ParticleIDs",
                         data=np.concatenate(uni.bound_ids).astype(np.uint64))
        f.create_dataset("Particles/PotentialEnergies", data=np.concatenate(pots))
        f.create_dataset("Subhalos/Nbound", data=np.asarray(uni.halo_nbound, np.int64))
        f.create_dataset("Units/LengthInMpch", data=[1.0])
        f.create_dataset("Units/MassInMsunh", data=[1.0])
        f.create_dataset("Units/VelInKmS", data=[2.0])
    out["sorted_hbt"] = sorted_file
    template = os.path.join(tmp, "multi", "snap.{file_nr}.hdf5")
    jax_mock.split_snapshot_files(out["snapshot"], template, n_files=3)
    out["template"] = template
    fof = os.path.join(tmp, "fof_snap.hdf5")
    shutil.copy(out["snapshot"], fof)
    with h5py.File(fof, "r+") as f:
        g = f["PartType1"]
        perm = np.random.default_rng(123).permutation(g["ParticleIDs"].shape[0])
        for name in ("ParticleIDs", "FOFGroupIDs"):
            g[name][...] = g[name][...][perm]
        for name in list(g):
            if name not in ("ParticleIDs", "FOFGroupIDs"):
                del g[name]
    out["fof"] = fof
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("layout", ["unsorted", "sorted"])
@pytest.mark.parametrize("pots", [False, True])
def test_read_hbtplus_groupnr_matches_jax(sim, layout, pots):
    base = sim["hbt_basename"] if layout == "unsorted" else sim["sorted_hbt"]
    want = jax_groupnr(base, read_potential_energies=pots)
    got = read_hbtplus_groupnr(base, read_potential_energies=pots)
    assert len(got) == len(want) and got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        _same(g, w, layout)
    assert GROUPNR_READERS["HBTplus"] is read_hbtplus_groupnr


def _file_items(path):
    """{name: (kind, value, attrs)} for every group and dataset of a file;
    the header's write time apart."""
    items = {}

    def visit(name, obj):
        attrs = {k: np.asarray(v) for k, v in obj.attrs.items() if k != "SnapshotDate"}
        value = obj[...] if isinstance(obj, h5py.Dataset) else None
        items[name] = (type(obj).__name__, value, attrs)

    with h5py.File(path, "r") as f:
        visit("/", f)
        f.visititems(visit)
    return items


def _same_file(got_path, want_path):
    got, want = _file_items(got_path), _file_items(want_path)
    assert list(got) == list(want)
    for name, (kind, value, attrs) in want.items():
        g_kind, g_value, g_attrs = got[name]
        assert g_kind == kind, name
        if value is not None:
            _same(g_value, value, name)
        assert list(g_attrs) == list(attrs), name
        for k in attrs:
            _same(g_attrs[k], attrs[k], f"{name}@{k}")


#: run_group_membership's cases: (snapshot, output name, keywords)
FILE_CASES = {
    "monolithic": ("snapshot", "mem.hdf5", {}),
    "monolithic-potentials": ("snapshot", "mem.hdf5", dict(with_potentials=True)),
    "monolithic-fof": ("snapshot", "mem.hdf5", dict(fof="fof")),
    "per-file": ("snapshot", "mem.{file_nr}.hdf5", dict(batch_rows=1000)),
    "multi-file-per-file": ("template", "mem.{file_nr}.hdf5",
                            dict(batch_rows=700, with_potentials=True)),
    "multi-file-monolithic": ("template", "mem.hdf5", dict(fof="fof")),
}


@pytest.mark.parametrize("case", list(FILE_CASES))
def test_membership_files_equal_jax(sim, case):
    snap_key, out_name, kw = FILE_CASES[case]
    kw = dict(kw)
    if "fof" in kw:
        kw["fof_filename"] = sim[kw.pop("fof")]
    snap = sim[snap_key]
    paths = {}
    labels = {}
    for who, fn in (("jax", jax_mem.run_group_membership), ("port", mem.run_group_membership)):
        out = os.path.join(sim["tmp"], case, who, out_name)
        labels[who] = fn(snap, sim["hbt_basename"], out, **kw)
        paths[who] = out
    assert list(labels["port"]) == list(labels["jax"])
    for pt in labels["jax"]:
        _same(labels["port"][pt], labels["jax"][pt], pt)
    n_files = 3 if snap_key == "template" and "{file_nr}" in out_name else 1
    for i in range(n_files):
        _same_file(paths["port"].format(file_nr=i), paths["jax"].format(file_nr=i))
    with h5py.File(paths["port"].format(file_nr=0), "r") as f:
        assert f["Header"].attrs["OutputType"] == "Membership"
        g = f["PartType1"]
        assert ("SpecificPotentialEnergies" in g) == bool(kw.get("with_potentials"))
        assert ("FOFGroupIDs" in g) == ("fof_filename" in kw)
    assert (labels["port"]["PartType1"] >= 0).any()


def test_fof_snapshot_type_without_group_ids_raises(sim):
    """Reference fault, ported as it is: a FOF snapshot type that has
    ParticleIDs but no FOFGroupIDs raises KeyError."""
    bad = os.path.join(sim["tmp"], "fof_bad.hdf5")
    shutil.copy(sim["fof"], bad)
    with h5py.File(bad, "r+") as f:
        del f["PartType1/FOFGroupIDs"]
    for fn in (jax_mem.run_group_membership, mem.run_group_membership):
        with pytest.raises(KeyError):
            fn(sim["snapshot"], sim["hbt_basename"], os.path.join(sim["tmp"], "x.hdf5"),
               fof_filename=bad)
    with pytest.raises(KeyError):
        mem._read_fof_columns(bad, "PartType1")


def test_other_finders_raise(sim):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mem.run_group_membership(sim["snapshot"], sim["hbt_basename"],
                                 os.path.join(sim["tmp"], "vr.hdf5"), halo_format="VR")


def test_batch_size_is_a_keyword_not_an_environment_variable():
    env = dict(os.environ, SOAP_TPU_MEMBERSHIP_BATCH="5", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c",
         "from soap_tpu_torch.pipeline import membership as m; print(m.BATCH)"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) == 16 * 1024 * 1024 == jax_mem.BATCH
