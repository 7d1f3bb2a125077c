"""The port's membership, matching and conversion tools against the JAX
tools, on the same files.

check-membership (HBTplus and VR, and its rejection of a corrupted
label), the birth-halo index, track evolution, the FOF reorder, the
hydrogen fractions, the FOF radii, ``build_matrix``, halo matching and
the EAGLE conversion.  Inputs come from the JAX package's mock writer and
the JAX tool tests' own file writers, from fixed seeds; returned arrays and
counters are equal, and HDF5 outputs equal dataset by dataset
(``test_torch_tools.py::assert_same_h5``).  The converted EAGLE files
then go through the port's entry on the CPU.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.tools import convert_eagle as jax_convert
from soap_tpu.tools import fof_radii as jax_fof_radii
from soap_tpu.tools import hydrogen_phases as jax_hydrogen
from soap_tpu.tools import match_membership as jax_match
from soap_tpu.tools import membership_checks as jax_checks
from soap_tpu.tools import reorder_fof as jax_reorder
from soap_tpu.tools import track_evolution as jax_tracks
from soap_tpu.utils.mock_data import build_mock_universe, make_mock_simulation
from soap_tpu_torch.io.halo_catalogue import (
    GROUPNR_READERS, read_hbtplus_catalogue, read_hbtplus_groupnr,
)
from soap_tpu_torch.pipeline import run
from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.tools import (
    convert_eagle, fof_radii, hydrogen_phases, match_membership, membership_checks, reorder_fof,
    track_evolution,
)
from soap_tpu_torch.utils import mock_finders
from test_convert_eagle import BOX_HFREE, _write_eagle_mock
from test_match_membership import _write_sim
from test_membership_checks import _mini_snap
from test_torch_tools import assert_same_h5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_arrays(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The JAX check-membership test's mock (5 halos, seed 44) with its
    HBTplus membership file, and the same bound lists as VR files with
    theirs."""
    tmp = str(tmp_path_factory.mktemp("membership_tools"))
    sim = make_mock_simulation(tmp, n_halos=5, n_field=2500, boxsize=16.0, seed=44)
    mem = os.path.join(tmp, "mem.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], mem)
    uni = sim["universe"]
    cat = read_hbtplus_catalogue(sim["hbt_basename"], h=uni.h)
    vr = mock_finders.write_finder_files(tmp, cat, uni.h, uni.a,
                                         read_hbtplus_groupnr(sim["hbt_basename"])[1])["VR"]
    vr_mem = os.path.join(tmp, "mem_vr.hdf5")
    run_group_membership(sim["snapshot"], vr, vr_mem, halo_format="VR")
    return dict(sim, tmp=tmp, inputs={"HBTplus": (mem, sim["hbt_basename"]),
                                      "VR": (vr_mem, vr)})


def _outcome(fn):
    """A check's counters, or the message of the RuntimeError it raised."""
    try:
        return fn()
    except RuntimeError as e:
        return f"RuntimeError: {e}"


#: each corruption of one particle of the files: the label of a bound
#: particle to another halo or to none, a field particle labelled, a
#: rank moved, and a bound particle's ID changed in the snapshot (with
#: its label dropped)
CORRUPTIONS = ["none", "label", "unlabel", "field", "rank", "missing"]


@pytest.mark.parametrize("corruption", CORRUPTIONS)
@pytest.mark.parametrize("halo_format", ["HBTplus", "VR"])
def test_check_membership_accepts_and_rejects(sim, tmp_path, halo_format, corruption):
    """Both tools on the written files, and on copies with one particle
    corrupted: equal counters where the files agree, RuntimeError with
    the same message where they do not (a moved rank counts only where
    the finder gives ranks, as in the JAX tool); the array half gives the
    same on the same arrays."""
    mem, basename = sim["inputs"][halo_format]
    snap = sim["snapshot"]
    with h5py.File(snap, "r") as f, h5py.File(mem, "r") as m:
        ids = f["PartType1/ParticleIDs"][...]
        labels = m["PartType1/GroupNr_bound"][...]
        ranks = m["PartType1/Rank_bound"][...]
    bound_row = np.flatnonzero(labels == 2)[0]
    if corruption == "label":
        labels[bound_row] = 3
    elif corruption == "unlabel":
        labels[bound_row] = -1
    elif corruption == "field":
        labels[np.flatnonzero(labels == -1)[0]] = 0
    elif corruption == "rank":
        ranks[bound_row] += 1
    elif corruption == "missing":
        ids[bound_row] = ids.max() + 1
        labels[bound_row] = -1
    if corruption != "none":
        mem = str(tmp_path / "mem.hdf5")
        with h5py.File(mem, "w") as f:
            f["PartType1/GroupNr_bound"] = labels
            f["PartType1/Rank_bound"] = ranks
    if corruption == "missing":
        snap = str(tmp_path / "snap.hdf5")
        with h5py.File(sim["snapshot"], "r") as src, h5py.File(snap, "w") as dst:
            src.copy("PartType1", dst)
            dst["PartType1/ParticleIDs"][...] = ids
    ours = _outcome(lambda: membership_checks.check_group_membership(
        snap, mem, basename, halo_format=halo_format))
    theirs = _outcome(lambda: jax_checks.check_group_membership(
        snap, mem, basename, halo_format=halo_format))
    assert ours == theirs
    res = GROUPNR_READERS[halo_format](basename)
    assert _outcome(lambda: membership_checks.check_labels(ids, labels, ranks, *res)) == ours
    if corruption == "none" or (corruption == "rank" and halo_format == "VR"):
        assert ours["n_halos"] == 5
        assert ours["n_labelled"] == sim["universe"].halo_nbound.sum()
    else:
        assert ours.startswith("RuntimeError: ")


def test_birth_halo_index(tmp_path):
    """The JAX test's three snapshots and five stars: equal indices and
    files, and the array half with a loader gives the same."""
    s0, m0 = _mini_snap(tmp_path / "snap_0.hdf5", 0.4, [10, 11], grnr=[7, -1])
    s1, m1 = _mini_snap(tmp_path / "snap_1.hdf5", 0.7, [10, 11, 12], grnr=[8, 2, 5])
    s2, m2 = _mini_snap(tmp_path / "snap_2.hdf5", 1.0, [10, 11, 12, 13, 14],
                        grnr=[8, 2, 5, 3, 9])
    final = _mini_snap(tmp_path / "final_snap.hdf5", 1.0, [10, 11, 12, 13, 14],
                       birth_a=[0.3, 0.6, 0.65, 0.9, 1.2])
    # listed out of scale-factor order: both tools sort by it
    pairs = [(s1, m1), (s0, m0), (s2, m2)]
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    got = membership_checks.compute_birth_halo_index(pairs, final, ours)
    _same_arrays(got, jax_checks.compute_birth_halo_index(pairs, final, theirs))
    np.testing.assert_array_equal(got, [7, 2, 5, 3, -1])
    assert_same_h5(ours, theirs)
    stars = np.array([10, 11, 12, 13, 14], np.uint64)
    snaps = {0.7: ([10, 11, 12], [8, 2, 5]), 0.4: ([10, 11], [7, -1]),
             1.0: ([10, 11, 12, 13, 14], [8, 2, 5, 3, 9])}
    a = list(snaps)
    loaded = []
    out = membership_checks.birth_halo_index(
        stars, np.array([0.3, 0.6, 0.65, 0.9, 1.2], np.float32).astype(np.float64), a,
        lambda i: loaded.append(a[i]) or tuple(np.asarray(v) for v in snaps[a[i]]))
    _same_arrays(out, got)
    assert loaded == [0.4, 0.7, 1.0]


def test_track_evolution(tmp_path):
    """The JAX test's three catalogues: equal evolution arrays, redshifts
    and files."""
    paths = []
    layouts = [(1.0, [5, 7], [10.0, 70.0]), (0.5, [7, 5, 6], [71.0, 11.0, 60.0]),
               (0.0, [5, 6, 7, 9], [12.0, 61.0, 72.0, 90.0])]
    for i, (z, tracks, masses) in enumerate(layouts):
        p = str(tmp_path / f"cat_{i}.hdf5")
        with h5py.File(p, "w") as f:
            f.create_group("Header").attrs["Redshift"] = np.array([z])
            f["InputHalos/HBTplus/TrackId"] = np.array(tracks, np.int64)
            f["BoundSubhalo/TotalMass"] = np.array(masses)
            f["BoundSubhalo/CentreOfMass"] = np.arange(3 * len(tracks), dtype=np.float32
                                                       ).reshape(-1, 3)
        paths.append(p)
    props = ["BoundSubhalo/TotalMass", "BoundSubhalo/CentreOfMass"]
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    got = track_evolution.get_track_evolution(paths, ours, [5, 9, 3], props)
    want = jax_tracks.get_track_evolution(paths, theirs, [5, 9, 3], props)
    assert list(got) == list(want) == props
    for p in props:
        _same_arrays(got[p], want[p])
    assert_same_h5(ours, theirs)
    np.testing.assert_array_equal(got["BoundSubhalo/TotalMass"][2], [-1, -1, 90.0])


def test_reorder_swift_fof(tmp_path):
    """FOF ids between differently ordered snapshots: equal arrays and
    files; an unmatched ID raises in both."""
    rng = np.random.default_rng(6)
    ids = np.arange(1, 101, dtype=np.uint64)
    fof = rng.integers(1, 6, 100).astype(np.int64)
    order1, order2 = rng.permutation(100), rng.permutation(100)
    s1, s2 = str(tmp_path / "s1.hdf5"), str(tmp_path / "s2.hdf5")
    with h5py.File(s1, "w") as f:
        for pt, n in (("PartType1", 100), ("PartType4", 30)):
            g = f.create_group(pt)
            g["ParticleIDs"] = ids[order1][:n] + (1000 if pt == "PartType4" else 0)
            g["FOFGroupIDs"] = fof[order1][:n]
    with h5py.File(s2, "w") as f:
        f.create_group("PartType1")["ParticleIDs"] = ids[order2]
        f.create_group("PartType4")["ParticleIDs"] = (ids[order1][:30] + 1000)[::-1]
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    got = reorder_fof.reorder_swift_fof(s1, s2, ours)
    want = jax_reorder.reorder_swift_fof(s1, s2, theirs)
    assert list(got) == list(want) == ["PartType1", "PartType4"]
    for pt in want:
        _same_arrays(got[pt], want[pt])
    assert_same_h5(ours, theirs)
    with h5py.File(s2, "a") as f:
        f["PartType1/ParticleIDs"][0] = 99999
    for tool in (reorder_fof, jax_reorder):
        with pytest.raises(RuntimeError, match="failed to match"):
            tool.reorder_swift_fof(s1, s2, str(tmp_path / "out2.hdf5"))


def test_hydrogen_fractions(tmp_path):
    """The JAX test's hydro mock: equal SpeciesFractions and files; the
    array half's float64 fractions sum to one within 1e-12 and round to
    the file's float32 columns; the fits equal on a (n_H, T) grid."""
    sim = make_mock_simulation(str(tmp_path), n_halos=3, n_field=1200, boxsize=12.0, seed=10,
                               hydro=True)
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    got = hydrogen_phases.compute_hydrogen_fractions(sim["snapshot"], ours)
    want = jax_hydrogen.compute_hydrogen_fractions(sim["snapshot"], theirs)
    _same_arrays(got["SpeciesFractions"], want["SpeciesFractions"])
    assert_same_h5(ours, theirs)
    from soap_tpu_torch.io.swift_snapshot import SnapshotMetadata

    meta = SnapshotMetadata(sim["snapshot"])
    with h5py.File(sim["snapshot"], "r") as f:
        gas = f["PartType0"]
        T = np.asarray(gas["Temperatures"], np.float64)
        rho = np.asarray(gas["Densities"], np.float64)
        xh = np.asarray(gas["ElementMassFractions"][:, 0], np.float64)
        press = np.asarray(gas["Pressures"], np.float64) if "Pressures" in gas else None
    hi, hii, h2 = hydrogen_phases.hydrogen_fractions(T, rho, xh, press, meta.snap_units_cgs,
                                                     meta.a, meta.z)
    assert hi.dtype == np.float64 and ((0 <= hi) & (hi <= 1) & (0 <= h2) & (h2 <= 1)).all()
    np.testing.assert_allclose(hi + hii + 2 * h2, 1.0, rtol=0, atol=1e-12)
    sp = got["SpeciesFractions"]
    for col, x in ((1, hi), (2, hii), (3, h2)):
        _same_arrays(sp[:, col], x.astype(np.float32))
    n, t = np.meshgrid(np.logspace(-7, 3, 30), np.logspace(2, 8, 20))
    for z in (0.0, 1.7, 9.0):
        _same_arrays(hydrogen_phases.neutral_fraction(n.ravel(), t.ravel(), z),
                     jax_hydrogen.neutral_fraction(n.ravel(), t.ravel(), z))
    p = np.logspace(-2, 9, 50)
    _same_arrays(hydrogen_phases.molecular_fraction(p), jax_hydrogen.molecular_fraction(p))


def test_fof_radii(tmp_path):
    """The JAX test's mock and FOF catalogue (with one group no particle
    names, and rows not in id order): equal radii and files."""
    sim = make_mock_simulation(str(tmp_path), n_halos=5, n_field=2000, boxsize=16.0, seed=13)
    uni = sim["universe"]
    fof_in = str(tmp_path / "fof.hdf5")
    rows = np.array([3, 0, 4, 1, 2])
    with h5py.File(fof_in, "w") as f:
        f.attrs["Source"] = np.bytes_("mock")
        g = f.create_group("Groups")
        g["GroupIDs"] = np.append(rows + 1, 77).astype(np.int64)
        g["Centres"] = np.vstack([uni.halo_pos[rows], [[1.0, 1.0, 1.0]]])
        g["Masses"] = np.ones(uni.n_halos + 1)
        g["Sizes"] = np.append(uni.halo_nbound[rows], 0).astype(np.int64)
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    got = fof_radii.calculate_fof_radii(sim["snapshot"], fof_in, ours)
    _same_arrays(got, jax_fof_radii.calculate_fof_radii(sim["snapshot"], fof_in, theirs))
    assert (got[:-1] > 0).all() and got[-1] == 0.0
    assert_same_h5(ours, theirs)


def test_build_matrix():
    """Flattened symmetric matrices of 1 to 4 dimensions, one row alone,
    float32 and float64: equal unpacking; a length that is no d(d+1)/2
    raises in both."""
    rng = np.random.default_rng(8)
    for ndim in (1, 2, 3, 4):
        for dtype in (np.float32, np.float64):
            flat = rng.random((10, ndim * (ndim + 1) // 2)).astype(dtype)
            _same_arrays(fof_radii.build_matrix(flat), jax_fof_radii.build_matrix(flat))
            _same_arrays(fof_radii.build_matrix(flat[0]), jax_fof_radii.build_matrix(flat[0]))
    for tool in (fof_radii, jax_fof_radii):
        with pytest.raises(ValueError):
            tool.build_matrix(np.ones((2, 5)))


MATCH_CASES = {
    # (sim 1, sim 2) layouts and keywords of the JAX tests, and a dropped
    # particle
    "permuted": (dict(perm=[0, 1, 2], id_offsets=[5, 6, 7]),
                 dict(perm=[2, 0, 1], id_offsets=[40, 41, 42]), dict(match_satellites=True)),
    "centrals": (dict(perm=[0, 1, 2], id_offsets=[5, 6, 7]),
                 dict(perm=[0, 1, 2], id_offsets=[5, 6, 7]), dict(match_satellites=False)),
    "limited": (dict(perm=[0, 1, 2], id_offsets=[1, 2, 3]),
                dict(perm=[0, 1, 2], id_offsets=[1, 2, 3]),
                dict(nr_particles=4, match_satellites=True)),
    "dropped": (dict(perm=[1, 2, 0], id_offsets=[1, 2, 3]),
                dict(perm=[0, 2, 1], id_offsets=[9, 8, 7], drop_particle=2), dict()),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_match_halos(tmp_path, case):
    """Both tools on the JAX tests' pairs of simulations: equal six
    datasets, equal files."""
    a, b, kw = MATCH_CASES[case]
    s1, m1, c1 = _write_sim(tmp_path, "a", **a)
    s2, m2, c2 = _write_sim(tmp_path, "b", **b)
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    got = match_membership.match_group_membership(s1, m1, c1, s2, m2, c2, ours, **kw)
    want = jax_match.match_group_membership(s1, m1, c1, s2, m2, c2, theirs, **kw)
    assert list(got) == list(want)
    for k in want:
        _same_arrays(got[k], want[k])
    assert_same_h5(ours, theirs)
    assert (got["MatchIndex1to2"] >= 0).any()


def test_convert_eagle_and_run_port_entry(tmp_path):
    """The JAX test's EAGLE mock (seed 77): equal counts and equal
    snapshot and membership files; then the port's entry on the converted
    files (SubfindEagle, the JAX test's two-spec list, on the CPU) gives
    the bound counts and masses the mock holds."""
    uni = build_mock_universe(n_halos=4, n_field=2500, boxsize=BOX_HFREE, seed=77,
                              mass_range=(40.0, 200.0))
    pd, tab = _write_eagle_mock(tmp_path, uni)
    out = {}
    for name, tool in (("port", convert_eagle), ("jax", jax_convert)):
        snap = str(tmp_path / name / "snap_0027.hdf5")
        mem = str(tmp_path / name / "membership_0027.hdf5")
        out[name] = (tool.convert_eagle(pd, snap, mem, subfind_basename=tab), snap, mem)
    counts, snap, mem = out["port"]
    assert counts == out["jax"][0] and counts["PartType1"] == len(uni.pos)
    assert_same_h5(snap, out["jax"][1])
    assert_same_h5(mem, out["jax"][2])

    specs = [
        HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "Ndm")),
        HaloTypeSpec(kind="SO", group="SO/200_crit", keys=("r", "Mtot"), so_type="crit",
                     so_multiple=200.0, centrals_only=True),
    ]
    res = run.compute_halo_properties(snap, mem, tab, str(tmp_path / "cat.hdf5"),
                                      halo_format="SubfindEagle", dmo=True, specs=specs,
                                      device="cpu", verbose=False)
    sub = res.results["BoundSubhalo"]
    order = np.argsort(-uni.halo_nbound)
    np.testing.assert_array_equal(sub["Ndm"], uni.halo_nbound[order])
    np.testing.assert_allclose(sub["Mtot"], uni.halo_nbound[order] * uni.mass[0], rtol=1e-5)
    assert (res.results["SO/200_crit"]["r"] > 0).all()
