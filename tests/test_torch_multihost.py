"""The port's multi-host runs: chunk shares, scratch combine, one writer.

Ports of ``tests/test_multihost.py``'s six tests and of the two-process
race of ``tests/test_multihost_concurrent.py``, on the port's
``parallel/multihost.py`` and its entry on the CPU (membership files
from the JAX package's program).  In the race each process imports
``soap_tpu_torch`` only.
"""

import os
import socket
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch.io.catalogue_writer import read_catalogue
from soap_tpu_torch.parallel import multihost
from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.pipeline.run import compute_halo_properties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = [HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "Ndm"))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's small CPU runs: the default pool
    oversubscribes the cores beside the other test workers, which makes
    runs of many small ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(tmp_path, seed, n_halos=8, n_field=4000, boxsize=20.0):
    sim = make_mock_simulation(str(tmp_path), n_halos=n_halos, n_field=n_field,
                               boxsize=boxsize, seed=seed)
    mem = str(tmp_path / "mem.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], mem)
    return dict(snapshot_file=sim["snapshot"], membership_file=mem,
                halo_basename=sim["hbt_basename"])


def test_chunks_for_host():
    assert multihost.chunks_for_host(6, 0, 2) == [0, 2, 4]
    assert multihost.chunks_for_host(6, 1, 2) == [1, 3, 5]
    assert multihost.chunks_for_host(5, 0, 1) == [0, 1, 2, 3, 4]


def test_detect_host_rank(monkeypatch):
    monkeypatch.delenv("SLURM_PROCID", raising=False)
    monkeypatch.delenv("SLURM_NTASKS", raising=False)
    assert multihost.detect_host_rank() == (0, 1)
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert multihost.detect_host_rank() == (3, 4)


def test_lazy_combine_matches_eager(tmp_path):
    """The lazy columns equal the eager combine byte for byte, apply
    set_mask, overlay and delete; incomplete scratch is refused."""
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    rng = np.random.default_rng(3)
    n_halos = 20
    specs = [HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "com"))]
    for fname, rows in (("chunk_0.hdf5", np.arange(0, 12)), ("chunk_1.hdf5", np.arange(12, 20))):
        with h5py.File(scratch / fname, "w") as f:
            f["rows"] = rows
            f["BoundSubhalo/Mtot"] = rng.random(len(rows)).astype(np.float32)
            f["BoundSubhalo/com"] = rng.random((len(rows), 3)).astype(np.float32)
            f.attrs["calc_names"] = [np.bytes_("BoundSubhalo/Mtot")]
            f.attrs["Write complete"] = True

    eager = multihost.combine_scratch(str(scratch), specs, n_halos)
    lazy = multihost.combine_scratch(str(scratch), specs, n_halos, lazy=True)
    assert set(lazy) == set(eager)
    assert set(lazy["BoundSubhalo"]) == set(eager["BoundSubhalo"])
    for key in eager["BoundSubhalo"]:
        np.testing.assert_array_equal(lazy["BoundSubhalo"][key], eager["BoundSubhalo"][key])

    mask = np.ones(n_halos, bool)
    mask[::3] = False
    lazy["BoundSubhalo"].set_mask("com", mask)
    got = lazy["BoundSubhalo"]["com"]
    np.testing.assert_array_equal(got[~mask], 0.0)
    np.testing.assert_array_equal(got[mask], eager["BoundSubhalo"]["com"][mask])

    lazy["BoundSubhalo"]["Extra"] = np.ones(n_halos)
    assert "Extra" in lazy["BoundSubhalo"]
    del lazy["BoundSubhalo"]["Mtot"]
    assert "Mtot" not in lazy["BoundSubhalo"]
    assert sorted(lazy["BoundSubhalo"]) == ["Extra", "com"]

    with h5py.File(scratch / "chunk_1.hdf5", "a") as f:
        f.attrs["Write complete"] = False
    with pytest.raises(RuntimeError):
        multihost.combine_scratch(str(scratch), specs, n_halos, lazy=True)


def test_two_host_run(tmp_path):
    common = dict(_sim(tmp_path, 17), output_file=None, dmo=True, specs=SPECS, nr_chunks=4,
                  scratch_dir=str(tmp_path / "scratch"), verbose=False, device="cpu")
    # host 1 runs first: its combine finds chunks missing
    r1 = compute_halo_properties(host_index=1, host_count=2, **common)
    assert r1.output_path is None and r1.catalogue is None
    assert [c.chunk_nr for c in r1.chunks] == [1, 3]
    # host 0 runs its half; then the combine succeeds
    r0 = compute_halo_properties(host_index=0, host_count=2, **common)
    assert r0.catalogue is not None
    ref = compute_halo_properties(**{**common, "scratch_dir": None}, host_index=0, host_count=1)
    np.testing.assert_allclose(r0.results["BoundSubhalo"]["Mtot"],
                               ref.results["BoundSubhalo"]["Mtot"], rtol=1e-6)
    np.testing.assert_array_equal(r0.results["BoundSubhalo"]["Ndm"],
                                  ref.results["BoundSubhalo"]["Ndm"])


def test_combine_claim_single_writer(tmp_path):
    """Exactly one host wins the combine; the loser returns partial
    results and writes no catalogue."""
    scratch = str(tmp_path / "scratch")
    out0, out1 = str(tmp_path / "cat0.hdf5"), str(tmp_path / "cat1.hdf5")
    common = dict(_sim(tmp_path, 23), dmo=True, specs=SPECS, nr_chunks=4, scratch_dir=scratch,
                  verbose=False, device="cpu")
    r1 = compute_halo_properties(host_index=1, host_count=2, output_file=out1, **common)
    assert r1.output_path is None
    r0 = compute_halo_properties(host_index=0, host_count=2, output_file=out0, **common)
    assert r0.output_path == out0 and os.path.exists(out0)
    assert os.path.exists(os.path.join(scratch, "combine.lock"))
    # host 1 again (a requeued job): every chunk is complete, the claim taken
    r1b = compute_halo_properties(host_index=1, host_count=2, output_file=out1, **common)
    assert r1b.output_path is None and not os.path.exists(out1)
    assert r1b.stats.halos_done == 0  # its chunks came from scratch
    assert not multihost.claim_combine(scratch)
    multihost.release_combine(scratch)
    assert multihost.claim_combine(scratch)


def test_stale_lock_takeover(tmp_path):
    """A lock of a dead process on this host is taken over; a live one,
    another host's and an unreadable one are respected."""
    scratch = str(tmp_path)
    lock = os.path.join(scratch, "combine.lock")

    p = subprocess.Popen(["sleep", "0.01"])
    p.wait()
    with open(lock, "w") as f:
        f.write(f"{socket.gethostname()} pid={p.pid}\n")
    assert multihost.claim_combine(scratch)
    with open(lock) as f:
        assert f"pid={os.getpid()}" in f.read()

    multihost.release_combine(scratch)
    q = subprocess.Popen(["sleep", "60"])
    try:
        with open(lock, "w") as f:
            f.write(f"{socket.gethostname()} pid={q.pid}\n")
        assert not multihost.claim_combine(scratch)
    finally:
        q.kill()
        q.wait()

    with open(lock, "w") as f:
        f.write(f"not-{socket.gethostname()} pid=1\n")
    assert not multihost.claim_combine(scratch)

    with open(lock, "w") as f:
        f.write("garbage\n")
    assert not multihost.claim_combine(scratch)


def test_combine_metadata_consistency(tmp_path):
    """combine_scratch refuses dtype/shape- or version-skewed scratch."""
    scratch = str(tmp_path)
    specs = [HaloTypeSpec(kind="bound", group="G", keys=("a",))]

    def write(fname, rows, dtype, version="soap_tpu_torch 0.1.0"):
        with h5py.File(f"{scratch}/{fname}", "w") as f:
            f.create_dataset("rows", data=np.asarray(rows))
            f.create_dataset("G/a", data=np.zeros(len(rows), dtype))
            f.attrs["calc_names"] = [np.bytes_("G/a")]
            f.attrs["soap_tpu_version"] = np.bytes_(version)
            f.attrs["Write complete"] = True

    write("chunk_0.hdf5", [0, 1], np.float32)
    write("chunk_1.hdf5", [2, 3], np.float64)
    with pytest.raises(RuntimeError, match="metadata mismatch"):
        multihost.combine_scratch(scratch, specs, 4)
    write("chunk_1.hdf5", [2, 3], np.float32, version="0.1.0")
    with pytest.raises(RuntimeError, match="different soap_tpu versions"):
        multihost.combine_scratch(scratch, specs, 4)
    write("chunk_1.hdf5", [2, 3], np.float32)
    assert multihost.combine_scratch(scratch, specs, 4)["G"]["a"].shape == (4,)


RACE = r"""
import sys
import torch
from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.pipeline.run import compute_halo_properties

torch.set_num_threads(1)
workdir, host_index, host_count, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
specs = [
    HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "Ndm")),
    HaloTypeSpec(kind="SO", group="SO/200_crit", keys=("r", "Mtot"),
                 so_type="crit", so_multiple=200.0, centrals_only=True),
]
run = compute_halo_properties(
    f"{workdir}/snap_0077.hdf5", f"{workdir}/mem.hdf5", f"{workdir}/SubSnap_077", out,
    dmo=True, specs=specs, nr_chunks=4, scratch_dir=f"{workdir}/scratch",
    host_index=host_index, host_count=host_count, verbose=False, device="cpu")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "soap_tpu")]
assert not bad, bad
print("WROTE" if run.output_path else "NO_CATALOGUE", flush=True)
"""


def test_concurrent_two_process_race(tmp_path):
    """Two processes, one scratch directory, disjoint chunk halves, at
    the same time: exactly one writes the catalogue, and it equals a
    sequential one-host run's over the same four chunks (time stamps
    apart)."""
    import shutil

    workdir = tmp_path / "sim"
    workdir.mkdir()
    _sim(workdir, 31, n_halos=12, n_field=6000, boxsize=24.0)
    env = dict(os.environ, PYTHONPATH=REPO)

    def launch(host_index, host_count, out):
        return subprocess.Popen(
            [sys.executable, "-c", RACE, str(workdir), str(host_index), str(host_count), out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    ref_path = str(tmp_path / "ref.hdf5")
    ref = launch(0, 1, ref_path)
    ref_out, ref_err = ref.communicate(timeout=300)
    assert ref.returncode == 0, ref_err[-3000:]
    assert "WROTE" in ref_out
    shutil.rmtree(workdir / "scratch")

    outs = [str(tmp_path / f"cat_host{i}.hdf5") for i in (0, 1)]
    procs = [launch(i, 2, outs[i]) for i in (0, 1)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    written = [p for p in outs if os.path.exists(p)]
    assert len(written) == 1, (written, results)
    assert "".join(o for o, _ in results).count("WROTE") == 1

    got, want = read_catalogue(written[0]), read_catalogue(ref_path)
    assert list(got.groups) == list(want.groups)
    assert list(got.datasets) == list(want.datasets)
    for path, ds in want.datasets.items():
        g = got.datasets[path]
        assert g.data.dtype == ds.data.dtype and g.data.tobytes() == ds.data.tobytes(), path
        assert set(g.attrs) == set(ds.attrs), path
    for path, attrs in want.groups.items():
        for k, v in attrs.items():
            assert np.array_equal(np.asarray(got.groups[path][k]), np.asarray(v)), (path, k)
