"""The port's chunk loop against itself, its readers and the JAX loop.

One written DMO mock (``tests/test_chunks.py``'s: 10 halos, seed 21)
with the JAX package's membership file, and the reduced list of
``tests/test_torch_entry_jax.py`` (BoundSubhalo, SO/200_crit, a 50 kpc
exclusive sphere and a projected aperture):

- the port of ``tests/test_chunks.py``: four chunks equal one under
  ``utils/parity.py``, a rerun on valid scratch files does no engine
  work and gives equal arrays, and stale scratch is recomputed;
- the port's four-chunk catalogue against the JAX entry's (run as
  ``test_torch_entry_jax.py`` runs it: the range layout, Pallas in
  interpret mode), the eight float32-summed non-iterative inertia
  tensors apart;
- the in-memory reader equals the file reader for every chunk, array
  for array; read-ahead equals no read-ahead; two reader processes equal
  the serial read byte for byte;
- the JAX ``combine_scratch`` reads the port's scratch files to the
  port's own combine, and refuses a directory that mixes both packages'.
"""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

from soap_tpu.parallel import multihost as jax_multihost
from soap_tpu.pipeline.chunks import _write_scratch as jax_write_scratch
from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.pipeline.run import compute_halo_properties as jax_compute
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch.io import reader_pool, swift_snapshot
from soap_tpu_torch.io.catalogue_writer import read_catalogue
from soap_tpu_torch.io.halo_catalogue import read_hbtplus_catalogue
from soap_tpu_torch.parallel import multihost
from soap_tpu_torch.parallel.domain import peano_decomposition
from soap_tpu_torch.pipeline import chunks, run
from soap_tpu_torch.pipeline.engine import HaloTypeSpec
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.parity import catalogue_differences, key_close

GROUPS = ("BoundSubhalo", "SO/200_crit", "ExclusiveSphere/50kpc",
          "ProjectedAperture/50kpc/projz")
#: the datasets the JAX entry sums in float32 (``test_torch_entry_jax.py``)
NONITERATIVE = tuple(
    f"{g}/{sp}InertiaTensor{red}Noniterative"
    for g in GROUPS[:2] for sp in ("Total", "DarkMatter") for red in ("", "Reduced")
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's small CPU runs: the default pool
    oversubscribes the cores beside the other test workers, which makes
    runs of many small ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(build=build_specs):
    return [s for s in build(None, True, 100.0) if s.group in GROUPS]


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_chunks"))
    s = make_mock_simulation(tmp, n_halos=10, n_field=6000, boxsize=24.0, seed=21)
    membership = os.path.join(tmp, "membership.hdf5")
    run_group_membership(s["snapshot"], s["hbt_basename"], membership)
    return {**s, "membership": membership, "tmp": tmp}


def _port(sim, output_file=None, specs=None, **kw):
    return run.compute_halo_properties(
        sim["snapshot"], sim["membership"], sim["hbt_basename"], output_file, dmo=True,
        specs=_specs() if specs is None else specs, verbose=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def port_runs(sim):
    out = {}
    for n in (1, 4):
        path = os.path.join(sim["tmp"], f"port_{n}.hdf5")
        out[n] = (_port(sim, path, nr_chunks=n), path)
    return out


def test_four_chunks_equal_one(port_runs):
    one, four = port_runs[1][0], port_runs[4][0]
    assert [r.halos for r in one.chunks] == [10]
    assert len(four.chunks) == 4 and sum(r.halos for r in four.chunks) == 10
    assert four.stats.halos_done == one.stats.halos_done == 10
    assert catalogue_differences(one.catalogue, four.catalogue) == []
    for group, props in one.results.items():
        for key, arr in props.items():
            assert key_close(arr, four.results[group][key], key), f"{group}/{key}"
    np.testing.assert_array_equal(one.order, four.order)


def _no_iterative_inertia(specs):
    """The list without its iterative inertia tensors: the JAX engine's
    interpret-mode Pallas loop would take most of this file's time, and
    the loop is held to the JAX one in ``test_torch_inertia.py``."""
    return [dataclasses.replace(s, keys=tuple(
        k for k in s.keys if "InertiaTensor" not in k or "Noniterative" in k)) for s in specs]


def test_four_chunks_match_jax(sim):
    path = os.path.join(sim["tmp"], "jax_4.hdf5")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAP_TPU_DMA_GATHER", "1")
        mp.setenv("SOAP_TPU_PALLAS_INERTIA", "interpret")
        jax_compute(sim["snapshot"], sim["membership"], sim["hbt_basename"], path, dmo=True,
                    specs=_no_iterative_inertia(_specs(jax_build_specs)), nr_chunks=4,
                    verbose=False)
    ours_path = os.path.join(sim["tmp"], "port_4_no_iterative.hdf5")
    _port(sim, ours_path, specs=_no_iterative_inertia(_specs()), nr_chunks=4)
    theirs, ours = read_catalogue(path), read_catalogue(ours_path)
    assert "BoundSubhalo/TotalInertiaTensorNoniterative" in ours.datasets
    # only the float32-summed eight may differ; the port's values of
    # those equal its one-chunk run's (test_four_chunks_equal_one), whose
    # engine the entry's JAX test holds to a float64 recomputation
    differing = catalogue_differences(theirs, ours)
    assert all(d.split(" ")[0] in NONITERATIVE for d in differing), differing


def test_scratch_restart(sim, tmp_path):
    scratch = str(tmp_path / "scratch")
    r1 = _port(sim, nr_chunks=3, scratch_dir=scratch)
    assert r1.stats.halos_done == 10
    assert sorted(multihost.scratch_files(scratch)) == [f"chunk_{c}.hdf5" for c in range(3)]
    # a rerun takes every chunk from scratch: no engine work
    r2 = _port(sim, nr_chunks=3, scratch_dir=scratch)
    assert r2.stats.halos_done == 0 and r2.stats.n_bucket_calls == 0
    assert all(r.from_scratch for r in r2.chunks)
    for group, props in r1.results.items():
        for key, arr in props.items():
            np.testing.assert_array_equal(r2.results[group][key], arr, err_msg=f"{group}/{key}")
    assert catalogue_differences(r1.catalogue, r2.catalogue) == []


def test_scratch_rejects_stale_calc_names(sim, tmp_path):
    scratch = str(tmp_path / "scratch")
    _port(sim, nr_chunks=2, scratch_dir=scratch)
    other = [HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "vcom"))]
    r = _port(sim, specs=other, nr_chunks=2, scratch_dir=scratch)
    assert r.stats.halos_done == 10
    assert "vcom" in r.results["BoundSubhalo"]
    # and a chunk whose rows changed is recomputed alone
    with h5py.File(chunks.scratch_path(scratch, 0), "a") as f:
        f["rows"][0] = f["rows"][0] + 1
    again = _port(sim, specs=other, nr_chunks=2, scratch_dir=scratch)
    assert [c.from_scratch for c in again.chunks] == [False, True]
    assert again.stats.halos_done == r.chunks[0].halos


def _inputs(sim):
    """The file's metadata and catalogue, and the mock's in memory."""
    uni = sim["universe"]
    meta = swift_snapshot.SnapshotMetadata(sim["snapshot"], [sim["membership"]])
    cat = read_hbtplus_catalogue(sim["hbt_basename"], h=meta.h, a=meta.a)
    mmeta = run.mock_metadata(uni)
    ptypes, specs = run.entry_plan(mmeta, True, None, _specs())
    host = chunks.mock_fields(uni, specs, mmeta, ptypes, run.age_table(mmeta))
    return meta, cat, mmeta, run.mock_catalogue(uni), host, ptypes, specs


def test_memory_reader_equals_file_reader(sim):
    meta, cat, mmeta, mcat, host, ptypes, specs = _inputs(sim)
    files = chunks.file_reader(meta, cat, specs, ptypes, run.age_table(meta))
    memory = chunks.memory_reader(mmeta, mcat, host, specs)
    chunk_of = peano_decomposition(np.mod(cat.cofp, meta.boxsize), meta.boxsize, 4)
    n_total = sum(len(p) for p, _ in host.values())
    seen = []
    for c in range(4):
        rows = np.flatnonzero(chunk_of == c)
        got, want = memory(rows), files(rows)
        assert list(got) == list(want) == ["PartType1"]
        for pt in want:
            assert got[pt][0].tobytes() == want[pt][0].tobytes(), pt
            assert list(got[pt][1]) == list(want[pt][1])
            for name, arr in want[pt][1].items():
                a = got[pt][1][name]
                assert a.dtype == arr.dtype and a.tobytes() == arr.tobytes(), name
        seen.append(len(want["PartType1"][0]))
    # the chunks' read masks leave cells out
    assert min(seen) < n_total


def test_prefetch_equals_serial(sim):
    _, _, mmeta, mcat, host, ptypes, specs = _inputs(sim)
    out = {}
    for prefetch in (True, False):
        out[prefetch] = run.build_catalogue(mmeta, mcat, host, specs, device="cpu",
                                            nr_chunks=4, prefetch=prefetch)
    a, b = out[True], out[False]
    assert list(a.catalogue.datasets) == list(b.catalogue.datasets)
    for path, ds in a.catalogue.datasets.items():
        assert ds.data.tobytes() == b.catalogue.datasets[path].data.tobytes(), path
    assert [r.particles for r in a.chunks] == [r.particles for r in b.chunks]


def test_parallel_read_byte_identical(sim):
    meta, cat, *_rest, ptypes, specs = _inputs(sim)
    mask = chunks.read_mask(meta, cat.cofp[:3], cat.search_radius[:3], specs)
    props = chunks.fields_per_type(specs, meta, ptypes)
    serial = swift_snapshot.read_masked_cells(meta, mask, props)
    parallel = reader_pool.read_masked_cells_parallel(meta, mask, props, n_processes=2)
    assert list(parallel) == list(serial)
    for pt, arrays in serial.items():
        assert list(parallel[pt]) == list(arrays)
        for name, arr in arrays.items():
            got = parallel[pt][name]
            assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes(), name


def test_jax_combine_reads_port_scratch(sim, tmp_path):
    scratch = str(tmp_path / "scratch")
    specs = _specs()
    r = _port(sim, specs=specs, nr_chunks=3, scratch_dir=scratch)
    ours = multihost.combine_scratch(scratch, specs, 10)
    theirs = jax_multihost.combine_scratch(scratch, _specs(jax_build_specs), 10)
    lazy = multihost.combine_scratch(scratch, specs, 10, lazy=True)
    for group, props in r.results.items():
        for key, arr in props.items():
            for got in (ours[group][key], theirs[group][key], lazy[group][key]):
                assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes(), key
    with h5py.File(chunks.scratch_path(scratch, 0), "r") as f:
        assert f.attrs["soap_tpu_version"].decode().startswith("soap_tpu_torch ")
    # a directory mixing the two packages' scratch files is refused by both
    with h5py.File(chunks.scratch_path(scratch, 1), "r") as f:
        rows = f["rows"][...]
    part = {g: {k: v[rows] for k, v in props.items()} for g, props in r.results.items()}
    jax_write_scratch(chunks.scratch_path(scratch, 1), _specs(jax_build_specs), rows, part)
    for combine in (multihost.combine_scratch, jax_multihost.combine_scratch):
        with pytest.raises(RuntimeError, match="different soap_tpu versions"):
            combine(scratch, specs, 10)


@pytest.mark.parametrize("K", [128, 1000, 57344])
def test_sums_do_not_depend_on_bucket_capacity(K):
    """A halo's prefix and particle sums are the same whatever the
    padded capacity of the bucket it lands in (its chunk's tiling), and
    the prefix sum is ``torch.cumsum``'s on the CPU bit for bit."""
    from soap_tpu_torch.ops.reductions import particle_sum, prefix_sum

    x = torch.from_numpy(np.random.default_rng(K).lognormal(0, 2, (5, K)).astype(np.float32))
    wide = torch.nn.functional.pad(x, (0, 3 * K + 128))
    assert torch.equal(prefix_sum(x), torch.cumsum(x, 1))
    assert torch.equal(prefix_sum(wide)[:, :K], prefix_sum(x))
    assert torch.equal(particle_sum(wide), particle_sum(x))
    exact = x.double().sum(1).float()
    assert torch.equal(particle_sum(x), exact)
