"""Halo batches across several devices: ``soap_tpu_torch/parallel/sharded.py``.

On the CPU a device list of repeated ``"cpu"`` entries runs one worker
thread per entry, so everything but the device guard runs here:

- the port's ``ShardedHaloEngine`` on ``device_grid(["cpu"] * 4, 2)``
  against the JAX ``ShardedHaloEngine`` on ``make_mesh(8, 2)`` over
  conftest's virtual devices (``tests/test_sharded.py``'s universe: seed
  3, 10 halos, two chunks, BoundSubhalo and SO/200_crit, a satellite in
  chunk 0), at ``utils/parity.py::key_close`` with counts exact;
- the split against the one-device engine, bit for bit, on the card
  check's DMO mock (``chip_smoke.py`` phase 5: 64 halos and 2
  satellites, EncloseRadius understated x0.3, so retries, copies,
  truncation and both passes run) with the full default DMO list over
  three workers (an uneven split), and the engine's counters: its plan
  counters equal the one-device run's, and each worker's launch counts
  add up to every launch made;
- the partition (``tile_shares``), the launch counters under contention,
  ``local_devices``, ``device_grid`` and the command line's
  ``--device``;
- ``build_catalogue`` over ``["cpu", "cpu"]`` at 1 and 2 chunks, with
  halo and property timings, against one device.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from soap_tpu.core.halo_types import implemented_keys_for as jax_keys_for
from soap_tpu.models.context import HaloContext as JaxContext
from soap_tpu.parallel.sharded import ShardedHaloEngine as JaxShardedEngine, make_mesh
from soap_tpu.pipeline.chunk_data import ChunkData as JaxChunk, stage_ptype as jax_stage
from soap_tpu.pipeline.engine import HaloTypeSpec as JaxSpec
from soap_tpu.utils import mock_data as jax_mock
from soap_tpu_torch import cli
from soap_tpu_torch.core.halo_types import implemented_keys_for
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.ops import inertia as inertia_ops
from soap_tpu_torch.ops import inertia_loop as il
from soap_tpu_torch.ops import range_gather as rg
from soap_tpu_torch.parallel.sharded import (
    ShardedHaloEngine, device_grid, local_devices, replicate,
)
from soap_tpu_torch.pipeline.chunk_data import ChunkData, chunk_from_numpy, stage_ptype
from soap_tpu_torch.pipeline.chunks import mock_fields
from soap_tpu_torch.pipeline.engine import HaloEngine, HaloTypeSpec, tile_shares
from soap_tpu_torch.pipeline.run import (
    age_table, build_catalogue, entry_plan, mock_catalogue, mock_metadata,
)
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.mock_data import G_INTERNAL, build_mock_universe
from soap_tpu_torch.utils.parity import catalogue_differences, key_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker: the default pool oversubscribes the
    cores beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- JAX twin

def _sharded_specs(spec_cls, keys_for):
    return (
        spec_cls(kind="bound", group="BoundSubhalo", keys=keys_for("BoundSubhalo", True)),
        spec_cls(kind="SO", group="SO/200_crit", keys=keys_for("SO", True), so_type="crit",
                 so_multiple=200.0, centrals_only=True),
    )


SHARDED_SPECS = _sharded_specs(HaloTypeSpec, implemented_keys_for)
SHARDED_KEYS = [(s.group, k) for s in SHARDED_SPECS for k in s.keys]


@pytest.fixture(scope="module")
def sharded_runs():
    """``tests/test_sharded.py``'s universe and chunk (seed 3, 10 halos,
    one store for both chunks), its halves as two chunks with halo 0 of
    chunk 0 a satellite, through the JAX engine on the (2, 4) mesh of
    the virtual devices (one call) and the port's on a (2, 2) grid of
    CPU workers."""
    uni = jax_mock.build_mock_universe(n_halos=10, n_field=6000, boxsize=40.0, seed=3,
                                       mass_range=(3.2, 60.0))
    groupnr = np.full(len(uni.ids), -1, dtype=np.int64)
    id_to_row = np.empty(uni.ids.max() + 1, dtype=np.int64)
    id_to_row[uni.ids] = np.arange(len(uni.ids))
    for hi, ids in enumerate(uni.bound_ids):
        groupnr[id_to_row[ids]] = hi
    fields = {"Masses": uni.mass.astype(np.float32), "Velocities": uni.vel.astype(np.float32),
              "GroupNr_bound": groupnr, "FOFGroupIDs": uni.fof_ids}
    jchunk = JaxChunk(boxsize=uni.boxsize, ptypes={
        "PartType1": jax_stage(uni.pos, fields, uni.boxsize, resolution=8)})
    G = jax_mock.G_INTERNAL
    rho_crit0 = 3.0 * (100.0 * uni.h) ** 2 / (8.0 * np.pi * G)
    E2 = uni.omega_m / uni.a**3 + uni.omega_lambda
    ctx_kw = dict(a=uni.a, z=0.0, G=G, boxsize=uni.boxsize, critical_density=rho_crit0 * E2,
                  mean_density=rho_crit0 * uni.omega_m / uni.a**3, softening=(0.01,),
                  ptypes=("PartType1",), capacities=(0,), dmo=True)
    order = np.arange(uni.n_halos)
    parts = [order[: uni.n_halos // 2], order[uni.n_halos // 2 :]]
    is_central = [np.ones(len(p), bool) for p in parts]
    is_central[0][0] = False
    args = dict(
        centres=[uni.halo_pos[p] for p in parts],
        search_radius_phys=[uni.halo_renclose[p] * uni.a * 1.01 for p in parts],
        index=[p.astype(np.int64) for p in parts],
        is_central=is_central,
        fof_id=[p.astype(np.int64) + 1 for p in parts],
    )
    jeng = JaxShardedEngine(JaxContext(**ctx_kw), [jchunk, jchunk],
                            _sharded_specs(JaxSpec, jax_keys_for), make_mesh(8, 2))
    ref = jeng.process(**args)
    chunk = chunk_from_numpy(jchunk, torch.device("cpu"))
    eng = ShardedHaloEngine(HaloContext(**ctx_kw), [chunk, chunk], SHARDED_SPECS,
                            device_grid(["cpu"] * 4, 2))
    got = eng.process(**args)
    return dict(ref=ref, got=got, stats=eng.stats, sizes=[len(p) for p in parts])


@pytest.mark.parametrize("group,key", SHARDED_KEYS, ids=[f"{g}/{k}" for g, k in SHARDED_KEYS])
def test_sharded_engine_matches_jax(sharded_runs, group, key):
    for c, size in enumerate(sharded_runs["sizes"]):
        a = np.asarray(sharded_runs["ref"][c][group][key])
        b = sharded_runs["got"][c][group][key]
        assert b.shape == a.shape and b.shape[0] == size, (c, group, key)
        assert key_close(a, b, key), f"{group}/{key} (chunk {c})"


def test_sharded_engine_satellite_and_groups(sharded_runs):
    """The satellite runs no SO (its SO/200_crit is zero) but has bound
    mass; each chunk ran on its own group of two workers."""
    res = sharded_runs["got"]
    assert float(res[0]["SO/200_crit"]["Mtot"][0]) == 0.0
    assert float(res[0]["BoundSubhalo"]["Mtot"][0]) > 0.0
    assert float(np.asarray(sharded_runs["ref"][0]["SO/200_crit"]["Mtot"][0])) == 0.0
    stats = sharded_runs["stats"]
    assert stats.halos_done == sum(sharded_runs["sizes"])
    assert set(stats.shares_by_worker) == {"0@cpu", "1@cpu"}


# ------------------------------------------------------- the split, bit for bit

#: ``chip_smoke.py``'s phase 5 mock (ENGINE_MOCK)
ENGINE_MOCK = dict(n_halos=64, n_field=20000, boxsize=40.0, seed=11, particle_mass=2.0,
                   mass_range=(300.0, 30000.0), n_satellites=2)
DMO_SPECS = build_specs(None, True, 100.0)
DMO_KEYS = [(s.group, k) for s in DMO_SPECS for k in s.keys]
SPLIT_WORKERS = ["cpu"] * 3


def _phase5_inputs():
    """Phase 5's inputs: the mock staged on the CPU, every fourth halo
    and the two subhalos satellites, every third input radius shrunk
    x0.002, EncloseRadius understated x0.3."""
    uni = build_mock_universe(**ENGINE_MOCK)
    groupnr = np.full(len(uni.ids), -1, dtype=np.int64)
    id_to_row = np.empty(int(uni.ids.max()) + 1, dtype=np.int64)
    id_to_row[uni.ids] = np.arange(len(uni.ids))
    for hi, ids in enumerate(uni.bound_ids):
        groupnr[id_to_row[ids]] = hi
    fields = {"Masses": uni.mass.astype(np.float32), "Velocities": uni.vel.astype(np.float32),
              "GroupNr_bound": groupnr, "FOFGroupIDs": uni.fof_ids}
    chunk = ChunkData(boxsize=uni.boxsize, ptypes={
        "PartType1": stage_ptype(uni.pos, fields, uni.boxsize, torch.device("cpu"))})
    rho_crit0 = 3.0 * (100.0 * uni.h) ** 2 / (8.0 * np.pi * G_INTERNAL)
    E2 = uni.omega_m / uni.a**3 + uni.omega_lambda
    ctx = HaloContext(a=uni.a, z=1.0 / uni.a - 1.0, G=G_INTERNAL, boxsize=uni.boxsize,
                      critical_density=rho_crit0 * E2,
                      mean_density=rho_crit0 * uni.omega_m / uni.a**3, softening=(0.01,),
                      ptypes=("PartType1",), capacities=(0,), dmo=True)
    H = uni.n_halos
    args = dict(
        centres=uni.halo_pos,
        search_radius_phys=uni.halo_renclose * uni.a * 1.01 * np.where(
            np.arange(H) % 3 == 0, 0.002, 1.0),
        index=np.arange(H, dtype=np.int64),
        is_central=(np.arange(H) % 4 != 0) & (np.asarray(uni.halo_rank) == 0),
        fof_id=np.arange(1, H + 1, dtype=np.int64),
        enclose_radius_phys=uni.halo_renclose * uni.a * 0.3,
    )
    return ctx, chunk, args


def _launching(fn, module, *count_args):
    """``fn`` counted as the CUDA wrapper counts a launch, so that the
    CPU's plain versions exercise the counters."""
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        module._count_launch(*count_args)
        return out
    return wrapped


@pytest.fixture(scope="module")
def split_runs():
    """Phase 5's run on one CPU worker and on three, each with every K1
    and K2 call counted as a launch, with the module totals each run
    made (the totals are restored afterwards)."""
    ctx, chunk, args = _phase5_inputs()
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rg, "range_gather_blocks", _launching(rg.range_gather_blocks, rg))
        mp.setattr(inertia_ops, "inertia_loop", _launching(inertia_ops.inertia_loop, il, 1))
        mp.setattr(il, "cluster_launches", {})
        for name, devices in (("one", "cpu"), ("split", SPLIT_WORKERS)):
            mp.setattr(rg, "launches", 0)
            mp.setattr(il, "launches", 0)
            engine = HaloEngine(ctx, chunk, DMO_SPECS, devices)
            res = engine.process(**args)
            runs[name] = dict(res=res, stats=engine.stats,
                              launches=(rg.launches, il.launches))
    return runs


@pytest.mark.parametrize("group,key", DMO_KEYS, ids=[f"{g}/{k}" for g, k in DMO_KEYS])
def test_split_is_bit_equal_to_one_device(split_runs, group, key):
    a = split_runs["one"]["res"][group][key]
    b = split_runs["split"]["res"][group][key]
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True) and a.tobytes() == b.tobytes(), f"{group}/{key}"


def _plan_counters(stats):
    return dict(bucket_calls=stats.n_bucket_calls, retries=stats.n_retries,
                overflow=stats.n_overflow, copied_specs=stats.n_copied_specs,
                truncated_tiles=stats.n_truncated_tiles, halos=stats.halos_done,
                by_pass=stats.bucket_calls_by_pass)


def test_split_counters(split_runs):
    """The plan's counters equal the one-device run's (every mechanism
    ran); the split ran tiles in several shares; each worker's K1 and K2
    counts, summed, are every launch made: one K1 per share and particle
    type."""
    one, split = split_runs["one"]["stats"], split_runs["split"]["stats"]
    assert _plan_counters(split) == _plan_counters(one)
    assert one.n_retries and one.n_copied_specs and one.n_truncated_tiles
    assert set(one.bucket_calls_by_pass) == {"narrow", "wide"}
    assert one.shares_by_worker == {"0@cpu": one.n_bucket_calls}
    n_shares = sum(split.shares_by_worker.values())
    assert set(split.shares_by_worker) == {"0@cpu", "1@cpu", "2@cpu"}
    assert n_shares > split.n_bucket_calls
    for run, stats, shares in (("one", one, one.n_bucket_calls), ("split", split, n_shares)):
        k1, k2 = split_runs[run]["launches"]
        assert stats.k1_launches_by_ptype == {"PartType1": shares} and k1 == shares
        assert sum(stats.k2_launches_by_group.values()) == k2 > 0
    assert set(split.k2_launches_by_group) == set(one.k2_launches_by_group)


def test_launch_counters_under_contention(monkeypatch):
    """Threads past the core count launching at once at a short switch
    interval: the totals lose no launch, and each thread's own count is
    its launches, by cluster size too (the totals are restored
    afterwards)."""
    n_threads, per_thread = 16, 2000
    monkeypatch.setattr(rg, "launches", 0)
    monkeypatch.setattr(il, "launches", 0)
    monkeypatch.setattr(il, "cluster_launches", {})
    mine = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        start = (rg.launches_here(), il.launches_here(), il.cluster_launches_here().get(7, 0))
        for _ in range(per_thread):
            rg._count_launch()
            il._count_launch(7)
        mine.append((rg.launches_here() - start[0], il.launches_here() - start[1],
                     il.cluster_launches_here()[7] - start[2]))

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    n = n_threads * per_thread
    assert (rg.launches, il.launches, il.cluster_launches) == (n, n, {7: n})
    assert mine == [(per_thread, per_thread, per_thread)] * n_threads


# --------------------------------------------------------------- partition

@pytest.mark.parametrize("n,workers,floor", [
    (1, 3, 8), (1, 2, 1), (2, 3, 1), (7, 3, 8), (64, 3, 8), (512, 3, 8), (513, 4, 8),
    (4096, 2, 8), (5, 1, 8), (3, 8, 1),
])
def test_tile_shares(n, workers, floor):
    shares = tile_shares(n, workers, floor)
    # every halo in exactly one share, in order, contiguous
    assert [lo for _, lo, _, _ in shares] == [0] + [hi for _, _, hi, _ in shares[:-1]]
    assert shares[-1][2] == n
    rows = np.concatenate([np.arange(lo, hi) for _, lo, hi, _ in shares])
    assert np.array_equal(rows, np.arange(n))
    # one worker each, sizes differing by at most one, no empty share
    assert [w for w, *_ in shares] == list(range(len(shares)))
    sizes = [hi - lo for _, lo, hi, _ in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert len(shares) == min(n, workers)
    # padded to a power of two at the tile's lane floor
    for size, (_, _, _, B) in zip(sizes, shares):
        assert B >= max(size, floor) and B & (B - 1) == 0 and (B == floor or B < 2 * size)
    if n == 1:
        assert shares == [(0, 0, 1, floor)]


def test_one_halo_tile_runs_on_one_worker():
    """A one-halo population on three workers: one share, on worker 0."""
    ctx, chunk, args = _phase5_inputs()
    one = {k: v[:1] for k, v in args.items()}
    specs = [s for s in DMO_SPECS if s.group == "BoundSubhalo"]
    engine = HaloEngine(ctx, chunk, specs, SPLIT_WORKERS)
    engine.process(**one)
    assert set(engine.stats.shares_by_worker) == {"0@cpu"}


# ------------------------------------------------- devices and the command line

def test_local_devices_and_grid():
    cuda = [torch.device("cuda", i) for i in range(4)]
    # one device, the current card included, is the one-device path
    assert local_devices("cuda") == [torch.device("cuda")]
    assert local_devices("cuda:2") == [torch.device("cuda", 2)]
    assert local_devices("cpu") == [torch.device("cpu")]
    assert local_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert local_devices(cuda) == cuda
    assert local_devices(torch.device("cpu")) == [torch.device("cpu")]
    with pytest.raises(ValueError):
        local_devices([])
    assert device_grid(cuda, 2) == [cuda[:2], cuda[2:]]
    assert device_grid(["cpu"] * 3, 1) == [[torch.device("cpu")] * 3]
    with pytest.raises(ValueError):
        device_grid(cuda, 3)


@pytest.mark.parametrize("flag,want,resolved", [
    (None, "cuda", ["cuda"]),
    ("cuda", "cuda", ["cuda"]),
    ("cuda:1", "cuda:1", ["cuda:1"]),
    ("cpu", "cpu", ["cpu"]),
    ("cuda:0,cuda:1", ["cuda:0", "cuda:1"], ["cuda:0", "cuda:1"]),
    ("cuda:0,cuda:0", ["cuda:0", "cuda:0"], ["cuda:0", "cuda:0"]),
    ("cpu,cpu,cpu", ["cpu"] * 3, ["cpu"] * 3),
])
def test_cli_device(flag, want, resolved):
    argv = ["halo-properties", "--snapshot", "s.hdf5", "--halo-basename", "h",
            "--output", "o.hdf5"] + ([] if flag is None else ["--device", flag])
    kw = cli.halo_properties_kwargs(cli.build_parser().parse_args(argv))
    assert kw["device"] == want
    assert local_devices(kw["device"]) == [torch.device(d) for d in resolved]


def test_replicate_shares_one_store_per_device():
    ctx, chunk, _ = _phase5_inputs()
    stores, events = replicate(chunk, ["cpu", "cpu", "cpu"])
    assert stores == [chunk] * 3 and events == [None] * 3


def test_engine_stores_per_worker():
    """One store is every worker's; a list needs one store per worker,
    each on its worker's device."""
    ctx, chunk, _ = _phase5_inputs()
    assert HaloEngine(ctx, chunk, [], ["cpu"] * 3).chunks == [chunk] * 3
    assert HaloEngine(ctx, [chunk, chunk], [], ["cpu", "cpu"]).chunks == [chunk] * 2
    with pytest.raises(ValueError, match="2 chunk stores for 3 workers"):
        HaloEngine(ctx, [chunk, chunk], [], ["cpu"] * 3)
    with pytest.raises(ValueError, match="worker on cuda:1"):
        HaloEngine(ctx, chunk, [], ["cpu", "cuda:1"])


# ------------------------------------------------------------------ the entry

def _entry(uni, device, **kw):
    meta = mock_metadata(uni)
    ptypes, specs = entry_plan(meta, True)
    host = mock_fields(uni, specs, meta, ptypes, age_table(meta))
    return build_catalogue(meta, mock_catalogue(uni), host, specs, device=device, **kw)


@pytest.fixture(scope="module")
def entry_universe():
    return build_mock_universe(n_halos=12, n_field=8000, boxsize=25.0, seed=11, n_satellites=2)


@pytest.mark.parametrize("nr_chunks,property_timings", [(1, False), (2, False), (2, True)])
def test_entry_over_two_workers(entry_universe, nr_chunks, property_timings):
    """``build_catalogue`` over two CPU workers equals the one-device
    catalogue (the timing datasets by name, dtype and shape)."""
    kw = dict(nr_chunks=nr_chunks, record_halo_timings=True,
              record_property_timings=property_timings)
    ref = _entry(entry_universe, "cpu", **kw)
    got = _entry(entry_universe, ["cpu", "cpu"], **kw)
    assert catalogue_differences(ref.catalogue, got.catalogue) == []
    assert np.array_equal(ref.order, got.order)
    assert len(got.chunks) == nr_chunks
    timing = {p for p in got.catalogue.datasets if p.endswith("_time") or "n_loop" in p}
    assert "InputHalos/process_time" in timing and "InputHalos/n_loop" in timing
    for path in timing:
        a, b = ref.catalogue.datasets[path].data, got.catalogue.datasets[path].data
        assert a.dtype == b.dtype and a.shape == b.shape, path
    assert np.array_equal(ref.catalogue.datasets["InputHalos/n_loop"].data,
                          got.catalogue.datasets["InputHalos/n_loop"].data)
    assert got.stats.n_bucket_calls == ref.stats.n_bucket_calls
    assert set(got.stats.shares_by_worker) == {"0@cpu", "1@cpu"}
    assert all(r.memory_after == {} and r.peak_memory == {} for r in got.chunks)
