"""The halo function on toy buffers, and a dry run over several devices.

The port's counterpart of the root ``__graft_entry__.py``:

- ``entry(device)`` gives the bucket's halo function
  (``pipeline/engine.py::_halo_fn``: one radius sort, then the property
  DAG of every spec) over ``_dmo_specs()``'s six calculations, with
  example gathered buffers of 8 halos x 256 rows built from seed 0
  (``toy_inputs``);
- ``dryrun_multichip(devices)`` runs the production paths over a device
  list (a device may repeat): ``build_catalogue`` on a DMO mock
  at two Peano chunks with the default list and on a hydro mock at one,
  then ``ShardedHaloEngine`` with two chunk groups and a satellite,
  and prints the same small workload's seconds on one device, on a
  one-device grid and on the whole list.

Run ``python -m soap_tpu_torch.graft_entry`` on a GPU machine for both (the
dry run over every local GPU).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from soap_tpu_torch.core.halo_types import implemented_keys_for
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.models.halo_slice import HaloParticles, HaloScalars
from soap_tpu_torch.pipeline.engine import HaloEngine, HaloTypeSpec, _halo_fn


def toy_inputs(device, B: int = 8, K: int = 256, seed: int = 0):
    """(HaloParticles, HaloScalars) of B halos x K gathered rows on
    ``device``, drawn from ``seed`` in the JAX entry's order, so that
    its ``_toy_inputs`` gives the same arrays (invalid rows keep their
    random payloads there too)."""
    rng = np.random.default_rng(seed)
    shape = (B, K)

    def f(*extra):
        return rng.normal(size=shape + extra).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    pos = f(3) * 0.3
    valid = rng.uniform(size=shape) < 0.9
    index = np.arange(B, dtype=np.int64)
    groupnr = np.where(rng.uniform(size=shape) < 0.7, index[:, None], -1)
    mass = np.abs(f()) * 0.1
    vel = f(3) * 100.0
    parts = HaloParticles(
        valid=t(valid), mass=t(mass), pos=t(pos), vel=t(vel), groupnr=t(groupnr),
        fofid=t(np.ones(shape, np.int64)), softening=t(np.full(shape, 0.01, np.float32)),
        fields={},
    )
    scalars = HaloScalars(
        index=t(index), centre=t(np.zeros((B, 3), np.float32)),
        search_radius=t(np.full(B, 2.0, np.float32)), is_central=t(np.ones(B, bool)),
        fof_id=t(np.ones(B, np.int64)),
    )
    return parts, scalars


def _dmo_specs():
    """All four spec kinds, with same-family pairs, so that the family
    lanes are part of the step."""
    ap_keys = implemented_keys_for("Aperture", True)
    so_keys = implemented_keys_for("SO", True)
    return (
        HaloTypeSpec(kind="bound", group="BoundSubhalo",
                     keys=implemented_keys_for("BoundSubhalo", True)),
        HaloTypeSpec(kind="SO", group="SO/200_crit", keys=so_keys, so_type="crit",
                     so_multiple=200.0, centrals_only=True),
        HaloTypeSpec(kind="SO", group="SO/500_crit", keys=so_keys, so_type="crit",
                     so_multiple=500.0, centrals_only=True),
        HaloTypeSpec(kind="aperture", group="ExclusiveSphere/50kpc", keys=ap_keys,
                     aperture_radius_mpc=0.05),
        HaloTypeSpec(kind="aperture", group="ExclusiveSphere/100kpc", keys=ap_keys,
                     aperture_radius_mpc=0.1),
        HaloTypeSpec(kind="projected", group="ProjectedAperture/100kpc/projz",
                     keys=implemented_keys_for("ProjectedAperture", True),
                     aperture_radius_mpc=0.1, axis=2),
    )


def entry(device="cuda"):
    """(halo function, (parts, scalars)): the function maps a bucket's
    gathered buffers to ``{group: {key: (B, ...) tensor}}``."""
    ctx = HaloContext(
        a=1.0, z=0.0, G=43.0, boxsize=100.0, critical_density=12.87, mean_density=3.94,
        softening=(0.01,), ptypes=("PartType1",), capacities=(256,), dmo=True,
    )
    return _halo_fn(ctx, _dmo_specs()), toy_inputs(device, B=8, K=256)


def _sync(devices):
    for d in {str(d): d for d in devices if d.type == "cuda"}.values():
        torch.cuda.synchronize(d)


def dryrun_multichip(devices) -> dict:
    """The production paths over ``devices`` (a list, or anything
    ``local_devices`` takes): prints two lines and returns their
    numbers.  Raises where a check fails."""
    from soap_tpu_torch.parallel.sharded import ShardedHaloEngine, device_grid, local_devices
    from soap_tpu_torch.pipeline.chunk_data import ChunkData, stage_ptype
    from soap_tpu_torch.pipeline.chunks import mock_fields
    from soap_tpu_torch.pipeline.run import (
        age_table, build_catalogue, entry_plan, mock_catalogue, mock_metadata,
    )
    from soap_tpu_torch.pipeline.specs import build_specs
    from soap_tpu_torch.utils import mock_data

    devices = local_devices(devices)
    n_devices = len(devices)

    def entry_run(uni, dmo, nr_chunks):
        meta = mock_metadata(uni)
        ptypes, specs = entry_plan(meta, dmo)
        host = mock_fields(uni, specs, meta, ptypes, age_table(meta))
        return build_catalogue(meta, mock_catalogue(uni), host, specs, dmo=dmo,
                               device=devices, nr_chunks=nr_chunks)

    # ---- the production entry over the list: the default DMO list at
    # two Peano chunks, then the default hydro list
    run = entry_run(mock_data.build_mock_universe(
        n_halos=8, n_field=4000, boxsize=18.0, seed=42), True, 2)
    so_mass = np.asarray(run.results["SO/200_crit"]["Mtot"], np.float64)
    if not (np.isfinite(so_mass).all() and (so_mass > 0).any()):
        raise AssertionError("dry run: SO/200_crit masses not finite and positive")
    if not float(np.sum(run.results["BoundSubhalo"]["Mtot"])) > 0.0:
        raise AssertionError("dry run: no bound mass")
    n_groups = len(run.results)
    if n_groups < 38:
        raise AssertionError(f"dry run: {n_groups} groups, not the default list's 38")
    hrun = entry_run(mock_data.build_mock_universe(
        n_halos=6, n_field=3000, boxsize=18.0, seed=43, hydro=True), False, 1)
    gas = np.asarray(hrun.results["ExclusiveSphere/100kpc"]["Mgas"], np.float64)
    if not (np.isfinite(gas).all() and (gas >= 0).all()):
        raise AssertionError("dry run: hydro gas masses not finite and >= 0")

    # ---- two chunk groups at once (one when the list is odd), the
    # default list, a satellite in the first chunk
    n_chunks = 2 if n_devices % 2 == 0 else 1
    G = mock_data.G_INTERNAL
    uni = mock_data.build_mock_universe(
        n_halos=4 * n_chunks, n_field=4000, boxsize=40.0, seed=42, mass_range=(3.2, 30.0))
    groupnr = np.full(len(uni.ids), -1, dtype=np.int64)
    id_to_row = np.empty(int(uni.ids.max()) + 1, dtype=np.int64)
    id_to_row[uni.ids] = np.arange(len(uni.ids))
    for hi, ids in enumerate(uni.bound_ids):
        groupnr[id_to_row[ids]] = hi
    fields = {"Masses": uni.mass.astype(np.float32), "Velocities": uni.vel.astype(np.float32),
              "GroupNr_bound": groupnr, "FOFGroupIDs": uni.fof_ids}
    grid = device_grid(devices, n_chunks)
    chunks = [ChunkData(boxsize=uni.boxsize, ptypes={  # on each group's first device
        "PartType1": stage_ptype(uni.pos, fields, uni.boxsize, group[0], resolution=8)})
        for group in grid]
    rho_crit0 = 3.0 * (100.0 * uni.h) ** 2 / (8.0 * np.pi * G)
    E2 = uni.omega_m / uni.a**3 + uni.omega_lambda
    ctx = HaloContext(
        a=uni.a, z=0.0, G=G, boxsize=uni.boxsize, critical_density=rho_crit0 * E2,
        mean_density=rho_crit0 * uni.omega_m / uni.a**3, softening=(0.01,),
        ptypes=("PartType1",), capacities=(0,), dmo=True,
    )
    x = uni.omega_m / E2 - 1.0
    specs = tuple(build_specs(None, True, 18.0 * np.pi**2 + 82.0 * x - 39.0 * x * x))
    parts = np.array_split(np.arange(uni.n_halos), n_chunks)
    is_central = [np.ones(len(p), bool) for p in parts]
    is_central[0][1] = False
    engine = ShardedHaloEngine(ctx, chunks, specs, grid)
    results = engine.process(
        centres=[uni.halo_pos[p] for p in parts],
        search_radius_phys=[uni.halo_renclose[p] * uni.a * 1.01 for p in parts],
        index=[p.astype(np.int64) for p in parts],
        is_central=is_central,
        fof_id=[p.astype(np.int64) + 1 for p in parts],
        enclose_radius_phys=[uni.halo_renclose[p] * uni.a for p in parts],
    )
    if len(results) != n_chunks or not all(
            np.isfinite(np.asarray(r["SO/200_crit"]["Mtot"], np.float64)).all() for r in results):
        raise AssertionError("dry run: a chunk group's SO/200_crit masses are not finite")
    if float(results[0]["SO/200_crit"]["Mtot"][1]) != 0.0:
        raise AssertionError("dry run: the satellite has an SO mass")
    if not sum(float(np.sum(r["BoundSubhalo"]["Mtot"])) for r in results) > 0.0:
        raise AssertionError("dry run: no bound mass in the chunk groups")
    stats = engine.stats

    # ---- the same small workload on one device, on a one-device grid
    # and on the whole list: the second process() call of each
    small = tuple(s for s in specs if s.group in ("BoundSubhalo", "SO/200_crit"))
    order = np.arange(uni.n_halos)
    one = dict(
        centres=uni.halo_pos[order], search_radius_phys=uni.halo_renclose[order] * uni.a * 1.01,
        index=order.astype(np.int64), is_central=np.ones(len(order), bool),
        fof_id=order.astype(np.int64) + 1, enclose_radius_phys=uni.halo_renclose[order] * uni.a,
    )
    lists = {k: [v] for k, v in one.items()}

    def timed(process, kw):
        process(**kw)
        _sync(devices)
        t0 = time.perf_counter()
        process(**kw)
        _sync(devices)
        return time.perf_counter() - t0

    t_one = timed(HaloEngine(ctx, chunks[0], small, devices[0]).process, one)
    t_grid1 = timed(ShardedHaloEngine(ctx, chunks[:1], small, [devices[:1]]).process, lists)
    t_gridn = timed(ShardedHaloEngine(ctx, chunks[:1], small, [devices]).process, lists)
    names = ", ".join(str(d) for d in devices)
    print(f"dryrun_multichip OK: {n_devices} devices ({names}); build_catalogue at 2 Peano "
          f"chunks ({n_groups} DMO groups) and at 1 ({len(hrun.results)} hydro groups) over the "
          f"list; {n_chunks} chunk groups with {len(specs)} calculations, {stats.halos_done} "
          f"halos in {stats.n_bucket_calls} tiles, shares by worker "
          f"{dict(sorted(stats.shares_by_worker.items()))}", flush=True)
    print(f"sharded-engine overhead (same workload, warm, {devices[0].type}): one device "
          f"{t_one * 1e3:.1f} ms, one-device grid {t_grid1 * 1e3:.1f} ms "
          f"({100 * (t_grid1 / t_one - 1):+.0f}%), {n_devices}-device grid "
          f"{t_gridn * 1e3:.1f} ms ({100 * (t_gridn / t_one - 1):+.0f}%)", flush=True)
    return dict(devices=[str(d) for d in devices], n_groups=n_groups,
                n_hydro_groups=len(hrun.results), n_chunks=n_chunks, stats=stats,
                seconds={"one_device": t_one, "one_device_grid": t_grid1,
                         "device_grid": t_gridn})


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", sorted(out))
    dryrun_multichip([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
