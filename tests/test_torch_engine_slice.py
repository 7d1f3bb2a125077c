"""The port's engine slice end to end on the CPU against the JAX engine.

Both engines process the same staged store (the JAX package's host
staging, handed to the port through ``chunk_from_numpy``) with the
slice spec set.  The JAX engine runs with ``SOAP_TPU_DMA_GATHER=1`` so
both gather into the same range layout.  Every fourth halo is marked a
satellite, so the central/satellite split runs, and every third halo's
input search radius is shrunk so far that the SO presize cannot reach
its threshold: those halos go round the x1.5 retry ladder.
"""

import dataclasses

import numpy as np
import pytest
import torch

from soap_tpu.models.context import HaloContext as JaxContext
from soap_tpu.pipeline.chunk_data import ChunkData as JaxChunk, stage_ptype
from soap_tpu.pipeline.engine import HaloEngine as JaxEngine
from soap_tpu.pipeline.engine import HaloTypeSpec as JaxSpec
from soap_tpu.utils import mock_data
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.pipeline import chunk_data as tcd
from soap_tpu_torch.pipeline.chunk_data import chunk_from_numpy
from soap_tpu_torch.pipeline.engine import HaloEngine, HaloTypeSpec
from soap_tpu_torch.pipeline.specs import slice_specs

#: keys compared at rtol 1e-5; the rest sum in different orders with
#: cancellation (com, vcom, inertia tensors): rtol 1e-3, atol 1e-4 max|ref|
TIGHT = ("r", "Mtot", "HalfMassRadiusTot")
KEYS = [(s.group, k) for s in slice_specs() for k in s.keys]


@pytest.fixture(scope="module")
def runs():
    G = mock_data.G_INTERNAL
    uni = mock_data.build_mock_universe(n_halos=12, n_field=8000, boxsize=25.0, seed=11)
    groupnr = np.full(len(uni.ids), -1, dtype=np.int64)
    id_to_row = np.empty(int(uni.ids.max()) + 1, dtype=np.int64)
    id_to_row[uni.ids] = np.arange(len(uni.ids))
    for hi, ids in enumerate(uni.bound_ids):
        groupnr[id_to_row[ids]] = hi
    fields = {
        "Masses": uni.mass.astype(np.float32),
        "Velocities": uni.vel.astype(np.float32),
        "GroupNr_bound": groupnr,
        "FOFGroupIDs": uni.fof_ids,
    }
    jchunk = JaxChunk(
        boxsize=uni.boxsize,
        ptypes={"PartType1": stage_ptype(uni.pos, fields, uni.boxsize)},
    )
    rho_crit0 = 3.0 * (100.0 * uni.h) ** 2 / (8.0 * np.pi * G)
    E2 = uni.omega_m / uni.a**3 + uni.omega_lambda
    ctx_kw = dict(
        a=uni.a, z=1.0 / uni.a - 1.0, G=G, boxsize=uni.boxsize,
        critical_density=rho_crit0 * E2,
        mean_density=rho_crit0 * uni.omega_m / uni.a**3,
        softening=(0.01,), ptypes=("PartType1",), capacities=(0,), dmo=True,
    )
    H = uni.n_halos
    shrink = np.where(np.arange(H) % 3 == 0, 0.002, 1.0)
    args = dict(
        centres=uni.halo_pos,
        search_radius_phys=uni.halo_renclose * uni.a * 1.01 * shrink,
        index=np.arange(H, dtype=np.int64),
        is_central=np.arange(H) % 4 != 0,
        fof_id=np.arange(1, H + 1, dtype=np.int64),
    )
    specs = slice_specs()
    jspecs = [JaxSpec(**dataclasses.asdict(s)) for s in specs]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAP_TPU_DMA_GATHER", "1")
        jeng = JaxEngine(JaxContext(**ctx_kw), jchunk, jspecs)
        assert jeng._dma_s == 64
        ref = jeng.process(**args)
    teng = HaloEngine(
        HaloContext(**ctx_kw), chunk_from_numpy(jchunk, torch.device("cpu")),
        specs, torch.device("cpu"),
    )
    got = teng.process(**args)
    return dict(ref=ref, got=got, jstats=jeng.stats, tstats=teng.stats,
                ctx_kw=ctx_kw, jchunk=jchunk, args=args)


def test_bucket_calls_and_retries_match(runs):
    j, t = runs["jstats"], runs["tstats"]
    assert t.n_retries > 0  # the retry ladder ran
    assert (t.n_bucket_calls, t.n_retries) == (j.n_bucket_calls, j.n_retries)
    assert t.compute_seconds > 0


@pytest.mark.parametrize("group,key", KEYS, ids=[f"{g}/{k}" for g, k in KEYS])
def test_slice_key_matches_jax(runs, group, key):
    a = np.asarray(runs["ref"][group][key], np.float64)
    b = np.asarray(runs["got"][group][key], np.float64)
    assert a.shape == b.shape
    assert np.isfinite(b).all()
    if key == "Ndm":
        np.testing.assert_array_equal(b, a)
    elif key in TIGHT:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=0.0)
    else:
        scale = np.abs(a).max() if a.size else 1.0
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4 * max(scale, 1e-30))


def test_satellites_get_no_so_values(runs):
    sat = ~runs["args"]["is_central"]
    so = runs["got"]["SO/200_crit"]
    assert (so["r"][sat] == 0).all() and (so["r"][~sat] > 0).all()
    assert (runs["got"]["BoundSubhalo"]["Mtot"] > 0).all()


def test_unported_keys_and_specs_raise(runs):
    ctx = HaloContext(**runs["ctx_kw"])
    chunk = chunk_from_numpy(runs["jchunk"], torch.device("cpu"))
    # a key the bound subhalo's slice has no method for (an SO key)
    bad_key = [HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "DopplerB"))]
    with pytest.raises(NotImplementedError, match="DopplerB"):
        HaloEngine(ctx, chunk, bad_key, "cpu").process(**runs["args"])
    # neutrinos with delta-f weights
    pt = chunk.ptypes["PartType1"]
    nu = tcd.stage_ptype(
        np.random.default_rng(3).uniform(0, 25.0, (500, 3)),
        {"Masses": np.full(500, 0.01, np.float32),
         "Velocities": np.zeros((500, 3), np.float32),
         "Weights": np.ones(500, np.float32)},
        25.0, torch.device("cpu"), resolution=pt.spec.dims[0],
    )
    nu_ctx = dataclasses.replace(ctx, ptypes=("PartType1", "PartType6"), softening=(0.01, 0.01))
    nu_chunk = tcd.ChunkData(boxsize=25.0, ptypes={"PartType1": pt, "PartType6": nu})
    with pytest.raises(NotImplementedError, match="PartType6"):
        HaloEngine(nu_ctx, nu_chunk, slice_specs(), "cpu").process(**runs["args"])
    # core-excised SOs run since parameter files were ported; an SO type
    # the engine has no definition for, and an aperture with both a
    # fixed radius and a radius property, are refused
    core_excised = [HaloTypeSpec(kind="SO", group="SO/500_crit_ce", keys=("Mtot",),
                                 so_type="crit", so_multiple=500.0,
                                 core_excision_fraction=0.15, centrals_only=True)]
    HaloEngine(ctx, chunk, core_excised, "cpu")
    unknown = [dataclasses.replace(core_excised[0], group="SO/odd", so_type="odd")]
    with pytest.raises(NotImplementedError, match="SO/odd"):
        HaloEngine(ctx, chunk, unknown, "cpu")
    both = [HaloTypeSpec(kind="aperture", group="ExclusiveSphere/both", keys=("Mtot",),
                         aperture_radius_mpc=0.05,
                         radius_property=("BoundSubhalo", "HalfMassRadiusTot", 2.0))]
    with pytest.raises(NotImplementedError, match="ExclusiveSphere/both"):
        HaloEngine(ctx, chunk, both, "cpu")
