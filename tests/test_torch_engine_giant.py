"""The port's engine on giant-halo tiles (B = 1) against the JAX engine.

The engines' row budget ``TARGET_ROWS`` is lowered in both modules so
that every halo of a small mock is a giant halo: the tile plan drops its
8-halo floor and gives each halo a bucket of its own, the regime in
which the inertia-loop kernel runs one cluster of CTAs per halo on the
card.  Same staging, gather layout (``SOAP_TPU_DMA_GATHER=1``) as
``tests/test_torch_engine_slice.py``; keys compare at
``soap_tpu_torch/utils/parity.py``'s tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import soap_tpu.pipeline.engine as jax_engine
import soap_tpu_torch.pipeline.engine as torch_engine
from soap_tpu.models.context import HaloContext as JaxContext
from soap_tpu.pipeline.chunk_data import ChunkData as JaxChunk, stage_ptype
from soap_tpu.pipeline.engine import HaloTypeSpec as JaxSpec
from soap_tpu.utils import mock_data
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.pipeline.chunk_data import chunk_from_numpy
from soap_tpu_torch.pipeline.specs import slice_specs
from soap_tpu_torch.utils.parity import key_close, scaled_error

#: every halo here has >= 512 candidate rows, so 8 x its row cap reaches
#: the budget and its tile is a giant-halo tile
TARGET_ROWS = 4096
KEYS = [(s.group, k) for s in slice_specs() for k in s.keys]


@pytest.fixture(scope="module")
def runs():
    G = mock_data.G_INTERNAL
    uni = mock_data.build_mock_universe(
        n_halos=3, n_field=5000, boxsize=30.0, seed=4242, mass_range=(300.0, 600.0)
    )
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
    args = dict(
        centres=uni.halo_pos,
        search_radius_phys=uni.halo_renclose * uni.a * 1.01,
        index=np.arange(H, dtype=np.int64),
        is_central=np.ones(H, dtype=bool),
        fof_id=np.arange(1, H + 1, dtype=np.int64),
    )
    specs = slice_specs()
    jspecs = [JaxSpec(**dataclasses.asdict(s)) for s in specs]
    tile_B = []
    bucket = torch_engine._process_bucket

    def recording_bucket(ctx, specs_, cubes, S, chunk, centre_hi, *rest):
        tile_B.append(centre_hi.shape[0])
        return bucket(ctx, specs_, cubes, S, chunk, centre_hi, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAP_TPU_DMA_GATHER", "1")
        mp.setattr(jax_engine, "TARGET_ROWS", TARGET_ROWS)
        mp.setattr(torch_engine, "TARGET_ROWS", TARGET_ROWS)
        mp.setattr(torch_engine, "_process_bucket", recording_bucket)
        jeng = jax_engine.HaloEngine(JaxContext(**ctx_kw), jchunk, jspecs)
        ref = jeng.process(**args)
        teng = torch_engine.HaloEngine(
            HaloContext(**ctx_kw), chunk_from_numpy(jchunk, torch.device("cpu")),
            specs, torch.device("cpu"),
        )
        got = teng.process(**args)
    return dict(ref=ref, got=got, jstats=jeng.stats, tstats=teng.stats,
                tile_B=tile_B, uni=uni)


def test_every_tile_is_one_giant_halo(runs):
    assert runs["tile_B"] and set(runs["tile_B"]) == {1}
    j, t = runs["jstats"], runs["tstats"]
    assert t.n_bucket_calls == len(runs["tile_B"]) >= runs["uni"].n_halos
    assert (t.n_bucket_calls, t.n_retries) == (j.n_bucket_calls, j.n_retries)
    ndm = runs["got"]["BoundSubhalo"]["Ndm"]
    np.testing.assert_array_equal(ndm, [len(ids) for ids in runs["uni"].bound_ids])


@pytest.mark.parametrize("group,key", KEYS, ids=[f"{g}/{k}" for g, k in KEYS])
def test_giant_tile_key_matches_jax(runs, group, key):
    a = np.asarray(runs["ref"][group][key], np.float64)
    b = np.asarray(runs["got"][group][key], np.float64)
    assert a.shape == b.shape
    assert np.isfinite(b).all()
    assert key_close(a, b, key), f"{group}/{key}: scaled error {scaled_error(a, b):.3e}"
