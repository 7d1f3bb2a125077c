"""The port's engine on the full DMO production spec list against the JAX engine.

Both engines run ``build_specs(None, dmo=True, ...)`` (38 calculations,
508 keys) with ``enclose_radius_phys`` on one staged mock, the JAX one
with ``SOAP_TPU_DMA_GATHER=1`` so both gather into the same range layout.
So the central/satellite split, the wide/narrow pass split, spec
families, sorted-prefix truncation and the aperture copy all run.

The mock has two real satellite subhalos of its biggest halo (they and
every fourth halo are satellites) and coarse particles over a wide mass
range, so that a few halos reach past 1 Mpc.  Every third halo's input
search radius is shrunk x0.002; the engine floors it at the pass's
widest aperture.  The catalogue EncloseRadius handed to the comparison
run is understated x0.3 for every halo: the sorted-prefix truncation
then misses bound rows of the biggest halos, the bound-count
cross-check flags them and they go round the x1.5 retry ladder
untruncated.  Keys compare at ``soap_tpu_torch/utils/parity.py``'s
tolerances.  The port-only checks use the true EncloseRadius and
unshrunk search radii, as a production run has them.
"""

import numpy as np
import pytest
import torch

import soap_tpu_torch.pipeline.engine as torch_engine
from soap_tpu.models.context import HaloContext as JaxContext
from soap_tpu.pipeline.chunk_data import ChunkData as JaxChunk, stage_ptype
from soap_tpu.pipeline.engine import HaloEngine as JaxEngine
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu.utils import mock_data
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.pipeline.chunk_data import chunk_from_numpy
from soap_tpu_torch.pipeline.engine import HaloEngine
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.parity import key_close

BN98 = 100.0
SPECS = build_specs(None, True, BN98)
KEYS = [(s.group, k) for s in SPECS for k in s.keys]
def _differing(ref, got):
    return [(s.group, k) for s in SPECS for k in s.keys
            if not key_close(ref[s.group][k], got[s.group][k], k)]


def dmo_inputs(uni):
    """The JAX-staged dark-matter chunk of a mock universe (membership
    from its bound particle lists) and the context's keywords."""
    G = mock_data.G_INTERNAL
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
    return jchunk, ctx_kw


@pytest.fixture(scope="module")
def runs():
    uni = mock_data.build_mock_universe(
        n_halos=16, n_field=8000, boxsize=25.0, seed=11, particle_mass=2.0,
        mass_range=(300.0, 30000.0), n_satellites=2,
    )
    jchunk, ctx_kw = dmo_inputs(uni)
    H = len(uni.halo_renclose)
    shrink = np.where(np.arange(H) % 3 == 0, 0.002, 1.0)
    enclose = uni.halo_renclose * uni.a
    args = dict(
        centres=uni.halo_pos,
        search_radius_phys=enclose * 1.01 * shrink,
        index=np.arange(H, dtype=np.int64),
        is_central=(np.arange(H) % 4 != 0) & (np.asarray(uni.halo_rank) == 0),
        fof_id=np.arange(1, H + 1, dtype=np.int64),
    )
    jspecs = jax_build_specs(None, True, BN98)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAP_TPU_DMA_GATHER", "1")
        jeng = JaxEngine(JaxContext(**ctx_kw), jchunk, jspecs)
        ref = jeng.process(**args, enclose_radius_phys=enclose * 0.3)
    ctx = HaloContext(**ctx_kw)
    chunk = chunk_from_numpy(jchunk, torch.device("cpu"))

    def port(run_args, enclose_radius_phys):
        eng = HaloEngine(ctx, chunk, SPECS, torch.device("cpu"))
        return eng.process(**run_args, enclose_radius_phys=enclose_radius_phys), eng.stats

    got, tstats = port(args, enclose * 0.3)
    # the port-only checks on production inputs: a shrunk search radius
    # inside a satellite's EncloseRadius leaves bound rows ungathered in
    # the narrow pass (bound specs raise no flag), but not in one pass
    # floored at the widest aperture
    true_args = dict(args, search_radius_phys=enclose * 1.01)
    true_split, st_split = port(true_args, enclose)
    no_enclose, st_none = port(true_args, None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_engine, "WIDE_RADIUS_MPC", 0.0)
        one_pass, st_one = port(true_args, enclose)
    return dict(ref=ref, got=got, jstats=jeng.stats, tstats=tstats,
                true_split=true_split, st_split=st_split,
                no_enclose=no_enclose, st_none=st_none,
                one_pass=one_pass, st_one=st_one, H=H)


def test_counters_match_jax(runs):
    j, t = runs["jstats"], runs["tstats"]
    j_trunc = sum(1 for rec in j.bucket_records if rec[5])
    assert (t.n_bucket_calls, t.n_retries, t.n_copied_specs, t.n_truncated_tiles) == (
        j.n_bucket_calls, j.n_retries, j.n_copied_specs, j_trunc
    )
    # every mechanism ran: retry ladder, copy, truncation, both passes
    assert t.n_retries > 0 and t.n_copied_specs > 0 and t.n_truncated_tiles > 0
    assert set(t.bucket_calls_by_pass) == {"narrow", "wide"}
    assert sum(t.bucket_calls_by_pass.values()) == t.n_bucket_calls


@pytest.mark.parametrize("group,key", KEYS, ids=[f"{g}/{k}" for g, k in KEYS])
def test_full_key_matches_jax(runs, group, key):
    a = runs["ref"][group][key]
    b = runs["got"][group][key]
    assert b.shape == np.asarray(a).shape and b.shape[0] == runs["H"]
    assert key_close(a, b, key), f"{group}/{key}"


def test_enclose_radius_changes_no_value(runs):
    """Truncation and the aperture copy with a true EncloseRadius give
    what the run without it (neither runs) gives."""
    with_e, without = runs["st_split"], runs["st_none"]
    assert with_e.n_truncated_tiles > 0 and with_e.n_copied_specs > 0
    assert without.n_truncated_tiles == 0 and without.n_copied_specs == 0
    assert _differing(runs["no_enclose"], runs["true_split"]) == []


def test_wide_narrow_split_matches_one_pass(runs):
    split, one = runs["st_split"], runs["st_one"]
    assert set(split.bucket_calls_by_pass) == {"narrow", "wide"}
    assert set(one.bucket_calls_by_pass) == {"one"}
    assert _differing(runs["one_pass"], runs["true_split"]) == []
