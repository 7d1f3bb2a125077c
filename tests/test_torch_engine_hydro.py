"""The port's engine on the default hydro spec list against the JAX engine.

Both engines run ``build_specs(None, dmo=False, ...)`` (38 calculations,
4729 keys) on one staged hydro mock: gas, dark matter, stars and black
holes, staged by the JAX package's ``stage_ptype`` from the port's
in-memory inputs (``tests/test_torch_staging.py`` holds those to the JAX
reader's) and handed to the port through ``chunk_from_numpy``.  The JAX
engine runs with ``SOAP_TPU_DMA_GATHER=1`` so both gather into the same
range layout, with the age table the JAX run hands it.  The mock has two
satellite subhalos of its biggest halo (they and every fourth halo are
satellites), every third input search radius is shrunk x0.002 and the
catalogue EncloseRadius is understated x0.3.

The two engines size hydro buckets differently (the port from its row
bytes and family lanes, the JAX engine with its TPU caps); given the JAX
engine's caps (``tile_caps``), as here, the port cuts the same buckets
and its counters equal the JAX engine's.  One case per (halo type, key) checks
the key in every group of its type, at ``soap_tpu_torch/utils/parity.py``'s
tolerances, and names the groups that differ.  ``hydro_runs`` serves the
parameter-file suites too (``test_torch_engine_colibre.py``,
``test_torch_engine_flamingo.py``).
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import soap_tpu_torch.pipeline.engine as torch_engine
from soap_tpu.core.params import ParameterFile as JaxParameterFile
from soap_tpu.models.context import HaloContext as JaxContext
from soap_tpu.pipeline.chunk_data import ChunkData as JaxChunk, stage_ptype
from soap_tpu.pipeline.engine import HaloEngine as JaxEngine
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
from soap_tpu_torch.pipeline import chunks, run
from soap_tpu_torch.pipeline.chunk_data import chunk_from_numpy
from soap_tpu_torch.pipeline.engine import HaloEngine
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.mock_data import build_mock_universe
from soap_tpu_torch.utils.parity import key_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX engine's tile caps for several particle types: a fifth of its
#: padded-row budget and at most 64 halos per bucket
JAX_HYDRO_TILE_CAPS = (torch_engine.TARGET_ROWS // 5, 64)

#: coarse particles (4e10 Msun) keep the CPU run short; every halo still
#: has >= 25 gas and 12 star particles, and the biggest ones a black hole
UNI = dict(n_halos=6, n_field=1000, boxsize=16.0, seed=101, hydro=True, n_satellites=2,
           particle_mass=4.0, mass_range=(100.0, 5000.0))

_HALO_TYPES = (
    ("BoundSubhalo", "bound"), ("SO", "SO"), ("Aperture", "aperture"),
    ("ProjectedAperture", "projected"),
)


def kind_key_cases(specs):
    """(kind, key) once for every key any spec of a halo type computes."""
    return [(kind, key) for _, kind in _HALO_TYPES
            for key in dict.fromkeys(k for s in specs if s.kind == kind for k in s.keys)]


def groups_differing(runs, kind, key):
    """The groups of one halo type whose ``key`` the port computes outside
    ``key_close`` of the JAX engine's."""
    bad = []
    for spec in runs["specs"]:
        if spec.kind != kind or key not in spec.keys:
            continue
        a, b = runs["ref"][spec.group][key], runs["got"][spec.group][key]
        assert np.asarray(b).shape[0] == runs["H"]
        if not key_close(a, b, key):
            bad.append(spec.group)
    return bad


def _cases():
    meta = run.mock_metadata(build_mock_universe(**UNI))
    names = {kind: name for name, kind in _HALO_TYPES}
    return [(names[kind], kind, key)
            for kind, key in kind_key_cases(build_specs(None, False, meta.virBN98))]


CASES = _cases()


def hydro_runs(parameter_file=None, jax_tile_plan=False, edit=None, select=None,
               bench_args=False, universe=None):
    """Both engines on the hydro mock with a shipped parameter file's
    spec list and context (None: the default hydro list and context).
    ``edit`` changes the file's dictionary before both sides read it;
    ``select`` keeps some of the specs; ``bench_args`` makes every halo
    central at 1.01 x EncloseRadius, as the bench paths run (no
    satellite phase and no retry rounds, each of which compiles new JAX
    programs).  With ``jax_tile_plan`` the port runs
    under the JAX engine's multi-type tile caps (``tile_caps``), and the
    JAX engine's bucket calls are counted by pass.  ``universe`` replaces
    the hydro mock (``UNI``'s universe by default)."""
    uni = build_mock_universe(**UNI) if universe is None else universe
    meta = run.mock_metadata(uni)
    params = jparams = None
    if parameter_file is not None and edit is None:
        params = ParameterFile(parameter_file_path(parameter_file))
        jparams = JaxParameterFile(os.path.join(REPO, "parameter_files", f"{parameter_file}.yml"))
    elif parameter_file is not None:
        with open(parameter_file_path(parameter_file)) as f:
            raw = json.load(f)
        edit(raw)
        params = ParameterFile(parameter_dictionary=copy.deepcopy(raw))
        jparams = JaxParameterFile(parameter_dictionary=copy.deepcopy(raw))
    specs = build_specs(params, False, meta.virBN98)
    jspecs = jax_build_specs(jparams, False, meta.virBN98)
    if select is not None:
        specs = [s for s in specs if select(s)]
        jspecs = [s for s in jspecs if select(s)]
    ptypes = [pt for pt in meta.ptypes if meta.datasets[pt]]
    ctx = run.make_context(meta, ptypes, False, params)
    ages = run.age_table(meta)
    host = chunks.mock_fields(uni, specs, meta, ptypes, ages)
    jchunk = JaxChunk(
        boxsize=uni.boxsize,
        ptypes={pt: stage_ptype(pos, f, uni.boxsize) for pt, (pos, f) in host.items()},
    )
    H = uni.n_halos
    enclose = uni.halo_renclose * uni.a
    args = dict(
        centres=uni.halo_pos,
        search_radius_phys=enclose * 1.01 * np.where(
            (np.arange(H) % 3 == 0) & (not bench_args), 0.002, 1.0),
        index=np.arange(H, dtype=np.int64),
        is_central=np.ones(H, bool) if bench_args else (
            (np.arange(H) % 4 != 0) & (np.asarray(uni.halo_rank) == 0)),
        fof_id=np.arange(1, H + 1, dtype=np.int64),
        enclose_radius_phys=enclose * 0.3,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAP_TPU_DMA_GATHER", "1")
        jeng = JaxEngine(
            JaxContext(**dataclasses.asdict(ctx)), jchunk,
            jspecs, aux={"age_table": ages},
        )
        j_by_pass = _count_by_pass(jeng, specs) if jax_tile_plan else None
        ref = jeng.process(**args)
    chunk = chunk_from_numpy(jchunk, torch.device("cpu"))
    eng = HaloEngine(ctx, chunk, specs, "cpu",
                     tile_caps=JAX_HYDRO_TILE_CAPS if jax_tile_plan else None)
    got = eng.process(**args)
    return dict(ref=ref, got=got, specs=specs, stats=eng.stats, H=H, args=args,
                jstats=jeng.stats, j_by_pass=j_by_pass)


def _count_by_pass(jeng, specs):
    """The JAX engine's bucket calls by pass, as the port counts them: a
    call of ``process`` made by the top call is the narrow pass (no wide
    aperture), the wide pass (only wide ones) or a central/satellite
    phase of one pass ('one')."""
    wide = {s.group for s in specs if torch_engine._pass_of(s) == "wide"}
    counts, depth, top = {}, [0], jeng.process

    def process(*a, specs=None, **kw):
        depth[0] += 1
        n0 = jeng.stats.n_bucket_calls
        try:
            return top(*a, specs=specs, **kw)
        finally:
            depth[0] -= 1
            n = jeng.stats.n_bucket_calls - n0
            if depth[0] == 1:
                groups = {s.group for s in specs}
                name = "wide" if groups <= wide else "narrow" if not groups & wide else "one"
                counts[name] = counts.get(name, 0) + n
            elif depth[0] == 0 and not counts:
                counts["one"] = n

    jeng.process = process
    return counts


@pytest.fixture(scope="module")
def runs():
    return hydro_runs(jax_tile_plan=True)


def test_spec_list_is_the_default_hydro_catalogue(runs):
    specs = runs["specs"]
    assert (len(specs), sum(len(s.keys) for s in specs)) == (38, 4729)
    assert len(CASES) == 124 + 129 + 156 + 79


def test_every_type_gathered_and_both_passes_ran(runs):
    st = runs["stats"]
    assert set(st.k1_launches_by_ptype) == {"PartType0", "PartType1", "PartType4", "PartType5"}
    assert st.n_copied_specs > 0 and st.n_truncated_tiles == 0  # several types: no truncation
    assert set(st.bucket_calls_by_pass) == {"narrow", "wide"}


@pytest.mark.parametrize(
    "halo_type,kind,key", CASES, ids=[f"{t}/{k}" for t, _, k in CASES]
)
def test_hydro_key_matches_jax(runs, halo_type, kind, key):
    bad = groups_differing(runs, kind, key)
    assert not bad, f"{key} differs in {bad}"


def test_counters_match_jax_under_its_tile_plan(runs):
    """Given the JAX engine's tile caps, the port cuts the same buckets:
    equal bucket calls (by pass), retries, copied specs and truncated
    tiles.  (The values are the key cases; the byte-sized default plan
    runs against JAX in the parameter-file suites.)"""
    j, t = runs["jstats"], runs["stats"]
    j_trunc = sum(1 for rec in j.bucket_records if rec[5])
    assert (t.n_bucket_calls, t.n_retries, t.n_copied_specs, t.n_truncated_tiles) == (
        j.n_bucket_calls, j.n_retries, j.n_copied_specs, j_trunc
    )
    assert t.bucket_calls_by_pass == runs["j_by_pass"]
    assert set(t.bucket_calls_by_pass) == {"narrow", "wide"} and t.n_copied_specs > 0
