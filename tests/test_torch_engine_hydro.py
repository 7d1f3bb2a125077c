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
bytes and family lanes, the JAX engine with its TPU caps), so values are
compared, not bucket counters.  One case per (halo type, key) checks the
key in every group of its type and names the groups that differ.
"""

import dataclasses

import numpy as np
import pytest
import torch

from soap_tpu.models.context import HaloContext as JaxContext
from soap_tpu.pipeline.chunk_data import ChunkData as JaxChunk, stage_ptype
from soap_tpu.pipeline.engine import HaloEngine as JaxEngine
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu_torch.pipeline import chunks, run
from soap_tpu_torch.pipeline.chunk_data import chunk_from_numpy
from soap_tpu_torch.pipeline.engine import HaloEngine
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.mock_data import build_mock_universe

#: counts compare exactly; masses and radii of the SO solution at rtol
#: 1e-5; the rest sum in different orders, some with cancellation (the
#: centres, inertia tensors, kappa, dispersions): rtol 1e-3 with atol
#: 1e-4 max|ref| over the key's values
COUNTS = ("Ngas", "Ndm", "Nstar", "Nbh")
TIGHT = ("r", "Mtot", "Mgas", "Mdm", "Mstar", "Mbh_dynamical")

#: coarse particles (4e10 Msun) keep the CPU run short; every halo still
#: has >= 25 gas and 12 star particles, and the biggest ones a black hole
UNI = dict(n_halos=6, n_field=1000, boxsize=16.0, seed=101, hydro=True, n_satellites=2,
           particle_mass=4.0, mass_range=(100.0, 5000.0))

_HALO_TYPES = (
    ("BoundSubhalo", "bound"), ("SO", "SO"), ("Aperture", "aperture"),
    ("ProjectedAperture", "projected"),
)


def _cases():
    meta = run.mock_metadata(build_mock_universe(**UNI))
    specs = build_specs(None, False, meta.virBN98)
    out = []
    for name, kind in _HALO_TYPES:
        first = next(s for s in specs if s.kind == kind)
        out += [(name, kind, key) for key in first.keys]
    return out


CASES = _cases()


def _close(a, b, key):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or not np.isfinite(b).all():
        return False
    if key in COUNTS:
        return np.array_equal(a, b)
    if key in TIGHT:
        return np.allclose(b, a, rtol=1e-5, atol=0.0)
    scale = np.abs(a).max() if a.size else 1.0
    return np.allclose(b, a, rtol=1e-3, atol=1e-4 * max(scale, 1e-30))


@pytest.fixture(scope="module")
def runs():
    uni = build_mock_universe(**UNI)
    meta = run.mock_metadata(uni)
    specs = build_specs(None, False, meta.virBN98)
    ptypes = [pt for pt in meta.ptypes if meta.datasets[pt]]
    ctx = run.make_context(meta, ptypes, False)
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
        search_radius_phys=enclose * 1.01 * np.where(np.arange(H) % 3 == 0, 0.002, 1.0),
        index=np.arange(H, dtype=np.int64),
        is_central=(np.arange(H) % 4 != 0) & (np.asarray(uni.halo_rank) == 0),
        fof_id=np.arange(1, H + 1, dtype=np.int64),
        enclose_radius_phys=enclose * 0.3,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAP_TPU_DMA_GATHER", "1")
        jeng = JaxEngine(
            JaxContext(**dataclasses.asdict(ctx)), jchunk,
            jax_build_specs(None, False, meta.virBN98), aux={"age_table": ages},
        )
        ref = jeng.process(**args)
    eng = HaloEngine(ctx, chunk_from_numpy(jchunk, torch.device("cpu")), specs, "cpu")
    got = eng.process(**args)
    return dict(ref=ref, got=got, specs=specs, stats=eng.stats, H=H, args=args)


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
    bad = []
    for spec in runs["specs"]:
        if spec.kind != kind:
            continue
        a, b = runs["ref"][spec.group][key], runs["got"][spec.group][key]
        assert np.asarray(b).shape[0] == runs["H"]
        if not _close(a, b, key):
            bad.append(spec.group)
    assert not bad, f"{key} differs in {bad}"
