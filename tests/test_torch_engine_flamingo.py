"""The port's engine on FLAMINGO's spec list, and on property-sized
apertures and a fixed-radius SO, against the JAX engine.

FLAMINGO (38 calculations, 2103 keys; ``tests/test_torch_engine_hydro.py::
hydro_runs`` on the hydro mock, with the file's context) has one
core-excised SO (500_crit) inside the SO family and apertures of 300 kpc
to 3 Mpc, above ``WIDE_RADIUS_MPC``, so its 500, 1000 and 3000 kpc
spheres run in the wide pass and copy from the narrow pass's 300 kpc.

On a small DMO mock with its catalogue EncloseRadius and twice it as
the search radius (the bound spec's
rows truncated to the sorted prefix, the property-sized aperture not),
both engines also run the pair of ``tests/test_radius_property_aperture.
py::test_property_aperture_values`` (an exclusive sphere of twice the
bound half-mass radius) and a 50 kpc fixed-radius SO with every DMO SO
key (no flow rates or concentrations: not a virial definition).
"""

import dataclasses

import numpy as np
import pytest
import torch

from soap_tpu.models.context import HaloContext as JaxContext
from soap_tpu.pipeline.engine import HaloEngine as JaxEngine
from soap_tpu.pipeline.engine import HaloTypeSpec as JaxSpec
from soap_tpu.utils import mock_data
from soap_tpu_torch.core.halo_types import implemented_keys_for
from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.pipeline import run
from soap_tpu_torch.pipeline.chunk_data import chunk_from_numpy
from soap_tpu_torch.pipeline.engine import HaloEngine, HaloTypeSpec, _pass_of
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.mock_data import build_mock_universe
from soap_tpu_torch.utils.parity import key_close
from test_torch_engine_full import dmo_inputs
from test_torch_engine_hydro import UNI, groups_differing, hydro_runs, kind_key_cases

NAME = "FLAMINGO"

DMO_SPECS = [
    HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=("Mtot", "HalfMassRadiusTot")),
    HaloTypeSpec(
        kind="aperture", group="ExclusiveSphere/2xHalfMassRadiusTotal", keys=("Mtot", "Ndm"),
        inclusive=False, radius_property=("BoundSubhalo", "HalfMassRadiusTot", 2.0),
    ),
    HaloTypeSpec(
        kind="SO", group="SO/50_kpc", keys=implemented_keys_for("SO", True),
        so_type="physical", so_multiple=0.05, centrals_only=True,
    ),
]
DMO_KEYS = [(s.group, k) for s in DMO_SPECS for k in s.keys]
#: keys a fixed-radius SO leaves at 0
NOT_VIRIAL = ("DarkMatterMassFlowRate", "concentration_soft", "concentration_unsoft")


def _cases():
    meta = run.mock_metadata(build_mock_universe(**UNI))
    return kind_key_cases(
        build_specs(ParameterFile(parameter_file_path(NAME)), False, meta.virBN98))


CASES = _cases()


@pytest.fixture(scope="module")
def runs():
    return hydro_runs(NAME)


@pytest.fixture(scope="module")
def dmo_runs():
    uni = mock_data.build_mock_universe(n_halos=8, n_field=2500, boxsize=16.0, seed=41,
                                        n_satellites=1)
    jchunk, ctx_kw = dmo_inputs(uni)
    H = uni.n_halos
    enclose = uni.halo_renclose * uni.a
    args = dict(
        centres=uni.halo_pos, search_radius_phys=enclose * 2.0,
        index=np.arange(H, dtype=np.int64),
        is_central=np.asarray(uni.halo_rank) == 0,
        fof_id=np.arange(1, H + 1, dtype=np.int64), enclose_radius_phys=enclose,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAP_TPU_DMA_GATHER", "1")
        jeng = JaxEngine(JaxContext(**ctx_kw), jchunk,
                         [JaxSpec(**dataclasses.asdict(s)) for s in DMO_SPECS])
        ref = jeng.process(**args)
    eng = HaloEngine(HaloContext(**ctx_kw), chunk_from_numpy(jchunk, torch.device("cpu")),
                     DMO_SPECS, "cpu")
    got = eng.process(**args)
    return dict(ref=ref, got=got, stats=eng.stats, jstats=jeng.stats, H=H,
                is_central=args["is_central"])


def test_spec_list_is_flamingo(runs):
    specs = runs["specs"]
    assert (len(specs), sum(len(s.keys) for s in specs)) == (38, 2103)
    assert [s.group for s in specs if s.core_excision_fraction] == ["SO/500_crit"]
    wide = [s.group for s in specs if _pass_of(s) == "wide"]
    assert wide == [f"{k}Sphere/{r}kpc" for k in ("Exclusive", "Inclusive")
                    for r in (500, 1000, 3000)]


def test_wide_pass_copies_from_the_narrow_pass(runs):
    st, j = runs["stats"], runs["jstats"]
    assert set(st.k1_launches_by_ptype) == {"PartType0", "PartType1", "PartType4", "PartType5"}
    assert set(st.bucket_calls_by_pass) == {"narrow", "wide"} and st.n_copied_specs > 0
    assert (st.n_bucket_calls, st.n_retries, st.n_copied_specs) == (
        j.n_bucket_calls, j.n_retries, j.n_copied_specs
    )


@pytest.mark.parametrize("kind,key", CASES, ids=[f"{k}/{key}" for k, key in CASES])
def test_flamingo_key_matches_jax(runs, kind, key):
    bad = groups_differing(runs, kind, key)
    assert not bad, f"{key} differs in {bad}"


def test_property_aperture_values(dmo_runs):
    """More than half the bound mass lies within twice the half-mass
    radius, and never more than the whole bound mass."""
    got = dmo_runs["got"]
    hmr = got["BoundSubhalo"]["HalfMassRadiusTot"]
    m_ap = got["ExclusiveSphere/2xHalfMassRadiusTotal"]["Mtot"]
    m_bound = got["BoundSubhalo"]["Mtot"]
    assert np.all(m_ap > 0.5 * m_bound)
    assert np.all(m_ap <= m_bound * (1 + 1e-6))
    assert np.all(hmr > 0)
    st = dmo_runs["stats"]
    assert st.n_truncated_tiles > 0  # the bound spec ran on the sorted prefix
    assert (st.n_bucket_calls, st.n_retries) == (
        dmo_runs["jstats"].n_bucket_calls, dmo_runs["jstats"].n_retries
    )


def test_physical_so_is_not_virial(dmo_runs):
    so = dmo_runs["got"]["SO/50_kpc"]
    cen = dmo_runs["is_central"]
    np.testing.assert_array_equal(so["r"][cen], np.float32(0.05))
    assert (so["Mtot"][cen] > 0).all()
    for key in NOT_VIRIAL:
        assert not np.asarray(so[key]).any(), key


@pytest.mark.parametrize("group,key", DMO_KEYS, ids=[f"{g}/{k}" for g, k in DMO_KEYS])
def test_dmo_property_aperture_and_physical_so_match_jax(dmo_runs, group, key):
    a, b = dmo_runs["ref"][group][key], dmo_runs["got"][group][key]
    assert np.asarray(b).shape[0] == dmo_runs["H"]
    assert key_close(a, b, key), f"{group}/{key}"
