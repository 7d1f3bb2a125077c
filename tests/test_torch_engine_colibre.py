"""The port's engine on COLIBRE_THERMAL's spec list against the JAX engine.

Both engines run the list the shipped ``COLIBRE_THERMAL`` parameter file
builds (50 calculations, 4114 keys) on the hydro test's mock
(``tests/test_torch_engine_hydro.py::hydro_runs``), with the file's
context: four core-excised SOs (200_crit, 200_mean, 500_crit, BN98; one
family of 4 lanes on the halo axis), apertures down to 100 pc, and
apertures, inclusive and exclusive, and projected apertures sized by
twice the bound stellar half-mass radius.  Its largest fixed aperture is
100 kpc, so there is no wide pass.  One case per (halo type, key)
checks the key in every group of its type and names the groups that
differ.
"""

import numpy as np
import pytest

from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
from soap_tpu_torch.pipeline import run
from soap_tpu_torch.pipeline.engine import _block_signature
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.mock_data import build_mock_universe
from test_torch_engine_hydro import UNI, groups_differing, hydro_runs, kind_key_cases

NAME = "COLIBRE_THERMAL"
PROPERTY_GROUPS = (
    "ExclusiveSphere/2xHalfMassRadiusStars", "InclusiveSphere/2xHalfMassRadiusStars",
) + tuple(f"ProjectedAperture/2xHalfMassRadiusStars/proj{a}" for a in "xyz")


def _specs():
    meta = run.mock_metadata(build_mock_universe(**UNI))
    return build_specs(ParameterFile(parameter_file_path(NAME)), False, meta.virBN98)


CASES = kind_key_cases(_specs())


@pytest.fixture(scope="module")
def runs():
    return hydro_runs(NAME)


def test_spec_list_is_colibre_thermal(runs):
    specs = runs["specs"]
    assert (len(specs), sum(len(s.keys) for s in specs)) == (50, 4114)
    assert [s.group for s in specs if s.radius_property] == list(PROPERTY_GROUPS)
    # the four core-excised SOs are consecutive: one family of 4 lanes
    ce = [s for s in specs if s.core_excision_fraction]
    assert [s.group for s in ce] == ["SO/200_crit", "SO/200_mean", "SO/500_crit", "SO/BN98"]
    ctx = run.make_context(run.mock_metadata(build_mock_universe(**UNI)), ["PartType1"], False)
    assert len({_block_signature(s, s.target_density(ctx)) for s in ce}) == 1
    i = specs.index(ce[0])
    assert specs[i : i + 4] == ce


def test_mechanisms_ran(runs):
    st = runs["stats"]
    assert set(st.k1_launches_by_ptype) == {"PartType0", "PartType1", "PartType4", "PartType5"}
    # nothing above WIDE_RADIUS_MPC: one pass; retries from the shrunk radii
    assert set(st.bucket_calls_by_pass) == {"one"} and st.n_retries > 0
    assert (st.n_bucket_calls, st.n_retries, st.n_copied_specs) == (
        runs["jstats"].n_bucket_calls, runs["jstats"].n_retries, runs["jstats"].n_copied_specs
    )


def test_property_apertures_read_this_buckets_half_mass_radius(runs):
    """The property-sized spheres come after BoundSubhalo in the spec
    order and read its stellar half-mass radius: more than half the bound
    stellar mass lies inside twice that radius (exclusive sphere: bound
    stars only), never more than all of it.  (A halo whose shrunk search
    radius, floored at 100 kpc, misses its bound stars has none.)"""
    got = runs["got"]
    m_bound = got["BoundSubhalo"]["Mstar"]
    has = m_bound > 0
    assert has.sum() >= runs["H"] // 2
    assert (got["BoundSubhalo"]["HalfMassRadiusStar"][has] > 0).all()
    m_ap = got["ExclusiveSphere/2xHalfMassRadiusStars"]["Mstar"]
    assert np.all(m_ap[has] > 0.5 * m_bound[has]) and np.all(m_ap <= m_bound * (1 + 1e-6))
    m_inc = got["InclusiveSphere/2xHalfMassRadiusStars"]["Mstar"]
    assert np.all(m_inc >= m_ap * (1 - 1e-6))


def test_core_excised_keys_differ_from_plain_ones(runs):
    """The excised core changes the core-excised temperatures of haloes
    whose gas reaches inside 0.15 R_SO: the fraction reaches the slices."""
    so = runs["got"]["SO/500_crit"]
    assert not np.array_equal(so["Tgas_core_excision"], so["Tgas"])


@pytest.mark.parametrize("kind,key", CASES, ids=[f"{k}/{key}" for k, key in CASES])
def test_colibre_key_matches_jax(runs, kind, key):
    bad = groups_differing(runs, kind, key)
    assert not bad, f"{key} differs in {bad}"
