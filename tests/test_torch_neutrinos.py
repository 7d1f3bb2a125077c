"""Neutrino delta-f weights (PartType6) through the port's engine against
the JAX engine.

The hydro mock of ``tests/test_torch_engine_hydro.py`` gains a PartType6
population (``utils/mock_data.py::add_neutrinos``: 0.17 of its dark
matter count, half around the halos, ``Weights`` in [-1, 1] with about
half of them negative), so a halo's weighted cumulative mass profile is
not monotone.  Both engines run FLAMINGO's SO groups (the ones that read
neutrinos) with the file's context, under the JAX engine's tile caps, on
the mock's narrowed search radii and understated EncloseRadius (retries
and the satellite phase): every key at ``utils/parity.py``'s tolerances,
equal counters, PartType6 gathered through K1's wrapper, and ``Mnu``
(RawNeutrinoMass) and ``MnuNS`` (NoiseSuppressedNeutrinoMass) equal to
float64 sums of the raw and the weighted masses inside each SO radius.
"""

import numpy as np
import pytest
import torch

from soap_tpu_torch.utils.mock_data import add_neutrinos, build_mock_universe
from soap_tpu_torch.utils.parity import key_close
from test_torch_engine_hydro import UNI, groups_differing, hydro_runs, kind_key_cases

torch.set_num_threads(1)


def _is_so(spec):
    return spec.kind == "SO"


def _universe():
    return add_neutrinos(build_mock_universe(**UNI))


@pytest.fixture(scope="module")
def runs():
    out = hydro_runs("FLAMINGO", jax_tile_plan=True, select=_is_so, universe=_universe())
    out["uni"] = _universe()
    return out


def _cases():
    from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
    from soap_tpu_torch.pipeline import run
    from soap_tpu_torch.pipeline.specs import build_specs

    meta = run.mock_metadata(_universe())
    specs = build_specs(ParameterFile(parameter_file_path("FLAMINGO")), False, meta.virBN98)
    return [key for kind, key in kind_key_cases([s for s in specs if _is_so(s)])]


CASES = _cases()


def test_neutrino_keys_are_in_the_list():
    assert {"Mnu", "MnuNS", "Nnu"} <= set(CASES)


def test_mock_weights_take_both_signs():
    w = _universe().extra_ptypes["PartType6"]["Weights"]
    assert (w < 0).mean() > 0.3 and (w > 0).mean() > 0.3
    assert w.min() >= -1.0 and w.max() <= 1.0


@pytest.mark.parametrize("key", CASES)
def test_so_key_matches_jax_with_neutrino_weights(runs, key):
    bad = groups_differing(runs, "SO", key)
    assert not bad, f"{key} differs in {bad}"


def test_k1_gathers_neutrinos_and_counters_match_jax(runs):
    st, j = runs["stats"], runs["jstats"]
    # gathered through the K1 wrapper (which launches on CUDA tensors
    # only: chip_smoke.py phases 5n and 15 count those launches)
    assert "PartType6" in st.k1_launches_by_ptype
    assert st.n_retries > 0
    j_trunc = sum(1 for rec in j.bucket_records if rec[5])
    assert (st.n_bucket_calls, st.n_retries, st.n_copied_specs, st.n_truncated_tiles) == (
        j.n_bucket_calls, j.n_retries, j.n_copied_specs, j_trunc
    )
    assert st.n_bucket_calls == sum(runs["j_by_pass"].values())


def _oracle(uni, centre, r_phys):
    """(raw mass, weighted mass, count) of the neutrinos within ``r_phys``
    (physical) of ``centre`` (comoving), in float64."""
    nu = uni.extra_ptypes["PartType6"]
    d = nu["Coordinates"] - centre
    d -= uni.boxsize * np.round(d / uni.boxsize)
    inside = np.sqrt((d * d).sum(1)) * uni.a <= r_phys
    m = nu["Masses"].astype(np.float64)
    return m[inside].sum(), (m * nu["Weights"].astype(np.float64))[inside].sum(), inside.sum()


@pytest.mark.parametrize("group", ["SO/200_crit", "SO/500_crit", "SO/200_mean"])
def test_raw_and_weighted_neutrino_masses(runs, group):
    uni, got = runs["uni"], runs["got"][group]
    checked = differ = 0
    for hi in range(uni.n_halos):
        r = float(got["r"][hi])
        if r <= 0:
            continue
        raw, weighted, n = _oracle(uni, uni.halo_pos[hi], r)
        assert int(got["Nnu"][hi]) == n, (group, hi)
        assert key_close(np.array([raw]), np.array([got["Mnu"][hi]]), "Mnu"), (group, hi)
        assert key_close(np.array([weighted]), np.array([got["MnuNS"][hi]]), "MnuNS"), (
            group, hi)
        checked += 1
        differ += int(n > 0 and abs(raw - weighted) > 1e-3 * raw)
    assert checked >= 3 and differ >= 1
