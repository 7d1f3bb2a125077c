"""Core-excised SOs, a fixed-radius SO and property-sized apertures with
every hydro key, through the inertia loop, against the JAX engine.

The production lists switch these kinds' iterative inertia tensors off
(COLIBRE_THERMAL computes only the non-iterative ones), so here
COLIBRE_THERMAL's variations run with every property enabled: the
bound subhalo, its four core-excised SOs (one family of 4 lanes on the
halo axis, whose iterative inertia configs go through one inertia-loop
call), a 50 kpc fixed-radius SO (not virial: no flow rates, no
concentrations) and the apertures and projected apertures of twice the
bound stellar half-mass radius (iterative stellar inertia configs,
mass- and luminosity-weighted).  11 calculations, 1390 keys, on the
hydro test's mock (``tests/test_torch_engine_hydro.py::hydro_runs``)
with every halo central at 1.01 x EncloseRadius.
One case per (halo type, key) checks the key in every group of its type.
"""

import numpy as np
import pytest

from test_torch_engine_hydro import groups_differing, hydro_runs, kind_key_cases

BASE_TYPES = ("SubhaloProperties", "SOProperties", "ApertureProperties",
              "ProjectedApertureProperties")


def every_key(raw):
    """COLIBRE_THERMAL with no property switched off, and a 50 kpc
    fixed-radius SO."""
    for section in BASE_TYPES:
        raw[section].pop("properties", None)
    raw["SOProperties"]["variations"]["50_kpc"] = {"type": "physical", "radius_in_kpc": 50.0}


def new_kinds(spec):
    return spec.kind in ("bound", "SO") or spec.radius_property is not None


@pytest.fixture(scope="module")
def runs():
    # the bench paths' inputs: the hydro test's shrunk radii would send
    # most halos round the retry ladder (COLIBRE's file test covers the
    # property-sized spheres' retries and satellites)
    return hydro_runs("COLIBRE_THERMAL", edit=every_key, select=new_kinds, bench_args=True)


def _cases():
    import json

    from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
    from soap_tpu_torch.pipeline.specs import build_specs

    with open(parameter_file_path("COLIBRE_THERMAL")) as f:
        raw = json.load(f)
    every_key(raw)
    return kind_key_cases([s for s in build_specs(ParameterFile(parameter_dictionary=raw),
                                                  False, 100.0) if new_kinds(s)])


CASES = _cases()


def test_spec_list(runs):
    specs = runs["specs"]
    assert (len(specs), sum(len(s.keys) for s in specs)) == (11, 1390)
    assert [s.group for s in specs if s.core_excision_fraction] == [
        "SO/200_crit", "SO/200_mean", "SO/500_crit", "SO/BN98"
    ]
    assert [s.so_type for s in specs if s.group == "SO/50_kpc"] == ["physical"]
    iterative = [s.group for s in specs
                 if any("InertiaTensor" in k and "Noniterative" not in k for k in s.keys)]
    assert len(iterative) == len(specs)


def test_fixed_radius_so_is_not_virial(runs):
    so, cen = runs["got"]["SO/50_kpc"], runs["args"]["is_central"]
    np.testing.assert_array_equal(so["r"][cen], np.float32(0.05))
    for key in ("DarkMatterMassFlowRate", "HotGasMassFlowRate", "concentration_unsoft"):
        assert not so[key].any(), key
    assert runs["got"]["SO/200_crit"]["DarkMatterMassFlowRate"].any()


@pytest.mark.parametrize("kind,key", CASES, ids=[f"{k}/{key}" for k, key in CASES])
def test_key_matches_jax(runs, kind, key):
    bad = groups_differing(runs, kind, key)
    assert not bad, f"{key} differs in {bad}"
