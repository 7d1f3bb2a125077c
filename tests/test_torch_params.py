"""The port's parameter files against the JAX package's.

``soap_tpu_torch/core/params.py`` is a copy of ``soap_tpu/core/params.py``
that reads the shipped JSON copies of ``parameter_files/*.yml`` (yaml only
for a ``.yml`` path), and ``build_specs(params, ...)`` a copy of the JAX
builder.  These tests hold the JSON to ``yaml.safe_load`` of each file,
every accessor and the spec lists to the JAX package's, and port the JAX
package's spec-builder tests of parameter files.
"""

import dataclasses
import json
import os

import pytest
import yaml

from soap_tpu.core.params import ParameterFile as JaxParameterFile
from soap_tpu.core.params import substitute_parameters as jax_substitute
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu_torch.core.params import (
    PARAMETER_FILES,
    ParameterFile,
    parameter_file_path,
    substitute_parameters,
)
from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.pipeline.engine import _check_spec
from soap_tpu_torch.pipeline.specs import build_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (name, specs, keys) of each file's hydro list, as the JAX builder makes it
HYDRO_SIZES = {
    "COLIBRE_THERMAL": (50, 4114), "COLIBRE_HYBRID": (50, 4564), "FLAMINGO": (38, 2103),
    "EAGLE": (28, 1362), "MINIMAL_FLAMINGO": (4, 48),
}
BASE_TYPES = ("SubhaloProperties", "SOProperties", "ApertureProperties",
              "ProjectedApertureProperties")


def _yml(name):
    return os.path.join(REPO, "parameter_files", f"{name}.yml")


def _params(cls, raw):
    """A parameter file over a deep copy of ``raw`` (the queries write
    their defaults into it)."""
    return cls(parameter_dictionary=json.loads(json.dumps(raw)))


def _pair(name):
    return ParameterFile(parameter_file_path(name)), JaxParameterFile(_yml(name))


def test_every_production_file_is_shipped():
    assert sorted(PARAMETER_FILES) == sorted(
        f[:-4] for f in os.listdir(os.path.join(REPO, "parameter_files")) if f.endswith(".yml")
    )
    assert parameter_file_path("FLAMINGO.yml") == parameter_file_path("FLAMINGO")
    with pytest.raises(KeyError):
        parameter_file_path("NOT_A_FILE")


@pytest.mark.parametrize("name", PARAMETER_FILES)
def test_json_equals_yaml_safe_load(name):
    """Values, types and key order: PyYAML's strings for exponents
    without a dot ("3.16e4") stay strings."""
    with open(_yml(name)) as f:
        want = yaml.safe_load(f)
    with open(parameter_file_path(name)) as f:
        got = json.load(f)
    assert json.dumps(got) == json.dumps(want)
    assert ParameterFile(_yml(name)).parameters == got


@pytest.mark.parametrize("name", PARAMETER_FILES)
def test_accessors_match_jax(name):
    ours, theirs = _pair(name)
    assert ours.parameters == theirs.parameters
    for fn in ("calculate_missing_properties", "strict_halo_copy",
               "recently_heated_gas_params", "get_parameters", "get_aliases",
               "get_defined_constants"):
        assert getattr(ours, fn)() == getattr(theirs, fn)(), fn
    names = sorted({p.name for _, p in full_property_table()._props.items()})
    for base in BASE_TYPES:
        assert ours.get_property_filters(base, names) == theirs.get_property_filters(base, names)
        defaults = {"v": {"radius_in_kpc": 1.0}}
        assert ours.get_halo_type_variations(base, defaults) == \
            theirs.get_halo_type_variations(base, defaults)
    assert ours.property_filters == theirs.property_filters
    assert ours.unregistered == theirs.unregistered
    defaults = {"general": {"limit": 7}, "made_up": {"limit": 3}}
    assert ours.get_filters(defaults) == theirs.get_filters(defaults)
    for prop in list(ours.get_aliases()) + ["PartType1/Masses"]:
        assert ours.get_particle_property(prop) == theirs.get_particle_property(prop)
    with pytest.raises(RuntimeError):
        ours.get_particle_property("Masses")
    # every mutation the queries made, the same on both sides
    assert ours.parameters == theirs.parameters
    snip = ParameterFile(parameter_file_path(name), snipshot=True)
    assert snip.get_aliases() == JaxParameterFile(_yml(name), snipshot=True).get_aliases()


def test_substitute_parameters_matches_jax():
    with open(parameter_file_path("COLIBRE_THERMAL")) as f:
        raw = json.load(f)
    over = {"sim_dir": "/sim", "output_dir": "/out", "scratch_dir": None, "snap_nr": 7}
    got = substitute_parameters(raw, over)
    assert got == jax_substitute(raw, over)
    # {snap_nr} and {file_nr} stay for later, per file
    assert "{snap_nr" in json.dumps(got["Snapshots"])


@pytest.mark.parametrize("dmo", [True, False], ids=["dmo", "hydro"])
@pytest.mark.parametrize("name", PARAMETER_FILES)
def test_build_specs_matches_jax(name, dmo):
    ours, theirs = _pair(name)
    got = build_specs(ours, dmo, 123.5)
    want = jax_build_specs(theirs, dmo, 123.5)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    assert ours.property_filters == theirs.property_filters
    if not dmo:
        assert (len(got), sum(len(s.keys) for s in got)) == HYDRO_SIZES[name]
    for spec in got:  # the engine runs every spec of every file
        _check_spec(spec)


@pytest.mark.parametrize("name", ["COLIBRE_HYBRID", "EAGLE", "MINIMAL_FLAMINGO"])
def test_other_parameter_files_build_specs(name):
    """Each file builds a valid list: keys known, groups unique, every
    copy source and radius-multiple parent built (from
    ``tests/test_colibre_params.py``, through the substituted dict)."""
    with open(parameter_file_path(name)) as f:
        raw = json.load(f)
    raw = substitute_parameters(raw, {"sim_dir": "/d", "output_dir": "/d", "scratch_dir": "/d"})
    specs = build_specs(ParameterFile(parameter_dictionary=raw), dmo=False, bn98_value=100.0)
    assert len(specs) > 3
    table = full_property_table()
    groups = set()
    for s in specs:
        assert s.group not in groups, f"duplicate group {s.group}"
        groups.add(s.group)
        for k in s.keys:
            assert k in table, f"{s.group}: unknown key {k}"
    for s in specs:
        if s.copy_from is not None:
            assert s.copy_from in groups, s.group
        if s.radius_multiple_of is not None:
            assert s.radius_multiple_of in groups, s.group


def test_inclusive_skip_gt_enclose_copy_chain():
    """Inclusive spheres join the copy chain only with
    skip_gt_enclose_radius; exclusive ones always."""
    raw = {
        "ApertureProperties": {
            "variations": {
                "inclusive_50_kpc": {"inclusive": True, "radius_in_kpc": 50.0},
                "inclusive_100_kpc": {"inclusive": True, "radius_in_kpc": 100.0,
                                      "skip_gt_enclose_radius": True},
                "inclusive_300_kpc": {"inclusive": True, "radius_in_kpc": 300.0},
                "exclusive_50_kpc": {"inclusive": False, "radius_in_kpc": 50.0},
                "exclusive_100_kpc": {"inclusive": False, "radius_in_kpc": 100.0},
            }
        }
    }
    kw = dict(dmo=True, bn98_value=100.0, subhalo=False, so=False, projected=False)
    specs = {s.group: s for s in build_specs(_params(ParameterFile, raw), **kw)}
    assert specs["InclusiveSphere/50kpc"].copy_from is None
    assert specs["InclusiveSphere/100kpc"].copy_from == "InclusiveSphere/50kpc"
    assert specs["InclusiveSphere/300kpc"].copy_from is None
    assert specs["ExclusiveSphere/100kpc"].copy_from == "ExclusiveSphere/50kpc"
    want = jax_build_specs(_params(JaxParameterFile, raw), **kw)
    assert [dataclasses.asdict(s) for s in specs.values()] == [
        dataclasses.asdict(s) for s in want
    ]


def test_colibre_aliases_resolve():
    params = ParameterFile(parameter_file_path("COLIBRE_THERMAL"))
    assert params.get_aliases()["PartType0/LastSNIIKineticFeedbackDensities"] == (
        "PartType0/DensitiesAtLastSupernovaEvent"
    )
    assert params.get_particle_property("PartType0/LastSNIIKineticFeedbackDensities") == (
        "PartType0", "DensitiesAtLastSupernovaEvent"
    )
    snip = ParameterFile(parameter_file_path("COLIBRE_THERMAL"), snipshot=True)
    assert snip.get_particle_property("PartType0/SpeciesFractions") == (
        "PartType0", "ReducedSpeciesFractions"
    )


def test_spec_builder_parses_property_apertures():
    """A property-sized aperture (from
    ``tests/test_radius_property_aperture.py``) comes first, outside the
    fixed radii's copy chain."""
    raw = {
        "ApertureProperties": {
            "variations": {
                "exclusive_50_kpc": {"radius_in_kpc": 50.0, "inclusive": False},
                "exclusive_twice_halfmass": {
                    "inclusive": False, "property": "BoundSubhalo/HalfMassRadiusTotal",
                    "radius_multiple": 2.0,
                },
                "exclusive_100_kpc": {"radius_in_kpc": 100.0, "inclusive": False},
            }
        }
    }
    kw = dict(bn98_value=100.0, so=False, projected=False)
    specs = build_specs(_params(ParameterFile, raw), True, **kw)
    prop_specs = [s for s in specs if s.radius_property is not None]
    assert len(prop_specs) == 1
    s = prop_specs[0]
    assert s.group == "ExclusiveSphere/2xHalfMassRadiusTotal"
    assert s.radius_property == ("BoundSubhalo", "HalfMassRadiusTot", 2.0)
    assert s.aperture_radius_mpc is None and s.copy_from is None
    assert [x.group for x in specs[1:]] == [
        "ExclusiveSphere/2xHalfMassRadiusTotal", "ExclusiveSphere/50kpc",
        "ExclusiveSphere/100kpc",
    ]
    assert specs[3].copy_from == "ExclusiveSphere/50kpc"
    want = jax_build_specs(_params(JaxParameterFile, raw), True, **kw)
    assert [dataclasses.asdict(x) for x in specs] == [dataclasses.asdict(x) for x in want]


def test_physical_and_core_excised_so_from_a_dict():
    raw = {
        "SOProperties": {
            "variations": {
                "50_kpc": {"type": "physical", "radius_in_kpc": 50.0},
                "500_crit": {"type": "crit", "value": 500.0, "core_excision_fraction": 0.15},
                "5xR500_crit": {"type": "crit", "value": 500.0, "radius_multiple": 5.0,
                                "filter": "general"},
            }
        },
        "filters": {"general": {"limit": 100, "properties": []}},
    }
    kw = dict(bn98_value=100.0, subhalo=False, apertures=False, projected=False)
    for dmo in (True, False):
        specs = build_specs(_params(ParameterFile, raw), dmo, **kw)
        want = jax_build_specs(_params(JaxParameterFile, raw), dmo, **kw)
        assert [dataclasses.asdict(s) for s in specs] == [dataclasses.asdict(s) for s in want]
        phys, ce, mult = specs
        assert (phys.so_type, phys.so_multiple, phys.core_excision_fraction) == (
            "physical", 0.05, None
        )
        assert ce.core_excision_fraction == 0.15
        # the excised extras are gas keys
        assert (len(ce.keys) > len(phys.keys)) != dmo
        assert (mult.radius_multiple_of, mult.radius_multiple, mult.halo_filter) == (
            "SO/500_crit", 5.0, "general"
        )
        for spec in specs:
            _check_spec(spec)
