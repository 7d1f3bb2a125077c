"""The port's copies of host code stay equal to the JAX package's.

``soap_tpu_torch`` must run where JAX and h5py are absent, so it carries
copies of ``HaloContext``, ``HaloTypeSpec``, the property key lists and
table, ``build_specs`` and the mock-universe generator instead of
importing them; these tests hold the copies to the originals.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from soap_tpu.core import halo_types as jax_halo_types
from soap_tpu.models import context as jax_context
from soap_tpu.pipeline import engine as jax_engine
from soap_tpu.pipeline import specs as jax_specs
from soap_tpu.utils import mock_data as jax_mock
from soap_tpu_torch.core import halo_types as torch_halo_types
from soap_tpu_torch.models import context as torch_context
from soap_tpu_torch.pipeline import engine as torch_engine
from soap_tpu_torch.pipeline import specs as torch_specs
from soap_tpu_torch.utils import mock_data as torch_mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize(
    "ours,theirs",
    [
        (torch_context.HaloContext, jax_context.HaloContext),
        (torch_engine.HaloTypeSpec, jax_engine.HaloTypeSpec),
    ],
    ids=["HaloContext", "HaloTypeSpec"],
)
def test_dataclass_mirrors_original(ours, theirs):
    assert _fields(ours) == _fields(theirs)


def test_context_helpers_and_ptype_order_match():
    assert torch_context.PTYPE_ORDER == jax_context.PTYPE_ORDER
    kw = dict(a=0.5, z=1.0, G=43.0, boxsize=10.0, critical_density=2.0,
              mean_density=1.0, ptypes=("PartType0", "PartType1"),
              capacities=(128, 256))
    ours, theirs = torch_context.HaloContext(**kw), jax_context.HaloContext(**kw)
    assert ours.segment("PartType1") == theirs.segment("PartType1") == (128, 384)
    assert ours.total_capacity == theirs.total_capacity
    spec = dict(kind="SO", group="SO/200_mean", keys=("r",), so_type="mean",
                so_multiple=200.0)
    assert torch_engine.HaloTypeSpec(**spec).target_density(ours) == \
        jax_engine.HaloTypeSpec(**spec).target_density(theirs)


def test_unit_constants_match():
    for name in ("MPC_CM", "MSUN_G", "UNIT_MASS_G", "UNIT_TIME_S", "G_INTERNAL"):
        assert getattr(torch_mock, name) == getattr(jax_mock, name), name


@pytest.mark.parametrize("seed", [7, 11])
def test_mock_universe_byte_identical(seed):
    kw = dict(n_halos=6, n_field=3000, boxsize=20.0, seed=seed, n_satellites=2)
    ours = torch_mock.build_mock_universe(**kw)
    theirs = jax_mock.build_mock_universe(**kw)
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name == "bound_ids":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


def test_port_imports_no_jax_soap_tpu_or_h5py():
    code = (
        "import sys\n"
        "import soap_tpu_torch.pipeline.engine, soap_tpu_torch.ops.inertia_loop\n"
        "import soap_tpu_torch.pipeline.specs, soap_tpu_torch.utils.mock_data\n"
        "import soap_tpu_torch.ops.kinematics, soap_tpu_torch.core.registry\n"
        "specs = soap_tpu_torch.pipeline.specs.build_specs(None, True, 100.0)\n"
        "assert sum(len(s.keys) for s in specs) == 508\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'soap_tpu', 'h5py')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _json(package, name):
    with open(os.path.join(REPO, *package.split("."), name)) as f:
        return json.load(f)


def test_property_data_mirrors_original():
    assert _json("soap_tpu_torch.core", "halo_type_property_keys.json") == _json(
        "soap_tpu.core", "halo_type_property_keys.json"
    )
    theirs = _json("soap_tpu.core", "property_table.json")["properties"]
    ours = _json("soap_tpu_torch.core", "property_table.json")["properties"]
    assert list(ours) == list(theirs)
    for key, e in theirs.items():
        assert ours[key] == {"name": e["name"], "dmo_property": e["dmo_property"]}, key


@pytest.mark.parametrize(
    "halo_type", ["BoundSubhalo", "SO", "Aperture", "ProjectedAperture"]
)
def test_implemented_dmo_keys_match(halo_type):
    ours = torch_halo_types.implemented_keys_for(halo_type, True)
    assert ours and ours == jax_halo_types.implemented_keys_for(halo_type, True)


def test_build_specs_matches_original():
    ours = torch_specs.build_specs(None, True, 123.5)
    theirs = jax_specs.build_specs(None, True, 123.5)
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in theirs]
    assert (len(ours), sum(len(s.keys) for s in ours)) == (38, 508)
    with pytest.raises(NotImplementedError, match="parameter files"):
        torch_specs.build_specs(object(), True, 123.5)
