"""The port's graft entry (``soap_tpu_torch/graft_entry.py``) against the
root ``__graft_entry__.py``.

- ``entry("cpu")`` builds the JAX entry's example buffers (seed 0, 8 halos
  x 256 rows, drawn in the same order), and its halo function over the
  six DMO calculations gives the JAX entry's function's results on them
  at ``utils/parity.py::key_close`` (one JAX compile per module);
- ``dryrun_multichip`` over four CPU workers runs ``build_catalogue`` at
  two chunks and on the hydro mock, two chunk groups with a satellite
  and the three timed engine configurations.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from soap_tpu_torch import graft_entry
from soap_tpu_torch.utils.parity import key_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker: the default pool oversubscribes the
    cores beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC_KEYS = [(s.group, k) for s in graft_entry._dmo_specs() for k in s.keys]


def _unstack(out):
    """The JAX step's output with each family's stacked members as groups."""
    real = {}
    for group, val in out.items():
        if hasattr(val, "groups"):  # a family of specs, stacked on axis 1
            for i, member in enumerate(val.groups):
                real[member] = {k: np.asarray(a[:, i]) for k, a in val.data.items()}
        else:
            real[group] = {k: np.asarray(a) for k, a in val.items()}
    return real


@pytest.fixture(scope="module")
def entries():
    fn, (parts, scalars) = jax_graft.entry()
    ref = _unstack(jax.jit(fn)(parts, scalars))
    tfn, (tparts, tscalars) = graft_entry.entry("cpu")
    got = tfn(tparts, tscalars)
    return dict(ref=ref, got={g: {k: v.numpy() for k, v in d.items()} for g, d in got.items()},
                jax_args=(parts, scalars), args=(tparts, tscalars))


def test_example_buffers_are_the_jax_entrys(entries):
    (parts, scalars), (tparts, tscalars) = entries["jax_args"], entries["args"]
    for name in parts._fields[:-1]:
        a, b = np.asarray(getattr(parts, name)), getattr(tparts, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in scalars._fields:
        a, b = np.asarray(getattr(scalars, name)), getattr(tscalars, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tparts.pos.shape == (8, 256, 3) and tparts.fields == {}


@pytest.mark.parametrize("group,key", SPEC_KEYS, ids=[f"{g}/{k}" for g, k in SPEC_KEYS])
def test_entry_matches_jax(entries, group, key):
    a, b = entries["ref"][group][key], entries["got"][group][key]
    assert a.shape == b.shape and b.shape[0] == 8, (group, key)
    assert key_close(a, b, key), f"{group}/{key}"


def test_dryrun_multichip_on_four_cpu_workers(capsys):
    out = graft_entry.dryrun_multichip(["cpu"] * 4)
    assert out["devices"] == ["cpu"] * 4
    assert out["n_groups"] == 38 and out["n_hydro_groups"] == 38 and out["n_chunks"] == 2
    assert out["stats"].halos_done == 8
    assert set(out["stats"].shares_by_worker) == {"0@cpu", "1@cpu"}
    assert all(t > 0 for t in out["seconds"].values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("dryrun_multichip OK: 4 devices")
    assert lines[1].startswith("sharded-engine overhead")
