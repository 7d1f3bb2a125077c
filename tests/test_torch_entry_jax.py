"""The port's entry against the JAX entry, file for file, on the CPU.

Both ``compute_halo_properties`` run on the written seed-11 DMO mock (the
JAX end-to-end test's) with the same reduced spec list: BoundSubhalo,
SO/200_crit, one exclusive sphere and one projected aperture, the
previous snapshot's catalogue (the same file, so every track matches), a
missing next one, and a SWIFT FOF file.  The JAX engine runs as the
engine parity tests run it: the port's range layout
(``SOAP_TPU_DMA_GATHER=1``) and its Pallas inertia kernel in interpret
mode.  The two catalogues hold the same groups, datasets, dtypes,
shapes and attributes (time stamps apart), equal integer, sort-order,
``InputHalos/*``, ``SOAP/*`` and ``FOF/*`` columns, and floats within
``utils/parity.py``'s tolerances.

The one exception is the eight non-iterative inertia tensors: the JAX
engine sums their moments in float32, which over this mock's ~4600
bound particles per halo drifts by up to 1.46e-4 of each dataset's
scale (the port sums in float64).  Those are held instead to a float64
recomputation from the particles, at their class's tolerance, and the
JAX values' larger distance from it is asserted.
"""

import os

import h5py
import numpy as np
import pytest

from soap_tpu.pipeline.membership import run_group_membership
from soap_tpu.pipeline.run import compute_halo_properties as jax_compute
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch.io.catalogue_writer import read_catalogue
from soap_tpu_torch.pipeline import run
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils.parity import catalogue_differences

GROUPS = ("BoundSubhalo", "SO/200_crit", "ExclusiveSphere/50kpc",
          "ProjectedAperture/50kpc/projz")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("entry_jax"))
    sim = make_mock_simulation(tmp, n_halos=8, n_field=5000, boxsize=20.0, seed=11)
    membership = os.path.join(tmp, "membership_0077.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], membership)
    uni = sim["universe"]
    hosts = np.unique(uni.halo_host[(uni.halo_rank == 0) & (uni.halo_host >= 0)])
    rng = np.random.default_rng(3)
    fof = os.path.join(tmp, "fof_output_0077.hdf5")
    with h5py.File(fof, "w") as f:
        ids = rng.permutation(np.concatenate([hosts, [10**6, 10**6 + 1]]))
        f.create_dataset("Groups/GroupIDs", data=ids)
        f.create_dataset("Groups/Centres", data=rng.random((len(ids), 3)) * 20.0)
        f.create_dataset("Groups/Masses", data=rng.random(len(ids)))
        f.create_dataset("Groups/Sizes", data=rng.integers(10, 1000, len(ids)))
    common = dict(
        snapshot_file=sim["snapshot"], membership_file=membership,
        halo_basename=sim["hbt_basename"], dmo=True,
        prev_halo_basename=sim["hbt_basename"],
        next_halo_basename=os.path.join(tmp, "SubSnap_078"), fof_filename=fof,
        verbose=False,
    )
    out = {}
    for name, compute, builder in (("jax", jax_compute, jax_build_specs),
                                   ("port", run.compute_halo_properties, build_specs)):
        specs = [s for s in builder(None, True, 100.0) if s.group in GROUPS]
        assert [s.group for s in specs] == list(GROUPS)
        kw = dict(device="cpu") if name == "port" else {}
        path = os.path.join(tmp, f"{name}.hdf5")
        with pytest.MonkeyPatch.context() as mp:
            # the JAX engine gathers into the range layout the port uses,
            # and runs its inertia kernel as its own tests do on the CPU
            mp.setenv("SOAP_TPU_DMA_GATHER", "1")
            mp.setenv("SOAP_TPU_PALLAS_INERTIA", "interpret")
            out[name] = (compute(output_file=path, specs=specs, **common, **kw), path)
    out["universe"] = uni
    return out


#: the datasets whose JAX reference sums in float32 (see the docstring)
NONITERATIVE = tuple(
    f"{g}/{sp}InertiaTensor{red}Noniterative"
    for g in GROUPS[:2] for sp in ("Total", "DarkMatter") for red in ("", "Reduced")
)


def test_catalogue_matches_jax(both):
    ours = read_catalogue(both["port"][1])
    theirs = read_catalogue(both["jax"][1])
    differing = catalogue_differences(theirs, ours)
    assert all(d.split(" ")[0] in NONITERATIVE for d in differing), differing
    for name in ("SOAP/HostHaloIndex", "SOAP/SubhaloRankByBoundMass", "SOAP/ProgenitorIndex",
                 "SOAP/DescendantIndex", "FOF/Centres", "FOF/Sizes"):
        assert name in ours.datasets, name
    assert (ours.datasets["SOAP/ProgenitorIndex"].data == np.arange(8)).all()
    assert (ours.datasets["SOAP/DescendantIndex"].data == -1).all()
    assert sum(p.split("/")[0] in GROUPS[0] for p in ours.datasets) > 10


def test_sort_and_results_match_jax(both):
    ours, theirs = both["port"][0], both["jax"][0]
    assert ours.order.dtype == theirs.order.dtype
    np.testing.assert_array_equal(ours.order, theirs.order)
    assert list(ours.results) == list(theirs.results)
    for group, props in theirs.results.items():
        assert list(ours.results[group]) == list(props), group
    assert ours.output_path == both["port"][1]


def test_stamps_are_fields(both):
    """The time stamps and git hash come back as the catalogue's fields,
    so the comparison leaves them out."""
    ours = read_catalogue(both["port"][1])
    assert len(ours.date) == 19 and ours.snapshot_date.endswith(" GMT")
    assert "SOAP date" not in ours.groups["Header"]
    assert "Date" not in ours.groups["Code"]


def _oracle(uni, cat, results, group, key):
    """A non-iterative inertia tensor in float64 from the particles: the
    bound particles within 10 half-mass radii (BoundSubhalo) or every
    particle within the SO radius (reduced: none at the centre), moments
    over the selected mass (divided by r^2 when reduced), as [xx, yy,
    zz, xy, xz, yz]."""
    box = uni.boxsize
    id_to_row = np.empty(int(uni.ids.max()) + 1, np.int64)
    id_to_row[uni.ids] = np.arange(len(uni.ids))
    out = np.zeros((cat.nr_halos, 6))
    for h in range(cat.nr_halos):
        if group == "BoundSubhalo":
            rows = id_to_row[np.asarray(uni.bound_ids[cat.index[h]])]
            radius = 10.0 * float(results[group]["HalfMassRadiusTot"][h])
        else:
            rows = np.arange(len(uni.pos))
            radius = float(results[group]["r"][h])
        x = np.mod(uni.pos[rows] - cat.cofp[h] + 0.5 * box, box) - 0.5 * box
        r2 = (x * x).sum(1)
        # no particle so near the sphere that float32 could flip it
        assert not (np.abs(np.sqrt(r2) / radius - 1.0) < 1e-5).any()
        sel = r2 <= radius * radius
        if "Reduced" in key:  # a particle at the centre has no 1/r^2
            sel &= r2 > 1e-8
        m = uni.mass[rows][sel].astype(np.float64)
        w = m / r2[sel] if "Reduced" in key else m
        t = np.einsum("n,ni,nj->ij", w, x[sel], x[sel]) / m.sum()
        out[h] = [t[0, 0], t[1, 1], t[2, 2], t[0, 1], t[0, 2], t[1, 2]]
    return out


@pytest.mark.parametrize("name", NONITERATIVE)
def test_noniterative_inertia_against_float64(both, name):
    """The port's non-iterative tensors within their class of a float64
    recomputation; the JAX reference's float32 sums further from it."""
    from soap_tpu_torch.utils.parity import key_close, scaled_error

    group, key = name.rsplit("/", 1)
    ours, theirs = both["port"][0], both["jax"][0]
    ref = _oracle(both["universe"], ours.halos, ours.results, group, key)
    assert key_close(ref, ours.results[group][key], key), scaled_error(
        ref, ours.results[group][key])
    assert scaled_error(ref, theirs.results[group][key]) > scaled_error(
        ref, ours.results[group][key])
