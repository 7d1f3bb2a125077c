"""The port's entry and membership program under the four other halo
finders, against the JAX package's, on the CPU.

A seed-11 DMO mock with two satellite subhalos is written by the JAX
package; its HBTplus halos are written again as a VR catalogue (with its
bound lists), a Gadget-4 tab, an EAGLE SubFind tab and a Rockstar list
(``soap_tpu_torch/utils/mock_finders.py::write_finder_files``, in each
finder's units, same halos in the same order).  Both membership
programs read the VR bound lists: their files are equal dataset for dataset, and every
bound particle has ``Rank_bound`` 0, the reference's fault ported as it
is (VR gives no rank).  Both ``compute_halo_properties`` then run each
finder's catalogue on that membership with one reduced spec list
(``tests/test_torch_entry_jax.py``'s groups without the non-iterative
inertia tensors, which the JAX engine sums in float32): the catalogues
hold the same datasets (no ``SOAP/*`` or ``FOF/*``: those need an
HBTplus catalogue), equal passthrough and integer columns, and floats
within ``utils/parity.py``'s tolerances, also under
``soap_tpu.tools.compare.compare_catalogues``.  Each finder's property
groups equal the port's run on the HBTplus catalogue itself (as
``chip_smoke.py`` phase 17 holds them on the card), and the port's VR
run over two chunks equals its one-chunk run.
"""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

from soap_tpu.pipeline.membership import run_group_membership as jax_membership
from soap_tpu.pipeline.run import compute_halo_properties as jax_compute
from soap_tpu.pipeline.specs import build_specs as jax_build_specs
from soap_tpu.tools.compare import compare_catalogues
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.io.catalogue_writer import read_catalogue
from soap_tpu_torch.io.halo_catalogue import read_hbtplus_catalogue, read_hbtplus_groupnr
from soap_tpu_torch.pipeline import membership, run
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils import mock_finders
from soap_tpu_torch.utils.parity import LOOSE_ATOL, RTOL, catalogue_differences

FINDERS = ("VR", "Gadget4", "SubfindEagle", "Rockstar")
GROUPS = ("BoundSubhalo", "SO/200_crit", "ExclusiveSphere/50kpc",
          "ProjectedAperture/50kpc/projz")
#: each finder's passthrough columns in the catalogue
PASSTHROUGH = {
    "VR": ("VR/ID", "VR/StructureType", "VR/HostHaloID", "VR/NumberOfSubstructures"),
    "Gadget4": (),
    "SubfindEagle": ("SubFind/GroupNumber", "SubFind/SubGroupNumber"),
    "Rockstar": (),
}


def _specs(build):
    """The reduced list without the non-iterative inertia tensors."""
    table = full_property_table()
    return [dataclasses.replace(s, keys=tuple(k for k in s.keys
                                              if "Noniterative" not in table[k].name))
            for s in build(None, True, 100.0) if s.group in GROUPS]


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("finder_entry"))
    sim = make_mock_simulation(tmp, n_halos=8, n_field=5000, boxsize=20.0, seed=11,
                               n_satellites=2)
    uni = sim["universe"]
    hbt = read_hbtplus_catalogue(sim["hbt_basename"], h=uni.h)
    ids_bound = read_hbtplus_groupnr(sim["hbt_basename"])[1]
    basenames = mock_finders.write_finder_files(tmp, hbt, uni.h, uni.a, ids_bound)
    mem = {name: os.path.join(tmp, f"membership_vr_{name}.hdf5") for name in ("jax", "port")}
    jax_membership(sim["snapshot"], basenames["VR"], mem["jax"], halo_format="VR")
    membership.run_group_membership(sim["snapshot"], basenames["VR"], mem["port"],
                                    halo_format="VR")
    basenames["HBTplus"] = sim["hbt_basename"]
    return dict(sim, tmp=tmp, hbt=hbt, basenames=basenames, membership=mem, runs={})


def _entry(sim, name, finder, **kw):
    """One package's entry on ``finder``'s catalogue (cached per module)."""
    key = (name, finder, tuple(sorted(kw.items())))
    if key not in sim["runs"]:
        path = os.path.join(sim["tmp"], f"{name}_{finder}_{len(sim['runs'])}.hdf5")
        common = dict(snapshot_file=sim["snapshot"], membership_file=sim["membership"]["port"],
                      halo_basename=sim["basenames"][finder], output_file=path,
                      halo_format=finder, dmo=True, verbose=False)
        if name == "jax":
            with pytest.MonkeyPatch.context() as mp:
                # the JAX engine gathers into the range layout the port
                # uses, and runs its inertia kernel as its tests do here
                mp.setenv("SOAP_TPU_DMA_GATHER", "1")
                mp.setenv("SOAP_TPU_PALLAS_INERTIA", "interpret")
                out = jax_compute(specs=_specs(jax_build_specs), **common)
        else:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                out = run.compute_halo_properties(specs=_specs(build_specs), device="cpu",
                                                  **common, **kw)
            finally:
                torch.set_num_threads(threads)
        sim["runs"][key] = (out, path)
    return sim["runs"][key]


def test_vr_membership_matches_jax(sim):
    """Both programs' VR membership files are equal; every bound particle
    has Rank_bound 0 (VR gives no rank), the same GroupNr_bound as the
    HBTplus bound lists of the same halos."""
    files = {name: h5py.File(path, "r") for name, path in sim["membership"].items()}
    try:
        names = {}
        for name, f in files.items():
            names[name] = []
            f.visititems(lambda n, o, acc=names[name]: acc.append(n)
                         if isinstance(o, h5py.Dataset) else None)
        assert names["port"] == names["jax"] and "PartType1/Rank_bound" in names["port"]
        for n in names["jax"]:
            a, b = files["port"][n], files["jax"][n]
            assert a.dtype == b.dtype and a.shape == b.shape, n
            assert np.array_equal(a[...], b[...]), n
            assert sorted(a.attrs) == sorted(b.attrs), n
        grnr = files["port"]["PartType1/GroupNr_bound"][...]
        rank = files["port"]["PartType1/Rank_bound"][...]
    finally:
        for f in files.values():
            f.close()
    bound = grnr >= 0
    assert bound.sum() == int(sim["hbt"].nr_bound_part.sum())
    assert (rank[bound] == 0).all() and (rank[~bound] == -1).all()
    ids_h, grnr_h = read_hbtplus_groupnr(sim["hbt_basename"])[1:3]
    with h5py.File(sim["snapshot"], "r") as f:
        snap_ids = f["PartType1/ParticleIDs"][...]
    hbt_grnr = membership.compute_membership(snap_ids, ids_h, grnr_h)[0]
    assert np.array_equal(grnr, hbt_grnr)


@pytest.mark.parametrize("finder", FINDERS)
def test_entry_matches_jax(sim, finder):
    ours_out, ours = _entry(sim, "port", finder)
    theirs_out, theirs = _entry(sim, "jax", finder)
    a, b = read_catalogue(ours), read_catalogue(theirs)
    assert catalogue_differences(b, a) == []
    np.testing.assert_array_equal(ours_out.order, theirs_out.order)
    assert not [p for p in a.datasets if p.split("/")[0] in ("SOAP", "FOF", "HBTplus")]
    for column in PASSTHROUGH[finder]:
        assert column in a.datasets, column
    assert a.groups["Parameters"]["halo_format"] == finder
    assert a.n_halos == sim["hbt"].nr_halos
    res = compare_catalogues(theirs, ours, use_compression_tolerance=False, rtol=RTOL,
                             scale_atol=LOOSE_ATOL)
    assert res.identical and res.n_compared > 60, res.report()


@pytest.mark.parametrize("finder", FINDERS)
def test_property_groups_match_hbtplus(sim, finder):
    """The same halos under another finder give the HBTplus run's
    property groups (on the same membership file), bit for bit where the
    finder's fields give the centres exactly (Gadget-4 and EAGLE here)."""
    hbt_out, hbt = _entry(sim, "port", "HBTplus")
    out, path = _entry(sim, "port", finder)
    ref, got = read_catalogue(hbt), read_catalogue(path)
    groups = ("BoundSubhalo", "SO", "ExclusiveSphere", "ProjectedAperture")
    assert catalogue_differences(ref, got, groups=groups) == []
    assert catalogue_differences(ref, got) != []  # InputHalos and SOAP/* differ
    np.testing.assert_array_equal(out.order, hbt_out.order)
    if finder in ("Gadget4", "SubfindEagle"):
        for p, ds in ref.datasets.items():
            if p.split("/")[0] in groups:
                assert np.array_equal(ds.data, got.datasets[p].data), p


def test_vr_two_chunks_equal_one_chunk(sim):
    one = read_catalogue(_entry(sim, "port", "VR")[1])
    out, path = _entry(sim, "port", "VR", nr_chunks=2)
    assert len(out.chunks) == 2
    assert catalogue_differences(one, read_catalogue(path)) == []
