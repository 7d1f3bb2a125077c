"""The frozen input builder: the same seed draws the same universe, every
seed the same halos, and the port's inputs match the schema."""

import numpy as np
import pytest

from halobench import inputs
from halobench import universe as U
from halobench.tests.conftest import tiny_plan

SEEDS = (5, 2**33 + 1)


@pytest.mark.parametrize("workload", ["dmo.hbt.chunk1", "flamingo.hbt.chunk1"])
def test_same_seed_same_universe(workload):
    plan = tiny_plan(workload)
    a = U.build_universe(plan["config"], plan["traffic"], SEEDS[1])
    b = U.build_universe(plan["config"], plan["traffic"], SEEDS[1])
    assert sorted(a.ptypes) == sorted(b.ptypes)
    for pt in a.ptypes:
        for name, arr in a.ptypes[pt].items():
            assert np.array_equal(arr, b.ptypes[pt][name]), (pt, name)
    assert np.array_equal(a.halo_centre, b.halo_centre)


@pytest.mark.parametrize("workload", ["dmo.hbt.chunk1", "flamingo.hbt.chunk1"])
def test_every_seed_same_halos(workload):
    plan = tiny_plan(workload)
    a, b = (U.build_universe(plan["config"], plan["traffic"], s) for s in SEEDS)
    assert np.array_equal(a.halo_nbound, b.halo_nbound)
    for pt in a.ptypes:
        assert len(a.ptypes[pt]["Masses"]) == len(b.ptypes[pt]["Masses"])
        ga, gb = a.ptypes[pt]["GroupNr_bound"], b.ptypes[pt]["GroupNr_bound"]
        assert np.array_equal(np.bincount(ga + 1), np.bincount(gb + 1))
    # the same places, the velocities drawn anew
    assert np.array_equal(a.halo_centre, b.halo_centre)
    for pt in a.ptypes:
        assert np.array_equal(a.ptypes[pt]["Coordinates"], b.ptypes[pt]["Coordinates"])
    va, vb = a.ptypes[U.PTYPE_DM]["Velocities"], b.ptypes[U.PTYPE_DM]["Velocities"]
    assert not np.array_equal(va, vb)
    m200, _, npart = U.halo_population(plan["traffic"], plan["config"])
    assert np.all(np.diff(m200) < 0) and npart.min() >= 32


def test_mass_function_quantiles_and_field():
    plan = tiny_plan("dmo.hbt.chunk1")
    cfg, traffic = plan["config"], plan["traffic"]
    M, dn = U.mass_function(traffic, cfg)
    m, conc, npart = U.halo_population(traffic, cfg)
    lo = traffic["min_particles"] * cfg["particle_mass"]
    # as many halos as the function expects in the box, each at a fixed
    # quantile: the expected count above the i-th mass is i + 1/2
    lnM = np.log(M)
    V = traffic["boxsize"] ** 3

    def above(x):
        sel = M >= x
        return V * np.trapezoid(dn[sel], lnM[sel])

    assert len(m) == round(above(lo)) and len(m) > 10
    for i in (0, len(m) // 2, len(m) - 1):
        assert above(m[i]) == pytest.approx(i + 0.5, rel=2e-2, abs=0.05)
    assert np.all(np.diff(m) < 0) and npart.min() >= traffic["min_particles"]
    assert np.array_equal(npart, np.maximum(np.rint(m / cfg["particle_mass"]), 32).astype(np.int64))
    assert np.all((conc >= 4.0) & (conc <= 10.0))
    # the field holds the rest of the box's mean matter density
    field = U.field_counts(traffic, cfg, {U.PTYPE_DM: npart})
    total = U.mean_matter_density(cfg) * V / cfg["particle_mass"]
    assert abs(field[U.PTYPE_DM] + npart.sum() - total) <= 1
    # sigma_8 normalises the spectrum: halos of ~1e14 Msun/h are rare
    assert 1e-6 < np.interp(np.log(1e4 / cfg["cosmology"]["h"]), lnM, dn) < 1e-4


def test_hydro_field_gas():
    plan = tiny_plan("flamingo.hbt.chunk1")
    cfg, traffic = plan["config"], plan["traffic"]
    uni = U.build_universe(cfg, traffic, 3)
    gas = uni.ptypes[U.PTYPE_GAS]["GroupNr_bound"]
    dm = uni.ptypes[U.PTYPE_DM]["GroupNr_bound"]
    assert (gas < 0).sum() == pytest.approx(cfg["gas_fraction"] * (dm < 0).sum(), abs=1)


def test_schema_and_port_inputs():
    plan = tiny_plan("flamingo.hbt.chunk1")
    cfg, traffic = plan["config"], plan["traffic"]
    uni = U.build_universe(cfg, traffic, 9)
    layout = U.schema(cfg, traffic)
    assert sorted(layout) == sorted(uni.ptypes)
    for pt, lay in layout.items():
        assert lay["count"] == len(uni.ptypes[pt]["Coordinates"])
        for name, shape in lay["datasets"].items():
            assert uni.ptypes[pt][name].shape[1:] == shape, (pt, name)
        pos = uni.ptypes[pt]["Coordinates"]
        assert pos.dtype == np.float64 and pos.min() >= 0 and pos.max() < traffic["boxsize"]
    # bound particles per halo, as the catalogue states them
    nb = sum(np.bincount(d["GroupNr_bound"][d["GroupNr_bound"] >= 0], minlength=uni.n_halos)
             for d in uni.ptypes.values())
    assert np.array_equal(nb, uni.halo_nbound)
    meta = inputs.snapshot_info(cfg, traffic)
    assert int(meta.dimension[0]) == traffic["cells_per_side"] and meta.boxsize == traffic["boxsize"]


def test_pass_shift_moves_by_whole_cells():
    pos = np.array([[0.5, 19.9, 10.0]])
    s = U.pass_shift(3, 0, 4)
    assert np.all((s >= 1) & (s <= 3))
    moved = U.shifted(pos, s, 20.0, 4)
    assert np.allclose(np.mod(moved - pos, 5.0), 0.0, atol=1e-12) or np.allclose(
        np.mod(moved - pos + 1e-9, 5.0), 1e-9, atol=1e-9)
    assert not np.array_equal(U.pass_shift(3, 0, 4), U.pass_shift(3, 1, 4)) or \
        not np.array_equal(U.pass_shift(3, 1, 4), U.pass_shift(3, 2, 4))
