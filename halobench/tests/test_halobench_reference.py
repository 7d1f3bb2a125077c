"""The plain reference against values worked out by hand."""

import math

import numpy as np
import pytest

from halobench import reference as R
from halobench import universe as U

COSMO = dict(a=1.0, h=0.681, omega_m=0.306, omega_b=0.0486)


def test_half_mass_radius():
    r = np.array([3.0, 1.0, 2.0, 4.0])
    m = np.ones(4)
    # half of 4 is reached at the second particle (r = 2) exactly
    assert R.half_mass_radius(r, m) == 2.0
    # 3 particles: half (1.5) lies between r = 1 (cum 1) and r = 2 (cum 2)
    assert R.half_mass_radius(np.array([1.0, 2.0, 3.0]), np.ones(3)) == pytest.approx(1.5)


def test_so_radius_of_a_uniform_ball_and_a_point():
    rho = 10.0
    # a heavy point at r ~ 0 (skipped first row) and light shells: the
    # mean density crosses rho where 4/3 pi rho R^3 equals the mass
    r = np.array([0.0, 0.5, 1.0, 2.0, 3.0])
    m = np.array([100.0, 1.0, 1.0, 1.0, 1.0])
    R_so, M_so = R.so_solve(r, m, rho)
    # crossing between r = 1 (cum 102) and r = 2 (cum 103)
    f = lambda x: R.FOUR_PI_3 * rho * x**3 - (102.0 + (x - 1.0))
    assert 1.0 < R_so < 2.0 and abs(f(R_so)) < 1e-9
    assert M_so == pytest.approx(R.FOUR_PI_3 * rho * R_so**3)
    # a profile that starts below the threshold grows linearly from zero
    R_b, M_b = R.so_solve(np.array([0.0, 10.0]), np.array([1.0, 1.0]), rho)
    assert R_b == pytest.approx(math.sqrt(0.75 * 2.0 / (math.pi * 10.0 * rho)))
    assert M_b == pytest.approx(2.0 * R_b / 10.0)


def test_inertia_tensor_of_an_axis_aligned_cloud():
    # points on the axes at +-1, +-2, +-3: a diagonal tensor
    x = np.array([[s * 1.0, 0, 0] for s in (1, -1)] + [[0, s * 2.0, 0] for s in (1, -1)]
                 + [[0, 0, s * 3.0] for s in (1, -1)] * 1)
    x = np.repeat(x, 4, axis=0)  # 24 particles, over the 20 needed
    m = np.ones(len(x))
    t = R.inertia_tensor(m, x, R=100.0, max_iterations=1)
    assert np.allclose(t, [8 / 24, 32 / 24, 72 / 24, 0, 0, 0])
    assert np.all(R.inertia_tensor(m[:10], x[:10], R=100.0) == 0)  # under 20 particles


def test_threshold_densities():
    rc = U.critical_density(COSMO["h"], COSMO["omega_m"], 1.0)
    assert R.threshold_density({"type": "crit", "value": 200.0}, COSMO) == pytest.approx(200 * rc)
    assert R.threshold_density({"type": "mean", "value": 200.0}, COSMO) == pytest.approx(
        200 * COSMO["omega_m"] * rc)


def _halo():
    # four bound dark matter particles about the centre, one field particle
    rel = np.array([[0.01, 0, 0], [-0.01, 0, 0], [0, 0.02, 0], [0, 0, -0.03], [0.2, 0, 0]])
    return R.HaloData(
        centre=np.array([5.0, 5.0, 5.0]), rel=rel, r=np.sqrt((rel**2).sum(1)),
        m=np.array([1.0, 1.0, 1.0, 1.0, 2.0]), v=np.array([[1.0, 0, 0]] * 4 + [[0, 0, 0]]),
        t=np.full(5, 1), bound=np.array([True] * 4 + [False]), fields={})


REF = dict(particle_types=["PartType1"], hydro=False, band=1e-5,
           so=[{"group": "SO/200_crit", "type": "crit", "value": 200.0}],
           apertures=[{"group": "ExclusiveSphere/50kpc", "radius_kpc": 50.0, "inclusive": False},
                      {"group": "InclusiveSphere/300kpc", "radius_kpc": 300.0, "inclusive": True}],
           inertia=[{"key": "TotalInertiaTensor", "types": ["PartType1"]}],
           filters={}, categories={}, group_filters={}, boxsize=10.0,
           numbers=["bound_count_gap", "aperture_count_gap", "mass_gap", "so_gap",
                    "centre_gap", "halfmass_gap", "inertia_gap", "mask_wrong"])


def test_answers_of_a_small_halo():
    ans = R.answers(_halo(), REF, COSMO)
    assert ans["BoundSubhalo/NumberOfDarkMatterParticles"] == 4
    assert ans["BoundSubhalo/TotalMass"] == 4.0
    assert np.allclose(ans["BoundSubhalo/CentreOfMass"], [5.0, 5.0 + 0.005, 5.0 - 0.0075])
    assert np.allclose(ans["BoundSubhalo/CentreOfMassVelocity"], [1.0, 0, 0])
    # radii 0.01, 0.01, 0.02, 0.03: half (2) reached at the second, r = 0.01
    assert ans["BoundSubhalo/HalfMassRadiusTotal"] == pytest.approx(0.01)
    assert ans["ExclusiveSphere/50kpc/TotalMass"] == 4.0
    assert ans["InclusiveSphere/300kpc/TotalMass"] == 6.0
    assert ans["InclusiveSphere/300kpc/NumberOfDarkMatterParticles"] == 5
    assert set(ans) == set(R.answer_paths(REF))


def test_judge_reads_the_reference_as_correct_and_a_change_as_wrong():
    hd = _halo()
    ans = R.answers(hd, REF, COSMO)
    assert all(v <= 1e-12 for v in R.judge(ans, ans, hd, REF, COSMO).values())
    bad = dict(ans, **{"BoundSubhalo/TotalMass": 4.004})
    assert R.judge(bad, ans, hd, REF, COSMO)["mass_gap"] == pytest.approx(1e-3)
    bad = dict(ans, **{"InclusiveSphere/300kpc/NumberOfDarkMatterParticles": 4})
    assert R.judge(bad, ans, hd, REF, COSMO)["aperture_count_gap"] == 1
    bad = dict(ans, **{"BoundSubhalo/NumberOfDarkMatterParticles": 3})
    assert R.judge(bad, ans, hd, REF, COSMO)["bound_count_gap"] == 1


def test_sort_order_by_cell_then_index():
    centres = np.array([[6.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.5, 1.0, 1.0], [9.9, 9.9, 9.9]])
    assert list(R.sort_order(centres, 10.0, 2)) == [1, 2, 0, 3]
