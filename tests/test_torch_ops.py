"""The port's leaf ops against their jnp twins on the same numpy inputs.

Integer results must be equal, f32 results within rtol 1e-6.  The two
frameworks sum in different orders, so a sum whose terms cancel also
gets an absolute tolerance of 1e-6 times the sum of its terms' sizes,
and the SO mass, which goes as r^3, three times the radius tolerance.
The jnp functions are written for one halo and run here under
``jax.vmap``; the port's take the halo axis explicitly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap_tpu.ops import geometry as jgeo
from soap_tpu.ops import grid as jgrid
from soap_tpu.ops import kinematics as jkin
from soap_tpu.ops import radii as jradii
from soap_tpu.ops import reductions as jred
from soap_tpu.ops import so_radius as jso
from soap_tpu_torch.ops import geometry as tgeo
from soap_tpu_torch.ops import grid as tgrid
from soap_tpu_torch.ops import kinematics as tkin
from soap_tpu_torch.ops import radii as tradii
from soap_tpu_torch.ops import reductions as tred
from soap_tpu_torch.ops import so_radius as tso

RTOL = 1e-6


def _close(ours, theirs, atol=0.0):
    a = np.asarray(theirs)
    b = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert a.shape == b.shape
    if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
        np.testing.assert_array_equal(b, a)
    else:
        err = np.abs(b.astype(np.float64) - a)
        bad = ~(err <= atol + RTOL * np.abs(a))
        assert not bad.any(), (a[bad], b[bad])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_periodic_offset(seed):
    rng = np.random.default_rng(seed)
    box = 50.0
    pos = rng.uniform(0, box, (5, 40, 3))
    centre = rng.uniform(0, box, (5, 3))
    ph, pl = jgeo.split_hi_lo(pos.reshape(-1, 3))
    ch, cl = jgeo.split_hi_lo(centre)
    ph, pl = ph.reshape(pos.shape), pl.reshape(pos.shape)
    th, tl = tgeo.split_hi_lo(centre)
    np.testing.assert_array_equal(th, ch)
    np.testing.assert_array_equal(tl, cl)
    theirs = jax.vmap(lambda a, b, c, d: jgeo.periodic_offset(a, b, c, d, box))(
        ph, pl, ch, cl
    )
    ours = tgeo.periodic_offset(
        *(torch.from_numpy(x) for x in (ph, pl, ch[:, None], cl[:, None])), box
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize(
    "periodic,cube", [(True, 3), (True, 5), (True, 13), (False, 5)]
)
def test_halo_cell_ranges(periodic, cube):
    rng = np.random.default_rng(cube)
    dims = (8, 8, 8)
    spec_kw = dict(origin=(0.0, 0.0, 0.0), cell_size=(1.25, 1.25, 1.25),
                   dims=dims, periodic=periodic)
    counts = rng.integers(0, 9, 512).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    # centres near the box edges exercise the periodic wrap
    centre = rng.uniform(-0.5, 10.5, (7, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 3.0, 7).astype(np.float32)
    jspec = jgrid.GridSpec(**spec_kw)
    s_j, c_j = jax.vmap(
        lambda c, r: jgrid.halo_cell_ranges(
            jspec, jnp.asarray(offsets), jnp.asarray(counts), c, r, cube)
    )(centre, radius)
    s_t, c_t = tgrid.halo_cell_ranges(
        tgrid.GridSpec(**spec_kw), torch.from_numpy(offsets),
        torch.from_numpy(counts), torch.from_numpy(centre),
        torch.from_numpy(radius), cube,
    )
    _close(s_t, s_j)
    _close(c_t, c_j)


def _profile(seed, B=6, K=300):
    """Radius-sorted padded profiles with gaps, an r=0 first row per
    halo and invalid tail rows (radius key inf)."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.gamma(2.0, 0.3, (B, K)).astype(np.float32), axis=1)
    r[:, 0] = 0.0
    m = rng.lognormal(0.0, 0.2, (B, K)).astype(np.float32)
    n_valid = rng.integers(K // 2, K, B)
    v = np.arange(K)[None, :] < n_valid[:, None]
    r = np.where(v, r, np.inf).astype(np.float32)
    sel = v & (rng.random((B, K)) < 0.8)
    return r, m, v, sel


@pytest.mark.parametrize("seed", [3, 4])
def test_reductions(seed):
    rng = np.random.default_rng(seed)
    B, K = 5, 200
    mass = rng.lognormal(0, 0.3, (B, K)).astype(np.float32)
    pos = rng.normal(size=(B, K, 3)).astype(np.float32)
    vel = rng.normal(0, 100, (B, K, 3)).astype(np.float32)
    mask = rng.random((B, K)) < 0.7
    mask[0] = False  # empty selection
    t = {k: torch.from_numpy(x) for k, x in
         dict(mass=mass, pos=pos, vel=vel, mask=mask).items()}
    m = np.where(mask, mass, 0)

    def term_scale(x):  # sum of |terms| of a masked (mass-weighted) sum
        return RTOL * np.abs(x).sum(1)

    _close(tred.masked_sum(t["mass"], t["mask"]), jax.vmap(jred.masked_sum)(mass, mask))
    _close(
        tred.masked_sum(t["pos"], t["mask"]),
        jax.vmap(jred.masked_sum)(pos, mask),
        atol=term_scale(np.where(mask[..., None], pos, 0)),
    )
    _close(tred.masked_count(t["mask"]), jax.vmap(jred.masked_count)(mask))
    mt_t, com_t = tred.centre_of_mass(t["mass"], t["pos"], t["mask"])
    mt_j, com_j = jax.vmap(jred.centre_of_mass)(mass, pos, mask)
    mtot = np.maximum(m.sum(1), 1e-37)[:, None]
    _close(mt_t, mt_j)
    _close(com_t, com_j, atol=term_scale(m[..., None] * pos) / mtot)
    _close(
        tred.centre_of_mass_velocity(t["mass"], t["vel"], t["mask"]),
        jax.vmap(jred.centre_of_mass_velocity)(mass, vel, mask),
        atol=term_scale(m[..., None] * vel) / mtot,
    )


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_half_weight_radius_sorted(seed):
    r, m, v, sel = _profile(seed)
    total = np.where(sel, m, 0).sum(1).astype(np.float32)
    total[1] = 0.0  # no weight: radius 0
    sel[2] = False
    theirs = jax.vmap(jradii.half_weight_radius_sorted)(r, m, sel, total)
    ours = tradii.half_weight_radius_sorted(
        *(torch.from_numpy(x) for x in (r, m, sel, total))
    )
    _close(ours, theirs)


@pytest.mark.parametrize("seed,nu", [(8, 0.0), (9, 0.0), (10, 0.05)])
def test_so_radius_sorted(seed, nu):
    r, m, v, _ = _profile(seed, B=8)
    # thresholds spanning crossing, start-below and no-crossing cases
    K = r.shape[1]
    dens = np.cumsum(m, 1) / (4.0 / 3.0 * np.pi * r**3 + 1e-30)
    ref = np.array(
        [np.median(dens[b, 1:K // 2]) for b in range(r.shape[0])], np.float32
    )
    ref[0] = 1e-6  # never crossed inside: needs_bigger
    ref[1] = 1e9  # below from the start: linear extrapolation
    theirs = jax.vmap(lambda a, b, c, d: jso.so_radius_sorted(
        a, b, c, d, jnp.float32(nu)))(r, m, v, ref)
    ours = tso.so_radius_sorted(
        *(torch.from_numpy(x) for x in (r, m, v, ref)), nu
    )
    for field in ("found", "needs_bigger", "radius"):
        _close(getattr(ours, field), getattr(theirs, field))
    np.testing.assert_allclose(
        ours.mass.numpy(), np.asarray(theirs.mass), rtol=3 * RTOL
    )
    assert bool(ours.needs_bigger[0]) and bool(ours.found[1])


@pytest.mark.parametrize("seed", [11, 12])
def test_enclosed_mass_sorted(seed):
    r, m, v, _ = _profile(seed)
    target = np.array([0.0, 0.05, 0.3, 0.6, 1.0, 50.0], np.float32)
    theirs = jax.vmap(lambda a, b, c, d: jso.enclosed_mass_sorted(
        a, b, c, d, jnp.float32(0.0)))(r, m, v, target)
    ours = tso.enclosed_mass_sorted(
        *(torch.from_numpy(x) for x in (r, m, v, target)), 0.0
    )
    _close(ours, theirs)


@pytest.mark.parametrize("seed", [13, 14])
def test_velocity_dispersion_and_enclose_radius(seed):
    rng = np.random.default_rng(seed)
    B, K = 5, 200
    mass = rng.lognormal(0, 0.3, (B, K)).astype(np.float32)
    vel = rng.normal(0, 100, (B, K, 3)).astype(np.float32)
    vcom = rng.normal(0, 10, (B, 3)).astype(np.float32)
    radius = rng.gamma(2.0, 0.3, (B, K)).astype(np.float32)
    mask = rng.random((B, K)) < 0.7
    mask[0] = False
    t = [torch.from_numpy(x) for x in (mass, vel, vcom, mask)]
    theirs = jax.vmap(jred.velocity_dispersion_matrix)(mass, vel, vcom, mask)
    dv = np.where(mask[..., None], vel - vcom[:, None], 0.0)
    _close(tred.velocity_dispersion_matrix(*t), theirs,
           atol=RTOL * (np.abs(dv).max(1) ** 2).max(1)[:, None])
    _close(
        tradii.enclose_radius(torch.from_numpy(radius), torch.from_numpy(mask)),
        jax.vmap(jradii.enclose_radius)(radius, mask),
    )


@pytest.mark.parametrize("seed", [17, 18])
def test_kinematics(seed):
    rng = np.random.default_rng(seed)
    B, K = 5, 300
    mass = rng.lognormal(0, 0.3, (B, K)).astype(np.float32)
    pos = rng.normal(size=(B, K, 3)).astype(np.float32)
    vel = rng.normal(0, 100, (B, K, 3)).astype(np.float32)
    mask = rng.random((B, K)) < 0.7
    mask[0] = False
    theirs = jax.vmap(jkin.angular_momentum)(mass, pos, vel, mask)
    ours = tkin.angular_momentum(*(torch.from_numpy(x) for x in (mass, pos, vel, mask)))
    terms = np.abs(np.where(mask, mass, 0)[..., None] * np.cross(pos, vel))
    _close(ours, theirs, atol=RTOL * terms.sum(1))

    r, m, v, sel = _profile(seed)
    sel[1] = False  # nothing selected
    _close_vmax(tkin.vmax_sorted(*(torch.from_numpy(x) for x in (m, r, sel))),
                jax.vmap(jkin.vmax_sorted)(m, r, sel))
    # two softening values over two row segments of the same sort
    seg = np.random.default_rng(seed + 1).random(r.shape) < 0.5
    masks = [sel & seg, sel & ~seg]
    softs = (0.05, 0.4)
    theirs = jax.vmap(lambda a, b, c, d: jkin.vmax_sorted_multi_soft(a, b, [c, d], softs))(
        m, r, *masks
    )
    ours = tkin.vmax_sorted_multi_soft(
        torch.from_numpy(m), torch.from_numpy(r), [torch.from_numpy(x) for x in masks], softs
    )
    _close_vmax(ours, theirs)

    L = np.abs(rng.normal(0, 1e3, B)).astype(np.float32)
    M = np.abs(rng.normal(0, 10, B)).astype(np.float32)
    M[2] = 0.0
    R = np.abs(rng.normal(0, 1, B)).astype(np.float32)
    _close(tkin.spin_parameter(*(torch.from_numpy(x) for x in (L, M, R)), 43.0),
           jkin.spin_parameter(L, M, R, 43.0))


def _close_vmax(ours, theirs):
    _close(ours.radius, theirs.radius)
    _close(ours.vmax_sq_over_G, theirs.vmax_sq_over_G)


def _particles(seed, B=5, K=300):
    rng = np.random.default_rng(seed)
    mass = rng.lognormal(0.0, 0.4, (B, K)).astype(np.float32)
    pos = rng.normal(0.0, 1.0, (B, K, 3)).astype(np.float32)
    vel = (rng.normal(0.0, 50.0, (B, K, 3)) + 80.0 * np.cross([0, 0, 1.0], pos)).astype(np.float32)
    mask = rng.random((B, K)) < 0.8
    mask[-1] = False  # a halo with nothing selected
    return mass, pos, vel, mask


def _torch(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("seed", [0, 1])
def test_angular_momentum_and_kappa(seed):
    """Sums of products with cancellation: atol 1e-6 x sum of |terms|."""
    mass, pos, vel, mask = _particles(seed)
    theirs = jax.vmap(jkin.angular_momentum_and_kappa)(mass, pos, vel, mask)
    ours = tkin.angular_momentum_and_kappa(*_torch(mass, pos, vel, mask))
    scale = (mass[..., None] * np.abs(pos) * np.abs(vel)).sum(1).max()
    _close(ours.L, theirs.L, atol=1e-6 * scale)
    _close(ours.kappa_corot, theirs.kappa_corot, atol=1e-6)
    _close(ours.m_counterrot, theirs.m_counterrot, atol=1e-6 * mass.sum(1).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_cylindrical_velocities_and_dispersions(seed):
    """Rotations through atan2 and the frame: atol 1e-4 x the speed scale."""
    mass, pos, vel, mask = _particles(seed)
    L = np.array(jax.vmap(jkin.angular_momentum)(mass, pos, vel, mask))
    L[1] = [1e-3, 0.0, 0.0]  # z nearly along x: the helper switches to y
    theirs = jax.vmap(jkin.cylindrical_velocities)(pos, vel, L)
    tp, tv, tL, tm, tmask = _torch(pos, vel, L, mass, mask)
    ours = tkin.cylindrical_velocities(tp, tv, tL)
    vscale = np.abs(vel).max()
    _close(ours, theirs, atol=1e-4 * vscale)
    v_cyl = np.array(theirs)
    tcyl = torch.from_numpy(v_cyl)
    _close(
        tkin.weighted_cylindrical_dispersion(tm, tcyl, tmask),
        jax.vmap(jkin.weighted_cylindrical_dispersion)(mass, v_cyl, mask),
        atol=1e-5 * vscale,
    )
    _close(
        tkin.weighted_rotation_velocity(tm, tcyl[..., 1], tmask),
        jax.vmap(jkin.weighted_rotation_velocity)(mass, v_cyl[..., 1], mask),
        atol=1e-5 * vscale,
    )


#: the chemistry keys whose floors and half-mass radii the test holds
CHEM_KEYS = (
    "LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfGasLowLimit",
    "LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfGasHighLimit",
    "LogarithmicMassWeightedDiffuseNitrogenOverOxygenOfGasLowLimit",
    "LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfAtomicGasLowLimit",
    "LogarithmicMassWeightedIronOverHydrogenOfStarsLowLimit",
    "LogarithmicMassWeightedIronOverHydrogenOfStarsHighLimit",
    "LogarithmicMassWeightedMagnesiumOverHydrogenOfStarsLowLimit",
    "LinearMassWeightedIronOverHydrogenOfStars",
    "HalfMassRadiusAtomicHydrogen",
    "HalfMassRadiusMolecularHydrogen",
    "AtomicHydrogenMass",
    "MolecularHydrogenMass",
)


@pytest.mark.parametrize("seed", [0, 1])
def test_chemistry_floors_and_hydrogen_radii(seed):
    """Gas and star abundance ratios straddling their solar-relative
    floors, and the HI/H2 half-mass radii (the port's on the shared sort's
    weight payloads, the JAX slice's on its own sort): rtol 1e-5."""
    from soap_tpu.models import halo_slice as jhs
    from soap_tpu.models.context import HaloContext as JaxContext
    from soap_tpu_torch.models import halo_slice as ths
    from soap_tpu_torch.models.context import HaloContext as TorchContext
    from soap_tpu_torch.pipeline.run import DEFAULT_CONSTANTS
    from soap_tpu_torch.utils.mock_data import NAMED_COLUMNS

    rng = np.random.default_rng(seed)
    B, caps = 4, (96, 64, 64)
    K = sum(caps)
    ptypes = ("PartType0", "PartType1", "PartType4")
    ctx_kw = dict(
        a=0.8, z=0.25, G=43.0, boxsize=20.0, critical_density=10.0, mean_density=3.0,
        ptypes=ptypes, capacities=caps, softening=(0.005, 0.01, 0.005), dmo=False,
        constants=tuple(sorted(DEFAULT_CONSTANTS.items())),
        named_columns=tuple(
            (f"{pt}/{ds}", tuple(NAMED_COLUMNS[ds]))
            for ds, pt in (("ElementMassFractions", "PartType0"),
                           ("ElementMassFractionsDiffuse", "PartType0"),
                           ("SpeciesFractions", "PartType0"),
                           ("ElementMassFractions", "PartType4"))
        ),
    )
    valid = rng.random((B, K)) < 0.9
    groupnr = np.where(rng.random((B, K)) < 0.85, np.arange(B)[:, None], -1)
    mass = np.where(valid, rng.lognormal(0.0, 0.3, (B, K)), 0.0).astype(np.float32)
    pos = np.where(valid[..., None], rng.normal(0, 0.2, (B, K, 3)), 0.0).astype(np.float32)
    vel = np.where(valid[..., None], rng.normal(0, 30, (B, K, 3)), 0.0).astype(np.float32)

    def elements(n):
        e = rng.uniform(0.0, 0.01, (B, n, 9)).astype(np.float32)
        e[..., 0] = 0.74
        # oxygen, nitrogen, iron and magnesium from far below to above the
        # floors (1e-4 and 1e-3 x solar)
        for col in (3, 4, 6, 8):
            e[..., col] = 10.0 ** rng.uniform(-12.0, -2.0, (B, n))
        return e

    sp = rng.uniform(0.0, 0.4, (B, caps[0], 5)).astype(np.float32)
    fields = {
        "PartType0/ElementMassFractions": elements(caps[0]),
        "PartType0/ElementMassFractionsDiffuse": elements(caps[0]),
        "PartType0/SpeciesFractions": sp,
        "PartType0/Temperatures": (10.0 ** rng.uniform(3.0, 5.0, (B, caps[0]))).astype(np.float32),
        "PartType0/Densities": (10.0 ** rng.uniform(4.0, 7.0, (B, caps[0]))).astype(np.float32),
        "PartType4/ElementMassFractions": elements(caps[2]),
    }
    base = dict(valid=valid, mass=mass, pos=pos, vel=vel, groupnr=groupnr.astype(np.int64),
                fofid=np.full((B, K), -1, np.int64),
                softening=np.full((B, K), 0.005, np.float32))
    sc = dict(index=np.arange(B, dtype=np.int64), centre=np.zeros((B, 3), np.float32),
              search_radius=np.ones(B, np.float32), is_central=np.ones(B, bool),
              fof_id=np.arange(B, dtype=np.int64))

    jctx = JaxContext(**ctx_kw)
    jparts = jhs.HaloParticles(**{k: jnp.asarray(v) for k, v in base.items()},
                               fields={k: jnp.asarray(v) for k, v in fields.items()})
    jsc = jhs.HaloScalars(**{k: jnp.asarray(v) for k, v in sc.items()})
    theirs = jax.vmap(
        lambda p, s: jhs.compute_properties(jhs.BoundSubhaloSlice(jctx, p, s), CHEM_KEYS)
    )(jparts, jsc)

    tctx = TorchContext(**ctx_kw)
    tparts = ths.HaloParticles(*_torch(*(base[k] for k in ths.HaloParticles._fields[:-1])),
                               fields={k: torch.from_numpy(v) for k, v in fields.items()})
    tsc = ths.HaloScalars(*_torch(*(sc[k] for k in ths.HaloScalars._fields)))
    s = ths.BoundSubhaloSlice(tctx, tparts, tsc)
    s.__dict__.update(ths.shared_sort_artifacts(tparts, tsc, tctx))
    ours = ths.compute_properties(s, CHEM_KEYS)
    for key in CHEM_KEYS:
        a = np.asarray(theirs[key], np.float64)
        assert (a > 0).any(), key
        np.testing.assert_allclose(ours[key].numpy(), a, rtol=1e-5, atol=0, err_msg=key)
