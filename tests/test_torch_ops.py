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
