"""Halo properties as a lazy DAG over a batch of padded halo slices.

Ported from ``soap_tpu/models/halo_slice.py``: a ``HaloSlice`` holds the
padded candidate particles of B halos, and ``lazy_property`` memoizes
the shared intermediates (radii, the radius sort, the SO solution) so
each is computed once per slice.  Every array carries an explicit
leading halo axis: per-particle (B, K, ...), per-halo (B, ...).  Property
methods are named by their property-table key.

The four slice classes carry every key of the DMO production catalogue
(``pipeline/specs.py::build_specs(None, dmo=True, ...)``); a key without
a method here, such as every hydro key, raises ``NotImplementedError``.
The engine evaluates a spec family (SO densities, aperture radii) as
one slice whose halo axis holds every member's halos, so a family's
iterative inertia tensors run through one call of the inertia loop.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.models.lazy import lazy_property
from soap_tpu_torch.ops import inertia as inertia_ops
from soap_tpu_torch.ops import kinematics as kin
from soap_tpu_torch.ops import radii as radii_ops
from soap_tpu_torch.ops import reductions as red
from soap_tpu_torch.ops import so_radius as so_ops


class HaloParticles(NamedTuple):
    """B halos' padded candidate particles (concatenated over ptypes);
    invalid rows have ``valid=False`` and zeroed payloads."""

    valid: torch.Tensor  # (B, K) bool
    mass: torch.Tensor  # (B, K) f32
    pos: torch.Tensor  # (B, K, 3) f32 halo-relative physical
    vel: torch.Tensor  # (B, K, 3) f32 peculiar
    groupnr: torch.Tensor  # (B, K) i64 bound-subhalo index (-1 unbound)
    fofid: torch.Tensor  # (B, K) i64 FOF group id (-1 field)
    softening: torch.Tensor  # (B, K) f32 physical softening


class HaloScalars(NamedTuple):
    """Per-halo scalar inputs."""

    index: torch.Tensor  # (B,) i64 halo catalogue index
    centre: torch.Tensor  # (B, 3) f32 comoving absolute centre
    search_radius: torch.Tensor  # (B,) f32 physical: data complete within
    is_central: torch.Tensor  # (B,) bool
    fof_id: torch.Tensor  # (B,) i64


#: mass-weighted 3D inertia keys -> (species, reduced, iterative)
_INERTIA3D_KEYS = {
    f"{name}InertiaTensor" + ("Reduced" if red_ else "") + ("" if it else "Noniterative"):
        (species, red_, it)
    for name, species in (("Total", "tot"), ("DarkMatter", "dm"))
    for red_ in (False, True)
    for it in (True, False)
}

#: the R1-concentration fit, log10(c) as a polynomial in log10(R1)
_CONCENTRATION_POLY = (-79.71, -222.46, -250.14, -140.17, -43.59, -5.07)


def _per_halo(x, valid: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) parameter as a (B,) f32 tensor beside ``valid``."""
    t = torch.as_tensor(x, dtype=torch.float32, device=valid.device)
    return t.expand(valid.shape[0]) if t.dim() == 0 else t


class HaloSlice:
    """Base class: B halos' selected particles + lazy property methods.
    Subclasses define ``selection`` (and its radius-sorted form)."""

    def __init__(self, ctx: HaloContext, parts: HaloParticles, scalars: HaloScalars):
        self.ctx = ctx
        self.parts = parts
        self.scalars = scalars

    # ---------------- selection & basic masks ----------------

    @lazy_property
    def selection(self) -> torch.Tensor:
        raise NotImplementedError

    @lazy_property
    def bound_mask(self) -> torch.Tensor:
        """Particles bound to this subhalo (GroupNr_bound == index)."""
        return self.parts.valid & (self.parts.groupnr == self.scalars.index[:, None])

    def _rows_of(self, ptype: str) -> torch.Tensor:
        """(K,) bool: the rows of one particle type's static segment."""
        lo, hi = self.ctx.segment(ptype)
        row = torch.arange(self.parts.valid.shape[1], device=self.parts.valid.device)
        return (row >= lo) & (row < hi)

    def type_mask(self, ptype: str) -> torch.Tensor:
        """Selected particles of one type."""
        return self.selection & self._rows_of(ptype)[None, :]

    def _valid_type_mask(self, ptype: str) -> torch.Tensor:
        """All valid candidates of one type, selected or not."""
        return self.parts.valid & self._rows_of(ptype)[None, :]

    @lazy_property
    def mask_dm(self):
        return self.type_mask("PartType1")

    @lazy_property
    def mask_nu(self):
        return self.type_mask("PartType6")

    @lazy_property
    def radius(self) -> torch.Tensor:
        p = self.parts.pos
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return torch.sqrt(x * x + y * y + z * z)

    @lazy_property
    def soft_radius(self) -> torch.Tensor:
        """Radius floored at the particle's softening."""
        return torch.maximum(self.radius, self.parts.softening)

    # ---------------- the shared radius sort ----------------
    # One stable sort of the radius key (invalid rows last) with its
    # payloads (``radius``, ``_rsort_order``, ``_r_sorted``, ``_m_sorted``,
    # ``_bound_sorted``, ``_pos_sorted``, ``_valid_sorted``), seeded into
    # every slice of a bucket by the engine (``shared_sort_artifacts``).
    # Sorted masks are derived elementwise: the bound flag rides the
    # sort, type segments come from the sorted permutation, radius cuts
    # compare the sorted key; each subclass derives its ``_sel_sorted``.

    def _seg_sorted(self, ptype: str) -> torch.Tensor:
        """Particle-type membership in sorted order, from the permutation."""
        name = f"_seg_sorted_{ptype}"
        if name not in self.__dict__:
            lo, hi = self.ctx.segment(ptype)
            o = self._rsort_order
            self.__dict__[name] = (o >= lo) & (o < hi)
        return self.__dict__[name]

    @lazy_property
    def _dm_sorted(self):
        return self._sel_sorted & self._seg_sorted("PartType1")

    # ---------------- needs-bigger-region flags ----------------

    @property
    def flags(self):
        """Accumulated needs-bigger-region bits, (B,) each."""
        if "_flags" not in self.__dict__:
            self._flags = [
                torch.zeros(self.parts.valid.shape[0], dtype=torch.bool,
                            device=self.parts.valid.device)
            ]
        return self._flags

    def add_flag(self, flag):
        self.flags.append(flag)

    @property
    def needs_bigger(self) -> torch.Tensor:
        out = self.flags[0]
        for f in self.flags[1:]:
            out = out | f
        return out

    # ---------------- masses, counts, centres ----------------

    @lazy_property
    def Mtot(self):
        return red.masked_sum(self.parts.mass, self.selection)

    @lazy_property
    def Mdm(self):
        return red.masked_sum(self.parts.mass, self.mask_dm)

    @lazy_property
    def Ndm(self):
        return red.masked_count(self.mask_dm, torch.int64)

    @lazy_property
    def Mnu(self):
        """Neutrino particle mass in the selection (0 without PartType6)."""
        return red.masked_sum(self.parts.mass, self.mask_nu)

    @lazy_property
    def MnuNS(self):
        """Noise-suppressed neutrino mass (the weighted masses)."""
        return red.masked_sum(self.parts.mass, self.mask_nu)

    @lazy_property
    def _com_pair(self):
        return red.centre_of_mass(self.parts.mass, self.parts.pos, self.selection)

    @lazy_property
    def com(self):
        """Absolute physical centre of mass."""
        _, rel = self._com_pair
        return self.scalars.centre * self.ctx.a + rel

    @lazy_property
    def vcom(self):
        return red.centre_of_mass_velocity(
            self.parts.mass, self.parts.vel, self.selection
        )

    @lazy_property
    def vcom_dm(self):
        return red.centre_of_mass_velocity(self.parts.mass, self.parts.vel, self.mask_dm)

    # ---------------- radii ----------------

    @lazy_property
    def EncloseRadius(self):
        """Radius of the furthest selected particle."""
        return radii_ops.enclose_radius(self.radius, self.selection)

    @lazy_property
    def HalfMassRadiusTot(self):
        return radii_ops.half_weight_radius_sorted(
            self._r_sorted, self._m_sorted, self._sel_sorted, self.Mtot
        )

    @lazy_property
    def HalfMassRadiusDM(self):
        return radii_ops.half_weight_radius_sorted(
            self._r_sorted, self._m_sorted, self._dm_sorted, self.Mdm
        )

    # ---------------- kinematics ----------------

    @lazy_property
    def Ldm(self):
        """DM angular momentum about (centre, vcom_dm)."""
        vel_rel = self.parts.vel - self.vcom_dm[:, None, :]
        return kin.angular_momentum(self.parts.mass, self.parts.pos, vel_rel, self.mask_dm)

    @lazy_property
    def veldisp_matrix_dm(self):
        return red.velocity_dispersion_matrix(
            self.parts.mass, self.parts.vel, self.vcom_dm, self.mask_dm
        )

    def _vmax_soft_for(self, sorted_mask):
        """Softened Vmax on the shared radius sort: with one softening
        value max(r, s) keeps the radius order; with several, the
        per-type step-function form stays exact on it."""
        softs = dict(zip(self.ctx.ptypes, self.ctx.softening))
        values = sorted(set(softs.values()))
        if len(values) <= 1:
            soft = values[0] if values else 0.0
            return kin.vmax_sorted(
                self._m_sorted, torch.clamp(self._r_sorted, min=soft), sorted_mask
            )
        masks = []
        for s in values:
            seg = None
            for pt, sp in softs.items():
                if sp == s:
                    m = self._seg_sorted(pt)
                    seg = m if seg is None else seg | m
            masks.append(sorted_mask & seg)
        return kin.vmax_sorted_multi_soft(
            self._m_sorted, self._r_sorted, masks, tuple(values)
        )

    @lazy_property
    def _vmax_soft(self):
        return self._vmax_soft_for(self._sel_sorted)

    @lazy_property
    def _vmax_unsoft(self):
        return kin.vmax_sorted(self._m_sorted, self._r_sorted, self._sel_sorted)

    @lazy_property
    def Vmax_soft(self):
        return torch.sqrt(self.ctx.G * self._vmax_soft.vmax_sq_over_G)

    @lazy_property
    def Vmax_unsoft(self):
        return torch.sqrt(self.ctx.G * self._vmax_unsoft.vmax_sq_over_G)

    @lazy_property
    def R_vmax_soft(self):
        return self._vmax_soft.radius

    @lazy_property
    def R_vmax_unsoft(self):
        return self._vmax_unsoft.radius

    @lazy_property
    def spin_parameter(self):
        """Bullock et al. (2001) spin inside R_vmax_soft."""
        R = self.R_vmax_soft
        V = self.Vmax_soft
        inside = self.selection & (self.radius <= R[:, None])
        vel_rel = self.parts.vel - self.vcom[:, None, :]
        L = kin.angular_momentum(self.parts.mass, self.parts.pos, vel_rel, inside)
        Lnorm = torch.sqrt((L * L).sum(1))
        M = red.masked_sum(self.parts.mass, inside)
        denom = math.sqrt(2.0) * M * V * R
        ok = (self.Mtot > 0) & (R > 0) & (V > 0) & (M > 0)
        return torch.where(ok, Lnorm / torch.clamp(denom, min=1e-37), 0.0)

    @lazy_property
    def ExSituFraction(self):
        """Ex-situ stellar mass fraction: 0 without stars (DMO)."""
        return torch.zeros(self.parts.valid.shape[0], dtype=torch.float32,
                           device=self.parts.valid.device)

    # ---------------- inertia tensors ----------------
    #  - BoundSubhalo: sphere = 10 x the species' half-mass radius, its
    #    bound particles only, no search-radius check;
    #  - SO: sphere = the SO radius, every candidate of the species,
    #    with the search-radius check.

    def _inertia_cfg(self, species: str):
        """(radius-sorted mask, sphere radius, search radius | None, gate)."""
        if species == "tot":
            return self._sel_sorted, 10.0 * self.HalfMassRadiusTot, None, self.Mtot
        return self._dm_sorted, 10.0 * self.HalfMassRadiusDM, None, self.Mdm

    def _inertia_configs(self, iterative: bool):
        """[(config, sorted mask, sphere, search | None, gate)] for the
        requested inertia keys of one kind, in request order."""
        out = []
        for key in getattr(self, "_requested_keys", ()):
            cfg = _INERTIA3D_KEYS.get(key)
            if cfg is not None and cfg[2] == iterative:
                out.append((cfg,) + tuple(self._inertia_cfg(cfg[0])))
        return out

    @lazy_property
    def _inertia_batch3d(self):
        """{(species, reduced, iterative): (B, 6)} for every requested
        inertia key: one loop-free single pass (plain PyTorch, as in the
        JAX package) for the non-iterative configs, one inertia-loop
        call for the iterative ones (a family's members are halos of the
        same call); adds the needs-bigger flag."""
        out = {}
        for iterative in (False, True):
            reqs = self._inertia_configs(iterative)
            if not reqs:
                continue
            search = None
            for r in reqs:
                if r[3] is not None:
                    search = r[3]
            result = inertia_ops.inertia_tensor_multi(
                self._m_sorted,
                self._pos_sorted,
                torch.stack([r[1] for r in reqs], 1),
                torch.stack([r[2].to(torch.float32) for r in reqs], 1),
                [r[0][1] for r in reqs],
                [iterative] * len(reqs),
                search_radius=search,
                check_search=[r[3] is not None for r in reqs] if search is not None else None,
                single_pass=not iterative,
                rows_radius_sorted=True,  # _pos_sorted ascends in radius
            )
            if search is not None:
                self.add_flag(result.needs_bigger.any(1))
            for col, (cfg, _, _, _, gate) in enumerate(reqs):
                out[cfg] = torch.where(gate[:, None] > 0, result.tensor[:, col], 0.0)
        return out

    def _inertia(self, key):
        return self._inertia_batch3d[_INERTIA3D_KEYS[key]]

    @lazy_property
    def TotalInertiaTensor(self):
        return self._inertia("TotalInertiaTensor")

    @lazy_property
    def TotalInertiaTensorReduced(self):
        return self._inertia("TotalInertiaTensorReduced")

    @lazy_property
    def TotalInertiaTensorNoniterative(self):
        return self._inertia("TotalInertiaTensorNoniterative")

    @lazy_property
    def TotalInertiaTensorReducedNoniterative(self):
        return self._inertia("TotalInertiaTensorReducedNoniterative")

    @lazy_property
    def DarkMatterInertiaTensor(self):
        return self._inertia("DarkMatterInertiaTensor")

    @lazy_property
    def DarkMatterInertiaTensorReduced(self):
        return self._inertia("DarkMatterInertiaTensorReduced")

    @lazy_property
    def DarkMatterInertiaTensorNoniterative(self):
        return self._inertia("DarkMatterInertiaTensorNoniterative")

    @lazy_property
    def DarkMatterInertiaTensorReducedNoniterative(self):
        return self._inertia("DarkMatterInertiaTensorReducedNoniterative")


class BoundSubhaloSlice(HaloSlice):
    """``BoundSubhalo/*`` selection: particles bound to this subhalo."""

    @lazy_property
    def selection(self):
        return self.bound_mask

    @lazy_property
    def _sel_sorted(self):
        return self._bound_sorted


class SOSlice(HaloSlice):
    """``SO/<X>/*`` selection: all particles inside the spherical
    overdensity radius.  ``target_density`` is the PHYSICAL threshold
    density (e.g. 200 x critical); a radius multiple of another SO passes
    ``physical_radius`` instead.  Every SO here is a virial definition
    (the fixed-radius SOs of parameter files are not ported), so the flow
    rates and concentrations always run."""

    def __init__(self, ctx, parts, scalars, target_density=None, physical_radius=None):
        super().__init__(ctx, parts, scalars)
        self.target_density = target_density
        self.physical_radius = physical_radius  # (B,) tensor

    def _inertia_cfg(self, species: str):
        """SO inertia: sphere = SO radius, ALL candidates of the species
        (the ellipsoid may deform beyond R_SO), search-radius check on."""
        if species == "tot":
            mask, gate = self._valid_sorted, self.SO_mass
        else:
            mask, gate = self._valid_sorted & self._seg_sorted("PartType1"), self.Mdm
        return mask, self.r, self.scalars.search_radius, gate

    @lazy_property
    def _so_solution(self) -> so_ops.SOResult:
        res = so_ops.so_radius_sorted(
            self._r_sorted, self._m_sorted, self._valid_sorted,
            self.target_density, self.ctx.nu_density,
        )
        self.add_flag(res.needs_bigger)
        return res

    @lazy_property
    def r(self):
        """The SO radius (``SORadius``)."""
        if self.physical_radius is not None:
            return self.physical_radius
        return self._so_solution.radius

    @lazy_property
    def SO_mass(self):
        if self.physical_radius is not None:
            return so_ops.enclosed_mass_sorted(
                self._r_sorted, self._m_sorted, self._valid_sorted, self.r,
                self.ctx.nu_density,
            )
        return self._so_solution.mass

    @lazy_property
    def exists(self):
        return (self.r > 0) & (self.SO_mass > 0)

    @lazy_property
    def selection(self):
        """All particles within the SO radius."""
        return self.parts.valid & (self.radius < self.r[:, None]) & self.exists[:, None]

    @lazy_property
    def _sel_sorted(self):
        return (
            self._valid_sorted & (self._r_sorted < self.r[:, None]) & self.exists[:, None]
        )

    @lazy_property
    def Mtot(self):
        """The SO mass comes from the density crossing, not a sum."""
        return self.SO_mass

    # -- satellite / external mass fractions

    @lazy_property
    def _halo_fofid(self):
        """FOF id of the halo: that of its closest non-neutrino particle
        (the catalogue's host ids live in another id space)."""
        ok = self.parts.valid & ~self.type_mask("PartType6")
        i = torch.argmin(torch.where(ok, self.radius, torch.inf), 1)
        return self.parts.fofid.gather(1, i[:, None])[:, 0]

    def _bound_elsewhere(self):
        p = self.parts
        return self.selection & (p.groupnr >= 0) & (p.groupnr != self.scalars.index[:, None])

    @lazy_property
    def Mfrac_satellites(self):
        sat = self._bound_elsewhere() & (self.parts.fofid == self._halo_fofid[:, None])
        m = red.masked_sum(self.parts.mass, sat)
        return torch.where(self.exists, m / torch.clamp(self.SO_mass, min=1e-37), 0.0)

    @lazy_property
    def Mfrac_external(self):
        ext = self._bound_elsewhere() & (self.parts.fofid != self._halo_fofid[:, None])
        m = red.masked_sum(self.parts.mass, ext)
        return torch.where(self.exists, m / torch.clamp(self.SO_mass, min=1e-37), 0.0)

    # -- shell flow rates

    def _vcom_inside(self, frac: float):
        inside = self.parts.valid & (self.radius < frac * self.r[:, None])
        return red.centre_of_mass_velocity(self.parts.mass, self.parts.vel, inside)

    #: shell radii as fractions of R_SO
    _FLOW_FRACS = (0.1, 0.3, 1.0)

    @lazy_property
    def _flow_shells(self):
        """Per shell fraction: the radial velocity about the fraction's
        CoM frame minus the SO radius's pseudo-evolution, the shell
        window, and the shell width; computed once for every flow key."""
        r = self.radius
        rhat = self.parts.pos / torch.clamp(r, min=1e-37)[..., None]
        rdot = (2.0 / 3.0) * torch.pow(
            self.ctx.G * self.SO_mass * self.ctx.H / 100.0, 1.0 / 3.0
        )
        rdot = rdot * (2.0 * self.ctx.omega_g + 1.5 * self.ctx.omega_m)
        vcoms = {0.1: self._vcom_inside(0.1), 0.3: self._vcom_inside(0.3), 1.0: self.vcom}
        out = {}
        for frac in self._FLOW_FRACS:
            R = frac * self.r
            dR = 0.1 * R
            self.add_flag(self.exists & (R + 0.5 * dR > self.scalars.search_radius))
            geom = (r > (R - 0.5 * dR)[:, None]) & (r < (R + 0.5 * dR)[:, None])
            dv = self.parts.vel - vcoms[frac][:, None, :]
            v_r = (
                dv[..., 0] * rhat[..., 0] + dv[..., 1] * rhat[..., 1]
                + dv[..., 2] * rhat[..., 2]
            ) - (frac * rdot)[:, None]
            out[frac] = (v_r, geom, dR)
        return out

    @lazy_property
    def DarkMatterMassFlowRate(self):
        """DM inflow then outflow mass rates (B, 6) through the shells at
        0.1, 0.3 and 1.0 x R_SO (shell width 0.1 R_shell); every valid DM
        candidate counts, the shells reach past R_SO."""
        dm = self._valid_type_mask("PartType1")
        inflow, outflow = [], []
        for frac in self._FLOW_FRACS:
            v_r, geom, dR = self._flow_shells[frac]
            in_shell = dm & geom
            fr = self.parts.mass * torch.abs(v_r)
            inflow.append(torch.where(in_shell & (v_r < 0), fr, 0.0).sum(1) / dR)
            outflow.append(torch.where(in_shell & (v_r > 0), fr, 0.0).sum(1) / dR)
        out = torch.stack(inflow + outflow, 1)
        return torch.where(self.exists[:, None], out, 0.0)

    # -- concentration

    def _concentration(self, radius_arr):
        """R1-statistic concentration with the missed-mass correction."""
        sel = self.selection
        r = self.r
        nu = self.ctx.nu_density
        R1 = torch.where(sel, self.parts.mass * torch.where(sel, radius_arr, 0.0), 0.0).sum(1)
        missed = self.SO_mass - red.masked_sum(self.parts.mass, sel)
        R1 = R1 + math.pi * nu * r**4
        missed = missed - nu * (4.0 / 3.0) * math.pi * r**3
        R1 = R1 + missed * r
        R1 = R1 / torch.clamp(r * self.SO_mass, min=1e-37)
        # the fit in float64, as the JAX package evaluates it
        x = torch.log10(torch.clamp(R1, min=1e-10)).to(torch.float64)
        logc = torch.zeros_like(x)
        for c in _CONCENTRATION_POLY:
            logc = logc * x + c
        logc = torch.clamp(logc, 0.0, 3.0)
        ok = self.exists & (red.masked_count(sel) >= 10)
        return torch.where(ok, 10.0**logc, 0.0)

    @lazy_property
    def concentration_unsoft(self):
        return self._concentration(self.radius)

    @lazy_property
    def concentration_soft(self):
        return self._concentration(self.soft_radius)

    @lazy_property
    def spin_parameter(self):
        """SO spin: |L| / (sqrt(2) M V R), V = sqrt(G M / R) at R_SO."""
        vel_rel = self.parts.vel - self.vcom[:, None, :]
        L = kin.angular_momentum(self.parts.mass, self.parts.pos, vel_rel, self.selection)
        Lnorm = torch.sqrt((L * L).sum(1))
        lam = kin.spin_parameter(Lnorm, self.SO_mass, self.r, self.ctx.G)
        return torch.where(self.exists, lam, 0.0)


class ApertureSlice(HaloSlice):
    """``ExclusiveSphere/<R>`` (bound particles) or ``InclusiveSphere/<R>``
    (all particles) within a fixed physical radius."""

    def __init__(self, ctx, parts, scalars, aperture_radius, inclusive: bool):
        super().__init__(ctx, parts, scalars)
        self.aperture_radius = _per_halo(aperture_radius, parts.valid)
        self.inclusive = inclusive

    def _flag_region(self):
        # an aperture larger than the region read needs a bigger region
        self.add_flag(self.aperture_radius > self.scalars.search_radius)

    @lazy_property
    def selection(self):
        self._flag_region()
        inside = self.parts.valid & (self.radius < self.aperture_radius[:, None])
        return inside if self.inclusive else inside & self.bound_mask

    @lazy_property
    def _sel_sorted(self):
        self._flag_region()
        inside = self._valid_sorted & (self._r_sorted < self.aperture_radius[:, None])
        return inside if self.inclusive else inside & self._bound_sorted


class ProjectedApertureSlice(HaloSlice):
    """``ProjectedAperture/<R>/proj{x,y,z}``: bound particles within the
    projected radius along one axis, no line-of-sight cut.  Half-mass
    radii profile in projected radius, over one stable sort of it that
    does not depend on the aperture radius (shared by an axis's family)."""

    def __init__(self, ctx, parts, scalars, aperture_radius, axis: int):
        super().__init__(ctx, parts, scalars)
        self.aperture_radius = _per_halo(aperture_radius, parts.valid)
        self.axis = axis
        self._proj_dims = [d for d in range(3) if d != axis]

    def _flag_region(self):
        self.add_flag(self.aperture_radius > self.scalars.search_radius)

    @lazy_property
    def proj_radius(self):
        p = self.parts.pos
        a, b = p[..., self._proj_dims[0]], p[..., self._proj_dims[1]]
        return torch.sqrt(a * a + b * b)

    @lazy_property
    def selection(self):
        self._flag_region()
        return self.bound_mask & (self.proj_radius < self.aperture_radius[:, None])

    @lazy_property
    def _proj_sort(self):
        """(radius, permutation, mass, bound flag) in projected-radius order."""
        key = torch.where(self.parts.valid, self.proj_radius, torch.inf)
        r_s, order = torch.sort(key, dim=1, stable=True)
        return r_s, order, self.parts.mass.gather(1, order), self.bound_mask.gather(1, order)

    @lazy_property
    def _proj_sel_sorted(self):
        r_s, _, _, b_s = self._proj_sort
        self._flag_region()
        return b_s & (r_s < self.aperture_radius[:, None])

    def _proj_seg_sorted(self, ptype: str) -> torch.Tensor:
        lo, hi = self.ctx.segment(ptype)
        order = self._proj_sort[1]
        return (order >= lo) & (order < hi)

    @lazy_property
    def HalfMassRadiusDM(self):
        r_s, _, m_s, _ = self._proj_sort
        mask = self._proj_sel_sorted & self._proj_seg_sorted("PartType1")
        return radii_ops.half_weight_radius_sorted(r_s, m_s, mask, self.Mdm)

    @lazy_property
    def proj_veldisp_dm(self):
        """1D DM velocity dispersion along the projection axis."""
        dv = self.parts.vel[..., self.axis] - self.vcom_dm[:, self.axis, None]
        m = torch.where(self.mask_dm, self.parts.mass, 0.0)
        mtot = m.sum(1)
        var = (m * dv * dv).sum(1) / torch.clamp(mtot, min=1e-37)
        return torch.where(mtot > 0, torch.sqrt(var), 0.0)


def shared_sort_artifacts(
    parts: HaloParticles, scalars: HaloScalars, vel_payload: bool = False
) -> Dict[str, torch.Tensor]:
    """The per-halo radius sort and its payloads, computed once per
    bucket and seeded into every slice: one stable sort of the radius
    key (invalid rows last), then one gather per payload.  The velocity
    payload lets the engine's sorted-prefix truncation hand slices a
    complete radius-sorted particle view as prefix slices."""
    x, y, z = parts.pos[..., 0], parts.pos[..., 1], parts.pos[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    key = torch.where(parts.valid, r, torch.inf)
    r_s, order = torch.sort(key, dim=1, stable=True)
    bound = parts.valid & (parts.groupnr == scalars.index[:, None])
    order3 = order[..., None].expand(-1, -1, 3)
    out = {
        "radius": r,
        "bound_mask": bound,
        "_rsort_order": order,
        "_r_sorted": r_s,
        "_m_sorted": parts.mass.gather(1, order),
        "_bound_sorted": bound.gather(1, order),
        "_pos_sorted": parts.pos.gather(1, order3),
        # invalid slots carry an inf key, so validity needs no payload
        "_valid_sorted": torch.isfinite(r_s),
    }
    if vel_payload:
        out["_vel_sorted"] = parts.vel.gather(1, order3)
    return out


def compute_properties(slice_obj: HaloSlice, keys) -> Dict[str, torch.Tensor]:
    """Evaluate the requested property-table keys on one slice; adds the
    needs-bigger flag under the reserved key ``__needs_bigger__``."""
    table = full_property_table()
    for key in keys:
        if key not in table or not hasattr(type(slice_obj), key):
            raise NotImplementedError(
                f"{type(slice_obj).__name__}: key {key!r} is not ported"
            )
    slice_obj._requested_keys = tuple(dict.fromkeys(keys))
    out = {key: getattr(slice_obj, key) for key in keys}
    out["__needs_bigger__"] = slice_obj.needs_bigger
    return out
