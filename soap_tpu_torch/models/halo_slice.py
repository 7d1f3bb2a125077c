"""Halo properties as a lazy DAG over a batch of padded halo slices.

Ported from ``soap_tpu/models/halo_slice.py``: a ``HaloSlice`` holds the
padded candidate particles of B halos, and ``lazy_property`` memoizes
the shared intermediates (radii, the radius sort, the SO solution) so
each is computed once per slice.  Every array carries an explicit
leading halo axis: per-particle (B, K, ...), per-halo (B, ...).  Property
methods are named by their property-table key.

The four slice classes carry every key of the default production
catalogue, DMO and hydro (``pipeline/specs.py::build_specs(None, dmo,
...)``); the gas, star and black-hole datasets ride in
``HaloParticles.fields`` with type-local rows, and a dataset the
snapshot lacks gives zeros.  The engine evaluates a spec family (SO
densities, aperture radii) as one slice whose halo axis holds every
member's halos, so a family's iterative inertia tensors run through one
call of the inertia loop; the luminosity-weighted ones run through one
more, with the nine bands on the halo axis.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.models.chemistry import ChemistryMixin
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.models.lazy import lazy_property
from soap_tpu_torch.ops import inertia as inertia_ops
from soap_tpu_torch.ops import inertia_loop as inertia_loop_ops
from soap_tpu_torch.ops import kernel_lib
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
    #: extra datasets by "PartTypeN/<name>", (B, K_t, ...) over the
    #: type's own rows; invalid rows hold arbitrary values
    fields: Dict[str, torch.Tensor]


class HaloScalars(NamedTuple):
    """Per-halo scalar inputs."""

    index: torch.Tensor  # (B,) i64 halo catalogue index
    centre: torch.Tensor  # (B, 3) f32 comoving absolute centre
    search_radius: torch.Tensor  # (B,) f32 physical: data complete within
    is_central: torch.Tensor  # (B,) bool
    fof_id: torch.Tensor  # (B,) i64


#: the GAMA r band among SWIFT's nine Luminosities columns (u, g, r, i,
#: z, Y, J, H, K)
GAMA_R_BAND = 2
N_BANDS = 9

#: 3D inertia keys -> (species, reduced, iterative, luminosity-weighted)
_INERTIA3D_KEYS = {
    f"{name}InertiaTensor" + ("Reduced" if red_ else "") + ("" if it else "Noniterative"):
        (species, red_, it, False)
    for name, species in (("Total", "tot"), ("Gas", "gas"), ("DarkMatter", "dm"),
                          ("Stellar", "star"))
    for red_ in (False, True)
    for it in (True, False)
}
_INERTIA3D_KEYS.update({
    "StellarInertiaTensor" + ("Reduced" if red_ else "") + ("" if it else "Noniterative")
    + "LuminosityWeighted": ("star", red_, it, True)
    for red_ in (False, True)
    for it in (True, False)
})

#: the projected (2D) analogue
_INERTIA2D_KEYS = {
    f"Projected{name}InertiaTensor" + ("Reduced" if red_ else "")
    + ("" if it else "Noniterative"): (species, red_, it, False)
    for name, species in (("Total", "tot"), ("Gas", "gas"), ("Stellar", "star"))
    for red_ in (False, True)
    for it in (True, False)
}
_INERTIA2D_KEYS.update({
    "ProjectedStellarInertiaTensor" + ("Reduced" if red_ else "")
    + ("" if it else "Noniterative") + "LuminosityWeighted": ("star", red_, it, True)
    for red_ in (False, True)
    for it in (True, False)
})

#: launches of the inertia loop's kernel by the configs they carried:
#: 'tot', 'gas', 'dm', 'star' (mass-weighted) and 'lum' (the bands);
#: counted only where a launch happened
k2_launches_by_config: Dict[str, int] = {}

#: the R1-concentration fit, log10(c) as a polynomial in log10(R1)
_CONCENTRATION_POLY = (-79.71, -222.46, -250.14, -140.17, -43.59, -5.07)


def _per_halo(x, valid: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) parameter as a (B,) f32 tensor beside ``valid``."""
    t = torch.as_tensor(x, dtype=torch.float32, device=valid.device)
    return t.expand(valid.shape[0]) if t.dim() == 0 else t


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[b, i[b], ...] for (B, K, ...) x and (B,) i."""
    idx = i.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand((-1, 1) + x.shape[2:])
    return x.gather(1, idx)[:, 0]


def _count_launches(fn):
    """Run ``fn`` and attribute the inertia-loop launches it made (in
    this thread)."""
    n = inertia_loop_ops.launches_here()
    out = fn()
    return out, inertia_loop_ops.launches_here() - n


def _star_sort(parts: HaloParticles, r, bound, lo4: int, hi4: int):
    """The star segment sorted by radius (invalid rows last): its radius
    key, permutation, bound flag, positions and luminosities."""
    key4 = torch.where(parts.valid[:, lo4:hi4], r[:, lo4:hi4], torch.inf)
    r_s, order = torch.sort(key4, dim=1, stable=True)
    out = {
        "_star_sort_r": r_s,
        "_star_sort_order": order,
        "_star_sort_bound": bound[:, lo4:hi4].gather(1, order),
        "_star_sort_pos": parts.pos[:, lo4:hi4].gather(
            1, order[..., None].expand(-1, -1, 3)
        ),
    }
    lum = parts.fields.get("PartType4/Luminosities")
    if lum is not None:
        out["_star_sort_lum"] = lum.gather(1, order[..., None].expand(-1, -1, lum.shape[2]))
    return out


class HaloSlice(ChemistryMixin):
    """Base class: B halos' selected particles + lazy property methods.
    Subclasses define ``selection`` (and its radius-sorted form)."""

    def __init__(self, ctx: HaloContext, parts: HaloParticles, scalars: HaloScalars):
        self.ctx = ctx
        self.parts = parts
        self.scalars = scalars

    def _zeros(self, *shape, dtype=torch.float32):
        v = self.parts.valid
        return torch.zeros((v.shape[0],) + shape, dtype=dtype, device=v.device)

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
        name = f"_rows_of_{ptype}"
        if name not in self.__dict__:
            lo, hi = self.ctx.segment(ptype)
            row = torch.arange(self.parts.valid.shape[1], device=self.parts.valid.device)
            self.__dict__[name] = (row >= lo) & (row < hi)
        return self.__dict__[name]

    def type_mask(self, ptype: str) -> torch.Tensor:
        """Selected particles of one type."""
        return self.selection & self._rows_of(ptype)[None, :]

    def _valid_type_mask(self, ptype: str) -> torch.Tensor:
        """All valid candidates of one type, selected or not."""
        return self.parts.valid & self._rows_of(ptype)[None, :]

    @lazy_property
    def mask_gas(self):
        return self.type_mask("PartType0")

    @lazy_property
    def mask_dm(self):
        return self.type_mask("PartType1")

    @lazy_property
    def mask_star(self):
        return self.type_mask("PartType4")

    @lazy_property
    def mask_bh(self):
        return self.type_mask("PartType5")

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
    # ``_bound_sorted``, ``_pos_sorted``, ``_valid_sorted``, the HI/H2
    # weights and the star segment's own sort), seeded into every slice
    # of a bucket by the engine (``shared_sort_artifacts``).  Sorted
    # masks are derived elementwise: the bound flag rides the sort, type
    # segments come from the sorted permutation, radius cuts compare the
    # sorted key; each subclass derives its ``_sel_sorted``.

    def _seg_sorted(self, ptype: str) -> torch.Tensor:
        """Particle-type membership in sorted order, from the permutation."""
        name = f"_seg_sorted_{ptype}"
        if name not in self.__dict__:
            lo, hi = self.ctx.segment(ptype)
            o = self._rsort_order
            self.__dict__[name] = (o >= lo) & (o < hi)
        return self.__dict__[name]

    @lazy_property
    def _gas_sorted(self):
        return self._sel_sorted & self._seg_sorted("PartType0")

    @lazy_property
    def _dm_sorted(self):
        return self._sel_sorted & self._seg_sorted("PartType1")

    @lazy_property
    def _star_sorted(self):
        return self._sel_sorted & self._seg_sorted("PartType4")

    @lazy_property
    def _star_sort_all(self):
        lo4, hi4 = self.ctx.segment("PartType4")
        return _star_sort(self.parts, self.radius, self.bound_mask, lo4, hi4)

    # the star segment's radius sort, when the engine did not seed it
    @lazy_property
    def _star_sort_r(self):
        return self._star_sort_all["_star_sort_r"]

    @lazy_property
    def _star_sort_order(self):
        return self._star_sort_all["_star_sort_order"]

    @lazy_property
    def _star_sort_bound(self):
        return self._star_sort_all["_star_sort_bound"]

    @lazy_property
    def _star_sort_pos(self):
        return self._star_sort_all["_star_sort_pos"]

    @lazy_property
    def _star_sort_lum(self):
        return self._star_sort_all["_star_sort_lum"]

    # ---------------- profile-radius view ----------------
    # The half-mass and half-light radii of this base class profile in
    # the 3D radius; ``ProjectedApertureSlice`` remaps these to its
    # projected-radius sort.

    @property
    def _prof_r_sorted(self):
        return self._r_sorted

    @property
    def _prof_m_sorted(self):
        return self._m_sorted

    @property
    def _prof_order(self):
        return self._rsort_order

    @property
    def _prof_sel_sorted(self):
        return self._sel_sorted

    def _prof_seg_sorted(self, ptype: str) -> torch.Tensor:
        return self._seg_sorted(ptype)

    @property
    def _prof_gas_sorted(self):
        return self._gas_sorted

    @lazy_property
    def _star_profile_sort(self):
        """(radius, permutation, luminosities) of the star segment in
        profile-radius order."""
        return self._star_sort_r, self._star_sort_order, self._star_sort_lum

    # ---------------- needs-bigger-region flags ----------------

    @property
    def flags(self):
        """Accumulated needs-bigger-region bits, (B,) each."""
        if "_flags" not in self.__dict__:
            self._flags = [self._zeros(dtype=torch.bool)]
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
    def Mgas(self):
        return red.masked_sum(self.parts.mass, self.mask_gas)

    @lazy_property
    def Mdm(self):
        return red.masked_sum(self.parts.mass, self.mask_dm)

    @lazy_property
    def Mstar(self):
        return red.masked_sum(self.parts.mass, self.mask_star)

    @lazy_property
    def Mbh_dynamical(self):
        return red.masked_sum(self.parts.mass, self.mask_bh)

    @lazy_property
    def Ngas(self):
        return red.masked_count(self.mask_gas, torch.int64)

    @lazy_property
    def Ndm(self):
        return red.masked_count(self.mask_dm, torch.int64)

    @lazy_property
    def Nstar(self):
        return red.masked_count(self.mask_star, torch.int64)

    @lazy_property
    def Nbh(self):
        return red.masked_count(self.mask_bh, torch.int64)

    @lazy_property
    def Nnu(self):
        return red.masked_count(self.mask_nu, torch.int64)

    @lazy_property
    def Mnu(self):
        """Raw (unweighted) neutrino particle mass in the selection (0
        without PartType6): with delta-f weights the concatenated masses
        carry them, so the raw masses come from the per-type field."""
        if self._has("PartType6/Masses"):
            return red.masked_sum(
                self.field("PartType6/Masses"), self._seg_arr(self.mask_nu, "PartType6")
            )
        return red.masked_sum(self.parts.mass, self.mask_nu)

    @lazy_property
    def MnuNS(self):
        """Noise-suppressed neutrino mass: the sum of the weighted masses
        (the concatenated masses carry the weights)."""
        return red.masked_sum(self.parts.mass, self.mask_nu)

    @lazy_property
    def _com_pair(self):
        return red.centre_of_mass(self.parts.mass, self.parts.pos, self.selection)

    @lazy_property
    def com(self):
        """Absolute physical centre of mass."""
        _, rel = self._com_pair
        return self.scalars.centre * self.ctx.a + rel

    def _species_com(self, mask, gate):
        _, rel = red.centre_of_mass(self.parts.mass, self.parts.pos, mask)
        return torch.where(gate[:, None] > 0, self.scalars.centre * self.ctx.a + rel, 0.0)

    @lazy_property
    def com_gas(self):
        return self._species_com(self.mask_gas, self.Mgas)

    @lazy_property
    def com_dm(self):
        return self._species_com(self.mask_dm, self.Mdm)

    @lazy_property
    def com_star(self):
        return self._species_com(self.mask_star, self.Mstar)

    @lazy_property
    def vcom(self):
        return red.centre_of_mass_velocity(
            self.parts.mass, self.parts.vel, self.selection
        )

    @lazy_property
    def vcom_dm(self):
        return red.centre_of_mass_velocity(self.parts.mass, self.parts.vel, self.mask_dm)

    @lazy_property
    def vcom_gas(self):
        return red.centre_of_mass_velocity(self.parts.mass, self.parts.vel, self.mask_gas)

    @lazy_property
    def vcom_star(self):
        return red.centre_of_mass_velocity(self.parts.mass, self.parts.vel, self.mask_star)

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
    def HalfMassRadiusGas(self):
        return radii_ops.half_weight_radius_sorted(
            self._r_sorted, self._m_sorted, self._gas_sorted, self.Mgas
        )

    @lazy_property
    def HalfMassRadiusDM(self):
        return radii_ops.half_weight_radius_sorted(
            self._r_sorted, self._m_sorted, self._dm_sorted, self.Mdm
        )

    @lazy_property
    def HalfMassRadiusStar(self):
        return radii_ops.half_weight_radius_sorted(
            self._r_sorted, self._m_sorted, self._star_sorted, self.Mstar
        )

    # ---------------- kinematics ----------------

    def _L(self, mask, vcom_species):
        vel_rel = self.parts.vel - vcom_species[:, None, :]
        return kin.angular_momentum(self.parts.mass, self.parts.pos, vel_rel, mask)

    @lazy_property
    def Ldm(self):
        """DM angular momentum about (centre, vcom_dm)."""
        return self._L(self.mask_dm, self.vcom_dm)

    @lazy_property
    def Lgas(self):
        return self._L(self.mask_gas, self.vcom_gas)

    @lazy_property
    def Lstar(self):
        return self._L(self.mask_star, self.vcom_star)

    @lazy_property
    def veldisp_matrix_dm(self):
        return red.velocity_dispersion_matrix(
            self.parts.mass, self.parts.vel, self.vcom_dm, self.mask_dm
        )

    @lazy_property
    def veldisp_matrix_gas(self):
        return red.velocity_dispersion_matrix(
            self.parts.mass, self.parts.vel, self.vcom_gas, self.mask_gas
        )

    @lazy_property
    def veldisp_matrix_star(self):
        return red.velocity_dispersion_matrix(
            self.parts.mass, self.parts.vel, self.vcom_star, self.mask_star
        )

    def _vmax_soft_for(self, sorted_mask, ptypes=None):
        """Softened Vmax on the shared radius sort: with one softening
        value max(r, s) keeps the radius order; with several, the
        per-type step-function form stays exact on it.  ``ptypes``
        restricts to the types the selection can hold."""
        softs = dict(zip(self.ctx.ptypes, self.ctx.softening))
        pts = [pt for pt in (ptypes or self.ctx.ptypes) if pt in softs]
        values = sorted({softs[pt] for pt in pts})
        if len(values) <= 1:
            soft = values[0] if values else 0.0
            return kin.vmax_sorted(
                self._m_sorted, torch.clamp(self._r_sorted, min=soft), sorted_mask
            )
        masks = []
        for s in values:
            seg = None
            for pt in pts:
                if softs[pt] == s:
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
    def _vmax_dm_soft(self):
        return self._vmax_soft_for(self._dm_sorted, ptypes=("PartType1",))

    @lazy_property
    def DM_Vmax_soft(self):
        return torch.sqrt(self.ctx.G * self._vmax_dm_soft.vmax_sq_over_G)

    @lazy_property
    def DM_R_vmax_soft(self):
        return self._vmax_dm_soft.radius

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
        """Ex-situ stellar mass fraction: needs star-formation tracking
        data the snapshots lack, so 0."""
        return self._zeros()

    # ---------------- inertia tensors ----------------
    #  - BoundSubhalo: sphere = 10 x the species' half-mass radius, its
    #    bound particles only, no search-radius check;
    #  - SO: sphere = the SO radius, every candidate of the species,
    #    with the search-radius check;
    #  - apertures: sphere = the aperture radius, every bound particle of
    #    the species, no check.

    def _inertia_cfg(self, species: str):
        """(radius-sorted mask, sphere radius, search radius | None, gate)."""
        mask, hmr, gate = {
            "tot": lambda: (self._sel_sorted, self.HalfMassRadiusTot, self.Mtot),
            "gas": lambda: (self._gas_sorted, self.HalfMassRadiusGas, self.Mgas),
            "dm": lambda: (self._dm_sorted, self.HalfMassRadiusDM, self.Mdm),
            "star": lambda: (self._star_sorted, self.HalfMassRadiusStar, self.Mstar),
        }[species]()
        return mask, 10.0 * hmr, None, gate

    def _inertia_star_mask_sorted(self):
        """The luminosity-weighted configs' selection in star-sort order:
        the bound stars (SO overrides: every valid star)."""
        return self._star_sort_bound

    def _inertia_configs(self, iterative: bool, lum: bool):
        """[(config, sorted mask, sphere, search | None, gate)] for the
        requested inertia keys of one kind, in request order."""
        out = []
        for key in getattr(self, "_requested_keys", ()):
            cfg = _INERTIA3D_KEYS.get(key)
            if cfg is None or cfg[2] != iterative or cfg[3] != lum:
                continue
            if lum and not self._has("PartType4/Luminosities"):
                continue
            mask, sphere, search, gate = self._inertia_cfg(cfg[0])
            if lum:
                mask = self._inertia_star_mask_sorted()
            out.append((cfg, mask, sphere, search, gate))
        return out

    def _run_inertia(self, reqs, iterative, lum):
        """One inertia call for configs of one kind: mass-weighted configs
        share the mass weights on the radius-sorted rows; the luminosity
        configs run on the star segment's own radius sort, the bands on
        the halo axis.  Non-iterative configs take the loop-free single
        pass (plain PyTorch, as in the JAX package)."""
        search = None
        for r in reqs:
            if r[3] is not None:
                search = r[3]
        masks = torch.stack([r[1] for r in reqs], 1)
        sphere = torch.stack([r[2].to(torch.float32) for r in reqs], 1)
        kw = dict(
            search_radius=search,
            check_search=[r[3] is not None for r in reqs] if search is not None else None,
            single_pass=not iterative,
            rows_radius_sorted=True,  # both sorts ascend in radius
        )
        flags = [r[0][1] for r in reqs], [iterative] * len(reqs)
        if lum:
            weights = self._star_sort_lum.permute(0, 2, 1)  # (B, bands, K4)
            result, n = _count_launches(lambda: inertia_ops.inertia_tensor_bands(
                weights, self._star_sort_pos, masks, sphere, *flags, **kw
            ))
            labels = ("lum",)
        else:
            result, n = _count_launches(lambda: inertia_ops.inertia_tensor_multi(
                self._m_sorted, self._pos_sorted, masks, sphere, *flags, **kw
            ))
            labels = tuple(dict.fromkeys(r[0][0] for r in reqs))
        with kernel_lib.COUNT_LOCK:
            for label in labels if n else ():
                k2_launches_by_config[label] = k2_launches_by_config.get(label, 0) + n
        return result, search is not None

    @lazy_property
    def _inertia_batch3d(self):
        """{(species, reduced, iterative, band | None): (B, 6)} for every
        requested inertia key; adds the needs-bigger flag."""
        out = {}
        for iterative in (False, True):
            for lum in (False, True):
                reqs = self._inertia_configs(iterative, lum)
                if not reqs:
                    continue
                result, checked = self._run_inertia(reqs, iterative, lum)
                if checked:
                    nb = result.needs_bigger
                    self.add_flag(nb.flatten(1).any(1))
                for col, (cfg, _, _, _, gate) in enumerate(reqs):
                    if lum:
                        for band in range(N_BANDS):
                            out[cfg[:3] + (band,)] = torch.where(
                                gate[:, None] > 0, result.tensor[:, band, col], 0.0
                            )
                    else:
                        out[cfg[:3] + (None,)] = torch.where(
                            gate[:, None] > 0, result.tensor[:, col], 0.0
                        )
        return out

    def _inertia(self, key):
        species, red_, it, lum = _INERTIA3D_KEYS[key]
        if not lum:
            return self._inertia_batch3d[(species, red_, it, None)]
        if not self._has("PartType4/Luminosities"):
            return self._zeros(6 * N_BANDS)
        batch = self._inertia_batch3d
        return torch.cat([batch[(species, red_, it, b)] for b in range(N_BANDS)], 1)

    # =====================================================================
    # Hydro tier: gas, star and black-hole properties.  Extra per-type
    # datasets ride in ``parts.fields`` with type-local rows; the helpers
    # below cut the concatenated arrays (mass, pos, vel, masks) down to
    # one type's segment so both align.  A dataset the snapshot lacks
    # gives zeros.
    # =====================================================================

    def _seg_arr(self, arr: torch.Tensor, ptype: str) -> torch.Tensor:
        lo, hi = self.ctx.segment(ptype)
        return arr[:, lo:hi]

    def _has(self, name: str) -> bool:
        return name in self.parts.fields

    def field(self, name: str) -> torch.Tensor:
        return self.parts.fields[name]

    def _full_from_gas(self, values: torch.Tensor) -> torch.Tensor:
        """Gas-segment values (B, K0) on the full row axis, 0 elsewhere."""
        lo, hi = self.ctx.segment("PartType0")
        K = self.parts.valid.shape[1]
        return torch.nn.functional.pad(values, (lo, K - hi))

    # ---- gas ----

    @lazy_property
    def _gas_sel(self):
        """Selected-gas mask, gas-segment local."""
        return self._seg_arr(self.mask_gas, "PartType0")

    @lazy_property
    def _gas_mass(self):
        return self._seg_arr(self.parts.mass, "PartType0")

    @lazy_property
    def _gas_sfr(self):
        """SFR with SWIFT's negative last-star-formation scale factors
        zeroed."""
        return torch.clamp(self.field("PartType0/StarFormationRates"), min=0.0)

    @lazy_property
    def SFR(self):
        if not self._has("PartType0/StarFormationRates"):
            return self._zeros()
        return red.masked_sum(self._gas_sfr, self._gas_sel)

    @lazy_property
    def Mgas_SF(self):
        if not self._has("PartType0/StarFormationRates"):
            return self._zeros()
        sf = self._gas_sel & (self._gas_sfr > 0.0)
        return red.masked_sum(self._gas_mass, sf)

    @lazy_property
    def _gas_metal_mass(self):
        return self._gas_mass * self.field("PartType0/MetalMassFractions")

    @lazy_property
    def gasmetalfrac(self):
        if not self._has("PartType0/MetalMassFractions"):
            return self._zeros()
        mm = red.masked_sum(self._gas_metal_mass, self._gas_sel)
        return torch.where(self.Mgas > 0, mm / torch.clamp(self.Mgas, min=1e-37), 0.0)

    @lazy_property
    def gasmetalfrac_SF(self):
        if not (
            self._has("PartType0/MetalMassFractions")
            and self._has("PartType0/StarFormationRates")
        ):
            return self._zeros()
        sf = self._gas_sel & (self._gas_sfr > 0.0)
        mm = red.masked_sum(self._gas_metal_mass, sf)
        return torch.where(self.Mgas_SF > 0, mm / torch.clamp(self.Mgas_SF, min=1e-37), 0.0)

    #: hot/cool boundary (K)
    T_COOL_MAX = 1.0e5

    @lazy_property
    def _gas_temp(self):
        return self.field("PartType0/Temperatures")

    @lazy_property
    def Tgas(self):
        if not self._has("PartType0/Temperatures"):
            return self._zeros()
        m = torch.where(self._gas_sel, self._gas_mass, 0.0)
        return red.particle_sum(m * self._gas_temp) / torch.clamp(self.Mgas, min=1e-37)

    def _masked_mw_temperature(self, extra_mask):
        m = torch.where(self._gas_sel & extra_mask, self._gas_mass, 0.0)
        mtot = red.particle_sum(m)
        return torch.where(
            mtot > 0, red.particle_sum(m * self._gas_temp) / torch.clamp(mtot, min=1e-37), 0.0
        )

    @lazy_property
    def Tgas_no_cool(self):
        """Mass-weighted temperature of gas with T >= 1e5 K."""
        if not self._has("PartType0/Temperatures"):
            return self._zeros()
        return self._masked_mw_temperature(self._gas_temp >= self.T_COOL_MAX)

    @lazy_property
    def Mhotgas(self):
        if not self._has("PartType0/Temperatures"):
            return self._zeros()
        hot = self._gas_sel & (self._gas_temp >= self.T_COOL_MAX)
        return red.masked_sum(self._gas_mass, hot)

    # ---- kinetic energies (about vcom, with the Hubble flow) ----

    def _kinetic_energy(self, mask):
        v = self.parts.vel - self.vcom[:, None, :] + self.parts.pos * self.ctx.H
        m = torch.where(mask, self.parts.mass, 0.0)
        return 0.5 * red.particle_sum(m * (v * v).sum(-1))

    @lazy_property
    def KineticEnergyTotal(self):
        return self._kinetic_energy(self.selection)

    @lazy_property
    def KineticEnergyGas(self):
        return self._kinetic_energy(self.mask_gas)

    @lazy_property
    def KineticEnergyStars(self):
        return self._kinetic_energy(self.mask_star)

    # ---- kappa_corot family ----

    def _kappa(self, mask, vcom_species):
        vel_rel = self.parts.vel - vcom_species[:, None, :]
        return kin.angular_momentum_and_kappa(self.parts.mass, self.parts.pos, vel_rel, mask)

    @lazy_property
    def _kappa_gas(self):
        return self._kappa(self.mask_gas, self.vcom_gas)

    @lazy_property
    def _kappa_star(self):
        return self._kappa(self.mask_star, self.vcom_star)

    @lazy_property
    def kappa_corot_gas(self):
        return self._kappa_gas.kappa_corot

    @lazy_property
    def kappa_corot_star(self):
        return self._kappa_star.kappa_corot

    @lazy_property
    def _mask_bar(self):
        return self.mask_gas | self.mask_star

    @lazy_property
    def vcom_bar(self):
        return red.centre_of_mass_velocity(self.parts.mass, self.parts.vel, self._mask_bar)

    @lazy_property
    def Lbaryons(self):
        return self._L(self._mask_bar, self.vcom_bar)

    @lazy_property
    def kappa_corot_baryons(self):
        return self._kappa(self._mask_bar, self.vcom_bar).kappa_corot

    @lazy_property
    def DtoTgas(self):
        """Disc-to-total: 1 - 2 Mcounterrot / M."""
        m = self.Mgas
        return torch.where(
            m > 0, 1.0 - 2.0 * self._kappa_gas.m_counterrot / torch.clamp(m, min=1e-37), 0.0
        )

    @lazy_property
    def DtoTstar(self):
        m = self.Mstar
        return torch.where(
            m > 0, 1.0 - 2.0 * self._kappa_star.m_counterrot / torch.clamp(m, min=1e-37), 0.0
        )

    # ---- stars ----

    @lazy_property
    def _star_sel(self):
        return self._seg_arr(self.mask_star, "PartType4")

    @lazy_property
    def _star_mass(self):
        return self._seg_arr(self.parts.mass, "PartType4")

    @lazy_property
    def Mstar_init(self):
        if not self._has("PartType4/InitialMasses"):
            return self._zeros()
        return red.masked_sum(self.field("PartType4/InitialMasses"), self._star_sel)

    @lazy_property
    def starmetalfrac(self):
        if not self._has("PartType4/MetalMassFractions"):
            return self._zeros()
        mm = red.masked_sum(
            self._star_mass * self.field("PartType4/MetalMassFractions"), self._star_sel
        )
        return torch.where(self.Mstar > 0, mm / torch.clamp(self.Mstar, min=1e-37), 0.0)

    @lazy_property
    def _star_lum(self):
        """(B, K4, 9) luminosities in the GAMA bands."""
        return self.field("PartType4/Luminosities")

    @lazy_property
    def _star_lum_sel(self):
        """(B, K4, 9) the selected stars' luminosities, 0 elsewhere."""
        return torch.where(self._star_sel[..., None], self._star_lum, 0.0)

    @lazy_property
    def StellarLuminosity(self):
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        return red.particle_sum(self._star_lum_sel)

    @lazy_property
    def HalfLightRadiusStar(self):
        """Per-band half-light radii (B, 9) on the star segment's profile
        sort."""
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        r_s, order, lum_s = self._star_profile_sort
        sel_s = self._star_sel.gather(1, order)
        out = []
        for band in range(N_BANDS):
            w = lum_s[..., band]
            total = red.masked_sum(w, sel_s)
            out.append(radii_ops.half_weight_radius_sorted(r_s, w, sel_s, total))
        return torch.stack(out, 1)

    @lazy_property
    def HalfMassRadiusBaryon(self):
        bar_sorted = self._prof_sel_sorted & (
            self._prof_seg_sorted("PartType0") | self._prof_seg_sorted("PartType4")
        )
        return radii_ops.half_weight_radius_sorted(
            self._prof_r_sorted, self._prof_m_sorted, bar_sorted, self.Mgas + self.Mstar
        )

    @lazy_property
    def _stellar_ages(self):
        """Per-star age, derived on the host from the birth scale factor
        through the cosmology's age table (``pipeline/chunks.py``)."""
        return self.field("PartType4/StellarAges")

    @lazy_property
    def stellar_age_mw(self):
        if not self._has("PartType4/StellarAges"):
            return self._zeros()
        m = torch.where(self._star_sel, self._star_mass, 0.0)
        return torch.where(
            self.Mstar > 0,
            red.particle_sum(m * self._stellar_ages) / torch.clamp(self.Mstar, min=1e-37),
            0.0,
        )

    @lazy_property
    def stellar_age_lw(self):
        """r-band luminosity-weighted mean age."""
        if not (self._has("PartType4/StellarAges") and self._has("PartType4/Luminosities")):
            return self._zeros()
        Lr = self._star_lum_sel[..., GAMA_R_BAND]
        Ltot = red.particle_sum(Lr)
        return torch.where(
            Ltot > 0, red.particle_sum(Lr * self._stellar_ages) / torch.clamp(Ltot, min=1e-37), 0.0
        )

    # ---- stellar cylindrical kinematics ----

    @lazy_property
    def _star_pos_local(self):
        return self._seg_arr(self.parts.pos, "PartType4")

    @lazy_property
    def _star_vel_local(self):
        return self._seg_arr(self.parts.vel, "PartType4")

    def _star_vcyl_about(self, vcom_frame, L):
        """Cylindrical velocities of the selected stars, z along L, about
        the frame velocity (B, 3)."""
        sel = self._star_sel[..., None]
        vel = torch.where(sel, self._star_vel_local - vcom_frame[:, None, :], 0.0)
        pos = torch.where(sel, self._star_pos_local, 0.0)
        return kin.cylindrical_velocities(pos, vel, L)

    @lazy_property
    def _star_vcyl(self):
        return self._star_vcyl_about(self.vcom_star, self.Lstar)

    @lazy_property
    def _star_cyl_ok(self):
        return (self.Nstar >= 2) & ((self.Lstar * self.Lstar).sum(1) > 0)

    @lazy_property
    def StellarRotationalVelocity(self):
        v = kin.weighted_rotation_velocity(self._star_mass, self._star_vcyl[..., 1], self._star_sel)
        return torch.where(self._star_cyl_ok, v, 0.0)

    @lazy_property
    def _star_cyl_disp(self):
        return kin.weighted_cylindrical_dispersion(self._star_mass, self._star_vcyl, self._star_sel)

    @lazy_property
    def StellarCylindricalVelocityDispersion(self):
        v = torch.sqrt((self._star_cyl_disp**2).sum(1) / 3.0)
        return torch.where(self._star_cyl_ok, v, 0.0)

    @lazy_property
    def StellarCylindricalVelocityDispersionVertical(self):
        return torch.where(self._star_cyl_ok, self._star_cyl_disp[:, 2], 0.0)

    @lazy_property
    def StellarCylindricalVelocityDispersionDiscPlane(self):
        d = self._star_cyl_disp
        v = torch.sqrt((d[:, 0] ** 2 + d[:, 1] ** 2) / 2.0)
        return torch.where(self._star_cyl_ok, v, 0.0)

    # luminosity-weighted variants: each band's own frame

    @lazy_property
    def _star_vlum_coms(self):
        """(B, 9, 3) luminosity-weighted mean velocities per band."""
        w = self._star_lum_sel  # (B, K4, 9)
        wsum = torch.clamp(red.particle_sum(w), min=1e-37)
        wv = w[..., None] * self._star_vel_local[:, :, None, :]  # (B, K4, 9, 3)
        return red.particle_sum(wv) / wsum[..., None]

    def _star_vel_band(self, b):
        return self._star_vel_local - self._star_vlum_coms[:, b, None, :]

    @lazy_property
    def _star_lum_L(self):
        """(B, 9, 3) per-band luminosity-weighted angular momenta."""
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS, 3)
        return torch.stack(
            [
                kin.angular_momentum(
                    self._star_lum[..., b], self._star_pos_local, self._star_vel_band(b),
                    self._star_sel,
                )
                for b in range(N_BANDS)
            ],
            1,
        )

    @lazy_property
    def Lstar_luminosity_weighted(self):
        """(B, 27): 9 bands x 3 components."""
        return self._star_lum_L.reshape(self._star_lum_L.shape[0], -1)

    @lazy_property
    def _kappa_star_lw_bands(self):
        return [
            kin.angular_momentum_and_kappa(
                self._star_lum[..., b], self._star_pos_local, self._star_vel_band(b),
                self._star_sel,
            )
            for b in range(N_BANDS)
        ]

    @lazy_property
    def kappa_corot_star_luminosity_weighted(self):
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        return torch.stack([r.kappa_corot for r in self._kappa_star_lw_bands], 1)

    @lazy_property
    def _star_vcyl_lw_bands(self):
        """Per band: (cylindrical velocities about the band's frame, ok)."""
        out = []
        for b in range(N_BANDS):
            L = self._star_lum_L[:, b]
            vcyl = self._star_vcyl_about(self._star_vlum_coms[:, b], L)
            out.append((vcyl, (self.Nstar >= 2) & ((L * L).sum(1) > 0)))
        return out

    @lazy_property
    def StellarRotationalVelocityLuminosityWeighted(self):
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        vals = []
        for b, (vcyl, ok) in enumerate(self._star_vcyl_lw_bands):
            v = kin.weighted_rotation_velocity(
                self._star_lum[..., b], vcyl[..., 1], self._star_sel
            )
            vals.append(torch.where(ok, v, 0.0))
        return torch.stack(vals, 1)

    @lazy_property
    def _star_cyl_disp_lw_bands(self):
        """(B, 9, 3) per-band luminosity-weighted cylindrical dispersions."""
        rows = []
        for b, (vcyl, ok) in enumerate(self._star_vcyl_lw_bands):
            d = kin.weighted_cylindrical_dispersion(self._star_lum[..., b], vcyl, self._star_sel)
            rows.append(torch.where(ok[:, None], d, 0.0))
        return torch.stack(rows, 1)

    @lazy_property
    def StellarCylindricalVelocityDispersionLuminosityWeighted(self):
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        return torch.sqrt((self._star_cyl_disp_lw_bands**2).sum(2) / 3.0)

    @lazy_property
    def StellarCylindricalVelocityDispersionVerticalLuminosityWeighted(self):
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        return self._star_cyl_disp_lw_bands[..., 2]

    @lazy_property
    def StellarCylindricalVelocityDispersionDiscPlaneLuminosityWeighted(self):
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        d = self._star_cyl_disp_lw_bands
        return torch.sqrt((d[..., 0] ** 2 + d[..., 1] ** 2) / 2.0)

    @lazy_property
    def DtoTstar_luminosity_weighted_luminosity_ratio(self):
        """(B, 9) 1 - 2 x (counter-rotating band luminosity) / (total)."""
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        Ltot = red.particle_sum(self._star_lum_sel)
        m_counter = torch.stack([r.m_counterrot for r in self._kappa_star_lw_bands], 1)
        return torch.where(
            Ltot > 0, 1.0 - 2.0 * m_counter / torch.clamp(Ltot, min=1e-37), 0.0
        )

    @lazy_property
    def DtoTstar_luminosity_weighted_mass_ratio(self):
        """(B, 9) 1 - 2 x (stellar mass counter-rotating about each band's
        luminosity-weighted L) / (total stellar mass)."""
        if not self._has("PartType4/Luminosities"):
            return self._zeros(N_BANDS)
        vals = []
        for b in range(N_BANDS):
            L = self._star_lum_L[:, b]
            Ldir = L / torch.sqrt(torch.clamp((L * L).sum(1), min=1e-37))[:, None]
            Li = (
                self._star_mass[..., None]
                * torch.linalg.cross(self._star_pos_local, self._star_vel_band(b), dim=-1)
                * Ldir[:, None, :]
            ).sum(-1)
            m_counter = red.masked_sum(self._star_mass, self._star_sel & (Li < 0.0))
            vals.append(torch.where(
                self.Mstar > 0, 1.0 - 2.0 * m_counter / torch.clamp(self.Mstar, min=1e-37), 0.0
            ))
        return torch.stack(vals, 1)

    # ---- black holes ----

    @lazy_property
    def _bh_sel(self):
        return self._seg_arr(self.mask_bh, "PartType5")

    @lazy_property
    def Mbh_subgrid(self):
        if not self._has("PartType5/SubgridMasses"):
            return self._zeros()
        return red.masked_sum(self.field("PartType5/SubgridMasses"), self._bh_sel)

    @lazy_property
    def _bh_max_idx(self):
        """(index, found) of the most massive (subgrid) selected BH."""
        sub = torch.where(self._bh_sel, self.field("PartType5/SubgridMasses"), -torch.inf)
        return torch.argmax(sub, 1), self._bh_sel.any(1)

    def _bh_max_of(self, values, fill=0.0):
        idx, found = self._bh_max_idx
        val = _take(values, idx)
        f = found.reshape((-1,) + (1,) * (val.dim() - 1))
        return torch.where(f, val, torch.full_like(val, fill))

    def _bh_max_field(self, name, fill=0.0):
        if not (self._has("PartType5/SubgridMasses") and self._has(name)):
            return self._zeros() + fill
        return self._bh_max_of(self.field(name), fill)

    @lazy_property
    def BHmaxM(self):
        return self._bh_max_field("PartType5/SubgridMasses")

    @lazy_property
    def BHmaxID(self):
        if not (self._has("PartType5/SubgridMasses") and self._has("PartType5/ParticleIDs")):
            return self._zeros(dtype=torch.int64)
        return self._bh_max_of(self.field("PartType5/ParticleIDs"))

    @lazy_property
    def BHmaxpos(self):
        if not self._has("PartType5/SubgridMasses"):
            return self._zeros(3)
        _, found = self._bh_max_idx
        rel = self._bh_max_of(self._seg_arr(self.parts.pos, "PartType5"))
        return torch.where(found[:, None], self.scalars.centre * self.ctx.a + rel, 0.0)

    @lazy_property
    def BHmaxvel(self):
        if not self._has("PartType5/SubgridMasses"):
            return self._zeros(3)
        return self._bh_max_of(self._seg_arr(self.parts.vel, "PartType5"))

    @lazy_property
    def BHmaxAR(self):
        return self._bh_max_field("PartType5/AccretionRates")

    @lazy_property
    def BHmaxlasteventa(self):
        return self._bh_max_field("PartType5/LastAGNFeedbackScaleFactors")

    @lazy_property
    def BHlasteventa(self):
        """Most recent AGN event scale factor over the selected BHs."""
        if not self._has("PartType5/LastAGNFeedbackScaleFactors"):
            return self._zeros()
        a = torch.where(self._bh_sel, self.field("PartType5/LastAGNFeedbackScaleFactors"), 0.0)
        return a.amax(1)

    def _bh_sum(self, name):
        if not self._has(name):
            return self._zeros()
        return red.masked_sum(self.field(name), self._bh_sel)

    @lazy_property
    def BlackHolesTotalInjectedThermalEnergy(self):
        return self._bh_sum("PartType5/AGNTotalInjectedEnergies")

    @lazy_property
    def BlackHolesTotalInjectedJetEnergy(self):
        return self._bh_sum("PartType5/InjectedJetEnergies")

    # ---- the recently-AGN-heated gas filter ----

    @lazy_property
    def _gas_recently_heated(self):
        """Recently AGN-heated gas (reference
        ``recently_heated_gas_filter.py:155-173``)."""
        if not self._has("PartType0/LastAGNFeedbackScaleFactors"):
            return torch.zeros_like(self._gas_sel)
        heated = self.field("PartType0/LastAGNFeedbackScaleFactors") >= self.ctx.agn_a_limit
        if self._has("PartType0/Temperatures"):
            heated = (
                heated
                & (self._gas_temp >= self.ctx.agn_Tmin)
                & (self._gas_temp <= self.ctx.agn_Tmax)
            )
        return heated

    @lazy_property
    def Tgas_no_agn(self):
        if not self._has("PartType0/Temperatures"):
            return self._zeros()
        return self._masked_mw_temperature(~self._gas_recently_heated)

    @lazy_property
    def Tgas_no_cool_no_agn(self):
        if not self._has("PartType0/Temperatures"):
            return self._zeros()
        return self._masked_mw_temperature(
            ~self._gas_recently_heated & (self._gas_temp >= self.T_COOL_MAX)
        )

    @lazy_property
    def AveragedStarFormationRate(self):
        if not self._has("PartType0/AveragedStarFormationRates"):
            return self._zeros(2)
        avg = self.field("PartType0/AveragedStarFormationRates")
        return red.masked_sum(avg, self._gas_sel)

    # ---- dust ----

    @lazy_property
    def _gas_dust_mass(self):
        return self._gas_mass * self.field("PartType0/TotalDustMassFractions")

    @lazy_property
    def DustMass(self):
        if not self._has("PartType0/TotalDustMassFractions"):
            return self._zeros()
        return red.masked_sum(self._gas_dust_mass, self._gas_sel)

    @lazy_property
    def HalfMassRadiusDust(self):
        if not self._has("PartType0/TotalDustMassFractions"):
            return self._zeros()
        w = self._full_from_gas(self._gas_dust_mass).gather(1, self._prof_order)
        return radii_ops.half_weight_radius_sorted(
            self._prof_r_sorted, w, self._prof_gas_sorted, self.DustMass
        )

    # ---- thermal and potential energies ----

    @lazy_property
    def ThermalEnergyGas(self):
        """Sum of m u with u = P / ((gamma - 1) rho), gamma = 5/3."""
        if not (self._has("PartType0/Pressures") and self._has("PartType0/Densities")):
            return self._zeros()
        u = self.field("PartType0/Pressures") / (
            (5.0 / 3.0 - 1.0) * torch.clamp(self.field("PartType0/Densities"), min=1e-37)
        )
        return red.masked_sum(self._gas_mass * u, self._gas_sel)

    @lazy_property
    def PotentialEnergyTotal(self):
        """Sum of m x specific potential / 2 over the selected types."""
        total = self._zeros()
        for ptype, mass_name in (
            ("PartType0", None), ("PartType1", None), ("PartType4", None),
            ("PartType5", "PartType5/DynamicalMasses"),
        ):
            key = f"{ptype}/SpecificPotentialEnergies"
            if not self._has(key):
                continue
            sel = self._seg_arr(self.selection, ptype)
            m = (
                self.field(mass_name) if mass_name and self._has(mass_name)
                else self._seg_arr(self.parts.mass, ptype)
            )
            total = total + 0.5 * red.masked_sum(m * self.field(key), sel)
        return total

    # ---- stellar birth statistics (median / min / max) ----

    def _masked_stat(self, vals, stat):
        sel = self._star_sel
        if stat == "min":
            v = torch.where(sel, vals, torch.inf).amin(1)
        elif stat == "max":
            v = torch.where(sel, vals, -torch.inf).amax(1)
        else:
            # the masked median of np.median: the two middle values' mean
            s = torch.sort(torch.where(sel, vals, torch.inf), 1).values
            n = sel.sum(1)
            lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
            hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
            med = 0.5 * (_take(s, lo) + _take(s, hi))
            return torch.where(n > 0, med, 0.0)
        return torch.where(torch.isfinite(v), v, 0.0)

    def _star_birth_stat(self, name, stat):
        if not self._has(name):
            return self._zeros()
        return self._masked_stat(self.field(name), stat)

    @lazy_property
    def MedianStellarBirthDensity(self):
        return self._star_birth_stat("PartType4/BirthDensities", "median")

    @lazy_property
    def MinimumStellarBirthDensity(self):
        return self._star_birth_stat("PartType4/BirthDensities", "min")

    @lazy_property
    def MaximumStellarBirthDensity(self):
        return self._star_birth_stat("PartType4/BirthDensities", "max")

    @lazy_property
    def MedianStellarBirthTemperature(self):
        return self._star_birth_stat("PartType4/BirthTemperatures", "median")

    @lazy_property
    def MinimumStellarBirthTemperature(self):
        return self._star_birth_stat("PartType4/BirthTemperatures", "min")

    @lazy_property
    def MaximumStellarBirthTemperature(self):
        return self._star_birth_stat("PartType4/BirthTemperatures", "max")

    def _birth_pressure_stat(self, stat):
        """Birth pressure rho T (ideal gas, the mean molecular weight
        folded into the units)."""
        if not (
            self._has("PartType4/BirthDensities") and self._has("PartType4/BirthTemperatures")
        ):
            return self._zeros()
        p = self.field("PartType4/BirthDensities") * self.field("PartType4/BirthTemperatures")
        return self._masked_stat(p, stat)

    @lazy_property
    def MedianStellarBirthPressure(self):
        return self._birth_pressure_stat("median")

    @lazy_property
    def MinimumStellarBirthPressure(self):
        return self._birth_pressure_stat("min")

    @lazy_property
    def MaximumStellarBirthPressure(self):
        return self._birth_pressure_stat("max")

    @lazy_property
    def LastSupernovaEventMaximumGasDensity(self):
        """Max over gas of the larger last SNII thermal/kinetic feedback
        density."""
        names = [
            n for n in ("PartType0/LastSNIIThermalFeedbackDensities",
                        "PartType0/LastSNIIKineticFeedbackDensities")
            if self._has(n)
        ]
        if not names:
            return self._zeros()
        dens = self.field(names[0])
        for n in names[1:]:
            dens = torch.maximum(dens, self.field(n))
        v = torch.where(self._gas_sel, dens, -torch.inf).amax(1)
        return torch.where(torch.isfinite(v), v, 0.0)

    # ---- X-ray, Compton-y, spectroscopic-like temperatures ----

    def _gas_band_sum(self, name, extra_mask=None, bands=3):
        if not self._has(name):
            return self._zeros(bands)
        mask = self._gas_sel if extra_mask is None else self._gas_sel & extra_mask
        return red.masked_sum(self.field(name), mask)

    @lazy_property
    def Xraylum(self):
        return self._gas_band_sum("PartType0/XrayLuminosities")

    @lazy_property
    def Xrayphlum(self):
        return self._gas_band_sum("PartType0/XrayPhotonLuminosities")

    @lazy_property
    def Xraylum_restframe(self):
        return self._gas_band_sum("PartType0/XrayLuminositiesRestframe")

    @lazy_property
    def Xrayphlum_restframe(self):
        return self._gas_band_sum("PartType0/XrayPhotonLuminositiesRestframe")

    @lazy_property
    def Xraylum_no_agn(self):
        return self._gas_band_sum("PartType0/XrayLuminosities", ~self._gas_recently_heated)

    @lazy_property
    def Xrayphlum_no_agn(self):
        return self._gas_band_sum(
            "PartType0/XrayPhotonLuminosities", ~self._gas_recently_heated
        )

    @lazy_property
    def Xraylum_restframe_no_agn(self):
        return self._gas_band_sum(
            "PartType0/XrayLuminositiesRestframe", ~self._gas_recently_heated
        )

    @lazy_property
    def Xrayphlum_restframe_no_agn(self):
        return self._gas_band_sum(
            "PartType0/XrayPhotonLuminositiesRestframe", ~self._gas_recently_heated
        )

    def _compY_sum(self, extra_mask=None):
        if not self._has("PartType0/ComptonYParameters"):
            return self._zeros()
        mask = self._gas_sel if extra_mask is None else self._gas_sel & extra_mask
        return red.masked_sum(self.field("PartType0/ComptonYParameters"), mask)

    @lazy_property
    def compY(self):
        return self._compY_sum()

    @lazy_property
    def compY_no_agn(self):
        return self._compY_sum(~self._gas_recently_heated)

    def _cy_weighted_T(self, extra_mask=None):
        """Compton-y-weighted mean temperature."""
        if not (
            self._has("PartType0/ComptonYParameters") and self._has("PartType0/Temperatures")
        ):
            return self._zeros()
        mask = self._gas_sel if extra_mask is None else self._gas_sel & extra_mask
        y = torch.where(mask, self.field("PartType0/ComptonYParameters"), 0.0)
        ysum = red.particle_sum(y)
        return torch.where(
            ysum > 0, red.particle_sum(y * self._gas_temp) / torch.clamp(ysum, min=1e-37), 0.0
        )

    @lazy_property
    def Tgas_cy_weighted(self):
        return self._cy_weighted_T()

    @lazy_property
    def Tgas_cy_weighted_no_agn(self):
        return self._cy_weighted_T(~self._gas_recently_heated)

    #: the X-ray temperature selection threshold (K)
    T_XRAY_MIN = 1.16e6

    def _spectroscopic_like_T(self, extra_mask=None):
        """rho m T^(1/4) / rho m T^(-3/4) over gas hotter than 1.16e6 K."""
        if not (self._has("PartType0/Densities") and self._has("PartType0/Temperatures")):
            return self._zeros()
        mask = self._gas_sel & (self._gas_temp > self.T_XRAY_MIN)
        if extra_mask is not None:
            mask = mask & extra_mask
        rho_m = self.field("PartType0/Densities") * self._gas_mass
        T = torch.clamp(self._gas_temp, min=1e-30)
        num = red.masked_sum(rho_m * T**0.25, mask)
        den = red.masked_sum(rho_m * T**-0.75, mask)
        return torch.where(den > 0, num / torch.clamp(den, min=1e-37), 0.0)

    @lazy_property
    def SpectroscopicLikeTemperature(self):
        return self._spectroscopic_like_T()

    @lazy_property
    def SpectroscopicLikeTemperature_no_agn(self):
        return self._spectroscopic_like_T(~self._gas_recently_heated)


#: "most massive BH" lookups: key -> (dataset, value shape, integer?)
_BH_MAX_DETAIL = {
    "MostMassiveBlackHoleAveragedAccretionRate": ("PartType5/AveragedAccretionRates", (2,), False),
    "MostMassiveBlackHoleAccretionMode": ("PartType5/AccretionModes", (), True),
    "MostMassiveBlackHoleFormationScalefactor": ("PartType5/FormationScaleFactors", (), False),
    "MostMassiveBlackHoleGWMassLoss": ("PartType5/GWMassLosses", (), False),
    "MostMassiveBlackHoleInjectedJetEnergyByMode": (
        "PartType5/InjectedJetEnergiesByMode", (3,), False),
    "MostMassiveBlackHoleInjectedThermalEnergy": (
        "PartType5/AGNTotalInjectedEnergies", (), False),
    "MostMassiveBlackHoleLastJetEventScalefactor": (
        "PartType5/LastAGNJetScaleFactors", (), False),
    "MostMassiveBlackHoleNumberOfAGNEvents": ("PartType5/NumberOfAGNEvents", (), True),
    "MostMassiveBlackHoleNumberOfAGNJetEvents": ("PartType5/NumberOfAGNJetEvents", (), True),
    "MostMassiveBlackHoleNumberOfMergers": ("PartType5/NumberOfMergers", (), True),
    "MostMassiveBlackHoleRadiatedEnergyByMode": (
        "PartType5/RadiatedEnergiesByMode", (3,), False),
    "MostMassiveBlackHoleSpin": ("PartType5/Spins", (), False),
    "MostMassiveBlackHoleTotalAccretedMass": ("PartType5/TotalAccretedMasses", (), False),
    "MostMassiveBlackHoleTotalAccretedMassesByMode": (
        "PartType5/TotalAccretedMassesByMode", (3,), False),
    "MostMassiveBlackHoleWindEnergyByMode": ("PartType5/WindEnergiesByMode", (3,), False),
}


def _make_bh_detail(key, dataset, shape, is_int):
    def method(self):
        if not (self._has("PartType5/SubgridMasses") and self._has(dataset)):
            return self._zeros(*shape, dtype=torch.int32 if is_int else torch.float32)
        return self._bh_max_of(self.field(dataset))

    method.__name__ = key
    method.__doc__ = f"{dataset} of the most massive (subgrid) selected BH."
    return lazy_property(method)


for _key, (_ds, _shape, _int) in _BH_MAX_DETAIL.items():
    setattr(HaloSlice, _key, _make_bh_detail(_key, _ds, _shape, _int))


def _make_inertia3d(key):
    def method(self):
        return self._inertia(key)

    method.__name__ = key
    return lazy_property(method)


for _key in _INERTIA3D_KEYS:
    setattr(HaloSlice, _key, _make_inertia3d(_key))


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
    ``physical_radius`` instead, as does a parameter file's fixed-radius
    SO.  The density definitions and their radius multiples are virial;
    a fixed-radius SO (``virial=False``) has no flow rates and no
    concentrations (they come out 0).  ``core_excision_fraction`` f
    excises the gas within f x R_SO from the core-excised keys."""

    def __init__(self, ctx, parts, scalars, target_density=None, physical_radius=None,
                 core_excision_fraction=None, virial: bool = True):
        super().__init__(ctx, parts, scalars)
        self.target_density = target_density
        self.physical_radius = (
            None if physical_radius is None else _per_halo(physical_radius, parts.valid)
        )
        self.core_excision_fraction = core_excision_fraction
        self.virial_definition = virial

    def _inertia_cfg(self, species: str):
        """SO inertia: sphere = SO radius, ALL candidates of the species
        (the ellipsoid may deform beyond R_SO), search-radius check on."""
        if species == "tot":
            mask, gate = self._valid_sorted, self.SO_mass
        else:
            pt, gate = {
                "gas": ("PartType0", self.Mgas), "dm": ("PartType1", self.Mdm),
                "star": ("PartType4", self.Mstar),
            }[species]
            mask = self._valid_sorted & self._seg_sorted(pt)
        return mask, self.r, self.scalars.search_radius, gate

    def _inertia_star_mask_sorted(self):
        return torch.isfinite(self._star_sort_r)

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

    def _per_so_mass(self, m):
        return torch.where(self.exists, m / torch.clamp(self.SO_mass, min=1e-37), 0.0)

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
    def _bound_to_satellite(self):
        return self._bound_elsewhere() & (self.parts.fofid == self._halo_fofid[:, None])

    @lazy_property
    def Mfrac_satellites(self):
        return self._per_so_mass(red.masked_sum(self.parts.mass, self._bound_to_satellite))

    @lazy_property
    def Mfrac_external(self):
        ext = self._bound_elsewhere() & (self.parts.fofid != self._halo_fofid[:, None])
        return self._per_so_mass(red.masked_sum(self.parts.mass, ext))

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
        window, the shell width and the kinetic term; computed once for
        every flow key."""
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
            vx, vy, vz = dv[..., 0], dv[..., 1], dv[..., 2]
            v_r = (
                vx * rhat[..., 0] + vy * rhat[..., 1] + vz * rhat[..., 2]
            ) - (frac * rdot)[:, None]
            kinetic = 0.5 * (vx * vx + vy * vy + vz * vz)
            out[frac] = (v_r, geom, dR, kinetic)
        return out

    def _flow_rate(self, mask_species, weights, flow_type, fast_outflows=False):
        """Inflow then outflow rates (B, 6) through the shells at 0.1, 0.3
        and 1.0 x R_SO (width 0.1 R_shell), then the fast outflows
        (v_r > 0.25 Vmax_soft) with ``fast_outflows`` (B, 9); every valid
        candidate of the species counts, the shells reach past R_SO."""
        shells = []
        for frac in self._FLOW_FRACS:
            v_r, geom, dR, kinetic = self._flow_shells[frac]
            in_shell = mask_species & geom
            if flow_type == "mass":
                fr = weights * torch.abs(v_r)
            elif flow_type == "energy":
                # m |v_r| (kinetic + internal)
                fr = weights * torch.abs(v_r) * (kinetic + self._u_full)
            elif flow_type == "momentum":
                # m (v_r^2 + c_s^2 / gamma), c_s^2 = gamma (gamma - 1) u
                fr = weights * (v_r**2 + (5.0 / 3.0 - 1.0) * self._u_full)
            else:
                raise ValueError(flow_type)
            inflow = red.masked_sum(fr, in_shell & (v_r < 0)) / dR
            outflow = red.masked_sum(fr, in_shell & (v_r > 0)) / dR
            fast = None
            if fast_outflows:
                fast_m = in_shell & (v_r > 0.25 * self.Vmax_soft[:, None])
                fast = red.masked_sum(fr, fast_m) / dR
            shells.append((inflow, outflow, fast))
        flat = [s[0] for s in shells] + [s[1] for s in shells]
        if fast_outflows:
            flat += [s[2] for s in shells]
        return torch.where(self.exists[:, None], torch.stack(flat, 1), 0.0)

    @lazy_property
    def DarkMatterMassFlowRate(self):
        if not self.virial_definition:
            return self._zeros(6)
        return self._flow_rate(self._valid_type_mask("PartType1"), self.parts.mass, "mass")

    @lazy_property
    def StellarMassFlowRate(self):
        if not self.virial_definition:
            return self._zeros(6)
        return self._flow_rate(self._valid_type_mask("PartType4"), self.parts.mass, "mass")

    @lazy_property
    def MetalMassFlowRate(self):
        if not (self.virial_definition and self._has("PartType0/MetalMassFractions")):
            return self._zeros(6)
        w = self._full_from_gas(self._gas_mass * self.field("PartType0/MetalMassFractions"))
        return self._flow_rate(self._valid_type_mask("PartType0"), w, "mass")

    #: the temperature bands of the gas flow rates (K)
    _GAS_T_BANDS = {
        "Cold": (None, 1.0e3),
        "Cool": (1.0e3, 1.0e5),
        "Warm": (1.0e5, 1.0e7),
        "Hot": (1.0e7, None),
    }

    @lazy_property
    def _u_full(self):
        """Specific internal energies on the full row axis (0 outside the
        gas segment)."""
        if not self._has("PartType0/InternalEnergies"):
            return torch.zeros_like(self.parts.mass)
        return self._full_from_gas(self.field("PartType0/InternalEnergies"))

    def _gas_T_flow(self, band, flow_type="mass"):
        if not (self.virial_definition and self._has("PartType0/Temperatures")):
            return self._zeros(9)
        if flow_type != "mass" and not self._has("PartType0/InternalEnergies"):
            return self._zeros(9)
        tmin, tmax = self._GAS_T_BANDS[band]
        t_full = self._full_from_gas(self._gas_temp)
        mask = self._valid_type_mask("PartType0")
        if tmin is not None:
            mask = mask & (t_full > tmin)
        if tmax is not None:
            mask = mask & (t_full < tmax)
        return self._flow_rate(mask, self.parts.mass, flow_type, fast_outflows=True)

    # -- concentrations

    def _concentration_fit(self, R1, ok):
        """The R1 fit in float64, as the JAX package evaluates it."""
        x = torch.log10(torch.clamp(R1, min=1e-10)).to(torch.float64)
        logc = torch.zeros_like(x)
        for c in _CONCENTRATION_POLY:
            logc = logc * x + c
        logc = torch.clamp(logc, 0.0, 3.0)
        return torch.where(ok, 10.0**logc, 0.0)

    def _concentration(self, radius_arr):
        """R1-statistic concentration with the missed-mass correction."""
        sel = self.selection
        r = self.r
        nu = self.ctx.nu_density
        R1 = red.masked_sum(self.parts.mass * torch.where(sel, radius_arr, 0.0), sel)
        missed = self.SO_mass - red.masked_sum(self.parts.mass, sel)
        R1 = R1 + math.pi * nu * r**4
        missed = missed - nu * (4.0 / 3.0) * math.pi * r**3
        R1 = R1 + missed * r
        R1 = R1 / torch.clamp(r * self.SO_mass, min=1e-37)
        return self._concentration_fit(R1, self.exists & (red.masked_count(sel) >= 10))

    @lazy_property
    def concentration_unsoft(self):
        if not self.virial_definition:
            return self._zeros()
        return self._concentration(self.radius)

    @lazy_property
    def concentration_soft(self):
        if not self.virial_definition:
            return self._zeros()
        return self._concentration(self.soft_radius)

    @lazy_property
    def _dm_missed_mass(self):
        """Interpolated mass of the first DM particle beyond R_SO:
        m2 (R_SO - r1) / (r2 - r1)."""
        dm_valid = self._valid_type_mask("PartType1")
        rr = self.r[:, None]
        inside = dm_valid & (self.radius < rr)
        outside = dm_valid & (self.radius >= rr)
        r1 = torch.where(inside, self.radius, -torch.inf).amax(1)
        r_out = torch.where(outside, self.radius, torch.inf)
        i2 = torch.argmin(r_out, 1)
        r2 = _take(r_out, i2)
        m2 = _take(self.parts.mass, i2)
        ok = inside.any(1) & outside.any(1) & (r2 > r1)
        return torch.where(ok, m2 * (self.r - r1) / torch.clamp(r2 - r1, min=1e-37), 0.0)

    def _concentration_dmo(self, radius_arr):
        """DM-only R1 concentration with the missed-mass correction."""
        R1 = red.masked_sum(self.parts.mass * radius_arr, self.mask_dm)
        R1 = R1 + self._dm_missed_mass * self.r
        denom = self.r * (self.Mdm + self._dm_missed_mass)
        R1 = R1 / torch.clamp(denom, min=1e-37)
        return self._concentration_fit(R1, self.exists & (self.Ndm >= 10))

    @lazy_property
    def concentration_dmo_unsoft(self):
        if not self.virial_definition:
            return self._zeros()
        return self._concentration_dmo(self.radius)

    @lazy_property
    def concentration_dmo_soft(self):
        if not self.virial_definition:
            return self._zeros()
        return self._concentration_dmo(self.soft_radius)

    @lazy_property
    def spin_parameter(self):
        """SO spin: |L| / (sqrt(2) M V R), V = sqrt(G M / R) at R_SO."""
        vel_rel = self.parts.vel - self.vcom[:, None, :]
        L = kin.angular_momentum(self.parts.mass, self.parts.pos, vel_rel, self.selection)
        Lnorm = torch.sqrt((L * L).sum(1))
        lam = kin.spin_parameter(Lnorm, self.SO_mass, self.r, self.ctx.G)
        return torch.where(self.exists, lam, 0.0)

    # -- Doppler B toward the lightcone observer

    @lazy_property
    def DopplerB(self):
        """sigma_T / c x sum of n_e v_r V_particle / (pi R_SO^2) along the
        line of sight to the observer; the reduction in float64, the
        constant being far below the float32 range."""
        if not (
            self._has("PartType0/ElectronNumberDensities") and self._has("PartType0/Densities")
        ):
            return self._zeros()
        sel = self._seg_arr(self.selection, "PartType0")
        pos = self._seg_arr(self.parts.pos, "PartType0")
        vel = self._seg_arr(self.parts.vel, "PartType0")
        obs = torch.tensor(
            self.ctx.observer_position, dtype=torch.float32, device=pos.device
        ) * self.ctx.a
        relpos = pos + (self.scalars.centre * self.ctx.a - obs)[:, None, :]
        dist = torch.sqrt((relpos * relpos).sum(-1))
        vr = torch.where(
            dist > 0, (vel * relpos).sum(-1) / torch.clamp(dist, min=1e-37), 0.0
        )
        ne = self.field("PartType0/ElectronNumberDensities")
        volumes = self._gas_mass / torch.clamp(self.field("PartType0/Densities"), min=1e-37)
        area = math.pi * torch.clamp(self.r, min=1e-37) ** 2
        sigma_t_over_c = 6.6524587158e-29 / (3.0856775815e22**2) / 2.99792458e5
        total = red.particle_sum(
            red.Summand(ne * vr * volumes, sel, torch.float64)
        ) / area.to(torch.float64)
        return torch.where(self.exists, sigma_t_over_c * total, 0.0).to(torch.float32)

    # -- satellite-excluded and core-excised X-ray luminosities and
    # temperatures (the core-excised ones belong to core-excised SOs)

    @lazy_property
    def _gas_not_satellite(self):
        """Gas not bound to another subhalo of the same FOF group."""
        return ~self._seg_arr(self._bound_to_satellite, "PartType0")

    @lazy_property
    def _gas_core_excised(self):
        """Gas outside the excised core r < f x R_SO."""
        f = self.core_excision_fraction or 0.0
        return self._seg_arr(self.radius, "PartType0") > f * self.r[:, None]

    @lazy_property
    def XRayLuminosityNoSat(self):
        return self._gas_band_sum("PartType0/XrayLuminosities", self._gas_not_satellite)

    @lazy_property
    def XRayLuminosityCoreExcisionNoSat(self):
        return self._gas_band_sum(
            "PartType0/XrayLuminosities", self._gas_not_satellite & self._gas_core_excised
        )

    def _ce_temperature(self, extra):
        if not self._has("PartType0/Temperatures"):
            return self._zeros()
        return self._masked_mw_temperature(self._gas_core_excised & extra)

    @lazy_property
    def Tgas_core_excision(self):
        return self._ce_temperature(True)

    @lazy_property
    def Tgas_no_cool_core_excision(self):
        return self._ce_temperature(self._gas_temp >= self.T_COOL_MAX)

    @lazy_property
    def Tgas_no_agn_core_excision(self):
        return self._ce_temperature(~self._gas_recently_heated)

    @lazy_property
    def Tgas_no_cool_no_agn_core_excision(self):
        return self._ce_temperature(
            ~self._gas_recently_heated & (self._gas_temp >= self.T_COOL_MAX)
        )

    @lazy_property
    def Tgas_cy_weighted_core_excision(self):
        return self._cy_weighted_T(self._gas_core_excised)

    @lazy_property
    def Tgas_cy_weighted_core_excision_no_agn(self):
        return self._cy_weighted_T(self._gas_core_excised & ~self._gas_recently_heated)

    @lazy_property
    def SpectroscopicLikeTemperature_core_excision(self):
        return self._spectroscopic_like_T(self._gas_core_excised)

    @lazy_property
    def SpectroscopicLikeTemperature_no_agn_core_excision(self):
        return self._spectroscopic_like_T(self._gas_core_excised & ~self._gas_recently_heated)


def _make_gas_flow(band, flow_type):
    def method(self):
        return self._gas_T_flow(band, flow_type)

    method.__name__ = f"{band}Gas{flow_type.capitalize()}FlowRate"
    return lazy_property(method)


for _band in SOSlice._GAS_T_BANDS:
    for _ft in ("mass", "energy", "momentum"):
        setattr(SOSlice, f"{_band}Gas{_ft.capitalize()}FlowRate", _make_gas_flow(_band, _ft))


def _make_band_sum(dataset, mask_attr):
    def method(self):
        mask = self._gas_core_excised
        if mask_attr:
            mask = mask & ~self._gas_recently_heated
        return self._gas_band_sum(dataset, mask)

    return lazy_property(method)


for _name, _ds in (("Xraylum", "XrayLuminosities"), ("Xrayphlum", "XrayPhotonLuminosities"),
                   ("Xraylum_restframe", "XrayLuminositiesRestframe"),
                   ("Xrayphlum_restframe", "XrayPhotonLuminositiesRestframe")):
    setattr(SOSlice, f"{_name}_core_excision", _make_band_sum(f"PartType0/{_ds}", False))
    setattr(SOSlice, f"{_name}_no_agn_core_excision", _make_band_sum(f"PartType0/{_ds}", True))


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

    def _inertia_cfg(self, species: str):
        """Aperture inertia: sphere = the aperture radius, ALL bound
        particles of the species (the ellipsoid may deform beyond it)."""
        if species == "tot":
            return self._bound_sorted, self.aperture_radius, None, self.Mtot
        pt, gate = {
            "gas": ("PartType0", self.Mgas), "dm": ("PartType1", self.Mdm),
            "star": ("PartType4", self.Mstar),
        }[species]
        return self._bound_sorted & self._seg_sorted(pt), self.aperture_radius, None, gate


class ProjectedApertureSlice(HaloSlice):
    """``ProjectedAperture/<R>/proj{x,y,z}``: bound particles within the
    projected radius along one axis, no line-of-sight cut.  Half-mass and
    half-light radii profile in projected radius, over one stable sort of
    it that does not depend on the aperture radius (shared by an axis's
    family)."""

    def __init__(self, ctx, parts, scalars, aperture_radius, axis: int):
        super().__init__(ctx, parts, scalars)
        self.aperture_radius = _per_halo(aperture_radius, parts.valid)
        self.axis = axis
        self._proj_dims = [d for d in range(3) if d != axis]

    def _flag_region(self):
        self.add_flag(self.aperture_radius > self.scalars.search_radius)

    @lazy_property
    def proj_pos(self):
        return self.parts.pos[..., self._proj_dims]

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

    # the profile view: the base class's half-mass and half-light radii
    # profile in the projected radius here

    @property
    def _prof_r_sorted(self):
        return self._proj_sort[0]

    @property
    def _prof_m_sorted(self):
        return self._proj_sort[2]

    @property
    def _prof_order(self):
        return self._proj_sort[1]

    @property
    def _prof_sel_sorted(self):
        return self._proj_sel_sorted

    def _prof_seg_sorted(self, ptype: str) -> torch.Tensor:
        return self._proj_seg_sorted(ptype)

    @property
    def _prof_gas_sorted(self):
        return self._proj_sel_sorted & self._proj_seg_sorted("PartType0")

    @lazy_property
    def _star_profile_sort(self):
        lo4, hi4 = self.ctx.segment("PartType4")
        key = torch.where(self.parts.valid[:, lo4:hi4], self.proj_radius[:, lo4:hi4], torch.inf)
        r_s, order = torch.sort(key, dim=1, stable=True)
        lum = self._star_lum
        return r_s, order, lum.gather(1, order[..., None].expand(-1, -1, lum.shape[2]))

    def _proj_half_mass(self, ptype, total):
        r_s, _, m_s, _ = self._proj_sort
        mask = self._proj_sel_sorted
        if ptype is not None:
            mask = mask & self._proj_seg_sorted(ptype)
        return radii_ops.half_weight_radius_sorted(r_s, m_s, mask, total)

    @lazy_property
    def HalfMassRadiusTot(self):
        return self._proj_half_mass(None, self.Mtot)

    @lazy_property
    def HalfMassRadiusGas(self):
        return self._proj_half_mass("PartType0", self.Mgas)

    @lazy_property
    def HalfMassRadiusDM(self):
        return self._proj_half_mass("PartType1", self.Mdm)

    @lazy_property
    def HalfMassRadiusStar(self):
        return self._proj_half_mass("PartType4", self.Mstar)

    def _proj_veldisp(self, mask, vcom_species):
        """1D velocity dispersion along the projection axis."""
        dv = self.parts.vel[..., self.axis] - vcom_species[:, self.axis, None]
        m = torch.where(mask, self.parts.mass, 0.0)
        mtot = red.particle_sum(m)
        var = red.particle_sum(m * dv * dv) / torch.clamp(mtot, min=1e-37)
        return torch.where(mtot > 0, torch.sqrt(var), 0.0)

    @lazy_property
    def proj_veldisp_gas(self):
        return self._proj_veldisp(self.mask_gas, self.vcom_gas)

    @lazy_property
    def proj_veldisp_dm(self):
        return self._proj_veldisp(self.mask_dm, self.vcom_dm)

    @lazy_property
    def proj_veldisp_star(self):
        return self._proj_veldisp(self.mask_star, self.vcom_star)

    # -- projected inertia tensors: circle radius = the aperture radius,
    # every bound particle of the species (the ellipse may deform beyond
    # the aperture)

    def _proj_mask_gate(self, species):
        if species == "tot":
            return self.bound_mask, self.Mtot
        pt, gate = {"gas": ("PartType0", self.Mgas), "star": ("PartType4", self.Mstar)}[species]
        return self.bound_mask & self._rows_of(pt)[None, :], gate

    @lazy_property
    def _inertia_batch2d(self):
        """{(species, reduced, iterative, band | None): (B, 3)} for every
        requested projected inertia key: one loop call per kind
        (mass-weighted or per-band luminosity-weighted, iterative or
        not)."""
        configs = []
        for key in getattr(self, "_requested_keys", ()):
            cfg = _INERTIA2D_KEYS.get(key)
            if cfg is None:
                continue
            if cfg[3]:
                if not self._has("PartType4/Luminosities"):
                    continue
                configs.extend(cfg[:3] + (b,) for b in range(N_BANDS))
            else:
                configs.append(cfg[:3] + (None,))
        lo4, hi4 = self.ctx.segment("PartType4")
        out = {}
        for iterative in (False, True):
            for lum in (False, True):
                cfgs = [c for c in configs if c[2] == iterative and (c[3] is not None) == lum]
                if not cfgs:
                    continue
                masks, gates, weights = [], [], []
                for species, _, _, band in cfgs:
                    mask, gate = self._proj_mask_gate(species)
                    if lum:
                        mask = mask[:, lo4:hi4]
                        weights.append(self._star_lum[..., band])
                    masks.append(mask)
                    gates.append(gate)
                masks = torch.stack(masks, 1)
                res = inertia_ops.projected_inertia_tensor_multi(
                    torch.stack(weights, 1) if lum else self.parts.mass,
                    self.proj_pos[:, lo4:hi4] if lum else self.proj_pos,
                    masks,
                    self.aperture_radius[:, None].expand(-1, len(cfgs)),
                    [c[1] for c in cfgs],
                    [c[2] for c in cfgs],
                    single_pass=not iterative,
                )
                for i, (cfg, gate) in enumerate(zip(cfgs, gates)):
                    out[cfg] = torch.where(gate[:, None] > 0, res.tensor[:, i], 0.0)
        return out

    def _proj_inertia(self, key):
        species, red_, it, lum = _INERTIA2D_KEYS[key]
        if not lum:
            return self._inertia_batch2d[(species, red_, it, None)]
        if not self._has("PartType4/Luminosities"):
            return self._zeros(3 * N_BANDS)
        return torch.cat(
            [self._inertia_batch2d[(species, red_, it, b)] for b in range(N_BANDS)], 1
        )


def _make_inertia2d(key):
    def method(self):
        return self._proj_inertia(key)

    method.__name__ = key
    return lazy_property(method)


for _key in _INERTIA2D_KEYS:
    setattr(ProjectedApertureSlice, _key, _make_inertia2d(_key))


def shared_sort_artifacts(
    parts: HaloParticles, scalars: HaloScalars, ctx: HaloContext = None,
    vel_payload: bool = False,
) -> Dict[str, torch.Tensor]:
    """The per-halo radius sort and its payloads, computed once per
    bucket and seeded into every slice: one stable sort of the radius
    key (invalid rows last), then one gather per payload.  With ``ctx``
    and hydro fields, also the HI and H2 mass weights as payloads and
    the star segment's own radius sort with its luminosities.  The
    velocity payload lets the engine's sorted-prefix truncation hand
    slices a complete radius-sorted particle view as prefix slices."""
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
    if ctx is None or not parts.fields:
        return out
    elem, spec = "PartType0/ElementMassFractions", "PartType0/SpeciesFractions"
    if elem in parts.fields and spec in parts.fields and ctx.has_column(elem, "Hydrogen"):
        lo, hi = ctx.segment("PartType0")
        h = parts.fields[elem][..., ctx.column_index(elem, "Hydrogen")]
        K = parts.valid.shape[1]
        for species, factor, name in (("HI", 1.0, "_w_HI_sorted"), ("H2", 2.0, "_w_H2_sorted")):
            if not ctx.has_column(spec, species):
                continue
            s = parts.fields[spec][..., ctx.column_index(spec, species)]
            w = torch.nn.functional.pad(parts.mass[:, lo:hi] * h * s * factor, (lo, K - hi))
            out[name] = w.gather(1, order)
    if "PartType4/Luminosities" in parts.fields:
        lo4, hi4 = ctx.segment("PartType4")
        if hi4 > lo4:
            out.update(_star_sort(parts, r, bound, lo4, hi4))
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
