"""Halo properties as a lazy DAG over a batch of padded halo slices.

Ported from ``soap_tpu/models/halo_slice.py``: a ``HaloSlice`` holds the
padded candidate particles of B halos, and ``lazy_property`` memoizes
the shared intermediates (radii, the radius sort, the SO solution) so
each is computed once per slice.  Every array carries an explicit
leading halo axis: per-particle (B, K, ...), per-halo (B, ...).  Property
methods are named by their property-table key.

This slice ports the keys of ``BoundSubhalo`` and ``SO`` that the
engine's slice spec set requests (``pipeline/specs.py``); any other key
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.models.lazy import lazy_property
from soap_tpu_torch.ops import inertia as inertia_ops
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


#: iterative mass-weighted 3D inertia keys -> (species, reduced)
_INERTIA3D_KEYS = {
    "TotalInertiaTensor": ("tot", False),
    "TotalInertiaTensorReduced": ("tot", True),
}


class HaloSlice:
    """Base class: B halos' selected particles + lazy property methods.
    Subclasses define ``selection`` and list their ported keys."""

    KEYS: frozenset = frozenset()

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

    def type_mask(self, ptype: str) -> torch.Tensor:
        """Selected particles of one type (a static row segment)."""
        lo, hi = self.ctx.segment(ptype)
        k = self.parts.valid.shape[1]
        row = torch.arange(k, device=self.parts.valid.device)
        return self.selection & ((row >= lo) & (row < hi))[None, :]

    @lazy_property
    def mask_dm(self):
        return self.type_mask("PartType1")

    # The radius sort and its payloads (``radius``, ``_r_sorted``,
    # ``_m_sorted``, ``_bound_sorted``, ``_pos_sorted``, ``_valid_sorted``) are seeded into every slice by the engine from
    # ``shared_sort_artifacts``: one sort serves every slice of a bucket.

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
    def Ndm(self):
        return red.masked_count(self.mask_dm, torch.int64)

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
    def HalfMassRadiusTot(self):
        return radii_ops.half_weight_radius_sorted(
            self._r_sorted, self._m_sorted, self._sel_sorted, self.Mtot
        )

    # ---------------- inertia tensors ----------------
    #  - BoundSubhalo: sphere = 10 x half-mass radius, bound particles
    #    only, no search-radius check;
    #  - SO: sphere = the SO radius, every candidate particle, with the
    #    search-radius check.

    def _inertia_cfg(self, species: str):
        """(sorted mask, sphere radius, search radius | None, gate)."""
        if species != "tot":
            raise NotImplementedError(f"{species} inertia tensors are not ported")
        return self._sel_sorted, 10.0 * self.HalfMassRadiusTot, None, self.Mtot

    @lazy_property
    def _inertia_batch3d(self):
        """{(species, reduced): (B, 6) tensor} for every requested
        inertia key, through one batched inertia loop."""
        cfgs = [
            _INERTIA3D_KEYS[k]
            for k in getattr(self, "_requested_keys", ())
            if k in _INERTIA3D_KEYS
        ]
        if not cfgs:
            return {}
        masks, radii, gates, checks = [], [], [], []
        search = None
        for species, _ in cfgs:
            mask, sphere, search_c, gate = self._inertia_cfg(species)
            masks.append(mask)
            radii.append(sphere.to(torch.float32))
            gates.append(gate)
            checks.append(search_c is not None)
            if search_c is not None:
                search = search_c
        result = inertia_ops.inertia_tensor_multi(
            self._m_sorted,
            self._pos_sorted,
            torch.stack(masks, 1),
            torch.stack(radii, 1),
            [r for _, r in cfgs],
            [True] * len(cfgs),
            search_radius=search,
            check_search=checks if search is not None else None,
            rows_radius_sorted=True,  # _pos_sorted ascends in radius
        )
        if search is not None:
            self.add_flag(result.needs_bigger.any(1))
        return {
            cfg: torch.where(gate[:, None] > 0, result.tensor[:, i], 0.0)
            for i, (cfg, gate) in enumerate(zip(cfgs, gates))
        }

    @lazy_property
    def TotalInertiaTensor(self):
        return self._inertia_batch3d[("tot", False)]

    @lazy_property
    def TotalInertiaTensorReduced(self):
        return self._inertia_batch3d[("tot", True)]


class BoundSubhaloSlice(HaloSlice):
    """``BoundSubhalo/*`` selection: particles bound to this subhalo."""

    KEYS = frozenset(
        ("Mtot", "Ndm", "com", "vcom", "HalfMassRadiusTot",
         "TotalInertiaTensor", "TotalInertiaTensorReduced")
    )

    @lazy_property
    def selection(self):
        return self.bound_mask

    @lazy_property
    def _sel_sorted(self):
        return self._bound_sorted


class SOSlice(HaloSlice):
    """``SO/<X>/*`` selection: all particles inside the spherical
    overdensity radius; ``target_density`` is the PHYSICAL threshold
    density (e.g. 200 x critical)."""

    KEYS = frozenset(("r", "Mtot", "Ndm", "com", "TotalInertiaTensor"))

    def __init__(self, ctx, parts, scalars, target_density: float):
        super().__init__(ctx, parts, scalars)
        self.target_density = target_density

    def _inertia_cfg(self, species: str):
        """SO inertia: sphere = SO radius, ALL candidates (the ellipsoid
        may deform beyond R_SO), search-radius check on."""
        if species != "tot":
            raise NotImplementedError(f"{species} inertia tensors are not ported")
        return self._valid_sorted, self.r, self.scalars.search_radius, self.SO_mass

    @lazy_property
    def _so_solution(self) -> so_ops.SOResult:
        res = so_ops.so_radius_sorted(
            self._r_sorted,
            self._m_sorted,
            self._valid_sorted,
            self.target_density,
            self.ctx.nu_density,
        )
        self.add_flag(res.needs_bigger)
        return res

    @lazy_property
    def r(self):
        """The SO radius (``SORadius``)."""
        return self._so_solution.radius

    @lazy_property
    def SO_mass(self):
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
            self._valid_sorted
            & (self._r_sorted < self.r[:, None])
            & self.exists[:, None]
        )

    @lazy_property
    def Mtot(self):
        """The SO mass comes from the density crossing, not a sum."""
        return self.SO_mass


def shared_sort_artifacts(
    parts: HaloParticles, scalars: HaloScalars
) -> Dict[str, torch.Tensor]:
    """The per-halo radius sort and its payloads, computed once per
    bucket and seeded into every slice: one stable sort of the radius
    key (invalid rows last), then one gather per payload."""
    x, y, z = parts.pos[..., 0], parts.pos[..., 1], parts.pos[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    key = torch.where(parts.valid, r, torch.inf)
    r_s, order = torch.sort(key, dim=1, stable=True)
    bound = parts.valid & (parts.groupnr == scalars.index[:, None])
    return {
        "radius": r,
        "_r_sorted": r_s,
        "_m_sorted": parts.mass.gather(1, order),
        "_bound_sorted": bound.gather(1, order),
        "_pos_sorted": parts.pos.gather(1, order[..., None].expand(-1, -1, 3)),
        # invalid slots carry an inf key, so validity needs no payload
        "_valid_sorted": torch.isfinite(r_s),
    }


def compute_properties(slice_obj: HaloSlice, keys) -> Dict[str, torch.Tensor]:
    """Evaluate the requested keys on one slice; adds the needs-bigger
    flag under the reserved key ``__needs_bigger__``."""
    for key in keys:
        if key not in slice_obj.KEYS:
            raise NotImplementedError(
                f"{type(slice_obj).__name__}: key {key!r} is not ported"
            )
    slice_obj._requested_keys = tuple(dict.fromkeys(keys))
    out = {key: getattr(slice_obj, key) for key in keys}
    out["__needs_bigger__"] = slice_obj.needs_bigger
    return out
