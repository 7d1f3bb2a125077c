"""Halo-batch processing engine on one device or several.

Ported from ``soap_tpu/pipeline/engine.py`` (single chunk):
 1. a counting pre-pass grows each halo's gather radius to its SO
    threshold and counts its candidate rows exactly with summed-area
    tables (``chunk_data.presize_and_count``);
 2. halos are sorted by candidate count and cut into tiles whose padded
    rows stay within ``row_budget`` (``TARGET_ROWS`` for DMO rows, less
    for wider hydro rows); each tile is one bucket call: per particle
    type cell ranges -> run-length range gather (kernel K1), with each
    type's extra datasets as ``HaloParticles.fields`` -> one radius
    sort -> the lazy property DAG of every spec (the SO bisection,
    masked reductions, kinematics, half-mass radii, and the inertia
    loop, kernel K2, once per spec family and kind of weights);
 3. halos whose candidate buffer overflowed, or whose properties need a
    bigger region, get their radius grown x1.5 and are re-bucketed until
    done or at the 20 Mpc cap.
Around that core, as in the JAX engine:
 - fixed apertures wider than ``WIDE_RADIUS_MPC`` run in a second
   ("wide") pass, so they do not set the gather capacity of every other
   key; the wide pass copies from the narrow pass's apertures;
 - centrals-only specs (SO) run in a central phase of their own;
 - consecutive specs of one kind (SO densities, core-excised or not,
   aperture radii, one axis's projected radii) form a family: one K2
   launch for all of them;
 - a parameter file's other spec kinds run alone: fixed-radius SOs (not
   virial: no flow rates, no concentrations), and apertures and
   projected apertures sized per halo by a multiple of an earlier spec's
   property in the same bucket (they need every gathered row, so they
   are never truncated, and stay in the narrow pass with their source);
 - given the catalogue's EncloseRadius, the first round truncates the
   bound, aperture and projected specs to the radius-sorted row prefix
   inside max(EncloseRadius, largest aperture), with a bound-count
   cross-check that retries untruncated where the catalogue lied;
 - where every halo of a tile lies inside the next-smaller aperture, an
   aperture's keys are copied from it instead of computed;
 - on several devices (the chunk store replicated on each, as the JAX
   engine runs under its ``(1, n)`` mesh) the host plans every tile as
   on one, then splits its halos into one contiguous share per device
   (``tile_shares``); the shares run at once, one thread per device,
   and the host joins them in halo order before it resolves copies and
   retries, so the results equal the one-device engine's bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.models.halo_slice import (
    ApertureSlice,
    BoundSubhaloSlice,
    HaloParticles,
    HaloScalars,
    ProjectedApertureSlice,
    SOSlice,
    compute_properties,
    shared_sort_artifacts,
)
from soap_tpu_torch.ops import cpu_math, geometry
from soap_tpu_torch.ops import inertia_loop, range_gather
from soap_tpu_torch.ops.grid import halo_cell_ranges
from soap_tpu_torch.ops.range_gather import (
    merge_adjacent_ranges,
    range_gather_rows,
    row_alignment,
)
from soap_tpu_torch.pipeline.chunk_data import (
    ChunkData,
    presize_and_count,
    unpack_field,
)

READ_RADIUS_FACTOR = 1.5  # reference halo_tasks.py:16
MAX_SEARCH_RADIUS = 20.0  # Mpc physical; reference halo_tasks.py:19-20

#: padded rows per bucket call (B * K) and the batch cap, as in the JAX
#: engine, so both engines cut the same tiles
TARGET_ROWS = 8 * 1024 * 1024
MAX_BATCH = 4096
#: bytes one bucket call may charge its rows, at 4 bytes x the widest
#: type's row width x the largest family's lanes per padded row.  The
#: charge tracks a hydro bucket's peak device memory (1M-row buckets of
#: 128-column gas rows in 8 lanes peaked at 4.53 GiB on an H100 80GB at
#: 700 W, PERF.md), so 24 GiB keeps a hydro bucket within an 80 GB card;
#: a DMO bucket's 16 columns stay at TARGET_ROWS.  The JAX engine's
#: B <= 64 cap and //5 budget were fitted to a 16 GB TPU; they serve only
#: to cut the JAX engine's tiles (``HaloEngine(tile_caps=...)``)
ROW_BYTES_BUDGET = 24 * 2**30
#: rows per block of the range gather (the JAX layout's S)
GATHER_S = 64
#: fixed apertures larger than this (Mpc) run in the wide pass; 0 runs
#: every spec in one pass
WIDE_RADIUS_MPC = 0.4
#: the staged fields a truncated bucket can carry as sort payloads
_BASE_FIELDS = {"Masses", "Velocities", "GroupNr_bound", "FOFGroupIDs"}
#: (dtype, value of a padding lane) of a bucket's per-halo inputs: the
#: centre's high and low parts, the comoving gather radius, catalogue
#: index, physical search radius, centrality and FOF id
_PADDING = ((np.float32, 0.0), (np.float32, 0.0), (np.float32, 1e-3), (np.int64, -1),
            (np.float32, 1e-3), (np.bool_, False), (np.int64, -1))


@dataclass(frozen=True)
class HaloTypeSpec:
    """Static description of one halo-type calculation instance: one
    spec per output group.  A copy of ``soap_tpu.pipeline.engine.
    HaloTypeSpec`` (``tests/test_torch_host_mirror.py`` holds the fields
    and defaults to the original's)."""

    kind: str  # 'bound' | 'SO' | 'aperture' | 'projected'
    group: str  # output group name, e.g. 'SO/200_crit'
    keys: Tuple[str, ...]  # property-table keys to compute
    # SO options
    so_type: Optional[str] = None  # 'crit' | 'mean' | 'BN98' | 'physical'
    so_multiple: Optional[float] = None  # e.g. 200.0 (or Mpc for physical)
    radius_multiple_of: Optional[str] = None  # parent SO group name
    radius_multiple: Optional[float] = None  # e.g. 5.0
    core_excision_fraction: Optional[float] = None
    # aperture options
    aperture_radius_mpc: Optional[float] = None  # physical
    inclusive: bool = False
    radius_property: Optional[Tuple[str, str, float]] = None
    # projected options
    axis: Optional[int] = None
    # SO specs additionally restrict to centrals
    centrals_only: bool = False
    halo_filter: str = "basic"
    # aperture copy: the next-smaller aperture of the same kind
    copy_from: Optional[str] = None
    copy_from_radius_mpc: Optional[float] = None
    strict_keys: Tuple[str, ...] = ()  # keys recomputed even when copying

    def target_density(self, ctx: HaloContext) -> Optional[float]:
        if self.kind != "SO" or self.so_type in (None, "physical"):
            return None
        if self.so_type == "crit":
            return self.so_multiple * ctx.critical_density
        if self.so_type == "mean":
            return self.so_multiple * ctx.mean_density
        if self.so_type == "BN98":
            return self.so_multiple * ctx.critical_density
        raise ValueError(self.so_type)


def _check_spec(spec: HaloTypeSpec) -> None:
    """Raise for a spec this engine cannot run (keys are checked by
    ``compute_properties``)."""
    ported = (
        spec.kind == "bound"
        or (spec.kind == "SO" and spec.so_type in ("crit", "mean", "BN98", "physical"))
        or (
            spec.kind in ("aperture", "projected")
            and (spec.radius_property is None) != (spec.aperture_radius_mpc is None)
        )
    )
    if not ported:
        raise NotImplementedError(f"spec {spec.group} ({spec.kind}) is not ported")


def _make_slice(spec: HaloTypeSpec, ctx, parts, scalars, prior):
    if spec.kind == "bound":
        return BoundSubhaloSlice(ctx, parts, scalars)
    if spec.kind == "SO":
        if spec.radius_multiple_of is not None:
            parent_r = prior[spec.radius_multiple_of]["r"]
            return SOSlice(ctx, parts, scalars,
                           physical_radius=spec.radius_multiple * parent_r)
        if spec.so_type == "physical":
            # a fixed radius is no virial definition
            return SOSlice(ctx, parts, scalars, physical_radius=spec.so_multiple,
                           virial=False)
        return SOSlice(ctx, parts, scalars, target_density=spec.target_density(ctx),
                       core_excision_fraction=spec.core_excision_fraction)
    if spec.radius_property is not None:
        # sized per halo by a property of an earlier spec of this bucket
        src_group, src_key, mult = spec.radius_property
        radius = float(mult) * prior[src_group][src_key]
    else:
        radius = spec.aperture_radius_mpc
    if spec.kind == "aperture":
        return ApertureSlice(ctx, parts, scalars, radius, spec.inclusive)
    return ProjectedApertureSlice(ctx, parts, scalars, radius, spec.axis)


def _lanes(t: torch.Tensor, L: int) -> torch.Tensor:
    """``t`` repeated L times along the halo axis (member-major)."""
    return t if L == 1 else t.repeat((L,) + (1,) * (t.dim() - 1))


class _LaneFields(dict):
    """A particle-field dict whose tensors are repeated L times along the
    halo axis on first access: a family reads only some of a hydro
    type's many datasets, and each copy costs L x its bytes."""

    def __init__(self, fields: Dict[str, torch.Tensor], L: int):
        super().__init__(fields)
        self._L = L
        self._done = set()

    def __getitem__(self, name):
        t = super().__getitem__(name)
        if name not in self._done:
            t = _lanes(t, self._L)
            self[name] = t
            self._done.add(name)
        return t

    def get(self, name, default=None):
        return self[name] if name in self else default


def _lanes_parts(parts: HaloParticles, L: int) -> HaloParticles:
    if L == 1:
        return parts
    return HaloParticles(
        *(_lanes(x, L) for x in parts[:-1]), fields=_LaneFields(parts.fields, L)
    )


def _family_slice(members, ctx, parts, scalars):
    """One slice over a family's L members x B halos: the particles and
    scalars repeated per member, each member's threshold density or
    aperture radius on its own B halos."""
    L, spec0 = len(members), members[0]
    parts_l = _lanes_parts(parts, L)
    scalars_l = HaloScalars(*(_lanes(x, L) for x in scalars))
    values = [
        s.target_density(ctx) if spec0.kind == "SO" else s.aperture_radius_mpc
        for s in members
    ]
    per_halo = torch.tensor(values, dtype=torch.float32, device=scalars.index.device)
    per_halo = per_halo.repeat_interleave(scalars.index.shape[0])
    if spec0.kind == "SO":
        return SOSlice(ctx, parts_l, scalars_l, target_density=per_halo,
                       core_excision_fraction=spec0.core_excision_fraction)
    if spec0.kind == "aperture":
        return ApertureSlice(ctx, parts_l, scalars_l, per_halo, spec0.inclusive)
    return ProjectedApertureSlice(ctx, parts_l, scalars_l, per_halo, spec0.axis)


def _block_signature(spec: HaloTypeSpec, dens) -> Optional[tuple]:
    """Consecutive specs with one signature form a family, evaluated as
    one slice with the members as lanes of the halo axis: one launch of
    each op, and of the inertia loop, for all of them."""
    if spec.kind == "SO" and dens is not None and spec.radius_multiple_of is None:
        return ("SO", spec.keys, spec.core_excision_fraction)
    if spec.kind == "aperture" and spec.radius_property is None:
        return ("aperture", spec.keys, spec.inclusive)
    if spec.kind == "projected" and spec.radius_property is None:
        return ("projected", spec.keys, spec.axis)
    return None


def _max_family(specs: Sequence[HaloTypeSpec], ctx: HaloContext) -> int:
    """The most members any family (run of specs with one signature) has."""
    best, run, prev = 1, 0, None
    for spec in specs:
        sig = _block_signature(spec, spec.target_density(ctx))
        run = run + 1 if sig is not None and sig == prev else 1
        prev = sig
        best = max(best, run)
    return best


def row_budget(chunk: ChunkData, specs: Sequence[HaloTypeSpec], ctx: HaloContext) -> int:
    """Padded rows (B x sum of the type capacities) one bucket call may
    hold: ROW_BYTES_BUDGET over the widest type's row bytes times the
    largest family's lanes, at most TARGET_ROWS (so a DMO run cuts the
    JAX engine's tiles)."""
    width = max(pt.row_width for pt in chunk.ptypes.values())
    return min(TARGET_ROWS, ROW_BYTES_BUDGET // (4 * width * _max_family(specs, ctx)))


def _spec_truncatable(spec: HaloTypeSpec) -> bool:
    """Specs whose rows lie within max(EncloseRadius, fixed aperture
    radius): BoundSubhalo (bound rows), fixed-radius apertures and
    projected apertures.  SO (the density crossing needs the whole
    gathered profile) and radius-property apertures need every row."""
    if spec.kind == "bound":
        return True
    return spec.kind in ("aperture", "projected") and spec.radius_property is None


def _halo_fn(ctx: HaloContext, specs: Tuple[HaloTypeSpec, ...], trunc: Optional[int] = None,
             k2_by_group: Optional[Dict[str, int]] = None):
    """Property evaluation over all specs for one bucket: one shared
    radius sort, then each family's slices, in spec order (a radius
    multiple or a property-sized aperture reads an earlier spec's
    results).  ``k2_by_group`` gains the inertia-loop launches of each
    family (or lone spec) under its first group.

    ``trunc``: sorted-prefix row truncation.  Truncatable specs run on
    the first ``trunc`` radius-sorted rows (prefix slices of the sort
    and its payloads) instead of the whole gather capacity; the host
    sized ``trunc`` from summed-area-table counts at the truncation
    radius, and a halo with a bound row past the prefix (its catalogue
    EncloseRadius lied) is flagged to retry untruncated."""
    blocks: List[Tuple[Optional[tuple], List[HaloTypeSpec]]] = []
    for spec in specs:
        sig = _block_signature(spec, spec.target_density(ctx))
        if sig is not None and blocks and blocks[-1][0] == sig:
            blocks[-1][1].append(spec)
        else:
            blocks.append((sig, [spec]))
    ctx_b = dataclasses.replace(ctx, capacities=(trunc,)) if trunc is not None else None

    def fn(parts: HaloParticles, scalars: HaloScalars):
        shared = shared_sort_artifacts(parts, scalars, ctx, vel_payload=trunc is not None)
        parts_b = shared_b = trunc_bad = None
        if trunc is not None:
            kb = trunc
            bound_b = shared["_bound_sorted"][:, :kb]
            parts_b = HaloParticles(
                valid=shared["_valid_sorted"][:, :kb],
                mass=shared["_m_sorted"][:, :kb],
                pos=shared["_pos_sorted"][:, :kb],
                vel=shared["_vel_sorted"][:, :kb],
                # exact for the one consumer (bound_mask, seeded below);
                # SO needs the full labels and never truncates
                groupnr=torch.where(bound_b, scalars.index[:, None], -1),
                fofid=torch.full_like(bound_b, -1, dtype=torch.int64),
                softening=parts.softening[:, :kb],
                # one particle type with the base fields only: no extras
                fields={},
            )
            shared_b = {
                "radius": shared["_r_sorted"][:, :kb],
                "_rsort_order": torch.arange(kb, device=bound_b.device).expand_as(bound_b),
                "_r_sorted": shared["_r_sorted"][:, :kb],
                "_m_sorted": parts_b.mass,
                "_bound_sorted": bound_b,
                "_pos_sorted": parts_b.pos,
                "_valid_sorted": parts_b.valid,
                "bound_mask": bound_b,
            }
            trunc_bad = shared["_bound_sorted"].sum(1) > bound_b.sum(1)

        out: Dict[str, Dict[str, torch.Tensor]] = {}
        prior: Dict[str, Dict[str, torch.Tensor]] = {}
        for _, members in blocks:
            truncated = trunc is not None and _spec_truncatable(members[0])
            cx, pr, shr = (ctx_b, parts_b, shared_b) if truncated else (ctx, parts, shared)
            L = len(members)
            spec0 = members[0]
            if L == 1:
                s = _make_slice(spec0, cx, pr, scalars, prior)
            else:
                # a family as lanes: its members stacked member-major on
                # the halo axis, one slice over L x B halos
                s = _family_slice(members, cx, pr, scalars)
            if spec0.kind == "projected":
                s.__dict__["bound_mask"] = _lanes(shr["bound_mask"], L)
                if L > 1:
                    # the projected-radius sort does not depend on the radius
                    one = ProjectedApertureSlice(cx, pr, scalars, 0.0, spec0.axis)
                    one.__dict__["bound_mask"] = shr["bound_mask"]
                    s.__dict__["_proj_sort"] = tuple(_lanes(t, L) for t in one._proj_sort)
            else:
                s.__dict__.update({k: _lanes(v, L) for k, v in shr.items()})
            n_k2 = inertia_loop.launches_here()
            res = compute_properties(s, spec0.keys)
            n_k2 = inertia_loop.launches_here() - n_k2
            if k2_by_group is not None and n_k2:
                k2_by_group[spec0.group] = k2_by_group.get(spec0.group, 0) + n_k2
            B = scalars.index.shape[0]
            for i, spec in enumerate(members):
                r = {k: v[i * B : (i + 1) * B] for k, v in res.items()}
                if truncated:
                    r["__needs_bigger__"] = r["__needs_bigger__"] | trunc_bad
                prior[spec.group] = r
                out[spec.group] = r
        return out

    return fn


def _process_bucket(
    ctx: HaloContext,
    specs: Tuple[HaloTypeSpec, ...],
    cubes: Tuple[int, ...],  # per-ptype search-cube sizes
    S: int,  # range-gather block rows
    chunk: ChunkData,
    centre_hi: torch.Tensor,  # (B, 3) comoving
    centre_lo: torch.Tensor,  # (B, 3)
    radius_com: torch.Tensor,  # (B,) comoving gather radius
    index: torch.Tensor,  # (B,) i64
    search_radius_phys: torch.Tensor,  # (B,) physical
    is_central: torch.Tensor,  # (B,) bool
    fof_id: torch.Tensor,  # (B,) i64
    trunc: Optional[int] = None,  # sorted-prefix row truncation
    k1_by_ptype: Optional[Dict[str, int]] = None,  # K1 launches, added per ptype
    k2_by_group: Optional[Dict[str, int]] = None,  # K2 launches, added per family
):
    """One padded bucket: range gather (one K1 call per particle type) +
    every property calculation.  Each type's extra datasets ride along as
    ``HaloParticles.fields['PartTypeN/<name>']``."""
    a = float(ctx.a)
    parts_per_type = []
    fields: Dict[str, torch.Tensor] = {}
    overflow = torch.zeros(centre_hi.shape[0], dtype=torch.bool, device=centre_hi.device)
    for ptype, cap, cube in zip(ctx.ptypes, ctx.capacities, cubes):
        pt = chunk.ptypes[ptype]
        starts, counts = halo_cell_ranges(
            pt.spec, pt.offsets, pt.counts, centre_hi, radius_com, cube
        )
        starts, counts = merge_adjacent_ranges(starts, counts)
        n_k1 = range_gather.launches_here()
        gf, valid, _, total = range_gather_rows(pt.packed, starts, counts, S, cap)
        if k1_by_ptype is not None:
            k1_by_ptype[ptype] = (
                k1_by_ptype.get(ptype, 0) + range_gather.launches_here() - n_k1
            )
        overflow = overflow | (total > cap)

        def fld(name):
            return unpack_field(gf, pt.cols_f, pt.cols_i, name)

        rel = geometry.periodic_offset(
            gf[..., 0:3], gf[..., 3:6], centre_hi[:, None], centre_lo[:, None],
            chunk.boxsize,
        ) * a
        mass = fld("Masses")
        if ptype == "PartType6" and pt.has_field("Weights"):
            # SO mass profiles use the delta-f weighted neutrino masses;
            # the raw masses stay a per-type field (RawNeutrinoMass)
            fields["PartType6/Masses"] = mass
            mass = mass * fld("Weights")
        vel = fld("Velocities")
        minus1 = torch.full(valid.shape, -1, dtype=torch.int64, device=valid.device)
        groupnr = fld("GroupNr_bound") if pt.has_field("GroupNr_bound") else minus1
        fofid = fld("FOFGroupIDs") if pt.has_field("FOFGroupIDs") else minus1
        soft = torch.full(
            valid.shape, ctx.softening[ctx.ptypes.index(ptype)],
            dtype=torch.float32, device=valid.device,
        )
        v3 = valid[..., None]
        parts_per_type.append(
            dict(
                valid=valid,
                mass=torch.where(valid, mass, 0.0),
                pos=torch.where(v3, rel, 0.0),
                vel=torch.where(v3, vel, 0.0),
                groupnr=torch.where(valid, groupnr, -1),
                fofid=torch.where(valid, fofid, -1),
                softening=soft,
            )
        )
        for col in pt.cols_f + pt.cols_i:
            if col[0] not in _BASE_FIELDS:
                fields[f"{ptype}/{col[0]}"] = fld(col[0])

    def cat(key):
        return torch.cat([p[key] for p in parts_per_type], 1)

    parts = HaloParticles(*(cat(k) for k in HaloParticles._fields[:-1]), fields=fields)
    scalars = HaloScalars(
        index=index,
        centre=centre_hi + centre_lo,
        search_radius=search_radius_phys,
        is_central=is_central,
        fof_id=fof_id,
    )
    out = _halo_fn(ctx, specs, trunc, k2_by_group)(parts, scalars)
    for res in out.values():
        res["__needs_bigger__"] = res["__needs_bigger__"] & ~overflow
    return out, overflow


def _to_host(out: Dict[str, Dict[str, torch.Tensor]], nb: int):
    """Every result's first ``nb`` halos as numpy arrays, through one
    device-to-host copy per dtype (thousands of keys per hydro bucket)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for grp, d in out.items():
        for k, v in d.items():
            by_dtype.setdefault(v.dtype, []).append((grp, k, v[:nb]))
    res: Dict[str, Dict[str, np.ndarray]] = {grp: {} for grp in out}
    for items in by_dtype.values():
        host = torch.cat([v.reshape(nb, -1) for _, _, v in items], 1).cpu().numpy()
        col = 0
        for grp, k, v in items:
            w = int(np.prod(v.shape[1:], dtype=np.int64))
            res[grp][k] = host[:, col : col + w].reshape(v.shape)
            col += w
    return res


def _next_pow2(n: int, floor: int = 256) -> int:
    return max(floor, 1 << int(math.ceil(math.log2(max(n, 1)))))


def tile_shares(n: int, n_workers: int, floor: int) -> List[Tuple[int, int, int, int]]:
    """A tile's ``n`` halos, in plan order, as one contiguous share per
    worker (the first ``n % n_workers`` shares one halo larger), each
    padded to a power of two at the tile's lane floor: ``(worker, start,
    stop, padded halos)`` for every share that holds a halo.  One worker,
    or a one-halo tile, gives the whole tile to worker 0."""
    q, r = divmod(n, n_workers)
    shares, start = [], 0
    for worker in range(n_workers):
        size = q + (worker < r)
        if size:
            shares.append((worker, start, start + size, _next_pow2(size, floor)))
        start += size
    return shares


def _quantize_cap(n: int, S: int, floor: int = 128) -> int:
    """Quarter-pow2 row capacity >= n, a multiple of max(128, S)."""
    q = max(128, S)
    n = max(n, floor, q)
    k = 1 << int(math.ceil(math.log2(n)))
    for c in (k // 2 + k // 8, k // 2 + k // 4, k // 2 + 3 * (k // 8), k):
        if c >= n and c % q == 0:
            return c
    return k


def min_physical_radius(specs: Sequence[HaloTypeSpec]) -> float:
    """Largest fixed physical radius any spec needs (Mpc): the floor of
    every halo's search radius, so a wide aperture does not send every
    small halo round the retry ladder."""
    r = 0.0
    for spec in specs:
        if spec.kind in ("aperture", "projected") and spec.aperture_radius_mpc:
            r = max(r, float(spec.aperture_radius_mpc))
        if spec.kind == "SO" and spec.so_type == "physical" and spec.so_multiple:
            r = max(r, float(spec.so_multiple))
    return r


def _pass_of(spec: HaloTypeSpec) -> str:
    wide = (
        spec.kind in ("aperture", "projected")
        and spec.aperture_radius_mpc is not None
        and spec.aperture_radius_mpc > WIDE_RADIUS_MPC
    )
    return "wide" if wide else "narrow"


def _keep_links(specs: Sequence[HaloTypeSpec], available) -> Tuple[HaloTypeSpec, ...]:
    """Sever the copy links whose source is computed in no pass that
    serves this one."""
    return tuple(
        dataclasses.replace(s, copy_from=None, copy_from_radius_mpc=None)
        if s.copy_from is not None and s.copy_from not in available
        else s
        for s in specs
    )


@dataclass
class EngineStats:
    """Scheduling and throughput counters (the first four, ``halos_done``,
    ``n_overflow`` and the timing records as the JAX engine keeps them)."""

    n_bucket_calls: int = 0
    n_retries: int = 0
    #: halos whose candidate rows overflowed their bucket's capacity
    n_overflow: int = 0
    #: halos ``process`` was given (0 for a chunk restored from scratch)
    halos_done: int = 0
    #: aperture specs copied from the next-smaller aperture, per tile
    n_copied_specs: int = 0
    #: tiles run with sorted-prefix truncation
    n_truncated_tiles: int = 0
    #: bucket calls by pass: 'narrow', 'wide', or 'one' (no split)
    bucket_calls_by_pass: Dict[str, int] = field(default_factory=dict)
    #: launches of the range-gather kernel (K1) by particle type
    k1_launches_by_ptype: Dict[str, int] = field(default_factory=dict)
    #: launches of the inertia-loop kernel (K2) by the first group of
    #: the family (or lone spec) that made them
    k2_launches_by_group: Dict[str, int] = field(default_factory=dict)
    #: bucket programs (one per tile and worker with halos) by worker,
    #: as ``"<worker>@<device>"``, and their wall seconds, each from its
    #: inputs' upload to its results on the host
    shares_by_worker: Dict[str, int] = field(default_factory=dict)
    worker_seconds: Dict[str, float] = field(default_factory=dict)
    #: wall seconds from each bucket's dispatch to its results on the
    #: host (device compute + transfers), summed
    compute_seconds: float = 0.0
    #: wall seconds inside ``HaloEngine.process``, summed over chunks by
    #: ``pipeline/chunks.py::process_chunks``
    process_seconds: float = 0.0
    #: per-spec wall seconds (``record_spec_timings``)
    spec_seconds: Dict[str, float] = field(default_factory=dict)
    #: (group, catalogue indices, seconds attributed to each halo) per
    #: spec program and bucket (``record_spec_timings``)
    spec_halo_chunks: List[Tuple[str, np.ndarray, np.ndarray]] = field(default_factory=list)
    #: (catalogue indices, seconds, bucket rounds) per population run
    #: (``record_halo_timings``)
    halo_timing_chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = field(
        default_factory=list)

    def halo_timings(self) -> Optional[Dict[str, np.ndarray]]:
        """{"index", "process_time", "n_loop"} per distinct catalogue
        index, summed over the runs that covered it (the narrow and wide
        passes), or None without records."""
        if not self.halo_timing_chunks:
            return None
        idx = np.concatenate([c[0] for c in self.halo_timing_chunks])
        sec = np.concatenate([c[1] for c in self.halo_timing_chunks])
        loops = np.concatenate([c[2] for c in self.halo_timing_chunks])
        uniq, inv = np.unique(idx, return_inverse=True)
        sec_m = np.zeros(len(uniq))
        loop_m = np.zeros(len(uniq), np.int32)
        np.add.at(sec_m, inv, sec)
        np.add.at(loop_m, inv, loops)
        return {"index": uniq, "process_time": sec_m, "n_loop": loop_m}

    def property_timings(self) -> Dict[str, Dict[int, float]]:
        """{group: {catalogue index: seconds}} from the per-spec runs."""
        out: Dict[str, Dict[int, float]] = {}
        for group, idx, sec in self.spec_halo_chunks:
            d = out.setdefault(group, {})
            for i, t in zip(idx.tolist(), sec.tolist()):
                d[i] = d.get(i, 0.0) + t
        return out

    def add(self, other: "EngineStats") -> None:
        """Add ``other``'s counters, seconds and records to these."""
        for f in dataclasses.fields(self):
            mine, theirs = getattr(self, f.name), getattr(other, f.name)
            if isinstance(mine, list):
                mine.extend(theirs)
            elif isinstance(mine, dict):
                for k, v in theirs.items():
                    mine[k] = mine.get(k, 0) + v
            else:
                setattr(self, f.name, mine + theirs)


class HaloEngine:
    """Bucketed halo-property engine over one chunk on one device or
    several.

    ``device`` is one device or a list of them, one worker each (a
    device may repeat: two workers on one card).  ``chunk`` is one store,
    which every worker shares (all on its device), or a list of one
    store per worker (``parallel/sharded.py::replicate``'s).  The host
    plans each tile on the first device and splits it over the workers
    (``tile_shares``); a worker's error is raised here.

    ``tile_caps`` = (padded rows, halos) per bucket replaces the port's
    byte-sized row budget and batch cap, for instance with the JAX
    engine's multi-type plan (TARGET_ROWS // 5, 64), so that the two
    engines cut the same hydro tiles.

    ``record_halo_timings``: each bucket's wall time is split over its
    halos in proportion to candidate count + 1 and each halo's bucket
    rounds are counted (``EngineStats.halo_timings``).
    ``record_spec_timings``: every spec of a bucket runs as its own
    program (a family's members alone, a radius multiple or a
    property-sized aperture with its source, untruncated, each with its
    own gather), timed to its results on the device, and its time split
    over the bucket's halos likewise (``EngineStats.property_timings``);
    slower, for profiling."""

    def __init__(
        self,
        ctx_base: HaloContext,
        chunk,
        specs: Sequence[HaloTypeSpec],
        device,
        tile_caps: Optional[Tuple[int, int]] = None,
        record_halo_timings: bool = False,
        record_spec_timings: bool = False,
    ):
        devices = device if isinstance(device, (list, tuple)) else [device]
        if not devices:
            raise ValueError("HaloEngine needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.tile_caps = tile_caps
        self.record_halo_timings = record_halo_timings
        self.record_spec_timings = record_spec_timings
        chunks = [chunk] * len(self.devices) if isinstance(chunk, ChunkData) else list(chunk)
        if len(chunks) != len(self.devices):
            raise ValueError(f"{len(chunks)} chunk stores for {len(self.devices)} workers")
        for dev, c in zip(self.devices, chunks):
            for pt in c.ptypes.values():
                at = pt.packed.device
                if at.type != dev.type or dev.index not in (None, at.index):
                    raise ValueError(f"chunk store on {at}, worker on {dev}")
        for spec in specs:
            _check_spec(spec)
        if any(d.type == "cpu" for d in self.devices):
            # a process's first threaded vector-math call can come back
            # inexact: make the first one on one thread, before any bucket
            cpu_math.prime()
        self.ctx_base = ctx_base
        self.chunks = chunks
        self.chunk = chunks[0]
        self.specs = tuple(specs)
        self.stats = EngineStats()
        #: the narrow pass's results, the wide pass's copy sources (set
        #: only between the two passes of one ``process`` call)
        self._cross_copy_sources: Optional[Dict[str, Dict[str, np.ndarray]]] = None
        self._pass = "one"

    def _cube_for(self, ptype: str, radius_com: float) -> int:
        spec = self.chunk.ptypes[ptype].spec
        need = int(math.floor(2.0 * radius_com / spec.cell_size[0])) + 2
        need = min(need, spec.dims[0])
        # quantized, as in the JAX engine
        for q in (2, 3, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 192, 256):
            if q >= need:
                return min(q, spec.dims[0])
        return spec.dims[0]

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # -- main ------------------------------------------------------------

    def process(
        self,
        centres,  # (H, 3) float64 comoving
        search_radius_phys,  # (H,) physical initial radii
        index,  # (H,) i64 catalogue indices
        is_central,  # (H,) bool
        fof_id,  # (H,) i64
        enclose_radius_phys=None,  # (H,) physical catalogue EncloseRadius
        specs: Optional[Tuple[HaloTypeSpec, ...]] = None,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Process every halo; returns ``{group: {key: (H, ...) array}}``.

        Without ``enclose_radius_phys`` neither the row truncation nor
        the aperture copy runs."""
        if specs is None:
            specs = self.specs
        centres = np.asarray(centres)
        search_radius_phys = np.asarray(search_radius_phys)
        index = np.asarray(index)
        fof_id = np.asarray(fof_id)
        cen = np.asarray(is_central, dtype=bool)
        if enclose_radius_phys is not None:
            enclose_radius_phys = np.asarray(enclose_radius_phys)
        H = len(index)
        results: Dict[str, Dict[str, np.ndarray]] = {}

        # ---- wide/narrow pass split ----
        classes: Dict[str, List[HaloTypeSpec]] = {}
        if WIDE_RADIUS_MPC > 0:
            for s in specs:
                classes.setdefault(_pass_of(s), []).append(s)
        if len(classes) > 1:
            # no split when every input radius already covers the widest
            # aperture: both passes would gather alike
            wide_max = max(s.aperture_radius_mpc for s in classes["wide"])
            if H == 0 or float(np.min(search_radius_phys)) >= wide_max:
                classes = {}
        if len(classes) > 1:
            narrow_groups = {s.group for s in classes["narrow"]}
            try:
                for name in ("narrow", "wide"):
                    # the wide pass copies from the narrow pass's results
                    groups = {s.group for s in classes[name]}
                    if name == "wide":
                        groups |= narrow_groups
                    self._pass = name
                    results.update(self.process(
                        centres, search_radius_phys, index, cen, fof_id,
                        enclose_radius_phys, specs=_keep_links(classes[name], groups),
                    ))
                    if name == "narrow":
                        self._cross_copy_sources = results
            finally:
                self._cross_copy_sources = None
                self._pass = "one"
            self.stats.halos_done = H
            return results

        # ---- central/satellite phases: satellites run no SO ----
        co_specs = [s for s in specs if s.centrals_only]
        if co_specs and (~cen).any():
            non_co = tuple(s for s in specs if not s.centrals_only)
            for phase, sub_specs in (("cen", tuple(specs)), ("sat", non_co)):
                rows = np.flatnonzero(cen if phase == "cen" else ~cen)
                if not len(rows) or not sub_specs:
                    continue
                part = self.process(
                    centres[rows], search_radius_phys[rows], index[rows],
                    cen[rows], fof_id[rows],
                    None if enclose_radius_phys is None else enclose_radius_phys[rows],
                    specs=sub_specs,
                )
                for spec in sub_specs:
                    buf = results.setdefault(spec.group, {})
                    for key in spec.keys:
                        arr = part[spec.group][key]
                        if key not in buf:
                            buf[key] = np.zeros((H,) + arr.shape[1:], arr.dtype)
                        buf[key][rows] = arr
            # centrals-only groups of an all-satellite population
            for spec in specs:
                buf = results.setdefault(spec.group, {})
                for key in spec.keys:
                    buf.setdefault(key, np.zeros(H, np.float32))
            self.stats.halos_done = H
            return results
        self._run(centres, search_radius_phys, index, cen, fof_id,
                  enclose_radius_phys, specs, results, H)
        self.stats.halos_done = H
        return results

    # -- one population through the round/tile machinery -----------------

    def _run(self, centres, search_radius_phys, index, is_central, fof_id,
             enclose, specs, results, H):
        # the workers keep the calling thread's numpy error rules
        self._np_err = np.geterr()
        if len(self.devices) == 1:
            self._rounds(None, centres, search_radius_phys, index, is_central, fof_id,
                         enclose, specs, results, H)
            return
        with ThreadPoolExecutor(len(self.devices)) as pool:
            self._rounds(pool, centres, search_radius_phys, index, is_central, fof_id,
                         enclose, specs, results, H)

    def _rounds(self, pool, centres, search_radius_phys, index, is_central, fof_id,
                enclose, specs, results, H):
        ctx0 = self.ctx_base
        a = ctx0.a
        radius_phys = np.maximum(
            np.asarray(search_radius_phys, np.float64), min_physical_radius(specs)
        )
        pending = np.arange(H)
        chi, clo = geometry.split_hi_lo(np.asarray(centres))
        halo_seconds = np.zeros(H) if self.record_halo_timings else None
        halo_nloop = np.zeros(H, np.int32) if self.record_halo_timings else None

        so_targets = []
        for s in specs:
            t = s.target_density(ctx0)
            if t is None:
                continue
            if s.radius_multiple_of is not None and s.radius_multiple:
                t = t / float(s.radius_multiple) ** 3
            so_targets.append(t)
        target_com = min(so_targets) * a**3 / 1.5 if so_targets else 0.0
        so_centrals_only = any(s.centrals_only for s in specs if s.kind == "SO")

        # ---- sorted-prefix truncation radius: the truncatable specs
        # touch rows within max(EncloseRadius, largest fixed aperture)
        ap_max = max(
            (float(s.aperture_radius_mpc) for s in specs
             if _spec_truncatable(s) and s.aperture_radius_mpc),
            default=0.0,
        )
        trunc_enabled = (
            enclose is not None
            and len(ctx0.ptypes) == 1
            and any(_spec_truncatable(s) for s in specs)
            and all(
                {c[0] for c in pt.cols_f + pt.cols_i} <= _BASE_FIELDS
                for pt in self.chunk.ptypes.values()
            )
        )
        rb_phys = (
            np.maximum(np.asarray(enclose, np.float64), ap_max) * 1.001 + 1e-4
            if trunc_enabled else None
        )

        first_round = True
        while len(pending):
            # truncation only in the first round: a retried halo carries
            # a grown radius (and maybe a lying EncloseRadius)
            # (per-spec programs run untruncated, as the JAX engine's do)
            do_trunc = trunc_enabled and first_round and not self.record_spec_timings
            # ---- presize + exact candidate counts ----
            n = len(pending)
            c_pad = chi[pending].astype(np.float32)
            r_pad = (radius_phys[pending] / a).astype(np.float32)
            e_pad = is_central[pending] if so_centrals_only else np.ones(n, bool)
            radius_dev, counts_dev, counts_b_dev = presize_and_count(
                self.chunk,
                self._tensor(c_pad),
                self._tensor(r_pad),
                self._tensor(e_pad),
                target_com,
                ctx0.ptypes,
                bool(so_targets) and first_round,
                radius_trunc=(
                    self._tensor((rb_phys[pending] / a).astype(np.float32))
                    if do_trunc else None
                ),
            )
            first_round = False
            radius_com = radius_dev.cpu().numpy()
            per_type_counts = {
                pt: c.cpu().numpy().astype(np.int64)
                for pt, c in zip(ctx0.ptypes, counts_dev)
            }
            totals = sum(per_type_counts.values())
            totals_b = sum(c.cpu().numpy().astype(np.int64) for c in counts_b_dev)
            rp = np.minimum(
                np.maximum(radius_phys[pending], radius_com.astype(np.float64) * a),
                MAX_SEARCH_RADIUS,
            )
            radius_phys[pending] = rp
            rcom = (rp / a).astype(np.float32)
            order = np.argsort(totals)

            # ---- tile plan: sorted by count, B * sum(caps) <= budget ----
            typemax = {pt: per_type_counts[pt][order] for pt in ctx0.ptypes}
            truncmax = totals_b[order]

            def caps_sum(maxes):
                return sum(_next_pow2(int(m) + 8, 128) for m in maxes.values())

            budget, max_batch = self.tile_caps or (
                row_budget(self.chunk, specs, ctx0), MAX_BATCH
            )
            plans = []
            pos = 0
            while pos < n:
                n_sel = 1
                maxes = {pt: typemax[pt][pos] for pt in ctx0.ptypes}
                bq, tile_budget = 8, budget
                if bq * caps_sum(maxes) >= budget:
                    # giant-halo tile: no 8-lane floor, half the budget
                    bq, tile_budget = 1, budget // 2
                while pos + n_sel < n and n_sel < max_batch:
                    cand = {
                        pt: max(maxes[pt], typemax[pt][pos + n_sel])
                        for pt in ctx0.ptypes
                    }
                    if _next_pow2(n_sel + 1, bq) * caps_sum(cand) > tile_budget:
                        break
                    maxes = cand
                    n_sel += 1
                B = _next_pow2(n_sel, bq)
                # occupancy clamp: a pow2 tile under 75% full is halved
                if B > bq and n_sel < 0.75 * B:
                    B //= 2
                    n_sel = B
                sel = order[pos : pos + n_sel]
                pos += n_sel
                rmax_tile = max(1e-3, float(rcom[sel].max()))
                cubes = tuple(self._cube_for(pt, rmax_tile) for pt in ctx0.ptypes)

                # range-gather layout slack: <= 2 cube^2 merged ranges,
                # each padded by up to S tail + alignment head rows
                def gather_caps(S):
                    return tuple(
                        _quantize_cap(
                            int(maxes[pt]) + 8 + 2 * cube**2 * (
                                S + row_alignment(self.chunk.ptypes[pt].row_width)
                            ),
                            S,
                        )
                        for pt, cube in zip(ctx0.ptypes, cubes)
                    )

                # S grows with the capacity as in the JAX engine (whose
                # per-halo block table had to fit the TPU's SMEM), which
                # keeps the gathered layout identical to its
                S = GATHER_S
                caps = gather_caps(S)
                while max(caps) // S > 48 * 1024:
                    S *= 2
                    caps = gather_caps(S)

                # aperture copy: every halo of the tile inside the
                # next-smaller aperture -> copy instead of compute
                bucket_specs = []
                if enclose is not None:
                    max_enclose = float(enclose[pending[sel]].max())
                    for spec in specs:
                        if (
                            spec.copy_from is not None
                            and spec.copy_from_radius_mpc is not None
                            and max_enclose <= spec.copy_from_radius_mpc
                        ):
                            self.stats.n_copied_specs += 1
                            if spec.strict_keys:
                                bucket_specs.append(
                                    dataclasses.replace(spec, keys=tuple(spec.strict_keys))
                                )
                        else:
                            bucket_specs.append(spec)
                else:
                    bucket_specs = list(specs)
                # truncation cap: the sorted prefix covers every row
                # inside the truncation radius, so it needs no gather slack
                trunc_tile = None
                if do_trunc:
                    kb = _quantize_cap(int(truncmax[pos - n_sel : pos].max(initial=0)) + 8, 1, 256)
                    if kb < 0.85 * sum(caps):
                        trunc_tile = min(kb, sum(caps))
                plans.append(dict(sel=sel, bq=bq, caps=caps, cubes=cubes, S=S,
                                  specs=tuple(bucket_specs), trunc=trunc_tile))

            # ---- bucket calls: each tile in one contiguous share of its
            # halos per worker, run at once, joined in halo order ----
            next_pending: List[int] = []
            for pl in plans:
                g = pending[pl["sel"]]
                nb = len(g)
                t0 = time.perf_counter()
                ctx = dataclasses.replace(ctx0, capacities=pl["caps"])
                w = totals[pl["sel"]].astype(np.float64) + 1.0
                halo_rows = (chi[g], clo[g], rcom[pl["sel"]], index[g],
                             radius_phys[g].astype(np.float32), is_central[g], fof_id[g])
                shares = tile_shares(nb, len(self.devices), pl["bq"])
                jobs = [(worker, ctx, pl, tuple(x[lo:hi] for x in halo_rows), B, w[lo:hi])
                        for worker, lo, hi, B in shares]
                if pool is None:  # one worker, one share
                    done = [self._share(*job) for job in jobs]
                else:
                    futures = [pool.submit(self._share, *job) for job in jobs]
                    done = [f.result() for f in futures]
                if len(done) == 1:  # no copy of a one-device run's thousands of keys
                    out, ov = done[0][:2]
                else:
                    out = {grp: {k: np.concatenate([d[0][grp][k] for d in done]) for k in keys}
                           for grp, keys in done[0][0].items()}
                    ov = np.concatenate([d[1] for d in done])
                dt = time.perf_counter() - t0
                self.stats.compute_seconds += dt
                for (_, lo, hi, _), (_, _, dt_share, stats) in zip(shares, done):
                    self.stats.add(stats)
                    if halo_seconds is not None:
                        # each share's wall time, over its halos
                        halo_seconds[g[lo:hi]] += dt_share * w[lo:hi] / w[lo:hi].sum()
                if halo_nloop is not None:
                    halo_nloop[g] += 1
                self.stats.n_overflow += int(ov.sum())
                self.stats.n_bucket_calls += 1
                self.stats.bucket_calls_by_pass[self._pass] = (
                    self.stats.bucket_calls_by_pass.get(self._pass, 0) + 1
                )
                self.stats.n_truncated_tiles += pl["trunc"] is not None

                # resolve in spec order, so copied apertures chain off
                # earlier (maybe also copied) ones
                bucket_out: Dict[str, Dict[str, np.ndarray]] = {}
                for spec in specs:
                    gdict = out.get(spec.group, {})
                    source = bucket_out.get(spec.copy_from or "")
                    if (
                        source is None
                        and spec.copy_from
                        and self._cross_copy_sources is not None
                    ):
                        # a source of the narrow pass: its final results,
                        # whose retries are already resolved
                        xs = self._cross_copy_sources.get(spec.copy_from)
                        if xs is not None:
                            source = {k: xs[k][g] for k in spec.keys if k in xs}
                            source["__needs_bigger__"] = np.zeros(nb, bool)
                    source = source or {}
                    res = {k: gdict[k] if k in gdict else source[k] for k in spec.keys}
                    res["__needs_bigger__"] = gdict.get(
                        "__needs_bigger__", source.get("__needs_bigger__")
                    )
                    bucket_out[spec.group] = res

                needs = np.zeros(nb, dtype=bool)
                for spec in specs:
                    res = bucket_out[spec.group]
                    flags = res["__needs_bigger__"]
                    if spec.centrals_only:
                        flags = flags & is_central[g]
                    needs |= flags
                    buf = results.setdefault(spec.group, {})
                    for key in spec.keys:
                        arr = res[key]
                        if key not in buf:
                            buf[key] = np.zeros((H,) + arr.shape[1:], arr.dtype)
                        if spec.centrals_only:
                            m = is_central[g].reshape((-1,) + (1,) * (arr.ndim - 1))
                            arr = np.where(m, arr, 0)
                        buf[key][g] = arr
                retry = ov | (needs & (radius_phys[g] < MAX_SEARCH_RADIUS))
                if retry.any():
                    grown = g[retry]
                    radius_phys[grown] *= READ_RADIUS_FACTOR
                    next_pending.extend(grown.tolist())
                    self.stats.n_retries += len(grown)
            pending = np.array(sorted(next_pending), dtype=np.int64)
        if halo_seconds is not None:
            self.stats.halo_timing_chunks.append(
                (np.asarray(index, np.int64).copy(), halo_seconds, halo_nloop))

    def _share(self, worker, ctx, pl, halo_rows, B, w):
        """One share of a tile on its worker's device and store, in the
        calling thread: its halos padded to ``B`` lanes, uploaded, through
        one bucket program; returns (host results, overflow, wall seconds,
        the share's ``EngineStats``)."""
        dev, chunk = self.devices[worker], self.chunks[worker]
        nb = len(halo_rows[0])
        stats = EngineStats()
        guard = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with guard, np.errstate(**self._np_err):
            t0 = time.perf_counter()
            halo_args = []
            for x, (dtype, pad) in zip(halo_rows, _PADDING):
                t = np.full((B,) + x.shape[1:], pad, dtype)
                t[:nb] = x
                halo_args.append(torch.from_numpy(t).to(dev))
            if self.record_spec_timings:
                index = halo_rows[3]  # the share's catalogue indices
                out, ov = self._timed_specs(stats, chunk, dev, ctx, pl, halo_args, nb, index, w)
            else:
                out, overflow = _process_bucket(
                    ctx, pl["specs"], pl["cubes"], pl["S"], chunk, *halo_args, pl["trunc"],
                    stats.k1_launches_by_ptype, stats.k2_launches_by_group,
                )
                out = _to_host(out, nb)
                ov = overflow[:nb].cpu().numpy()
            dt = time.perf_counter() - t0
        name = f"{worker}@{dev}"
        stats.shares_by_worker[name] = 1
        stats.worker_seconds[name] = dt
        return out, ov, dt, stats

    def _timed_specs(self, stats, chunk, dev, ctx, pl, halo_args, nb, index, w):
        """A bucket with every spec as its own program, each timed to its
        results on the device; returns the host results and overflow."""
        by_group = {s.group: s for s in pl["specs"]}
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for spec in pl["specs"]:
            # a radius multiple or a property-sized aperture runs with the
            # spec it reads, so that chain stays in one program
            src = spec.radius_multiple_of or (spec.radius_property or (None,))[0]
            tup = (by_group[src], spec) if src in by_group else (spec,)
            t0 = time.perf_counter()
            o, overflow = _process_bucket(
                ctx, tup, pl["cubes"], pl["S"], chunk, *halo_args, pl["trunc"],
                stats.k1_launches_by_ptype, stats.k2_launches_by_group,
            )
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            stats.spec_seconds[spec.group] = stats.spec_seconds.get(spec.group, 0.0) + dt
            stats.spec_halo_chunks.append(
                (spec.group, np.asarray(index, np.int64).copy(), dt * w / w.sum()))
            out[spec.group] = _to_host({spec.group: o[spec.group]}, nb)[spec.group]
        return out, overflow[:nb].cpu().numpy()
