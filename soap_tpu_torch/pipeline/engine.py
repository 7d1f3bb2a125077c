"""Halo-batch processing engine on one device.

Ported from ``soap_tpu/pipeline/engine.py`` (single chunk, one device):
 1. a counting pre-pass grows each halo's gather radius to its SO
    threshold and counts its candidate rows exactly with summed-area
    tables (``chunk_data.presize_and_count``);
 2. halos are sorted by candidate count and cut into tiles whose padded
    rows stay within ``TARGET_ROWS``; each tile is one bucket call:
    cell ranges -> run-length range gather (kernel K1) -> one radius
    sort -> the lazy property DAG (the SO bisection, masked reductions,
    half-mass radius, and the inertia loop, kernel K2);
 3. halos whose candidate buffer overflowed, or whose properties need a
    bigger region, get their radius grown x1.5 and are re-bucketed until
    done or at the 20 Mpc cap.
Centrals-only specs (SO) run in a separate central phase, so satellite
buckets carry no SO work.  Not ported yet: sorted-prefix truncation,
spec families, the aperture copy and the wide/narrow pass split.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.models.halo_slice import (
    BoundSubhaloSlice,
    HaloParticles,
    HaloScalars,
    SOSlice,
    compute_properties,
    shared_sort_artifacts,
)
from soap_tpu_torch.ops import geometry
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
#: rows per block of the range gather (the JAX layout's S)
GATHER_S = 64


@dataclass(frozen=True)
class HaloTypeSpec:
    """Static description of one halo-type calculation instance: one
    spec per output group.  A copy of ``soap_tpu.pipeline.engine.
    HaloTypeSpec`` (``tests/test_torch_host_mirror.py`` holds the fields
    and defaults to the original's); the engine runs the ``bound`` and
    plain ``SO`` kinds."""

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
    # aperture-copy optimization
    copy_from: Optional[str] = None
    copy_from_radius_mpc: Optional[float] = None
    strict_keys: Tuple[str, ...] = ()

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
    """Raise for a spec this engine does not run yet (keys are checked
    by ``compute_properties``)."""
    if spec.kind == "bound":
        return
    if (
        spec.kind == "SO"
        and spec.so_type in ("crit", "mean", "BN98")
        and spec.radius_multiple_of is None
        and spec.core_excision_fraction is None
    ):
        return
    raise NotImplementedError(f"spec {spec.group} ({spec.kind}) is not ported")


def _make_slice(spec: HaloTypeSpec, ctx, parts, scalars):
    if spec.kind == "bound":
        return BoundSubhaloSlice(ctx, parts, scalars)
    return SOSlice(ctx, parts, scalars, target_density=spec.target_density(ctx))


def _halo_fn(ctx: HaloContext, specs: Tuple[HaloTypeSpec, ...]):
    """Property evaluation over all specs for one bucket: one shared
    radius sort, then each spec's slice."""

    def fn(parts: HaloParticles, scalars: HaloScalars):
        shared = shared_sort_artifacts(parts, scalars)
        out = {}
        for spec in specs:
            s = _make_slice(spec, ctx, parts, scalars)
            s.__dict__.update(shared)
            out[spec.group] = compute_properties(s, spec.keys)
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
):
    """One padded bucket: range gather + every property calculation."""
    a = float(ctx.a)
    parts_per_type = []
    overflow = torch.zeros(centre_hi.shape[0], dtype=torch.bool, device=centre_hi.device)
    for ptype, cap, cube in zip(ctx.ptypes, ctx.capacities, cubes):
        pt = chunk.ptypes[ptype]
        starts, counts = halo_cell_ranges(
            pt.spec, pt.offsets, pt.counts, centre_hi, radius_com, cube
        )
        starts, counts = merge_adjacent_ranges(starts, counts)
        gf, valid, _, total = range_gather_rows(pt.packed, starts, counts, S, cap)
        overflow = overflow | (total > cap)

        def fld(name):
            return unpack_field(gf, pt.cols_f, pt.cols_i, name)

        rel = geometry.periodic_offset(
            gf[..., 0:3], gf[..., 3:6], centre_hi[:, None], centre_lo[:, None],
            chunk.boxsize,
        ) * a
        mass = fld("Masses")
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

    def cat(key):
        return torch.cat([p[key] for p in parts_per_type], 1)

    parts = HaloParticles(*(cat(k) for k in HaloParticles._fields))
    scalars = HaloScalars(
        index=index,
        centre=centre_hi + centre_lo,
        search_radius=search_radius_phys,
        is_central=is_central,
        fof_id=fof_id,
    )
    out = _halo_fn(ctx, specs)(parts, scalars)
    for res in out.values():
        res["__needs_bigger__"] = res["__needs_bigger__"] & ~overflow
    return out, overflow


def _next_pow2(n: int, floor: int = 256) -> int:
    return max(floor, 1 << int(math.ceil(math.log2(max(n, 1)))))


def _quantize_cap(n: int, S: int, floor: int = 128) -> int:
    """Quarter-pow2 row capacity >= n, a multiple of max(128, S)."""
    q = max(128, S)
    n = max(n, floor, q)
    k = 1 << int(math.ceil(math.log2(n)))
    for c in (k // 2 + k // 8, k // 2 + k // 4, k // 2 + 3 * (k // 8), k):
        if c >= n and c % q == 0:
            return c
    return k


@dataclass
class EngineStats:
    """Scheduling and throughput counters."""

    n_bucket_calls: int = 0
    n_retries: int = 0
    #: wall seconds from each bucket's dispatch to its results on the
    #: host (device compute + transfers), summed
    compute_seconds: float = 0.0


class HaloEngine:
    """Bucketed halo-property engine over one chunk on one device."""

    def __init__(
        self,
        ctx_base: HaloContext,
        chunk: ChunkData,
        specs: Sequence[HaloTypeSpec],
        device,
    ):
        self.device = torch.device(device)
        for pt in chunk.ptypes.values():
            if pt.packed.device.type != self.device.type:
                raise ValueError(
                    f"chunk store on {pt.packed.device}, engine on {self.device}"
                )
        for spec in specs:
            _check_spec(spec)
        self.ctx_base = ctx_base
        self.chunk = chunk
        self.specs = tuple(specs)
        self.stats = EngineStats()

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
        specs: Optional[Tuple[HaloTypeSpec, ...]] = None,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Process every halo; returns ``{group: {key: (H, ...) array}}``.

        Centrals-only specs run for the centrals alone (satellites get
        zeros), in a separate phase from the satellites."""
        if specs is None:
            specs = self.specs
        centres = np.asarray(centres)
        search_radius_phys = np.asarray(search_radius_phys)
        index = np.asarray(index)
        fof_id = np.asarray(fof_id)
        cen = np.asarray(is_central, dtype=bool)
        H = len(index)
        co_specs = [s for s in specs if s.centrals_only]
        if co_specs and (~cen).any():
            results: Dict[str, Dict[str, np.ndarray]] = {}
            non_co = tuple(s for s in specs if not s.centrals_only)
            for phase, sub_specs in (("cen", tuple(specs)), ("sat", non_co)):
                rows = np.flatnonzero(cen if phase == "cen" else ~cen)
                if not len(rows) or not sub_specs:
                    continue
                part = self.process(
                    centres[rows], search_radius_phys[rows], index[rows],
                    cen[rows], fof_id[rows], specs=sub_specs,
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
            return results
        results = {}
        self._run(centres, search_radius_phys, index, cen, fof_id, specs, results, H)
        return results

    # -- one population through the round/tile machinery -----------------

    def _run(self, centres, search_radius_phys, index, is_central, fof_id,
             specs, results, H):
        ctx0 = self.ctx_base
        a = ctx0.a
        radius_phys = np.asarray(search_radius_phys, np.float64).copy()
        pending = np.arange(H)
        chi, clo = geometry.split_hi_lo(np.asarray(centres))

        so_targets = [
            s.target_density(ctx0) for s in specs
            if s.kind == "SO" and s.target_density(ctx0) is not None
        ]
        target_com = min(so_targets) * a**3 / 1.5 if so_targets else 0.0
        so_centrals_only = any(s.centrals_only for s in specs if s.kind == "SO")

        first_round = True
        while len(pending):
            # ---- presize + exact candidate counts ----
            n = len(pending)
            c_pad = chi[pending].astype(np.float32)
            r_pad = (radius_phys[pending] / a).astype(np.float32)
            e_pad = is_central[pending] if so_centrals_only else np.ones(n, bool)
            radius_dev, counts_dev = presize_and_count(
                self.chunk,
                self._tensor(c_pad),
                self._tensor(r_pad),
                self._tensor(e_pad),
                target_com,
                ctx0.ptypes,
                bool(so_targets) and first_round,
            )
            first_round = False
            radius_com = radius_dev.cpu().numpy()
            per_type_counts = {
                pt: c.cpu().numpy().astype(np.int64)
                for pt, c in zip(ctx0.ptypes, counts_dev)
            }
            totals = sum(per_type_counts.values())
            rp = np.minimum(
                np.maximum(radius_phys[pending], radius_com.astype(np.float64) * a),
                MAX_SEARCH_RADIUS,
            )
            radius_phys[pending] = rp
            rcom = (rp / a).astype(np.float32)
            order = np.argsort(totals)

            # ---- tile plan: sorted by count, B * sum(caps) <= budget ----
            typemax = {pt: per_type_counts[pt][order] for pt in ctx0.ptypes}

            def caps_sum(maxes):
                return sum(_next_pow2(int(m) + 8, 128) for m in maxes.values())

            plans = []
            pos = 0
            while pos < n:
                n_sel = 1
                maxes = {pt: typemax[pt][pos] for pt in ctx0.ptypes}
                bq, tile_budget = 8, TARGET_ROWS
                if bq * caps_sum(maxes) >= TARGET_ROWS:
                    # giant-halo tile: no 8-lane floor, half the budget
                    bq, tile_budget = 1, TARGET_ROWS // 2
                while pos + n_sel < n and n_sel < MAX_BATCH:
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
                plans.append(dict(sel=sel, B=B, caps=caps, cubes=cubes, S=S))

            # ---- bucket calls ----
            next_pending: List[int] = []
            for pl in plans:
                B = pl["B"]
                g = pending[pl["sel"]]
                nb = len(g)
                t_chi = np.zeros((B, 3), np.float32)
                t_clo = np.zeros((B, 3), np.float32)
                t_rcom = np.full(B, 1e-3, np.float32)
                t_idx = np.full(B, -1, np.int64)
                t_srp = np.full(B, 1e-3, np.float32)
                t_cen = np.zeros(B, bool)
                t_fof = np.full(B, -1, np.int64)
                t_chi[:nb] = chi[g]
                t_clo[:nb] = clo[g]
                t_rcom[:nb] = rcom[pl["sel"]]
                t_idx[:nb] = index[g]
                t_srp[:nb] = radius_phys[g].astype(np.float32)
                t_cen[:nb] = is_central[g]
                t_fof[:nb] = fof_id[g]

                t0 = time.perf_counter()
                ctx = dataclasses.replace(ctx0, capacities=pl["caps"])
                out, overflow = _process_bucket(
                    ctx, tuple(specs), pl["cubes"], pl["S"], self.chunk,
                    *(self._tensor(x) for x in
                      (t_chi, t_clo, t_rcom, t_idx, t_srp, t_cen, t_fof)),
                )
                out = {
                    grp: {k: v[:nb].cpu().numpy() for k, v in d.items()}
                    for grp, d in out.items()
                }
                ov = overflow[:nb].cpu().numpy()
                self.stats.compute_seconds += time.perf_counter() - t0
                self.stats.n_bucket_calls += 1

                needs = np.zeros(nb, dtype=bool)
                for spec in specs:
                    res = out[spec.group]
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
