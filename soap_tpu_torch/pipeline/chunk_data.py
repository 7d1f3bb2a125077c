"""Device-resident chunk data: staging, spatial index, candidate counting.

One copy of a chunk's particles lives in device memory, cell-sorted per
particle type, packed as one (N, F) f32 row block: ``pos_hi`` | ``pos_lo``
| the f32 fields | the int64 fields as f32 bit-halves, padded to F
columns (the layout of ``soap_tpu.pipeline.chunk_data.stage_ptype``, so
the range gather's rows are bit-equal to the JAX package's).  Summed-area
tables over per-cell counts and masses size every halo's candidate set
before any particle moves.  ``adopt`` readies a store staged or copied
on another CUDA stream for the current one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from soap_tpu_torch.ops import geometry
from soap_tpu_torch.ops.grid import GridSpec, cell_index_of, choose_resolution
from soap_tpu_torch.ops.range_gather import pad_columns_for_dma

_FOUR_PI_3 = 4.0 * np.pi / 3.0


@dataclass
class PTypeChunk:
    """One particle type's cell-sorted device tensors."""

    spec: GridSpec
    n: int  # real particle count
    packed: torch.Tensor  # (N, F) f32 packed rows (N padded past n)
    row_width: int  # F
    cols_f: Tuple  # ((name, start, row_shape), ...)
    cols_i: Tuple  # ((name, start, row_shape, dtype_str), ...), 2 cols/int
    offsets: torch.Tensor  # (n_cells,) i32 first row of each cell
    counts: torch.Tensor  # (n_cells,) i32
    sat: torch.Tensor  # (d0+1, d1+1, d2+1) i32 summed-area table
    mass_sat: torch.Tensor  # (d0+1, d1+1, d2+1) f32 mass summed-area table

    def has_field(self, name: str) -> bool:
        return any(c[0] == name for c in self.cols_f) or any(
            c[0] == name for c in self.cols_i
        )


@dataclass
class ChunkData:
    """All particle types of one chunk, on one device."""

    boxsize: float  # comoving internal units
    ptypes: Dict[str, PTypeChunk]


def _row_width(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _quantize_rows(n: int) -> int:
    """Next quarter-pow2 step >= n (1.0/1.25/1.5/1.75 x 2^k)."""
    if n <= 64:
        return 64
    base = 1 << int(math.floor(math.log2(n)))
    for m in (4, 5, 6, 7, 8):
        q = base * m // 4
        if q >= n:
            return q
    return base * 2


def unpack_field(packed, cols_f, cols_i, name):
    """Slice one named field out of packed rows: the (N, F) store or a
    gathered (..., F) block alike.  Int columns are rebuilt from their
    f32 bit-halves with ``.contiguous().view(torch.int64)``."""
    for cname, start, shape in cols_f:
        if cname == name:
            w = _row_width(shape)
            out = packed[..., start : start + w]
            return out.reshape(out.shape[:-1] + tuple(shape)) if shape else out[..., 0]
    for cname, start, shape, dtype_str in cols_i:
        if cname == name:
            w = _row_width(shape)
            out = packed[..., start : start + 2 * w].contiguous().view(torch.int64)
            if dtype_str not in ("int64", "uint64"):
                out = out.to(getattr(torch, dtype_str))
            # uint64 ids keep their int64 bit pattern (torch has no
            # general uint64 arithmetic); only copies touch them
            return out.reshape(out.shape[:-1] + tuple(shape)) if shape else out[..., 0]
    raise KeyError(name)


def _cumsum_seq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 prefix sum accumulated strictly in order along
    ``dim``: bit-equal to numpy's sequential ``cumsum``, which staged the
    JAX package's mass table (a parallel scan rounds differently)."""
    out = x.clone()
    n = x.shape[dim]
    for i in range(1, n):
        cur = out.narrow(dim, i, 1)
        cur += out.narrow(dim, i - 1, 1)
    return out


def _summed_area_table(values: torch.Tensor, dims, dtype) -> torch.Tensor:
    """3D inclusive prefix sum with a leading zero plane per axis:
    ``sat[i, j, k]`` = sum of per-cell values in cells [0:i, 0:j, 0:k]."""
    c = values.reshape(dims).to(dtype)
    for axis in range(3):
        c = (
            _cumsum_seq(c, axis)
            if dtype.is_floating_point
            else torch.cumsum(c, axis).to(dtype)
        )
    return torch.nn.functional.pad(c, (1, 0, 1, 0, 1, 0))


def _upload(arr: np.ndarray, device: torch.device, non_blocking: bool) -> torch.Tensor:
    """A host array on ``device``; ``non_blocking``: through a pinned
    buffer, copied asynchronously on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if non_blocking and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stage_ptype(
    pos: np.ndarray,  # (N, 3) float64 comoving, inside [0, box)
    fields: Dict[str, np.ndarray],
    boxsize: float,
    device: torch.device,
    resolution: Optional[int] = None,
    non_blocking: bool = False,
) -> PTypeChunk:
    """Stage one particle type into the packed cell-sorted store.

    The hi/lo split runs on the host; the cell keys, the stable cell
    sort, the per-cell counts and masses, both summed-area tables and
    the packing run on ``device``.  The grid covers the full periodic
    box.  Rows past the real count (quantized to quarter powers of two,
    with 1024 guard rows for the block-granular range gather) stay zero
    and are unreachable: cell offsets and counts reference real rows
    only.  ``non_blocking``: host arrays go up through pinned buffers
    with asynchronous copies (a side stream's staging).
    """
    device = torch.device(device)
    n = len(pos)
    empty = n == 0
    if empty:
        # absent particle type: one unreachable padding row, zero counts
        pos = np.zeros((1, 3), np.float64)
        fields = {
            k: np.zeros((1,) + np.asarray(v).shape[1:], np.asarray(v).dtype)
            for k, v in fields.items()
        }
    if resolution is None:
        resolution = choose_resolution(n)
    cell_size = boxsize / resolution
    spec = GridSpec(
        origin=(0.0, 0.0, 0.0),
        cell_size=(cell_size, cell_size, cell_size),
        dims=(resolution, resolution, resolution),
        periodic=True,
    )
    hi_h, lo_h = geometry.split_hi_lo(pos)
    hi = _upload(hi_h, device, non_blocking)
    lo = _upload(lo_h, device, non_blocking)

    # flat cell keys from the f32 hi positions, as the query side bins them
    keys = cell_index_of(spec, hi)
    _, order = torch.sort(keys, stable=True)
    counts = torch.bincount(keys, minlength=spec.n_cells).to(torch.int32)
    offsets = torch.zeros(spec.n_cells, dtype=torch.int32, device=device)
    offsets[1:] = torch.cumsum(counts[:-1], 0).to(torch.int32)
    mass = fields.get("Masses")
    if mass is None:
        cell_mass = counts.to(torch.float32)
    else:
        w = _upload(np.asarray(mass, np.float64), device, non_blocking)
        cell_mass = torch.bincount(keys, weights=w, minlength=spec.n_cells).to(
            torch.float32
        )
    if empty:
        counts = torch.zeros_like(counts)
        offsets = torch.zeros_like(offsets)
        cell_mass = torch.zeros_like(cell_mass)
    sat = _summed_area_table(counts, spec.dims, torch.int32)
    mass_sat = _summed_area_table(cell_mass, spec.dims, torch.float32)

    # column layout: pos_hi | pos_lo | f32 fields | int fields as bit-halves
    cols_f, cols_i = [], []
    off = 6
    for name in sorted(fields):
        arr = np.asarray(fields[name])
        shape = tuple(int(s) for s in arr.shape[1:])
        w = _row_width(shape)
        if np.issubdtype(arr.dtype, np.floating):
            cols_f.append((name, off, shape))
            off += w
        else:
            cols_i.append((name, off, shape, str(arr.dtype)))
            off += 2 * w
    f_pad = pad_columns_for_dma(off)
    n_rows = len(pos)
    packed = torch.zeros(
        (_quantize_rows(n_rows + 1024), f_pad), dtype=torch.float32, device=device
    )
    packed[:n_rows, 0:3] = hi[order]
    packed[:n_rows, 3:6] = lo[order]
    for name, start, shape in cols_f:
        arr = _upload(np.asarray(fields[name]).reshape(n_rows, -1), device, non_blocking)
        packed[:n_rows, start : start + _row_width(shape)] = arr[order].to(
            torch.float32
        )
    for name, start, shape, _ in cols_i:
        arr = np.asarray(fields[name]).reshape(n_rows, -1)
        if arr.dtype == np.uint64:
            arr = arr.view(np.int64)
        arr = _upload(arr.astype(np.int64), device, non_blocking)
        bits = arr[order].contiguous().view(torch.float32)
        packed[:n_rows, start : start + bits.shape[1]] = bits
    return PTypeChunk(
        spec=spec,
        n=n,
        packed=packed,
        row_width=f_pad,
        cols_f=tuple(cols_f),
        cols_i=tuple(cols_i),
        offsets=offsets,
        counts=counts,
        sat=sat,
        mass_sat=mass_sat,
    )


def chunk_from_numpy(chunk, device: torch.device) -> ChunkData:
    """The port's ``ChunkData`` on ``device`` from any object shaped like
    the JAX package's host-staged ``ChunkData``: ``boxsize`` and
    ``ptypes`` whose members carry ``spec``, ``n``, ``packed_lines``,
    ``row_width``, ``cols_f``, ``cols_i``, ``offsets``, ``counts``,
    ``sat`` and ``mass_sat`` as numpy arrays (duck-typed: nothing of
    the JAX package is imported)."""

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(device)

    ptypes = {}
    for name, pt in chunk.ptypes.items():
        s = pt.spec
        ptypes[name] = PTypeChunk(
            spec=GridSpec(
                origin=tuple(float(v) for v in s.origin),
                cell_size=tuple(float(v) for v in s.cell_size),
                dims=tuple(int(v) for v in s.dims),
                periodic=bool(s.periodic),
            ),
            n=int(pt.n),
            packed=dev(np.asarray(pt.packed_lines).reshape(-1, pt.row_width)),
            row_width=int(pt.row_width),
            cols_f=tuple(pt.cols_f),
            cols_i=tuple(pt.cols_i),
            offsets=dev(pt.offsets),
            counts=dev(pt.counts),
            sat=dev(pt.sat),
            mass_sat=dev(pt.mass_sat),
        )
    return ChunkData(boxsize=float(chunk.boxsize), ptypes=ptypes)


def _axis_intervals(lo, hi, d: int):
    """Wrapped [lo, hi] cell-index span -> two half-open intervals
    ((a0, b0), (a1, b1)); the second is (0, 0) when no wrap occurs."""
    full = (hi - lo + 1) >= d
    lo_w = torch.remainder(lo, d)
    hi_w = torch.remainder(hi, d)
    wraps = (~full) & (hi_w < lo_w)
    a0 = torch.where(full, 0, lo_w)
    b0 = torch.where(full, d, torch.where(wraps, d, hi_w + 1))
    a1 = torch.zeros_like(lo_w)
    b1 = torch.where(wraps, hi_w + 1, 0)
    return (a0, b0), (a1, b1)


def sat_aabb_sum(
    sat: torch.Tensor,  # (d0+1, d1+1, d2+1)
    dims,
    cell_size,
    centre: torch.Tensor,  # (..., 3)
    radius: torch.Tensor,  # (...)
) -> torch.Tensor:
    """Sum of per-cell values over each halo's periodic search AABB
    (8 periodic sub-boxes x 8 table corners per halo)."""
    cell = torch.tensor(cell_size, dtype=torch.float32, device=centre.device)
    r = radius[..., None]
    lo = torch.floor((centre - r) / cell).to(torch.int64)
    hi = torch.floor((centre + r) / cell).to(torch.int64)
    s1, s2 = sat.shape[1], sat.shape[2]
    flat = sat.reshape(-1)

    def at(i, j, k):
        return flat[(i * s1 + j) * s2 + k]

    def box_sum(ix, iy, iz):
        (a, b), (c, e), (f, g) = ix, iy, iz
        return (
            at(b, e, g)
            - at(a, e, g)
            - at(b, c, g)
            - at(b, e, f)
            + at(a, c, g)
            + at(a, e, f)
            + at(b, c, f)
            - at(a, c, f)
        )

    total = torch.zeros(centre.shape[:-1], dtype=sat.dtype, device=centre.device)
    ivx = _axis_intervals(lo[..., 0], hi[..., 0], dims[0])
    ivy = _axis_intervals(lo[..., 1], hi[..., 1], dims[1])
    ivz = _axis_intervals(lo[..., 2], hi[..., 2], dims[2])
    for ix in ivx:
        for iy in ivy:
            for iz in ivz:
                total = total + box_sum(ix, iy, iz)
    return total


def count_candidates(
    chunk_pt: PTypeChunk,
    centre_hi: torch.Tensor,  # (H, 3) comoving f32
    radius: torch.Tensor,  # (H,) comoving f32
) -> torch.Tensor:
    """Exact candidate-row count per halo via the summed-area table."""
    spec = chunk_pt.spec
    return sat_aabb_sum(chunk_pt.sat, spec.dims, spec.cell_size, centre_hi, radius)


def presize_so_radius(
    chunk: ChunkData,
    centre_hi: torch.Tensor,  # (H, 3) comoving
    radius0: torch.Tensor,  # (H,) comoving initial radii
    target_density_com: float,  # comoving density threshold
    grow: float = 1.2,
    n_steps: int = 24,
) -> torch.Tensor:
    """Grow each radius by ``grow`` until the enclosed mean density (from
    the mass tables) drops below the SO threshold, then on past any
    particle-free gap until the candidate count grows (the vacuum-gap
    rule of ``soap_tpu.pipeline.chunk_data.presize_so_radius``: the SO
    solver only registers a crossing at a particle)."""
    dev = centre_hi.device
    grow_t = torch.tensor(grow, dtype=torch.float32, device=dev)
    steps = torch.arange(-1, n_steps, dtype=torch.float32, device=dev)
    factors = torch.pow(grow_t, steps)  # (S+1,)
    radii = radius0[None, :] * factors[:, None]  # (S+1, H)
    c = centre_hi[None].expand(radii.shape[0], -1, -1)
    target = torch.tensor(target_density_com, dtype=torch.float32, device=dev)

    mass = torch.zeros_like(radii[1:])
    cnt = torch.zeros(radii.shape, dtype=torch.int32, device=dev)
    for pt in chunk.ptypes.values():
        mass = mass + sat_aabb_sum(
            pt.mass_sat, pt.spec.dims, pt.spec.cell_size, c[1:], radii[1:]
        )
        cnt = cnt + sat_aabb_sum(pt.sat, pt.spec.dims, pt.spec.cell_size, c, radii)
    r = radii[1:]
    vol = _FOUR_PI_3 * (r * r * r)
    ok = mass <= target * vol  # (S, H)

    any_ok = ok.any(0)
    first = torch.argmax(ok.to(torch.int8), 0)
    chosen = radius0 * torch.pow(grow_t, first.to(torch.float32))
    cnt_d = cnt.gather(0, (first + 1)[None])[0]
    cnt_prev = cnt.gather(0, first[None])[0]
    vacuum = cnt_d == cnt_prev
    grew = ok & (cnt[1:] > cnt_d[None, :])
    any_grew = grew.any(0)
    first_grew = torch.argmax(grew.to(torch.int8), 0)
    last = radius0 * torch.pow(grow_t, torch.tensor(float(n_steps - 1), device=dev))
    r_grew = torch.where(
        any_grew, radius0 * torch.pow(grow_t, first_grew.to(torch.float32)), last
    )
    chosen = torch.where(vacuum, torch.maximum(chosen, r_grew), chosen)
    return torch.where(any_ok, chosen, last)


def presize_and_count(
    chunk: ChunkData,
    centre_hi: torch.Tensor,  # (H, 3) comoving
    radius0: torch.Tensor,  # (H,) comoving
    so_eligible: torch.Tensor,  # (H,) bool: grow these to the SO target
    target_density_com: float,
    ptypes: Tuple[str, ...],
    do_presize: bool = True,
    radius_trunc: Optional[torch.Tensor] = None,  # (H,) comoving
):
    """The host's bucketing pre-pass: optional SO gather-radius growth,
    then exact per-type candidate counts at the chosen radius.  With
    ``radius_trunc``, also the counts at min(radius_trunc, radius): the
    sorted-prefix bound of the engine's row truncation (else zeros)."""
    if do_presize:
        grown = presize_so_radius(chunk, centre_hi, radius0, target_density_com)
        radius = torch.where(so_eligible, torch.maximum(radius0, grown), radius0)
    else:
        radius = radius0
    counts = tuple(
        count_candidates(chunk.ptypes[pt], centre_hi, radius) for pt in ptypes
    )
    if radius_trunc is None:
        return radius, counts, tuple(torch.zeros_like(c) for c in counts)
    rt = torch.minimum(radius_trunc, radius)
    counts_b = tuple(count_candidates(chunk.ptypes[pt], centre_hi, rt) for pt in ptypes)
    return radius, counts, counts_b


def chunk_tensors(chunk: ChunkData) -> List[torch.Tensor]:
    """Every device tensor of a staged chunk."""
    return [t for pt in chunk.ptypes.values()
            for t in (pt.packed, pt.offsets, pt.counts, pt.sat, pt.mass_sat)]


def adopt(chunk: ChunkData, ready: Optional[torch.cuda.Event], device: torch.device) -> None:
    """Make a prestaged store safe on the current stream: wait for its
    event, and record the stream on every tensor, so that the caching
    allocator does not hand a block to the next prestage while this
    stream's kernels still read it."""
    if ready is None:
        return
    current = torch.cuda.current_stream(device)
    current.wait_event(ready)
    for t in chunk_tensors(chunk):
        t.record_stream(current)
