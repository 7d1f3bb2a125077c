"""A chunk's particle inputs on the host, staged on a device, and the
loop over the Peano–Hilbert chunks of a run.

The port's copies of ``soap_tpu/pipeline/chunks.py``'s
``required_datasets``, chunk read, host-side ``StellarAges`` derivation
and ``process_chunks``.  A chunk reader is a callable ``read(rows)``
giving the particle fields of the cells within ``READ_MARGIN`` search
radii of the halos ``rows``, each particle type in ascending cell order,
in ``read_chunk_fields``' form: ``file_reader`` reads them from a
snapshot and its membership file (serially, or over worker processes),
``memory_reader`` keeps them out of every cell's fields held in memory
(``mock_fields`` builds those for a mock universe, with no file and no
h5py).  ``stage_chunk`` stages a chunk on a device; ``prestage`` does
so from pinned host buffers on a side CUDA stream, in the read-ahead
thread.  ``process_chunks`` runs the engine chunk after chunk with
scratch files, restart and read-ahead, each chunk's halo batches over
every device of its list (``parallel/sharded.py``).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

import soap_tpu_torch
from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.io import swift_snapshot
from soap_tpu_torch.io.reader_pool import ChunkPrefetcher, read_masked_cells_parallel
from soap_tpu_torch.parallel.domain import peano_decomposition
from soap_tpu_torch.parallel.multihost import VERSION_ATTR
from soap_tpu_torch.parallel.sharded import local_devices, replicate
from soap_tpu_torch.pipeline.chunk_data import ChunkData, adopt, chunk_tensors, stage_ptype
from soap_tpu_torch.pipeline.engine import (
    READ_RADIUS_FACTOR, EngineStats, HaloEngine, min_physical_radius,
)
from soap_tpu_torch.utils import trace
from soap_tpu_torch.utils.mock_data import MOCK_CELLS_PER_DIM

#: one chunk's particle fields per type: (comoving positions (N, 3) f64
#: in [0, box), {dataset: array})
HostFields = Dict[str, Tuple[np.ndarray, Dict[str, np.ndarray]]]

#: fields every run reads per particle type (the DMO tier)
BASE_FIELDS = ["Coordinates", "Masses", "Velocities", "GroupNr_bound", "FOFGroupIDs"]

#: factor applied to search radii when masking cells to read: leaves head
#: room for the engine's x1.5 retry ladder without re-reading
READ_MARGIN = 4.0


def required_datasets(specs, meta) -> Dict[str, List[str]]:
    """Union of the particle datasets the specs' keys need, from the
    property table's ``particle_properties``, restricted to datasets
    present in ``meta.datasets``."""
    table = full_property_table()
    out: Dict[str, List[str]] = {}
    for spec in specs:
        for key in spec.keys:
            if key not in table:
                continue
            for ds in table[key].particle_properties:
                ptype, name = ds.split("/", 1)
                if ptype in meta.datasets and name in meta.datasets[ptype]:
                    out.setdefault(ptype, [])
                    if name not in out[ptype]:
                        out[ptype].append(name)
    return out


def fields_per_type(specs, meta, ptypes: Sequence[str]) -> Dict[str, List[str]]:
    """Per particle type: the base fields it has, then the datasets the
    specs need, in the order the JAX run reads them."""
    out = {pt: [f for f in BASE_FIELDS if f in meta.datasets[pt]] for pt in ptypes}
    for pt, names in required_datasets(specs, meta).items():
        for n in names:
            if n not in out.get(pt, []):
                out.setdefault(pt, []).append(n)
    return out


def stellar_ages(
    birth_a: np.ndarray, age_table: Tuple[np.ndarray, np.ndarray], a: float
) -> np.ndarray:
    """Per-star age at scale factor ``a`` from the birth scale factor,
    through the a -> age table (internal time units), floored at 0."""
    age_a, age_t = age_table
    t_now = np.interp(float(a), age_a, age_t)
    return np.maximum(t_now - np.interp(birth_a, age_a, age_t), 0.0).astype(np.float32)


def read_mask(meta, centres: np.ndarray, search_radius: np.ndarray, specs) -> np.ndarray:
    """The cells a chunk reads for halos at ``centres`` with comoving
    ``search_radius``: those within ``READ_MARGIN`` search radii of a
    halo (at least two retry steps past the largest fixed physical
    radius), plus half a cell."""
    floor_com = min_physical_radius(specs) / meta.a
    return meta.mask_cells_for_spheres(
        np.mod(centres, meta.boxsize),
        np.maximum(search_radius * READ_MARGIN, floor_com * READ_RADIUS_FACTOR**2)
        + 0.5 * float(np.max(meta.cell_size)),
    )


def read_chunk_fields(
    meta: swift_snapshot.SnapshotMetadata,
    cat,
    specs,
    ptypes: Sequence[str],
    age_table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    io_processes: int = 0,
) -> HostFields:
    """The chunk of the halos of ``cat`` (a ``HaloCatalogue``) read from
    the snapshot and its extra inputs, as ``mock_fields`` returns them:
    the cells of ``read_mask``; ``fields_per_type``'s datasets; the
    derived ``StellarAges`` when ``age_table`` is given.  With
    ``io_processes`` > 1 the read runs over that many worker processes
    (``io/reader_pool.py``), byte for byte the serial read."""
    mask = read_mask(meta, cat.cofp, cat.search_radius, specs)
    data = read_masked_cells_parallel(
        meta, mask, fields_per_type(specs, meta, ptypes), io_processes)
    out = {}
    for pt in ptypes:
        fields = {
            name: arr for name, arr in data[pt].items()
            if name not in ("Coordinates", "__cells__")
        }
        if pt == "PartType4" and age_table is not None and "BirthScaleFactors" in fields:
            fields["StellarAges"] = stellar_ages(fields["BirthScaleFactors"], age_table, meta.a)
        out[pt] = (np.mod(data[pt]["Coordinates"], meta.boxsize), fields)
    return out


def file_reader(meta, cat, specs, ptypes: Sequence[str], age_table=None,
                io_processes: int = 0) -> Callable[[np.ndarray], HostFields]:
    """``read(rows)``: ``read_chunk_fields`` for the halos ``rows`` of ``cat``."""

    def read(rows):
        keep = np.zeros(cat.nr_halos, bool)
        keep[rows] = True
        return read_chunk_fields(meta, cat.select(keep), specs, ptypes, age_table, io_processes)

    return read


def memory_reader(meta, cat, host: Mapping[str, tuple], specs
                  ) -> Callable[[np.ndarray], HostFields]:
    """``read(rows)`` over every cell's fields held in memory (``host``,
    as ``mock_fields`` or a whole-snapshot ``read_chunk_fields`` give
    them): the particles of the cells of ``read_mask`` for the halos
    ``rows`` of ``cat``, in their order in ``host`` (ascending cell, as
    the file reader returns them); ``host``'s own arrays where the mask
    holds every cell.  No h5py."""
    dims = np.asarray(meta.dimension, np.int64)
    cells: Dict[str, np.ndarray] = {}

    def cell_of(pt):
        # each particle's top-level cell, computed on first need
        if pt not in cells:
            pos = host[pt][0]
            ijk = np.floor(pos / np.asarray(meta.cell_size)[None, :]).astype(np.int64) % dims
            cells[pt] = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
        return cells[pt]

    def read(rows):
        mask = read_mask(meta, cat.cofp[rows], cat.search_radius[rows], specs)
        if mask.all():
            return dict(host)
        out = {}
        for pt, (pos, fields) in host.items():
            keep = mask[cell_of(pt)]
            out[pt] = (pos[keep], {name: arr[keep] for name, arr in fields.items()})
        return out

    return read


def _snapshot_order(pos: np.ndarray, boxsize: float) -> np.ndarray:
    """The permutation the mock snapshot stores a particle type in: a
    stable sort by top-level cell (row-major flat index)."""
    n = MOCK_CELLS_PER_DIM
    ijk = np.floor(pos / (boxsize / n)).astype(np.int64) % n
    flat = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
    return np.argsort(flat, kind="stable")


def mock_fields(
    uni,
    specs,
    meta,
    ptypes: Sequence[str],
    age_table: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Dict[str, Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """{ptype: (comoving positions (N, 3) f64 in [0, box), {dataset: array})}
    for a mock universe, as the JAX run reads them from its snapshot and
    membership file with every cell selected: the snapshot's cell order,
    the stored dtypes, ``fields_per_type``'s datasets (``Coordinates``
    apart), ``GroupNr_bound`` from the bound particle lists, and the
    derived ``StellarAges`` when ``age_table`` is given."""
    stored = {
        "PartType1": {
            "Coordinates": uni.pos,
            "Velocities": uni.vel.astype(np.float32),
            "Masses": uni.mass.astype(np.float32),
            "ParticleIDs": uni.ids,
            "FOFGroupIDs": uni.fof_ids,
        }
    }
    stored.update(uni.extra_ptypes or {})
    # membership: the catalogue index of the halo each particle is bound to
    all_ids = np.concatenate([np.asarray(d["ParticleIDs"]) for d in stored.values()])
    id_to_halo = np.full(int(all_ids.max()) + 1, -1, np.int64)
    for hi, ids in enumerate(uni.bound_ids):
        id_to_halo[np.asarray(ids, np.int64)] = hi
    wanted = fields_per_type(specs, meta, ptypes)
    out = {}
    for pt in ptypes:
        data = stored[pt]
        order = _snapshot_order(np.asarray(data["Coordinates"]), uni.boxsize)
        fields = {}
        for name in wanted[pt]:
            if name == "Coordinates":
                continue
            if name == "GroupNr_bound":
                ids = np.asarray(data["ParticleIDs"], np.int64)[order]
                fields[name] = id_to_halo[ids]
            else:
                fields[name] = np.asarray(data[name])[order]
        if pt == "PartType4" and age_table is not None and "BirthScaleFactors" in fields:
            fields["StellarAges"] = stellar_ages(fields["BirthScaleFactors"], age_table, meta.a)
        pos = np.mod(np.asarray(data["Coordinates"])[order], uni.boxsize)
        out[pt] = (pos, fields)
    return out


def stage_chunk(host: HostFields, boxsize: float, device: torch.device,
                non_blocking: bool = False) -> ChunkData:
    """A chunk's fields staged per particle type on ``device``
    (``non_blocking``: uploads from pinned buffers, on the current
    stream)."""
    return ChunkData(
        boxsize=float(boxsize),
        ptypes={
            pt: stage_ptype(pos, fields, boxsize, device, non_blocking=non_blocking)
            for pt, (pos, fields) in host.items()
        },
    )


def store_bytes(chunk: ChunkData) -> int:
    """Device bytes a staged chunk holds, in the caching allocator's
    512-byte blocks."""
    return sum(-(-t.numel() * t.element_size() // 512) * 512 for t in chunk_tensors(chunk))


def prestage(host: HostFields, boxsize: float, device: torch.device
             ) -> Tuple[ChunkData, Optional[torch.cuda.Event]]:
    """``stage_chunk`` for a thread beside the engine's: on a CUDA device
    on a side stream, from pinned buffers, returning once the store is
    complete with the event that marks it (None on the CPU).  A stream
    that uses the store must wait on the event, and each tensor must
    record that stream (``adopt``) before the engine touches it."""
    device = torch.device(device)
    if device.type != "cuda":
        return stage_chunk(host, boxsize, device), None
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        chunk = stage_chunk(host, boxsize, device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
    ready.synchronize()
    return chunk, ready


# ----------------------------------------------------------------------
# The chunk loop: scratch files, restart, read-ahead
# ----------------------------------------------------------------------


def _progress(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def scratch_path(scratch_dir: str, chunk_nr: int) -> str:
    return os.path.join(scratch_dir, f"chunk_{chunk_nr}.hdf5")


def calc_names(specs) -> List[str]:
    return [f"{s.group}/{k}" for s in specs for k in s.keys]


def try_load_scratch(path: str, specs, rows: np.ndarray
                     ) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
    """A finished chunk's results, if its scratch file is complete and
    was written for the same calculations and halo rows; else None."""
    import h5py

    if not os.path.exists(path):
        return None
    try:
        with h5py.File(path, "r") as f:
            if not f.attrs.get("Write complete", False):
                return None
            if [n.decode() for n in f.attrs["calc_names"]] != calc_names(specs):
                return None
            if not np.array_equal(f["rows"][...], rows):
                return None
            return {s.group: {k: f[f"{s.group}/{k}"][...] for k in s.keys} for s in specs}
    except (OSError, KeyError):
        return None


def write_scratch(path: str, specs, rows: np.ndarray,
                  results: Dict[str, Dict[str, np.ndarray]]) -> None:
    """A chunk's results as the JAX package lays them out: ``rows``,
    ``<group>/<key>``, the ``calc_names``, the writing package's version
    and ``Write complete``, written to a temporary file renamed into
    place."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.create_dataset("rows", data=rows)
        for spec in specs:
            for key in spec.keys:
                f.create_dataset(f"{spec.group}/{key}", data=results[spec.group][key])
        f.attrs["calc_names"] = [np.bytes_(n) for n in calc_names(specs)]
        f.attrs[VERSION_ATTR] = np.bytes_(f"soap_tpu_torch {soap_tpu_torch.__version__}")
        f.attrs["Write complete"] = True
    os.replace(tmp, path)


@dataclass
class ChunkRecord:
    """One chunk of a run: its halos and staged particles, the seconds
    its read, staging and replication took in the thread that ran them,
    the seconds the loop waited for them, the engine's seconds, its
    store's bytes (``store_bytes``, one device's copy), and per CUDA
    device (by name, none on the CPU) the memory allocated after it was
    merged and freed, read once the next chunk's store was taken (no
    read in flight then) or after the loop, and the most allocated so
    far (since the caller last reset the peak), read when its engine
    finished.  A chunk restored from scratch has only its halos."""

    chunk_nr: int
    halos: int
    particles: int = 0
    read_seconds: float = 0.0
    wait_seconds: float = 0.0
    engine_seconds: float = 0.0
    store_bytes: int = 0
    memory_after: Dict[str, int] = field(default_factory=dict)
    peak_memory: Dict[str, int] = field(default_factory=dict)
    from_scratch: bool = False


def process_chunks(
    read_chunk: Callable[[np.ndarray], HostFields],
    cat,
    ctx,
    specs,
    search_radius_phys: np.ndarray,
    device,
    nr_chunks: int = 1,
    scratch_dir: Optional[str] = None,
    chunk_subset: Optional[Sequence[int]] = None,
    prefetch: bool = True,
    record_halo_timings: bool = False,
    record_property_timings: bool = False,
    verbose: bool = False,
) -> Tuple[Dict[str, Dict[str, np.ndarray]], EngineStats, List[ChunkRecord]]:
    """Every halo of ``cat``, chunk by chunk; returns the merged
    ``{group: {key: (H, ...)}}``, the summed engine counters and one
    ``ChunkRecord`` per chunk.

    ``device`` is resolved by ``parallel/sharded.py::local_devices`` (one
    device, or a list): over a list each chunk's
    store is staged on the first device and replicated on the others,
    and its halo batches split over all of them (``HaloEngine``).

    Halos are split into ``nr_chunks`` Peano–Hilbert chunks (one chunk:
    all of them), run in chunk order (only ``chunk_subset``'s, for a
    host of a multi-host run), empty chunks skipped.  With
    ``scratch_dir`` each chunk's results go to a scratch file, and a
    valid one (same calculations and rows) is reused instead of
    computed.  With ``prefetch`` and more than one chunk to compute, one
    thread reads chunk N+1, stages it on the first device (``prestage``)
    and replicates it while the engine computes chunk N (the first chunk
    is read here); an error there is raised here, and the chunk is not
    read again.  Each chunk's stores and engine are dropped once its
    results are merged: each device holds at most two stores and one
    bucket per worker."""
    devices = local_devices(device)
    device = devices[0]
    cards = list({str(d): d for d in devices if d.type == "cuda"}.values())
    t_start = time.perf_counter()
    H = cat.nr_halos
    chunk_of = (
        peano_decomposition(np.mod(cat.cofp, ctx.boxsize), ctx.boxsize, nr_chunks)
        if nr_chunks > 1 else np.zeros(H, dtype=np.int32)
    )
    chunk_nrs = range(int(chunk_of.max()) + 1 if H else 0)
    if chunk_subset is not None:
        chunk_nrs = sorted(set(chunk_nrs) & set(chunk_subset))
    todo = [(c, rows) for c in chunk_nrs for rows in [np.flatnonzero(chunk_of == c)] if len(rows)]

    restored = {}
    if scratch_dir:
        for c, rows in todo:
            restored[c] = try_load_scratch(scratch_path(scratch_dir, c), specs, rows)
    to_compute = [(c, rows) for c, rows in todo if restored.get(c) is None]

    def load(rows, side):
        # the importing thread's numpy error rules hold in the reader too
        with np.errstate(divide="raise", over="raise", invalid="raise"):
            t0 = time.perf_counter()
            with trace.span("chunks.read", halos=len(rows)):
                host = read_chunk(rows)
            stage = trace.start("chunks.stage", side=side)
            if side:
                chunk, ready = prestage(host, ctx.boxsize, device)
            else:
                chunk, ready = stage_chunk(host, ctx.boxsize, device), None
                if device.type == "cuda":  # staged, not only queued
                    torch.cuda.current_stream(device).synchronize()
            stores, events = replicate(chunk, devices, ready)
            stage.stop()
            n = sum(len(pos) for pos, _ in host.values())
            return stores, events, n, time.perf_counter() - t0

    def allocated():
        return {str(d): torch.cuda.memory_allocated(d) for d in cards}

    prefetcher = ChunkPrefetcher(enabled=prefetch and len(to_compute) > 1)
    total = EngineStats()
    records: List[ChunkRecord] = []
    merged: Dict[str, Dict[str, np.ndarray]] = {}
    last = None  # the record of the last chunk computed
    try:
        for c, rows in todo:
            rec = ChunkRecord(chunk_nr=c, halos=len(rows))
            results = restored.pop(c, None)
            if results is not None:
                rec.from_scratch = True
                if verbose:
                    _progress(f"[{time.perf_counter() - t_start:6.1f}s] chunk {c}: "
                              f"restart, {len(rows)} halos from scratch")
            else:
                t0 = time.perf_counter()
                wait = trace.start("chunks.wait", t0, chunk=c)
                stores, events, rec.particles, rec.read_seconds = prefetcher.take(
                    c, lambda: load(rows, False))
                for i, dev in enumerate(devices):  # no name outlives the stores
                    adopt(stores[i], events[i], dev)
                rec.wait_seconds = time.perf_counter() - t0
                wait.stop(t0 + rec.wait_seconds)
                rec.store_bytes = store_bytes(stores[0])
                if last is not None:
                    # no read in flight now: the last chunk's store and
                    # engine must be gone, this one's store alone added
                    last.memory_after = allocated()
                # the next chunk to compute is read and staged while
                # this one computes
                k = next(j for j, (cc, _) in enumerate(to_compute) if cc == c)
                for nc, nrows in to_compute[k + 1 : k + 2]:
                    prefetcher.submit(nc, lambda r=nrows: load(r, True))
                t1 = time.perf_counter()
                process = trace.start("engine.process", t1, chunk=c, halos=len(rows))
                engine = HaloEngine(ctx, stores, specs, devices,
                                    record_halo_timings=record_halo_timings,
                                    record_spec_timings=record_property_timings)
                results = engine.process(
                    centres=cat.cofp[rows],
                    search_radius_phys=search_radius_phys[rows],
                    index=cat.index[rows],
                    is_central=cat.is_central.astype(bool)[rows],
                    fof_id=cat.fof_id[rows],
                    # upper bound on EncloseRadius (HBT search radius = 1.01 x REnclose)
                    enclose_radius_phys=cat.search_radius[rows] * ctx.a,
                )
                rec.engine_seconds = time.perf_counter() - t1
                process.stop(t1 + rec.engine_seconds)
                rec.peak_memory = {str(d): torch.cuda.max_memory_allocated(d) for d in cards}
                total.add(engine.stats)
                del engine, stores, events
                last = rec
                if scratch_dir:
                    write_scratch(scratch_path(scratch_dir, c), specs, rows, results)
                if verbose:
                    _progress(
                        f"[{time.perf_counter() - t_start:6.1f}s] chunk {c}: {len(rows)} "
                        f"halos, {rec.particles} particles read and staged in "
                        f"{rec.read_seconds:.2f} s (waited {rec.wait_seconds:.2f} s), "
                        f"engine {rec.engine_seconds:.2f} s")
            for group, props in results.items():
                buf = merged.setdefault(group, {})
                for key, arr in props.items():
                    if key not in buf:
                        buf[key] = np.zeros((H,) + arr.shape[1:], arr.dtype)
                    buf[key][rows] = arr
            del results
            records.append(rec)
        if last is not None:
            last.memory_after = allocated()
    finally:
        prefetcher.close()
    return merged, total, records
