"""Parallel snapshot reading and chunk read-ahead, on the host.

The port's copy of ``soap_tpu/io/reader_pool.py``.  h5py serialises
every HDF5 call of a process on one lock, so threads cannot read in
parallel; the reference reads cells with a pool of MPI ranks into shared
memory (``SOAP/core/swift_cells.py:548-734``).  Here:

* ``read_masked_cells_parallel`` fans the read segments of
  ``swift_snapshot.plan_masked_read`` out over worker processes that
  write straight into POSIX shared memory; its arrays are byte-identical
  to ``swift_snapshot.read_masked_cells``'s;
* ``ChunkPrefetcher`` runs one read closure ahead on one background
  thread: chunk N+1 is read (and staged) while chunk N computes.

h5py is imported only in the functions that open files.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

from soap_tpu_torch.io import swift_snapshot


def _read_worker(args) -> None:
    """One worker process: read its {(file, ptype): [(dataset, file
    offset, row offset, rows)]} share into the shared-memory arrays."""
    import h5py
    from multiprocessing import shared_memory

    work_by_file, buffers = args
    shms = {}
    views = {}
    try:
        for key, (shm_name, dtype_str, shape) in buffers.items():
            shm = shared_memory.SharedMemory(name=shm_name)
            shms[key] = shm
            views[key] = np.ndarray(shape, dtype=np.dtype(dtype_str), buffer=shm.buf)
        for (filename, ptype), items in work_by_file.items():
            with h5py.File(filename, "r") as f:
                group = f[ptype]
                for name, file_offset, mem_offset, count in items:
                    group[name].read_direct(
                        views[(ptype, name)],
                        np.s_[file_offset : file_offset + count],
                        np.s_[mem_offset : mem_offset + count],
                    )
    finally:
        views.clear()
        for shm in shms.values():
            shm.close()


def read_masked_cells_parallel(
    meta: swift_snapshot.SnapshotMetadata,
    mask: np.ndarray,
    properties: Mapping[str, Sequence[str]],
    n_processes: int = 0,
) -> Dict[str, Dict[str, np.ndarray]]:
    """``swift_snapshot.read_masked_cells`` over ``n_processes`` worker
    processes (0 or 1: the serial read itself).

    Plans the reads as the serial path does, allocates every output
    array in shared memory, deals the (file, particle type) work units,
    largest first, round-robin to the workers (started with ``spawn``),
    and copies the results into ordinary arrays."""
    if n_processes <= 1:
        return swift_snapshot.read_masked_cells(meta, mask, properties)

    from multiprocessing import get_context, shared_memory

    out: Dict[str, Dict[str, np.ndarray]] = {}
    buffers: Dict[Tuple[str, str], Tuple[str, str, tuple]] = {}
    shms: List = []
    work_by_file: Dict[Tuple[str, str], List[tuple]] = {}
    try:
        for ptype, names in properties.items():
            if ptype not in meta.datasets:
                continue
            plans: Dict = {}
            arrays: Dict[str, np.ndarray] = {}
            cell_idx = None
            for name in names:
                info = meta.datasets[ptype].get(name)
                if info is None:
                    raise KeyError(f"dataset {ptype}/{name} not present in inputs")
                template = info.file_template
                if template is None:
                    plans.setdefault(None, (np.zeros(0, np.int64), [], 0))
                elif template not in plans:
                    layout = meta.template_layouts.get(template, {}).get(ptype)
                    plans[template] = swift_snapshot.plan_masked_read(
                        meta, ptype, mask, layout=layout)
                t_cells, segments, total = plans[template]
                if cell_idx is None:
                    cell_idx = t_cells
                shape = (total,) + info.row_shape
                shm = shared_memory.SharedMemory(
                    create=True, size=max(1, int(np.prod(shape)) * info.dtype.itemsize))
                shms.append(shm)
                arrays[name] = np.ndarray(shape, dtype=info.dtype, buffer=shm.buf)
                buffers[(ptype, name)] = (shm.name, info.dtype.str, shape)
                for seg in segments:
                    work_by_file.setdefault(
                        (template.format(file_nr=seg.file_nr), ptype), []
                    ).append((name, seg.file_offset, seg.mem_offset, seg.count))
            out[ptype] = arrays
            out[ptype]["__cells__"] = cell_idx

        units = sorted(work_by_file.items(), key=lambda kv: -sum(w[3] for w in kv[1]))
        shares: List[Dict] = [dict() for _ in range(n_processes)]
        for i, (key, items) in enumerate(units):
            shares[i % n_processes][key] = items
        # spawn, never fork: the parent may hold threads (torch's pools,
        # the read-ahead thread)
        ctx = get_context("spawn")
        procs = []
        for share in (s for s in shares if s):
            needed = {
                (pt, name): buffers[(pt, name)]
                for (_, pt), items in share.items()
                for (name, *_rest) in items
            }
            p = ctx.Process(target=_read_worker, args=((share, needed),))
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"reader workers failed: exit codes {bad}")

        # detach from shared memory: copy into ordinary arrays
        for ptype in out:
            for name, arr in out[ptype].items():
                if name != "__cells__":
                    out[ptype][name] = np.array(arr)
        return out
    finally:
        for shm in shms:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass


class ChunkPrefetcher:
    """Depth-1 read-ahead: one background thread runs the next chunk's
    read closure.

    ``submit(chunk_nr, fn)`` schedules ``fn()`` on the thread (a no-op
    for a chunk already submitted, or when disabled); ``take(chunk_nr,
    fn)`` returns its result, blocking until it is done, or runs ``fn``
    here when nothing was submitted.  An exception of ``fn`` propagates
    out of ``take``."""

    def __init__(self, enabled: bool = True):
        self._pool = ThreadPoolExecutor(max_workers=1) if enabled else None
        self._futures: Dict[int, object] = {}

    def submit(self, chunk_nr: int, fn: Callable[[], object]) -> None:
        if self._pool is not None and chunk_nr not in self._futures:
            self._futures[chunk_nr] = self._pool.submit(fn)

    def take(self, chunk_nr: int, fn: Callable[[], object]):
        fut = self._futures.pop(chunk_nr, None)
        if fut is not None:
            return fut.result()
        return fn()

    def close(self) -> None:
        """Wait for the thread; a result nobody took is dropped (its
        exception with it)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._futures.clear()
