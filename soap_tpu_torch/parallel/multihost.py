"""Multi-host runs: static chunk assignment, scratch combine, one writer.

The port's copy of ``soap_tpu/parallel/multihost.py``.  The reference
deals chunks to MPI ranks from a master thread
(``SOAP/core/task_queue.py:63-216``); here every host computes the same
Peano chunks, takes those with ``chunk_nr % host_count == host_index``,
writes one scratch file per chunk into a shared directory, and the first
host to find every chunk complete claims the combine with an ``O_EXCL``
lock file and writes the catalogue.  The scratch directory is the only
hand-off between hosts.

``detect_host_rank`` reads ``torch.distributed`` when it is initialised,
else the scheduler's ``SLURM_PROCID`` and ``SLURM_NTASKS``.  h5py is
imported only in the functions that open files.
"""

from __future__ import annotations

import os
import socket
from collections.abc import MutableMapping
from typing import Dict, List, Tuple

import numpy as np

#: the scratch file attribute naming the package version that wrote it
#: (the JAX package's name, so a directory mixing both is refused alike)
VERSION_ATTR = "soap_tpu_version"
#: the lock file that makes one host the combiner
LOCK_NAME = "combine.lock"


def detect_host_rank() -> Tuple[int, int]:
    """(host_index, host_count): ``torch.distributed``'s rank and world
    size when it is initialised, else SLURM's, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "SLURM_PROCID" in os.environ and "SLURM_NTASKS" in os.environ:
        return int(os.environ["SLURM_PROCID"]), int(os.environ["SLURM_NTASKS"])
    return 0, 1


def chunks_for_host(nr_chunks: int, host_index: int, host_count: int) -> List[int]:
    """Round-robin chunk subset of one host."""
    return [c for c in range(nr_chunks) if c % host_count == host_index]


def scratch_files(scratch_dir: str) -> List[str]:
    """The chunk scratch files' names in ``scratch_dir``, sorted."""
    return sorted(
        f for f in os.listdir(scratch_dir) if f.startswith("chunk_") and f.endswith(".hdf5")
    )


class LazyScratchColumns(MutableMapping):
    """One output group's columns, read from the chunk scratch files one
    column at a time on access and never kept: the writer's peak is one
    full column plus its pieces (the reference combines in batches of
    properties, ``combine_chunks.py:376-404``).  ``set_mask`` registers
    a category mask, applied when a column is read; set columns overlay
    the files' and deleted ones hide them."""

    def __init__(self, scratch_dir, chunk_rows, group, keys, n_halos):
        self._dir = scratch_dir
        self._chunk_rows = chunk_rows  # {filename: halo rows}
        self._group = group
        self._base_keys = list(keys)
        self._n = n_halos
        self._overlay: Dict[str, np.ndarray] = {}
        self._deleted: set = set()
        self._masks: Dict[str, np.ndarray] = {}

    def set_mask(self, key: str, mask: np.ndarray) -> None:
        """Zero the halos failing ``mask`` in this column when it is read."""
        self._masks[key] = self._masks[key] & mask if key in self._masks else mask

    def _load(self, key: str) -> np.ndarray:
        import h5py

        out = None
        for fname, rows in self._chunk_rows.items():
            with h5py.File(os.path.join(self._dir, fname), "r") as f:
                arr = f[f"{self._group}/{key}"][...]
            if out is None:
                out = np.zeros((self._n,) + arr.shape[1:], arr.dtype)
            out[rows] = arr
        return out

    def __getitem__(self, key: str) -> np.ndarray:
        if key in self._overlay:
            arr = self._overlay[key]
        elif key in self._deleted or key not in self._base_keys:
            raise KeyError(key)
        else:
            arr = self._load(key)
        mask = self._masks.get(key)
        if mask is not None and not mask.all():
            arr = np.where(mask.reshape((-1,) + (1,) * (arr.ndim - 1)), arr, 0)
        return arr

    def __setitem__(self, key: str, value) -> None:
        self._deleted.discard(key)
        self._overlay[key] = value

    def __delitem__(self, key: str) -> None:
        existed = key in self._overlay or (key in self._base_keys and key not in self._deleted)
        self._overlay.pop(key, None)
        if not existed:
            raise KeyError(key)
        if key in self._base_keys:
            self._deleted.add(key)

    def __iter__(self):
        for key in self._base_keys:
            if key not in self._deleted and key not in self._overlay:
                yield key
        yield from self._overlay

    def __len__(self) -> int:
        return sum(1 for _ in self)


def check_scratch_complete(scratch_dir: str, specs, n_halos: int) -> None:
    """Raise unless the scratch files are present, complete and together
    cover every halo (the condition for combining)."""
    import h5py

    files = scratch_files(scratch_dir)
    if not files:
        raise FileNotFoundError(f"no chunk scratch files in {scratch_dir}")
    covered = np.zeros(n_halos, dtype=bool)
    for fname in files:
        with h5py.File(os.path.join(scratch_dir, fname), "r") as f:
            if not f.attrs.get("Write complete", False):
                raise RuntimeError(f"incomplete scratch file {fname}")
            covered[f["rows"][...]] = True
    if not covered.all():
        raise RuntimeError(
            f"{int((~covered).sum())} halos not covered by scratch files — "
            "some hosts have not finished")


def lock_line() -> str:
    """What this process writes into the lock it claims."""
    return f"{socket.gethostname()} pid={os.getpid()}\n"


def _lock_holder_alive(path: str) -> bool:
    """Whether the lock at ``path`` may belong to a live process: true
    unless it names this host and a pid that no longer exists (another
    host's lock, or one that cannot be read, is never taken over)."""
    try:
        with open(path) as f:
            host, _, pidpart = f.read().strip().partition(" pid=")
        pid = int(pidpart)
    except (OSError, ValueError):
        return True
    if host != socket.gethostname() or pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def claim_combine(scratch_dir: str) -> bool:
    """Claim the combine and write for this process: ``O_CREAT|O_EXCL``
    on the lock file, so exactly one claimant wins; a lock left by a
    dead process of this host is taken over once."""
    path = os.path.join(scratch_dir, LOCK_NAME)
    for attempt in range(2):
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if attempt == 0 and not _lock_holder_alive(path):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                continue
            return False
        with os.fdopen(fd, "w") as f:
            f.write(lock_line())
        return True
    return False


def release_combine(scratch_dir: str) -> None:
    """Give up a claimed combine (after a failed attempt)."""
    try:
        os.unlink(os.path.join(scratch_dir, LOCK_NAME))
    except FileNotFoundError:
        pass


def combine_scratch(scratch_dir: str, specs, n_halos: int, lazy: bool = False) -> dict:
    """Every chunk scratch file merged into (n_halos, ...) arrays per
    group and key, or with ``lazy`` into ``LazyScratchColumns`` per group
    (checked up front, read per column).

    Raises if a file is incomplete, if the files leave a halo uncovered,
    if a column's dtype or trailing shape differs between files, or if
    the files were written by different package versions (the
    reference's cross-chunk consistency asserts,
    ``core/result_set.py:275-418``)."""
    import h5py

    files = scratch_files(scratch_dir)
    if not files:
        raise FileNotFoundError(f"no chunk scratch files in {scratch_dir}")
    covered = np.zeros(n_halos, dtype=bool)
    chunk_rows: Dict[str, np.ndarray] = {}
    col_meta: Dict[str, tuple] = {}
    version_seen: Dict[str, str] = {}
    for fname in files:
        with h5py.File(os.path.join(scratch_dir, fname), "r") as f:
            if not f.attrs.get("Write complete", False):
                raise RuntimeError(f"incomplete scratch file {fname}")
            rows = f["rows"][...]
            version_seen[fname] = f.attrs.get(VERSION_ATTR, b"").decode()
            for spec in specs:
                for key in spec.keys:
                    name = f"{spec.group}/{key}"
                    ds = f[name]
                    meta = (ds.dtype.str, ds.shape[1:])
                    prev = col_meta.setdefault(name, meta)
                    if prev != meta:
                        raise RuntimeError(
                            f"scratch metadata mismatch for {name}: {fname} has dtype/shape "
                            f"{meta}, earlier chunks have {prev}")
        chunk_rows[fname] = rows
        covered[rows] = True
    if len(set(version_seen.values())) > 1:
        raise RuntimeError(
            "scratch files written by different soap_tpu versions: "
            + ", ".join(f"{k}={v or '?'}" for k, v in version_seen.items()))
    if not covered.all():
        raise RuntimeError(
            f"{int((~covered).sum())} halos not covered by scratch files — "
            "some hosts have not finished")

    if lazy:
        return {
            spec.group: LazyScratchColumns(scratch_dir, chunk_rows, spec.group, spec.keys,
                                           n_halos)
            for spec in specs
        }
    merged: dict = {}
    for fname, rows in chunk_rows.items():
        with h5py.File(os.path.join(scratch_dir, fname), "r") as f:
            for spec in specs:
                grp = merged.setdefault(spec.group, {})
                for key in spec.keys:
                    arr = f[f"{spec.group}/{key}"][...]
                    if key not in grp:
                        grp[key] = np.zeros((n_halos,) + arr.shape[1:], arr.dtype)
                    grp[key][rows] = arr
    return merged
