"""Halo batches across several local devices.

The port's counterpart of ``soap_tpu/parallel/sharded.py``.  The JAX
package runs a chunk's halo batches under a ``(chunks, halos)`` device
mesh: the chunk store is placed on every device of its mesh slice and
each bucket's halo lanes are sharded over them (``_local_mesh`` makes a
``(1, n)`` mesh of all local devices for the production chunk loop).
Here a flat device list takes the mesh's place, one worker thread per
entry:

- ``local_devices`` gives the devices a run uses (``_local_mesh``): a
  list splits the halo batches, one device (``"cuda"`` too) does not;
- ``device_grid`` cuts a list into one group per chunk (``make_mesh``);
- ``replicate`` puts a chunk store on every distinct device of a group;
- ``pipeline/engine.py::HaloEngine`` plans each tile on the group's
  first device and runs one contiguous share of its halos per worker;
- ``ShardedHaloEngine`` runs several chunks at once, each on its group.

Not ported: ``stack_chunks`` (the zero-padded stacking that lets XLA
vmap over the stores; each device here holds its chunk's own store) and
the vmapped programs ``_sharded_presize_count`` and ``_sharded_bucket``
(eager torch runs the engine's own steps on each device).
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
import torch

from soap_tpu_torch.pipeline.chunk_data import ChunkData, adopt
from soap_tpu_torch.pipeline.engine import EngineStats, HaloEngine


def local_devices(device) -> List[torch.device]:
    """The devices a run's halo batches use, one worker each.

    A list is taken as given (a device may repeat: two workers on one
    card, or several on the CPU).  One device, ``"cuda"`` (the current
    card) included, is the plain one-device path.  Unlike the JAX entry,
    which takes every local device, the split is asked for by name: on
    the H100 it has yet to beat one card (``PERF.md``, phase 19)."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [torch.device(d) for d in device]
    return [torch.device(device)]


def device_grid(devices: Sequence, n_chunks: int) -> List[List[torch.device]]:
    """A flat device list as ``n_chunks`` contiguous groups of equal
    size, one per chunk (the JAX ``make_mesh``'s ``(chunks, halos)``
    reshape)."""
    devices = [torch.device(d) for d in devices]
    if n_chunks < 1 or len(devices) % n_chunks:
        raise ValueError(f"{len(devices)} devices do not split into {n_chunks} equal groups")
    k = len(devices) // n_chunks
    return [devices[i * k : (i + 1) * k] for i in range(n_chunks)]


def _key(dev: torch.device) -> Tuple[str, int]:
    """One key per physical device: a card by its index, the CPU as one."""
    if dev.type != "cuda":
        return dev.type, 0
    return "cuda", torch.cuda.current_device() if dev.index is None else dev.index


def _chunk_device(chunk: ChunkData) -> torch.device:
    return next(iter(chunk.ptypes.values())).packed.device


def _chunk_to(chunk: ChunkData, dev: torch.device) -> ChunkData:
    def to(t):
        return t.to(dev, non_blocking=True)

    return ChunkData(boxsize=chunk.boxsize, ptypes={
        name: dataclasses.replace(pt, packed=to(pt.packed), offsets=to(pt.offsets),
                                  counts=to(pt.counts), sat=to(pt.sat),
                                  mass_sat=to(pt.mass_sat))
        for name, pt in chunk.ptypes.items()
    })


def _copy(chunk: ChunkData, dev: torch.device, ready) -> Tuple[ChunkData, torch.cuda.Event]:
    """``chunk`` copied to the card ``dev`` on side streams of the
    source (a card's) and the target, after ``ready`` (or the source's
    current stream); returns once the copy is complete, with the event
    that marks it."""
    src = _chunk_device(chunk)
    with contextlib.ExitStack() as streams:
        if src.type == "cuda":
            # a device-to-device copy runs on the source's current stream
            src_stream = torch.cuda.Stream(src)
            if ready is not None:
                src_stream.wait_event(ready)
            else:
                src_stream.wait_stream(torch.cuda.current_stream(src))
            streams.enter_context(torch.cuda.stream(src_stream))
        dst_stream = torch.cuda.Stream(dev)
        streams.enter_context(torch.cuda.stream(dst_stream))
        copy = _chunk_to(chunk, dev)
        event = torch.cuda.Event()
        event.record(dst_stream)
    event.synchronize()
    return copy, event


def replicate(chunk: ChunkData, devices: Sequence, ready=None):
    """One store per entry of ``devices``: ``chunk`` itself on its own
    device, a copy on each other distinct device, the same store for a
    repeated device.  A copy goes to a card, with ``Tensor.to(dev,
    non_blocking=True)`` on a side stream of the target (and of the
    source card), after the source's staging event ``ready`` (or the
    work queued on its current stream).  Returns once every copy is
    complete: ``(stores, events)``, each event marking its store
    (``ready`` for the source's own), for ``pipeline/chunk_data.py::adopt``
    on each device before the engine uses it."""
    devices = [torch.device(d) for d in devices]
    made = {_key(_chunk_device(chunk)): (chunk, ready)}
    for dev in devices:
        if _key(dev) not in made:
            made[_key(dev)] = _copy(chunk, dev, ready)
    return [made[_key(d)][0] for d in devices], [made[_key(d)][1] for d in devices]


class ShardedHaloEngine:
    """Several chunks at once, each over its group of ``grid``
    (``device_grid``'s, one group per chunk): the JAX
    ``ShardedHaloEngine`` over its ``(chunks, halos)`` mesh.  Each chunk's
    store is replicated on its group and runs through a ``HaloEngine``
    there; the groups run in threads of their own.  ``process`` takes
    per-chunk lists and returns per-chunk result dicts; ``engine_kw``
    goes to each ``HaloEngine``."""

    def __init__(self, ctx_base, chunks: Sequence[ChunkData], specs, grid, **engine_kw):
        if len(grid) != len(chunks):
            raise ValueError(f"{len(grid)} device groups for {len(chunks)} chunks")
        self.engines = []
        for chunk, group in zip(chunks, grid):
            group = [torch.device(d) for d in group]
            stores, events = replicate(chunk, group)
            for store, event, dev in zip(stores, events, group):
                adopt(store, event, dev)
            self.engines.append(HaloEngine(ctx_base, stores, specs, group, **engine_kw))

    @property
    def stats(self) -> EngineStats:
        """Every group's counters, summed."""
        total = EngineStats()
        for engine in self.engines:
            total.add(engine.stats)
        return total

    def process(self, centres, search_radius_phys, index, is_central, fof_id,
                enclose_radius_phys=None) -> list:
        """Each chunk's halos on its group: each argument is a list with
        one array per chunk (``HaloEngine.process``'s), the result one
        ``{group: {key: array}}`` per chunk.  A group's error is raised
        here."""
        n = len(self.engines)
        per_chunk = [centres, search_radius_phys, index, is_central, fof_id]
        if any(len(arg) != n for arg in per_chunk) or (
                enclose_radius_phys is not None and len(enclose_radius_phys) != n):
            raise ValueError(f"every argument needs one array per chunk ({n})")
        err = np.geterr()

        def one(c):
            with np.errstate(**err):
                return self.engines[c].process(
                    *(arg[c] for arg in per_chunk),
                    None if enclose_radius_phys is None else enclose_radius_phys[c])

        if n == 1:
            return [one(0)]
        with ThreadPoolExecutor(n) as pool:
            futures = [pool.submit(one, c) for c in range(n)]
            return [f.result() for f in futures]
