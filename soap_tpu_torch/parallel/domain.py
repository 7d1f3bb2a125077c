"""Spatial domain decomposition: Peano–Hilbert chunking of halos.

The port's copy of ``soap_tpu/parallel/domain.py`` (reference
``SOAP/core/domain_decomposition.py``): halos are ordered along a
Hilbert curve over a 2^bits-cell grid and split into chunks of equal
halo count, so each chunk is spatially compact and its particles fit
one device.  ``separate_chunks`` puts the most massive halos in chunks
of their own, after the spatial ones.

The Hilbert key is Skilling's transpose algorithm, vectorised over
numpy arrays; it is the one implementation (no native library).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def hilbert_key_3d(ijk: np.ndarray, bits: int) -> np.ndarray:
    """Hilbert curve index (uint64) of integer cells ``ijk`` (N, 3) at
    ``bits`` bits per dimension."""
    x = ijk.astype(np.uint64).copy()
    n = 3
    m = np.uint64(1) << np.uint64(bits - 1)

    # inverse undo excess work
    q = m
    while q > np.uint64(1):
        p = q - np.uint64(1)
        for i in range(n):
            mask = (x[:, i] & q) != 0
            x[mask, 0] ^= p  # invert the low bits of x[0]
            t = (x[:, 0] ^ x[:, i]) & p
            x[~mask, 0] ^= t[~mask]
            x[~mask, i] ^= t[~mask]
        q >>= np.uint64(1)

    # Gray encode
    for i in range(1, n):
        x[:, i] ^= x[:, i - 1]
    t = np.zeros(len(x), dtype=np.uint64)
    q = m
    while q > np.uint64(1):
        mask = (x[:, n - 1] & q) != 0
        t[mask] ^= q - np.uint64(1)
        q >>= np.uint64(1)
    for i in range(n):
        x[:, i] ^= t

    # interleave the bits of the transposed index
    key = np.zeros(len(x), dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(n):
            key = (key << np.uint64(1)) | ((x[:, i] >> np.uint64(b)) & np.uint64(1))
    return key


def peano_decomposition(
    centres: np.ndarray,  # (H, 3) comoving
    boxsize: float,
    nr_chunks: int,
    bits: int = 10,  # 2^10 cells per dimension, the reference's default
    nr_bound_part: Optional[np.ndarray] = None,
    separate_chunks: Optional[List[int]] = None,
) -> np.ndarray:
    """Chunk index (int32) per halo: an equal-count split along the
    Hilbert curve into ``nr_chunks`` chunks; with ``separate_chunks`` (a
    descending list of ``nr_bound_part`` thresholds) each halo above a
    threshold gets a chunk of its own, numbered after the spatial ones."""
    H = len(centres)
    chunk_nr = np.zeros(H, dtype=np.int32)
    if H == 0 or nr_chunks <= 1 and not separate_chunks:
        return chunk_nr

    spatial = np.ones(H, dtype=bool)
    next_chunk = nr_chunks
    if separate_chunks:
        if nr_bound_part is None:
            raise ValueError("separate_chunks needs nr_bound_part")
        for threshold in separate_chunks:
            big = spatial & (nr_bound_part > threshold)
            for idx in np.flatnonzero(big):
                chunk_nr[idx] = next_chunk
                next_chunk += 1
            spatial &= ~big

    cells = np.floor(np.mod(centres, boxsize) / boxsize * (1 << bits)).astype(np.int64)
    cells = np.clip(cells, 0, (1 << bits) - 1)
    keys = hilbert_key_3d(cells, bits)
    order = np.argsort(keys[spatial], kind="stable")
    spatial_rows = np.flatnonzero(spatial)[order]
    n_spatial = len(spatial_rows)
    boundaries = (np.arange(1, nr_chunks) * n_spatial) // nr_chunks
    assignment = np.searchsorted(boundaries, np.arange(n_spatial), side="right")
    chunk_nr[spatial_rows] = assignment.astype(np.int32)
    return chunk_nr
