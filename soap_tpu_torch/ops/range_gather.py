"""Run-length range gather: contiguous cell ranges -> padded halo rows.

A halo's candidate particles are a union of contiguous row ranges of the
cell-sorted store.  The gather copies whole S-row blocks of each range
(kernel K1, ``csrc/range_gather.cu``) instead of one indexed load per
row.  The layout is the JAX package's (``soap_tpu/ops/dma_gather.py``),
so the gathered buffer equals its ``range_gather_rows(use_dma=False)``
bit for bit:
 - each range starts aligned DOWN to ``a = max(1, 128 // F)`` rows; up to
   ``a - 1`` leading rows are marked invalid;
 - each aligned range occupies ``ceil(count' / S) * S`` destination rows,
   its tail marked invalid;
 - destination capacity must cover ``sum(count) + n_ranges * (S + a)``.
Unused blocks copy source block 0, so every destination row is written.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from soap_tpu_torch.ops import kernel_lib


def pad_columns_for_dma(F: int) -> int:
    """Columns padded so whole rows tile 128-lane lines: the next
    divisor of 128 (F <= 128) or multiple of 128 (F > 128)."""
    if F <= 0:
        return 1
    if F <= 128:
        for p in (1, 2, 4, 8, 16, 32, 64, 128):
            if p >= F:
                return p
    return -(-F // 128) * 128


def row_alignment(F: int) -> int:
    """Source row-start alignment for F padded columns."""
    return max(1, 128 // F)


def build_block_table(
    starts: torch.Tensor,  # (B, C) source row starts
    counts: torch.Tensor,  # (B, C) range lengths (0 = skip)
    S: int,  # sub-block rows (multiple of the row alignment)
    F: int,  # padded column count
    r_max: int,  # table length (>= capacity // S)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(table, head, rows_valid), each (B, r_max) i32.

    ``table[b, j]`` is the source row that block j copies into the
    destination slot ``j * S``; its valid destination rows are
    ``[j*S + head, j*S + head + rows_valid)``.
    """
    a = row_alignment(F)
    starts = starts.to(torch.int64)
    counts = counts.to(torch.int64)
    C = counts.shape[1]
    nz = counts > 0
    head = torch.where(nz, starts % a, 0)
    start_al = starts - head
    count_al = torch.where(nz, counts + head, 0)
    nb = (count_al + (S - 1)) // S  # sub-blocks per range
    cum_nb = torch.cumsum(nb, 1)
    total_blocks = cum_nb[:, -1:]

    j = torch.arange(r_max, dtype=torch.int64, device=starts.device)
    j = j[None, :].expand(starts.shape[0], -1).contiguous()
    # index of the range holding block j = #ranges ending at or before j
    rng = torch.searchsorted(cum_nb, j, right=True)
    rng_safe = torch.clamp(rng, max=C - 1)
    prev = torch.clamp(rng_safe - 1, min=0)
    base_blocks = torch.where(rng_safe > 0, cum_nb.gather(1, prev), 0)
    k_in = j - base_blocks  # sub-block index within its range
    src = start_al.gather(1, rng_safe) + k_in * S
    block_valid = j < total_blocks
    first_in_range = block_valid & (k_in == 0)
    head_j = torch.where(first_in_range, head.gather(1, rng_safe), 0)
    rows_left = count_al.gather(1, rng_safe) - k_in * S
    rows_valid = torch.clamp(rows_left, 0, S) * block_valid - head_j
    src = torch.where(block_valid, src, 0)
    return (
        src.to(torch.int32),
        head_j.to(torch.int32),
        rows_valid.to(torch.int32),
    )


def expand_table_rows(
    table: torch.Tensor,  # (B, R)
    head: torch.Tensor,  # (B, R)
    rows_valid: torch.Tensor,  # (B, R)
    S: int,
    capacity: int,  # R * S
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per destination row: (source row, valid flag), each (B, capacity)."""
    off = torch.arange(S, dtype=torch.int32, device=table.device)
    src_row = table[:, :, None] + off
    rel = off - head[:, :, None]
    valid = (rel >= 0) & (rel < rows_valid[:, :, None])
    B = table.shape[0]
    return src_row.reshape(B, capacity), valid.reshape(B, capacity)


def merge_adjacent_ranges(
    starts: torch.Tensor,  # (B, C)
    counts: torch.Tensor,  # (B, C) (0 = skip)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coalesce ranges that are contiguous in the source into one.

    The cube's z-runs of cells are usually one contiguous row range of
    the cell-sorted store; merging them cuts per-range padding.  Output
    is (B, C) padded with zero counts, in concatenation order.
    """
    B, C = counts.shape
    dev = counts.device
    nz = counts > 0
    ends = starts + counts
    idx = torch.arange(C, dtype=torch.int64, device=dev)
    # index of the last non-empty range at or before i, -1 if none
    last = torch.cummax(torch.where(nz, idx, -1).expand(B, C), dim=1).values
    prev_last = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int64, device=dev), last[:, :-1]], 1
    )
    prev_ok = prev_last >= 0
    prev_val = ends.gather(1, torch.clamp(prev_last, min=0))
    new_seg = nz & (~prev_ok | (starts != prev_val))
    seg = torch.cumsum(new_seg.to(torch.int64), 1) - 1
    seg = torch.where(nz, torch.clamp(seg, min=0), C - 1)

    big = torch.iinfo(starts.dtype).max
    m_start = torch.full((B, C), big, dtype=starts.dtype, device=dev)
    m_start = m_start.scatter_reduce(
        1, seg, torch.where(nz, starts, big), reduce="amin", include_self=True
    )
    m_count = torch.zeros_like(counts).scatter_add(
        1, seg, torch.where(nz, counts, 0)
    )
    m_start = torch.where(m_count > 0, m_start, 0)
    return m_start, m_count


def range_gather_blocks_plain(
    packed: torch.Tensor,  # (N, F) f32
    table: torch.Tensor,  # (B, R) i32 source row of each S-row block
    S: int,
    capacity: int,  # R * S
) -> torch.Tensor:
    """Plain PyTorch version of K1: an index gather on the same layout
    (source rows clipped to the store, as the kernel clips them)."""
    N = packed.shape[0]
    off = torch.arange(S, dtype=torch.int64, device=packed.device)
    src = torch.clamp(table.to(torch.int64)[:, :, None] + off, 0, N - 1)
    return packed[src.reshape(table.shape[0], capacity)]


#: launches of the K1 CUDA kernel, from every thread (incremented only
#: where it launches, under ``kernel_lib.COUNT_LOCK``)
launches = 0
_here = kernel_lib.ThreadCount()


def launches_here() -> int:
    """The K1 launches the calling thread made."""
    return _here.n


def _count_launch() -> None:
    """One K1 launch, in the total and in the calling thread's count."""
    global launches
    with kernel_lib.COUNT_LOCK:
        launches += 1
    _here.n += 1


def range_gather_blocks(
    packed: torch.Tensor, table: torch.Tensor, S: int, capacity: int
) -> torch.Tensor:
    """(B, capacity, F) rows: block j of halo b holds source rows
    ``table[b, j] + [0, S)``.  CUDA tensors launch K1; CPU tensors take
    the plain version; anything else raises."""
    if packed.device.type == "cpu" and table.device.type == "cpu":
        return range_gather_blocks_plain(packed, table, S, capacity)
    if packed.device.type != "cuda" or table.device != packed.device:
        raise ValueError(
            f"range_gather_blocks: tensors on {packed.device} and {table.device}"
        )
    if packed.dtype != torch.float32 or table.dtype != torch.int32:
        raise TypeError(
            f"range_gather_blocks wants f32 rows and i32 table, got "
            f"{packed.dtype}, {table.dtype}"
        )
    if packed.dim() != 2 or table.dim() != 2 or not (
        packed.is_contiguous() and table.is_contiguous()
    ):
        raise ValueError("range_gather_blocks wants contiguous (N, F) and (B, R)")
    N, F = packed.shape
    B, R = table.shape
    # R is bounded by the grid's y extent (65535 CTAs of 4 blocks each)
    if F % 4 or R * S != capacity or R > 4 * 65535:
        raise ValueError(
            f"range_gather_blocks: F={F} must be a multiple of 4, "
            f"R*S={R * S} must equal capacity={capacity}, "
            f"R={R} <= 262140 blocks"
        )
    out = torch.empty((B, capacity, F), dtype=torch.float32, device=packed.device)
    if B == 0 or R == 0:
        return out
    lib = kernel_lib.load("range_gather")
    fn = lib.range_gather_f32
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    # the library sets the device it is given, the tensors' own, which
    # need not be this thread's current one; the guard gives PyTorch's
    # current device back afterwards
    with torch.cuda.device(packed.device):
        rc = fn(
            packed.device.index, packed.data_ptr(), N, F, table.data_ptr(), B, R, S,
            out.data_ptr(), torch.cuda.current_stream(packed.device).cuda_stream,
        )
    kernel_lib.check(rc, "range_gather_f32")
    _count_launch()
    return out


def range_gather_rows(
    packed: torch.Tensor,  # (N, F) f32
    starts: torch.Tensor,  # (B, C)
    counts: torch.Tensor,  # (B, C)
    S: int,  # sub-block rows (multiple of row_alignment(F))
    capacity: int,  # destination rows (multiple of S)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather each halo's ranges into (B, capacity, F) padded rows.

    Returns (rows, valid, src_rows, total): ``valid`` marks real
    candidate rows, ``src_rows`` the source row each slot holds, and
    ``total`` the padded row demand per halo (> capacity = overflow).
    """
    N, F = packed.shape
    a = row_alignment(F)
    if S % a or capacity % S:
        raise ValueError(f"S={S} must be a multiple of {a}, capacity of S")
    r_max = capacity // S
    table, head, rows_valid = build_block_table(starts, counts, S, F, r_max)
    c64 = counts.to(torch.int64)
    padded = torch.where(c64 > 0, c64 + starts.to(torch.int64) % a, 0)
    total = (((padded + S - 1) // S) * S).sum(1)
    rows = range_gather_blocks(packed, table, S, capacity)
    src_rows, valid = expand_table_rows(table, head, rows_valid, S, capacity)
    src_rows = torch.clamp(src_rows, 0, N - 1)
    return rows, valid, src_rows, total
