"""The port's range-gather layout against ``soap_tpu.ops.dma_gather``.

Block tables, row expansion, range merging and the plain gather
(``range_gather_rows`` on CPU tensors) must be bit-equal to the JAX
package's ``use_dma=False`` path, including empty ranges, empty halos
and ranges of a search cube that wraps the periodic box.  The CUDA
kernel itself is checked against the same plain version by
``chip_smoke.py`` on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap_tpu.ops import dma_gather as jdg
from soap_tpu.ops import grid as jgrid
from soap_tpu_torch.ops import grid as tgrid
from soap_tpu_torch.ops import range_gather as trg


def _eq(ours, theirs):
    a = np.asarray(theirs)
    b = ours.numpy()
    assert b.shape == a.shape
    np.testing.assert_array_equal(b, a)


def _ranges(rng, N, B, C):
    starts = rng.integers(0, N - 900, size=(B, C)).astype(np.int32)
    counts = rng.integers(0, 800, size=(B, C)).astype(np.int32)
    counts[0, 2] = 0  # empty range
    counts[1] = 0  # fully empty halo
    return starts, counts


def test_padding_rules_match():
    for F in (3, 11, 16, 40, 128, 200):
        assert trg.pad_columns_for_dma(F) == jdg.pad_columns_for_dma(F)
        assert trg.row_alignment(F) == jdg.row_alignment(F)


@pytest.mark.parametrize("F,S", [(16, 64), (64, 128), (128, 64)])
def test_block_table_and_rows_match(F, S):
    rng = np.random.default_rng(7)
    N, B, C = 5000, 6, 5
    packed = rng.normal(size=(N, F)).astype(np.float32)
    starts, counts = _ranges(rng, N, B, C)
    cap = jdg.dest_capacity(int(counts.sum(1).max()), C, S, F)
    cap = -(-cap // S) * S
    R = cap // S

    tab_j = jax.vmap(lambda s, c: jdg.build_block_table(s, c, S, F, R))(starts, counts)
    tab_t = trg.build_block_table(torch.from_numpy(starts), torch.from_numpy(counts), S, F, R)
    for a, b in zip(tab_t, tab_j):
        _eq(a, b)
    src_j, val_j = jax.vmap(lambda t, h, r: jdg.expand_table_rows(t, h, r, S, cap))(*tab_j)
    src_t, val_t = trg.expand_table_rows(*tab_t, S, cap)
    _eq(src_t, src_j)
    _eq(val_t, val_j)

    rows_j, valid_j, srcr_j, total_j = jdg.range_gather_rows(
        jnp.asarray(packed), jnp.asarray(starts), jnp.asarray(counts), S, cap,
        use_dma=False,
    )
    rows_t, valid_t, srcr_t, total_t = trg.range_gather_rows(
        torch.from_numpy(packed), torch.from_numpy(starts), torch.from_numpy(counts),
        S, cap,
    )
    assert np.asarray(rows_j).tobytes() == rows_t.numpy().tobytes()
    for a, b in ((valid_t, valid_j), (srcr_t, srcr_j), (total_t, total_j)):
        _eq(a, b)


def test_overflow_signalling_matches():
    packed = np.zeros((2048, 16), np.float32)
    starts = np.asarray([[0, 512]], np.int32)
    counts = np.asarray([[500, 700]], np.int32)
    _, _, _, total_j = jdg.range_gather_rows(
        jnp.asarray(packed), jnp.asarray(starts), jnp.asarray(counts), 64, 512,
        use_dma=False,
    )
    _, _, _, total_t = trg.range_gather_rows(
        torch.from_numpy(packed), torch.from_numpy(starts), torch.from_numpy(counts),
        64, 512,
    )
    assert int(total_t[0]) == int(total_j[0]) > 512


def test_merge_adjacent_ranges_cases():
    # A(0,10) zero B(10,5) C(40,5) D(45,0) E(45,3) -> A+B, C+E
    starts = np.asarray([[0, 0, 10, 40, 45, 45], [5, 100, 0, 0, 0, 0],
                         [0, 0, 0, 0, 0, 0]], np.int32)
    counts = np.asarray([[10, 0, 5, 5, 0, 3], [3, 4, 0, 0, 0, 0],
                         [0, 0, 0, 0, 0, 0]], np.int32)
    ms_t, mc_t = trg.merge_adjacent_ranges(torch.from_numpy(starts), torch.from_numpy(counts))
    ms_j, mc_j = jax.vmap(jdg.merge_adjacent_ranges)(starts, counts)
    _eq(ms_t, ms_j)
    _eq(mc_t, mc_j)
    got = [(s, c) for s, c in zip(ms_t[0].tolist(), mc_t[0].tolist()) if c > 0]
    assert got == [(0, 15), (40, 8)]


@pytest.mark.parametrize("cube", [3, 5])
def test_periodic_cube_ranges_gather_match(cube):
    """Cell ranges of search cubes at the box corners (their z-runs wrap
    and split), merged, then gathered: same layout as the JAX package."""
    rng = np.random.default_rng(cube)
    dims, cell = (6, 6, 6), 1.0
    cnt = rng.integers(0, 12, 216).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    N, F, S = int(cnt.sum()) + 1024, 16, 64
    packed = rng.normal(size=(N, F)).astype(np.float32)
    centre = np.asarray([[0.2, 0.1, 5.9], [5.8, 3.0, 0.3], [3.0, 3.0, 3.0]], np.float32)
    radius = np.asarray([1.1, 0.9, 2.2], np.float32)
    spec = jgrid.GridSpec((0.0, 0.0, 0.0), (cell,) * 3, dims, True)

    def ranges(c, r):
        s, n = jgrid.halo_cell_ranges(spec, jnp.asarray(off), jnp.asarray(cnt), c, r, cube)
        return jdg.merge_adjacent_ranges(s, n)

    s_j, c_j = jax.jit(jax.vmap(ranges))(centre, radius)
    s_t, c_t = tgrid.halo_cell_ranges(
        tgrid.GridSpec((0.0, 0.0, 0.0), (cell,) * 3, dims, True),
        torch.from_numpy(off), torch.from_numpy(cnt), torch.from_numpy(centre),
        torch.from_numpy(radius), cube,
    )
    s_t, c_t = trg.merge_adjacent_ranges(s_t, c_t)
    _eq(s_t, s_j)
    _eq(c_t, c_j)
    cap = -(-jdg.dest_capacity(int(np.asarray(c_j).sum(1).max()), cube**3, S, F) // S) * S
    rows_j, valid_j, _, _ = jdg.range_gather_rows(
        jnp.asarray(packed), s_j, c_j, S, cap, use_dma=False
    )
    rows_t, valid_t, _, _ = trg.range_gather_rows(torch.from_numpy(packed), s_t, c_t, S, cap)
    assert np.asarray(rows_j).tobytes() == rows_t.numpy().tobytes()
    _eq(valid_t, valid_j)


def test_cuda_only_rules_on_cpu():
    """CPU tensors take the plain version; mixed devices raise."""
    packed = torch.zeros((300, 16))
    table = torch.zeros((2, 3), dtype=torch.int32)
    out = trg.range_gather_blocks(packed, table, 64, 192)
    assert out.shape == (2, 192, 16) and trg.launches == 0
    with pytest.raises(ValueError):
        trg.range_gather_blocks(packed.to("meta"), table, 64, 192)
