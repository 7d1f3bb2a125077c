"""The port's Peano–Hilbert chunking against the JAX package's.

``soap_tpu_torch/parallel/domain.py`` keeps only the numpy Skilling
transform; the JAX package takes its native library when it builds and
the same numpy transform otherwise.  Keys and chunk indices must be
bit-equal to JAX's on either of its paths.
"""

import numpy as np
import pytest

from soap_tpu import native
from soap_tpu.parallel import domain as jax_domain
from soap_tpu_torch.parallel import domain

SEEDS = (0, 5, 19)


@pytest.fixture(params=["native", "numpy"])
def jax_path(request, monkeypatch):
    """Run the JAX functions on their native path (where the library
    builds) or on their numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "hilbert_keys_3d", lambda ijk, bits: None)
    return request.param


@pytest.mark.parametrize("bits", [4, 10])
@pytest.mark.parametrize("seed", SEEDS)
def test_hilbert_keys_bit_equal(jax_path, seed, bits):
    rng = np.random.default_rng(seed)
    ijk = rng.integers(0, 1 << bits, (3000, 3))
    ours = domain.hilbert_key_3d(ijk, bits)
    theirs = jax_domain.hilbert_key_3d(ijk, bits)
    assert ours.dtype == theirs.dtype == np.uint64
    np.testing.assert_array_equal(ours, theirs)
    # a bijection of the grid's cells when every cell is given
    if bits == 4:
        g = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3)
        keys = domain.hilbert_key_3d(g, bits)
        assert np.array_equal(np.sort(keys), np.arange(16**3, dtype=np.uint64))
        np.testing.assert_array_equal(keys, jax_domain.hilbert_key_3d(g, bits))


@pytest.mark.parametrize("separate", [False, True], ids=["spatial", "separate"])
@pytest.mark.parametrize("nr_chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("bits", [4, 10])
@pytest.mark.parametrize("seed", SEEDS)
def test_peano_decomposition_bit_equal(jax_path, seed, bits, nr_chunks, separate):
    rng = np.random.default_rng([seed, nr_chunks])
    box = 50.0
    centres = rng.random((257, 3)) * box * 1.2 - 0.1 * box  # some outside the box
    nbound = rng.integers(10, 10**5, 257)
    kw = dict(bits=bits)
    if separate:
        kw.update(nr_bound_part=nbound, separate_chunks=[90_000, 50_000])
    ours = domain.peano_decomposition(centres, box, nr_chunks, **kw)
    theirs = jax_domain.peano_decomposition(centres, box, nr_chunks, **kw)
    assert ours.dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)
    n_sep = int((nbound > 50_000).sum()) if separate else 0
    spatial = ours < nr_chunks
    assert spatial.sum() == 257 - n_sep
    # the spatial chunks are equal in count to within one halo
    if nr_chunks > 1 or separate:
        counts = np.bincount(ours[spatial], minlength=nr_chunks)
        assert counts.max() - counts.min() <= 1
    if separate:
        assert sorted(ours[~spatial]) == list(range(nr_chunks, nr_chunks + n_sep))


def test_empty_and_separate_needs_counts():
    assert domain.peano_decomposition(np.zeros((0, 3)), 1.0, 4).shape == (0,)
    with pytest.raises(ValueError):
        domain.peano_decomposition(np.zeros((3, 3)), 1.0, 2, separate_chunks=[5])
