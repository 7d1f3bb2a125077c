"""The port's batched inertia tensors against the JAX package.

The port's ``inertia_tensor_multi`` on CPU tensors (the plain version of
the inertia-loop kernel) runs a batch of halos at once; the JAX function
runs each halo through its XLA while loop (``SOAP_TPU_PALLAS_INERTIA=0``)
or through its Pallas kernel in interpret mode (``=interpret``).  The
clouds are those of ``tests/test_pallas_inertia.py``.  ``found`` and
``needs_bigger`` must be equal, tensors within rtol 2e-5 (atol 1e-7 of
the largest component, for components that cancel to ~0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap_tpu.ops import inertia as jI
from soap_tpu_torch.ops import inertia as tI
from soap_tpu_torch.ops import inertia_loop as tloop


def _triaxial(seed):
    rng = np.random.default_rng(seed)
    K = 700  # not a multiple of 128
    ax = np.sort(np.exp(rng.normal(0, 1.0, 3)))[::-1]
    if seed == 1:
        ax[2] = ax[0] * 3e-2  # strongly flattened
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pos = ((rng.normal(size=(K, 3)) * ax) @ Q.T).astype(np.float32)
    pos[0] = 0.0  # centre-of-potential particle at r == 0
    w = rng.lognormal(0.0, 0.3, K).astype(np.float32)
    masks = rng.random((4, K)) < [[0.9], [0.7], [0.5], [0.02]]
    masks[3, :10] = True  # config 3: tiny selection (< MIN_PARTICLES)
    rmed = float(np.median(np.linalg.norm(pos, axis=1)))
    R = np.array([2.0 * rmed, 1.2 * rmed, 0.6 * rmed, 1.0 * rmed], np.float32)
    return dict(w=w, pos=pos, masks=masks, R=R,
                red=[False, True, False, True], it=[True, True, False, True])


def _sorted_cloud(seed):
    rng = np.random.default_rng(seed)
    K = 1920
    pos = (rng.normal(size=(K, 3)) * [1.5, 1.0, 0.7]).astype(np.float32)
    pos = pos[np.argsort(np.linalg.norm(pos, axis=1))]
    pos[0] = 0.0
    w = rng.lognormal(0.0, 0.3, K).astype(np.float32)
    masks = np.zeros((3, K), bool)
    masks[0] = True
    masks[1, : K // 3] = True
    masks[2] = rng.random(K) < 0.5
    rmed = float(np.median(np.linalg.norm(pos, axis=1)))
    R = np.array([1.5 * rmed, 0.8 * rmed, 1.1 * rmed], np.float32)
    return dict(w=w, pos=pos, masks=masks, R=R,
                red=[False, True, False], it=[True, True, True], sorted=True)


def _edge(_seed):
    rng = np.random.default_rng(7)
    K = 256
    masks = np.ones((3, K), bool)
    masks[1] = False  # empty selection
    return dict(w=np.ones(K, np.float32),
                pos=rng.normal(size=(K, 3)).astype(np.float32), masks=masks,
                R=np.array([1.5, 1.5, 0.0], np.float32),  # zero radius
                red=[True, False, False], it=[True, True, True],
                search=1.0, check=[True, True, False])


CASES = [("triaxial", _triaxial, s) for s in (0, 1, 2)] + [
    ("sorted", _sorted_cloud, s) for s in (3, 4)
] + [("edge", _edge, 0)]


def _jax_one(c, pos, w, mask, R, search):
    res = jI.inertia_tensor_multi(
        jnp.asarray(w), jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(R),
        np.asarray(c["red"]), np.asarray(c["it"]),
        search_radius=None if search is None else jnp.float32(search),
        check_search=None if search is None else np.asarray(c["check"]),
        rows_radius_sorted=c.get("sorted", False),
    )
    return [np.asarray(x) for x in res]


@pytest.mark.parametrize("mode", ["0", "interpret"])
@pytest.mark.parametrize("name,make,seed", CASES, ids=[f"{n}{s}" for n, _, s in CASES])
def test_batched_inertia_matches_jax(monkeypatch, mode, name, make, seed):
    monkeypatch.setenv("SOAP_TPU_PALLAS_INERTIA", mode)
    c = make(seed)
    # a batch of 3 halos: the cloud, scaled by 2, and mirrored with its
    # masks shuffled across configs
    pos = np.stack([c["pos"], 2.0 * c["pos"], -c["pos"]])
    w = np.stack([c["w"]] * 3)
    masks = np.stack([c["masks"], c["masks"], c["masks"][::-1]])
    R = np.stack([c["R"], 2.0 * c["R"], c["R"]])
    search = c.get("search")
    search_b = None if search is None else np.array([search, 2.0 * search, search], np.float32)

    ours = tI.inertia_tensor_multi(
        torch.from_numpy(w), torch.from_numpy(pos), torch.from_numpy(masks.copy()),
        torch.from_numpy(R), c["red"], c["it"],
        search_radius=None if search is None else torch.from_numpy(search_b),
        check_search=c.get("check"),
    )
    assert tloop.launches == 0  # CPU tensors: the plain version
    for b in range(3):
        t_j, found_j, nb_j = _jax_one(
            c, pos[b], w[b], masks[b], R[b], None if search is None else search_b[b]
        )
        np.testing.assert_array_equal(ours.found[b].numpy(), found_j)
        np.testing.assert_array_equal(ours.needs_bigger[b].numpy(), nb_j)
        np.testing.assert_allclose(
            ours.tensor[b].numpy(), t_j, rtol=2e-5,
            atol=1e-7 * float(np.abs(t_j).max() + 1e-30),
        )


def test_sym_eigh_3x3_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(20, 3, 3))
    A = A @ np.swapaxes(A, 1, 2)
    A[0] = np.eye(3) * 2.0  # degenerate
    A[1] = np.diag([1.0, 1.0, 3.0])  # two equal eigenvalues
    w_t, V_t = tI.sym_eigh_3x3(torch.from_numpy(A))
    for i in range(len(A)):
        w_j, V_j = jI.sym_eigh_3x3(jnp.asarray(A[i]))
        np.testing.assert_allclose(w_t[i].numpy(), np.asarray(w_j), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(V_t[i].numpy(), np.asarray(V_j), rtol=1e-10, atol=1e-10)


def test_inertia_loop_device_rules():
    """CPU tensors take the plain version; tensors on another device
    raise instead of falling back."""
    args, _ = tI.pack_inertia_inputs(
        torch.ones(1, 64), torch.randn(1, 64, 3, generator=torch.Generator().manual_seed(0)),
        torch.ones(1, 1, 64, dtype=torch.bool), torch.full((1, 1), 2.0), [False], [True],
    )
    assert tloop.inertia_loop(*args).shape == (1, 1, 6)
    with pytest.raises(ValueError):
        tloop.inertia_loop(args[0].to("meta"), *args[1:])
