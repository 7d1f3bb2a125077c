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


# (name, cloud, seed, rows_radius_sorted): the sorted clouds run with the
# flag on (the JAX kernel's extent stop) and off
CASES = [("triaxial", _triaxial, s, False) for s in (0, 1, 2)] + [
    ("sorted", _sorted_cloud, s, rs) for s in (3, 4) for rs in (True, False)
] + [("edge", _edge, 0, False)]
CASE_IDS = [
    f"{n}{s}" + ("-unsorted" if n == "sorted" and not rs else "") for n, _, s, rs in CASES
]


def _jax_one(c, pos, w, mask, R, search, rows_radius_sorted):
    res = jI.inertia_tensor_multi(
        jnp.asarray(w), jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(R),
        np.asarray(c["red"]), np.asarray(c["it"]),
        search_radius=None if search is None else jnp.float32(search),
        check_search=None if search is None else np.asarray(c["check"]),
        rows_radius_sorted=rows_radius_sorted,
    )
    return [np.asarray(x) for x in res]


@pytest.mark.parametrize("mode", ["0", "interpret"])
@pytest.mark.parametrize("name,make,seed,rows_radius_sorted", CASES, ids=CASE_IDS)
def test_batched_inertia_matches_jax(monkeypatch, mode, name, make, seed, rows_radius_sorted):
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
        rows_radius_sorted=rows_radius_sorted,
    )
    assert tloop.launches == 0  # CPU tensors: the plain version
    for b in range(3):
        t_j, found_j, nb_j = _jax_one(
            c, pos[b], w[b], masks[b], R[b], None if search is None else search_b[b],
            rows_radius_sorted,
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


@pytest.mark.parametrize("K", [256, 32768, 1 << 20, 1 << 22])
@pytest.mark.parametrize("B", [1, 8, 256, 4096])
def test_cluster_size_rule(B, K):
    """The largest power of two G with B * G <= the SM count (one wave of
    one CTA per SM), capped at 16 and so that every CTA keeps at least
    4096 of the K rows."""
    for n_sm in (132, 114):
        one_wave = max(g for g in (1, 2, 4, 8, 16) if g == 1 or B * g <= n_sm)
        by_rows = max(g for g in (1, 2, 4, 8, 16) if g == 1 or K // g >= 4096)
        want = min(one_wave, by_rows)
        assert tloop.cluster_size(B, K, n_sm) == want
    if B == 1 and K == 1 << 20:
        assert tloop.cluster_size(B, K, 132) == 16
    if B == 256:
        assert tloop.cluster_size(B, K, 132) == 1
    assert tloop.cluster_size(64, 131072, 132) == 2


@pytest.mark.parametrize("K", [700, 1920, 300000])
def test_radius_table_matches_numpy(K):
    rng = np.random.default_rng(K)
    B = 3
    pos = (rng.normal(size=(B, K, 3)) * [1.5, 1.0, 0.7]).astype(np.float32)
    r = np.linalg.norm(pos.astype(np.float64), axis=2)
    srt = np.take_along_axis(pos, np.argsort(r, 1)[..., None], 1)
    srt[0, K - K // 5:] = 0.0  # empty slots after the sorted rows
    T = tloop.table_rows(K)
    assert T >= 128 and T & (T - 1) == 0 and -(-K // T) <= 1024
    assert T == 128 or -(-K // (T // 2)) > 1024
    for rows, flag in ((srt, True), (pos, False), (srt, False)):
        table, t = tloop.radius_table(torch.from_numpy(rows).permute(0, 2, 1).contiguous(), flag)
        assert t == T and table.dtype == torch.float32 and table.shape == (B, -(-K // T))
        if not flag:
            assert torch.isneginf(table).all()
            continue
        first = rows[:, ::T]
        x, y, z = first[..., 0], first[..., 1], first[..., 2]
        want = np.maximum.accumulate(np.sqrt(x * x + y * y + z * z), axis=1)
        # torch's vectorised CPU sqrt is not always correctly rounded: 1 ulp
        np.testing.assert_allclose(table.numpy(), want, rtol=2.0**-23, atol=0.0)


@pytest.mark.parametrize("rows_radius_sorted", [False, True])
def test_rows_radius_sorted_reaches_only_the_loop(monkeypatch, rows_radius_sorted):
    """``inertia_tensor_multi`` hands its flag to the inertia loop as a
    keyword; the packed arguments are those the plain version takes."""
    seen = []

    def loop(*args, **kw):
        seen.append(kw)
        return tloop.inertia_loop_plain(*args)

    monkeypatch.setattr(tI, "inertia_loop", loop)
    c = _sorted_cloud(3)
    res = tI.inertia_tensor_multi(
        torch.from_numpy(c["w"][None]), torch.from_numpy(c["pos"][None]),
        torch.from_numpy(c["masks"][None]), torch.from_numpy(c["R"][None]),
        c["red"], c["it"], rows_radius_sorted=rows_radius_sorted,
    )
    assert seen == [{"rows_radius_sorted": rows_radius_sorted}]
    assert res.tensor.shape == (1, 3, 6) and bool(res.found.all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_pass_matches_jax(seed):
    """Non-iterative configs: the loop-free sphere moment tensor, in
    plain PyTorch on any device (no kernel launch)."""
    c = _triaxial(seed)
    it = [False] * 4
    pos, w, masks, R = (np.stack([c[k], c[k]]) for k in ("pos", "w", "masks", "R"))
    pos[1] *= -1.5
    R[1] *= 1.5
    search = np.array([0.5 * c["R"][0], 10.0 * c["R"][0]], np.float32)
    check = [True, False, True, True]
    ours = tI.inertia_tensor_multi(
        *(torch.from_numpy(x.copy()) for x in (w, pos, masks, R)), c["red"], it,
        search_radius=torch.from_numpy(search), check_search=check, single_pass=True,
    )
    assert tloop.launches == 0
    for b in range(2):
        res = jI.inertia_tensor_multi(
            jnp.asarray(w[b]), jnp.asarray(pos[b]), jnp.asarray(masks[b]),
            jnp.asarray(R[b]), np.asarray(c["red"]), np.asarray(it),
            search_radius=jnp.float32(search[b]), check_search=np.asarray(check),
            single_pass=True,
        )
        np.testing.assert_array_equal(ours.found[b].numpy(), np.asarray(res.found))
        np.testing.assert_array_equal(ours.needs_bigger[b].numpy(), np.asarray(res.needs_bigger))
        t_j = np.asarray(res.tensor)
        np.testing.assert_allclose(
            ours.tensor[b].numpy(), t_j, rtol=2e-5,
            atol=1e-7 * float(np.abs(t_j).max() + 1e-30),
        )
    with pytest.raises(ValueError, match="non-iterative"):
        tI.inertia_tensor_multi(
            *(torch.from_numpy(x.copy()) for x in (w, pos, masks, R)), c["red"],
            [True] * 4, single_pass=True,
        )


@pytest.mark.parametrize("seed", [3, 4])
def test_luminosity_bands_match_jax_per_config_weights(seed):
    """The luminosity-weighted route: each band's weights through one loop
    call with the bands on the halo axis, against the JAX function given
    (bands x configs, K) per-config weights (its XLA loop: per-config
    weights never take the Pallas kernel); rtol 2e-5, atol 1e-7 max."""
    c = _sorted_cloud(seed)
    rng = np.random.default_rng(seed)
    NB, K = 9, len(c["w"])
    lum = (10.0 ** rng.uniform(6.0, 9.0, (2, K, NB))).astype(np.float32)
    pos = np.stack([c["pos"], 1.5 * c["pos"]])
    masks = np.stack([c["masks"]] * 2)
    R = np.stack([c["R"], 1.5 * c["R"]])
    search = np.array([10.0, 0.5 * R[1].max()], np.float32)  # halo 1 needs more
    check = [True, False, True]
    ours = tI.inertia_tensor_bands(
        torch.from_numpy(lum.transpose(0, 2, 1).copy()), torch.from_numpy(pos),
        torch.from_numpy(masks.copy()), torch.from_numpy(R), c["red"], c["it"],
        search_radius=torch.from_numpy(search), check_search=check,
        rows_radius_sorted=True,
    )
    C = masks.shape[1]
    for b in range(2):
        res = jI.inertia_tensor_multi(
            jnp.asarray(np.repeat(lum[b].T, C, axis=0)),  # band-major rows
            jnp.asarray(pos[b]), jnp.asarray(np.tile(masks[b], (NB, 1))),
            jnp.asarray(np.tile(R[b], NB)), np.tile(c["red"], NB), np.tile(c["it"], NB),
            search_radius=jnp.float32(search[b]), check_search=np.tile(check, NB),
            rows_radius_sorted=True,
        )
        t_j, found_j, nb_j = (np.asarray(x).reshape((NB, C) + np.shape(x)[1:]) for x in res)
        np.testing.assert_array_equal(ours.found[b].numpy(), found_j)
        np.testing.assert_array_equal(ours.needs_bigger[b].numpy(), nb_j)
        np.testing.assert_allclose(
            ours.tensor[b].numpy(), t_j, rtol=2e-5, atol=1e-7 * np.abs(t_j).max()
        )
    assert ours.needs_bigger[1].any() and not ours.needs_bigger[0].any()


def _jax_projected(w, pos2d, masks, R, red, it, single_pass):
    res = jI.projected_inertia_tensor_multi(
        jnp.asarray(w), jnp.asarray(pos2d), jnp.asarray(masks), jnp.asarray(R),
        np.asarray(red), np.asarray(it), single_pass=single_pass,
    )
    return [np.asarray(x) for x in res]


@pytest.mark.parametrize("per_config", [False, True], ids=["shared", "per-config"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projected_inertia_matches_jax(seed, per_config):
    """2D tensors of 3 halos against the JAX loop per halo, shared and
    per-config weights, iterative and single-pass; rtol 2e-5, atol 1e-7
    of the largest component."""
    c = _triaxial(seed)
    pos2d = np.stack([c["pos"][:, :2], 2.0 * c["pos"][:, 1:], -c["pos"][:, ::2]])
    C, K = c["masks"].shape
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0.0, 0.3, (3, C, K) if per_config else (3, K)).astype(np.float32)
    masks = np.stack([c["masks"], c["masks"], c["masks"][::-1]])
    R = np.stack([c["R"], 2.0 * c["R"], c["R"]])
    for single_pass in (False, True):
        it = [False] * C if single_pass else c["it"]
        ours = tI.projected_inertia_tensor_multi(
            torch.from_numpy(w), torch.from_numpy(pos2d.copy()),
            torch.from_numpy(masks.copy()), torch.from_numpy(R), c["red"], it,
            single_pass=single_pass,
        )
        for b in range(3):
            t_j, found_j, _ = _jax_projected(w[b], pos2d[b], masks[b], R[b], c["red"], it,
                                             single_pass)
            np.testing.assert_array_equal(ours.found[b].numpy(), found_j)
            np.testing.assert_allclose(
                ours.tensor[b].numpy(), t_j, rtol=2e-5, atol=1e-7 * np.abs(t_j).max()
            )


@pytest.mark.parametrize("name,make,seed,rows_radius_sorted", CASES, ids=CASE_IDS)
def test_sphere_moments_equal_the_loops_first_iteration(name, make, seed, rows_radius_sorted):
    """The single-pass configs' function against the plain loop limited to
    one iteration, on the same packed arguments: rtol 1e-6."""
    c = make(seed)
    pos = np.stack([c["pos"], 2.0 * c["pos"]])
    masks = np.stack([c["masks"], c["masks"][::-1]])
    R = np.stack([c["R"], 2.0 * c["R"]])
    args, _ = tI.pack_inertia_inputs(
        torch.from_numpy(np.stack([c["w"]] * 2)), torch.from_numpy(pos),
        torch.from_numpy(masks.copy()), torch.from_numpy(R), c["red"],
        [False] * len(c["red"]),
    )
    np.testing.assert_allclose(
        tI.sphere_moments(*args).numpy(), tloop.inertia_loop_plain(*args).numpy(),
        rtol=1e-6, atol=0.0,
    )


@pytest.mark.parametrize("seed", [5, 6])
def test_sphere_moments_of_a_folded_family_match_jax(seed):
    """(B, C, k) sums with many configs: an SO family's 8 radii x 4
    configs folded into C = 32 for 3 halos of 1001 rows (not a multiple
    of 4), against the plain loop's first iteration (rtol 1e-6) and the
    JAX single pass per halo (rtol 2e-5, atol 1e-7 of the largest
    component)."""
    c = _sorted_cloud(seed)
    rng = np.random.default_rng(seed)
    K, C = 1001, 32
    pos = np.stack([c["pos"][:K], 1.7 * c["pos"][:K], -c["pos"][:K]])
    w = rng.lognormal(0.0, 0.3, (3, K)).astype(np.float32)
    masks = rng.random((3, C, K)) < np.linspace(0.2, 0.95, C)[None, :, None]
    rmed = np.median(np.linalg.norm(pos, axis=2), axis=1)
    R = (rmed[:, None] * np.repeat(np.linspace(0.4, 1.6, C // 4), 4)[None, :]).astype(
        np.float32)
    red = [i % 2 == 1 for i in range(C)]
    it = [False] * C
    args, _ = tI.pack_inertia_inputs(
        torch.from_numpy(w), torch.from_numpy(pos), torch.from_numpy(masks), torch.from_numpy(R),
        red, it,
    )
    np.testing.assert_allclose(
        tI.sphere_moments(*args).numpy(), tloop.inertia_loop_plain(*args).numpy(),
        rtol=1e-6, atol=0.0,
    )
    ours = tI.inertia_tensor_multi(
        torch.from_numpy(w), torch.from_numpy(pos), torch.from_numpy(masks),
        torch.from_numpy(R), red, it, single_pass=True,
    )
    for b in range(3):
        res = jI.inertia_tensor_multi(
            jnp.asarray(w[b]), jnp.asarray(pos[b]), jnp.asarray(masks[b]), jnp.asarray(R[b]),
            np.asarray(red), np.asarray(it), single_pass=True,
        )
        np.testing.assert_array_equal(ours.found[b].numpy(), np.asarray(res.found))
        t_j = np.asarray(res.tensor)
        np.testing.assert_allclose(
            ours.tensor[b].numpy(), t_j, rtol=2e-5,
            atol=1e-7 * float(np.abs(t_j).max() + 1e-30),
        )
