"""Iterative ellipsoidal inertia tensors, batched over halos.

Reference algorithm (``SOAP/property_calculation/inertia_tensors.py``,
ported from ``soap_tpu/ops/inertia.py``):
 - start from a sphere of the aperture radius;
 - compute I_ij = sum w x_i x_j / sum w over the selected particles
   inside the ellipsoid (each divided by |x|^2 when reduced),
   eigendecompose, reshape the ellipsoid to the eigenvalue axis ratios
   at fixed volume, re-select, and iterate until the axis ratio
   q = sqrt(l1/l2) changes by < 1e-4, at most 20 iterations;
 - a config needs >= 20 particles inside the initial sphere;
 - output order (xx, yy, zz, xy, xz, yz).

``inertia_tensor_multi`` packs a (B halos x C configs) request into the
layout of the inertia loop (``ops/inertia_loop.py``): positions as
(B, 3, K) planes, per-config masks as bits of i32 words, and the
per-config radius, reduced flag, iteration limit, occupied prefix and
initial done flag as (B, C) rows.  ``inertia_tensor_bands`` runs the
luminosity-weighted configs (a weight vector per band) through the same
loop with the bands on the halo axis.  ``projected_inertia_tensor_multi``
is the 2D analogue, a loop of plain PyTorch (the JAX package runs it as
an XLA loop, with no Pallas kernel).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from soap_tpu_torch.ops.inertia_loop import inertia_loop
from soap_tpu_torch.ops.reductions import Summand, particle_sum

TOL = 1.0e-4
MIN_PARTICLES = 20


def sym_eigh_3x3(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric (..., 3, 3) matrices.

    Trigonometric eigenvalues and cross-product eigenvectors in float64
    (f32 trigonometry limits eigenvalues to ~2e-4 relative accuracy, too
    coarse for the 1e-4 axis-ratio test).  Returns (w ascending (..., 3),
    V (..., 3, 3) with eigenvectors as columns) in the input dtype.
    """
    in_dtype = A.dtype
    A = A.to(torch.float64)
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    p_safe = torch.clamp(p, min=1e-30)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[..., None, None] * eye) / p_safe[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)  # largest
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)  # smallest
    w1 = 3.0 * q - w2 - w0
    degenerate = p2 <= 1e-30 * torch.clamp(q * q, min=1e-30)
    w = torch.stack([w0, w1, w2], -1)
    w = torch.where(degenerate[..., None], q[..., None].expand_as(w), w)

    def eigenvector(lam):
        # v is orthogonal to the rows of (A - lam I): take the largest of
        # the three row cross products (first one on ties)
        M = A - lam[..., None, None] * eye
        c = torch.stack(
            [
                torch.linalg.cross(M[..., 0, :], M[..., 1, :]),
                torch.linalg.cross(M[..., 0, :], M[..., 2, :]),
                torch.linalg.cross(M[..., 1, :], M[..., 2, :]),
            ],
            -2,
        )  # (..., 3, 3): candidate vectors as rows
        n = (c * c).sum(-1)
        best = torch.argmax(n, -1)
        v = torch.gather(c, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
        nrm = torch.sqrt(torch.clamp((v * v).sum(-1), min=1e-37))
        return v / nrm[..., None]

    v0 = eigenvector(w0)
    v2 = eigenvector(w2)
    # orthonormal right-handed frame, robust when w1 nears a neighbour
    v2 = v2 - v0 * (v0 * v2).sum(-1, keepdim=True)
    v2 = v2 / torch.sqrt(torch.clamp((v2 * v2).sum(-1, keepdim=True), min=1e-37))
    v1 = torch.linalg.cross(v2, v0)
    V = torch.stack([v0, v1, v2], -1)
    V = torch.where(degenerate[..., None, None], eye, V)
    return w.to(in_dtype), V.to(in_dtype)


class InertiaResult(NamedTuple):
    tensor: torch.Tensor  # (B, C, 6) flattened tensors
    found: torch.Tensor  # (B, C) bool: enough particles
    needs_bigger: torch.Tensor  # (B, C) bool: ellipsoid beyond the region


def pack_mask_words(masks: torch.Tensor) -> torch.Tensor:
    """(B, C, K) bool -> (B, W, K) i32 words, config c = bit c%32 of
    word c//32."""
    B, C, K = masks.shape
    W = -(-C // 32)
    words = torch.zeros((B, W, K), dtype=torch.int32, device=masks.device)
    for c in range(C):
        words[:, c // 32] |= masks[:, c].to(torch.int32) << (c % 32)
    return words


def pack_inertia_inputs(
    weights: torch.Tensor,  # (B, K) shared by every config
    pos: torch.Tensor,  # (B, K, 3) halo-relative positions
    masks: torch.Tensor,  # (B, C, K) per-config selection
    sphere_radius: torch.Tensor,  # (B, C)
    reduced: Sequence[bool],  # (C,) 1/r^2 weighting
    iterative: Sequence[bool],  # (C,) 20 iterations vs 1
    max_iterations: int = 20,
):
    """(inertia-loop arguments, enough (B, C)) for a request: the
    caller-side packing of ``soap_tpu/ops/inertia.py`` (zero-radius rows
    leave reduced configs, the MIN_PARTICLES gate, mask bit words, each
    config's occupied prefix)."""
    B, C, K = masks.shape
    dev = pos.device
    red = torch.as_tensor(np.asarray(reduced, bool), device=dev)
    it = torch.as_tensor(np.asarray(iterative, bool), device=dev)
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    r2 = x * x + y * y + z * z  # (B, K)
    zero_r = torch.abs(r2) <= 1e-8  # jnp.isclose(r2, 0.0)
    masks = masks & ~(red[None, :, None] & zero_r[:, None, :])
    R = sphere_radius.to(torch.float32).contiguous()
    init_inside = masks & (r2[:, None, :] <= (R * R)[:, :, None])
    n_init = init_inside.sum(-1)
    enough = (masks.sum(-1) >= MIN_PARTICLES) & (n_init >= MIN_PARTICLES)
    # occupied prefix: index after each config's last selected row
    row = torch.arange(1, K + 1, dtype=torch.int32, device=dev)
    occ = torch.where(masks, row, 0).amax(-1)

    def per_config(v):
        return v.to(torch.int32).expand(B, C).contiguous()

    args = (
        torch.stack([x, y, z], 1).contiguous(),  # (B, 3, K)
        weights.to(torch.float32).contiguous(),
        pack_mask_words(masks),
        R,
        per_config(red),
        per_config(torch.where(it, max_iterations, 1)),
        per_config(occ),
        per_config(~enough),
        max_iterations,
    )
    return args, enough


def sphere_moments(pos3, w, mw, R, reduced, limit, occ, done0, max_iterations):
    """The loop's first iteration alone, for configs that stop there: each
    (halo, config)'s moment tensor (B, C, 6) over its selected rows inside
    the sphere of radius R, with the inertia loop's arithmetic (f32
    products, f64 sums), on any device.  Takes the loop's packed
    arguments; the (unused) iteration limit stays for their sake."""
    B, _, K = pos3.shape
    C = R.shape[1]
    kmax = max(int(occ.max()), 1) if occ.numel() else 1
    pos3, w, mw = pos3[..., :kmax], w[:, :kmax], mw[..., :kmax]
    x, y, z = (pos3[:, None, i] for i in range(3))  # (B, 1, k)
    r2 = x * x + y * y + z * z
    w_inv = w[:, None] * (1.0 / torch.where(torch.abs(r2) <= 1e-8, 1.0, r2))
    c = torch.arange(C, device=pos3.device)
    mask = ((mw[:, c // 32] >> (c % 32)[None, :, None]) & 1).bool()  # (B, C, k)
    # the unit sphere's quadratic form scaled to R: the loop's first
    # ellipsoid test, x (ia x) + y (ia y) + (ia z) z
    ia = (1.0 / (R * R))[..., None]
    inside = mask & (x * (ia * x) + y * (ia * y) + ia * z * z <= 1.0)
    wsel = torch.where(inside, w[:, None], 0.0)
    wi = torch.where(inside, torch.where(reduced.bool()[..., None], w_inv, w[:, None]), 0.0)
    sums = [
        particle_sum(Summand(wi * a * b, out_dtype=torch.float64), -1)
        for a, b in ((x, x), (x, y), (x, z), (y, y), (y, z), (z, z))
    ]
    inv = 1.0 / torch.clamp(particle_sum(Summand(wsel, out_dtype=torch.float64), -1), min=1e-37)
    out = torch.stack([s * inv for s in sums], -1).to(torch.float32)
    return torch.where(done0.bool()[..., None], 0.0, out)


def inertia_tensor_multi(
    weights: torch.Tensor,  # (B, K) shared by every config
    pos: torch.Tensor,  # (B, K, 3) halo-relative positions
    masks: torch.Tensor,  # (B, C, K) per-config selection
    sphere_radius: torch.Tensor,  # (B, C)
    reduced: Sequence[bool],  # (C,) 1/r^2 weighting
    iterative: Sequence[bool],  # (C,) 20 iterations vs 1
    search_radius: Optional[torch.Tensor] = None,  # (B,) (None: no check)
    check_search: Optional[Sequence[bool]] = None,  # (C,)
    max_iterations: int = 20,
    single_pass: bool = False,  # every config non-iterative
    rows_radius_sorted: bool = False,  # rows ascending in |pos|
) -> InertiaResult:
    """Every (halo, config) 3D inertia tensor through one inertia loop.

    Per-config semantics are those of ``soap_tpu.ops.inertia.
    inertia_tensor_multi``.  The loop sweeps only up to each config's
    last selected row, so radius-sorted rows, whose selections are dense
    in a prefix, sweep least; with ``rows_radius_sorted`` the kernel
    also stops at the ellipsoid's extent, as the JAX kernel does.
    ``single_pass`` (all configs non-iterative) gives each config's
    sphere moment tensor: the loop's first iteration
    (``sphere_moments``), in plain PyTorch on any device, as the JAX
    package computes it without its kernel.
    """
    args, enough = pack_inertia_inputs(
        weights, pos, masks, sphere_radius, reduced, iterative, max_iterations
    )
    if single_pass:
        if any(iterative):
            raise ValueError("single_pass takes non-iterative configs only")
        out = sphere_moments(*args)
    else:
        out = inertia_loop(*args, rows_radius_sorted=rows_radius_sorted)
    # loop order [xx, xy, xz, yy, yz, zz] -> result order [xx, yy, zz, xy, xz, yz]
    flat = out[..., [0, 3, 5, 1, 2, 4]]
    flat = torch.where(enough[..., None], flat, 0.0)
    if search_radius is None or check_search is None:
        needs_bigger = torch.zeros_like(enough)
    else:
        chk = torch.as_tensor(np.asarray(check_search, bool), device=pos.device)
        needs_bigger = chk[None, :] & enough & (args[3] > search_radius[:, None])
    return InertiaResult(flat, enough, needs_bigger)


def inertia_tensor_bands(
    weights: torch.Tensor,  # (B, NB, K): one weight vector per band
    pos: torch.Tensor,  # (B, K, 3) shared by every band
    masks: torch.Tensor,  # (B, C, K) per-config selection, every band
    sphere_radius: torch.Tensor,  # (B, C)
    reduced: Sequence[bool],  # (C,)
    iterative: Sequence[bool],  # (C,)
    search_radius: Optional[torch.Tensor] = None,  # (B,)
    check_search: Optional[Sequence[bool]] = None,  # (C,)
    single_pass: bool = False,
    rows_radius_sorted: bool = False,
) -> InertiaResult:
    """Each config under each band's weights (the luminosity-weighted
    inertia tensors, one band per weight vector) through ONE inertia-loop
    call: the bands are laid on the halo axis (lane n * B + b holds halo b
    under band n), so every lane has one shared weight vector and the
    loop's interface stays as it is.  Returns (B, NB, C, ...) fields."""
    B, NB, K = weights.shape
    C = masks.shape[1]

    def lanes(t):
        return t.repeat((NB,) + (1,) * (t.dim() - 1))

    res = inertia_tensor_multi(
        weights.transpose(0, 1).reshape(NB * B, K),
        lanes(pos),
        lanes(masks),
        lanes(sphere_radius),
        reduced,
        iterative,
        search_radius=None if search_radius is None else lanes(search_radius),
        check_search=check_search,
        single_pass=single_pass,
        rows_radius_sorted=rows_radius_sorted,
    )

    def unlane(t):
        return t.reshape((NB, B) + t.shape[1:]).transpose(0, 1)

    return InertiaResult(unlane(res.tensor), unlane(res.found), unlane(res.needs_bigger))


def sym_eigh_2x2(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric (..., 2, 2) matrices in
    float64: (w ascending (..., 2), V (..., 2, 2) eigenvectors as columns)
    in the input dtype."""
    in_dtype = A.dtype
    A = A.to(torch.float64)
    a, b, d = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
    tr2 = (a + d) / 2.0
    det = a * d - b * b
    disc = torch.sqrt(torch.clamp(tr2 * tr2 - det, min=0.0))
    w0, w1 = tr2 - disc, tr2 + disc
    # eigenvector of w1: (b, w1 - a) unless b ~ 0
    use_b = torch.abs(b) > 1e-30
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    v1x = torch.where(use_b, b, torch.where(a >= d, one, zero))
    v1y = torch.where(use_b, w1 - a, torch.where(a >= d, zero, one))
    nrm = torch.sqrt(torch.clamp(v1x * v1x + v1y * v1y, min=1e-37))
    v1x, v1y = v1x / nrm, v1y / nrm
    V = torch.stack([torch.stack([-v1y, v1x], -1), torch.stack([v1x, v1y], -1)], -1)
    return torch.stack([w0, w1], -1).to(in_dtype), V.to(in_dtype)


def projected_inertia_tensor_multi(
    weights: torch.Tensor,  # (B, K) shared, or (B, C, K) per config
    pos2d: torch.Tensor,  # (B, K, 2) projected halo-relative positions
    masks: torch.Tensor,  # (B, C, K)
    circle_radius: torch.Tensor,  # (B, C)
    reduced: Sequence[bool],  # (C,)
    iterative: Sequence[bool],  # (C,)
    max_iterations: int = 20,
    single_pass: bool = False,  # every config non-iterative
) -> InertiaResult:
    """Every (halo, config) 2D inertia tensor (xx, yy, xy) in one loop of
    plain PyTorch (``soap_tpu.ops.inertia.projected_inertia_tensor_multi``,
    an XLA loop with no Pallas kernel): the ellipse starts as the circle,
    is reshaped to sqrt(l0/l1) at fixed area and re-selected until q
    changes by < TOL; a config needs MIN_PARTICLES inside the circle.
    Products in float32, sums in float64, as the 3D loop."""
    B, C, K = masks.shape
    dev = pos2d.device
    red = torch.as_tensor(np.asarray(reduced, bool), device=dev)
    it = torch.as_tensor(np.asarray(iterative, bool), device=dev)
    w_in = weights if weights.dim() == 3 else weights[:, None, :]
    px, py = pos2d[..., 0][:, None, :], pos2d[..., 1][:, None, :]  # (B, 1, K)
    r2 = px * px + py * py
    zero_r = torch.abs(r2) <= 1e-8
    masks = masks & ~(red[None, :, None] & zero_r)
    R = circle_radius.to(torch.float32)
    enough = (masks & (r2 <= (R * R)[..., None])).sum(-1) >= MIN_PARTICLES
    limit = torch.where(it, max_iterations, 1)
    w_inv = w_in * (1.0 / torch.where(zero_r, 1.0, r2))

    def compute_tensor(val, vec):
        q = torch.sqrt(val[..., 0] / val[..., 1])
        axis = R[..., None] * torch.stack([torch.sqrt(q), 1.0 / torch.sqrt(q)], -1)
        ia = 1.0 / (axis * axis)  # (B, C, 2)
        Q = torch.einsum("bcik,bcjk,bck->bcij", vec, vec, ia)
        rr = px * (Q[..., 0, 0, None] * px + 2.0 * Q[..., 0, 1, None] * py) \
            + Q[..., 1, 1, None] * py * py
        inside = masks & (rr <= 1.0)
        w = torch.where(inside, w_in, 0.0)
        wi = torch.where(inside, torch.where(red[None, :, None], w_inv, w_in), 0.0)
        sums = [particle_sum(Summand(wi * a * b, out_dtype=torch.float64), -1)
                for a, b in ((px, px), (px, py), (py, py))]
        inv = 1.0 / torch.clamp(particle_sum(Summand(w, out_dtype=torch.float64), -1), min=1e-37)
        xx, xy, yy = (s * inv for s in sums)
        t = torch.stack(
            [torch.stack([xx, xy], -1), torch.stack([xy, yy], -1)], -2
        ).to(torch.float32)
        return t, q

    eye = torch.eye(2, dtype=torch.float32, device=dev).expand(B, C, 2, 2)
    val = torch.ones((B, C, 2), dtype=torch.float32, device=dev)
    if single_pass:
        tensor, _ = compute_tensor(val, eye)
    else:
        vec = eye.clone()
        tensor = torch.zeros((B, C, 2, 2), dtype=torch.float32, device=dev)
        old_q = torch.full((B, C), 1000.0, dtype=torch.float32, device=dev)
        done = ~enough
        for i in range(max_iterations):
            if bool(done.all()):
                break
            q_now = torch.sqrt(val[..., 0] / val[..., 1])
            converged = torch.abs((old_q - q_now) / torch.clamp(q_now, min=1e-37)) < TOL
            t_new, q = compute_tensor(val, vec)
            val_n, vec_n = sym_eigh_2x2(t_new)
            val_n = torch.abs(val_n)
            degenerate = q == 0.0
            t_new = torch.where(degenerate[..., None, None], 0.0, t_new)
            stop = converged | degenerate | (i + 1 >= limit)[None, :]
            active = ~done
            upd = active & ~(converged | degenerate)
            tensor = torch.where((active & ~converged)[..., None, None], t_new, tensor)
            val = torch.where(upd[..., None], val_n, val)
            vec = torch.where(upd[..., None, None], vec_n, vec)
            old_q = torch.where(upd, q_now, old_q)
            done = done | (active & stop)
    flat = torch.stack([tensor[..., 0, 0], tensor[..., 1, 1], tensor[..., 0, 1]], -1)
    flat = torch.where(enough[..., None], flat, 0.0)
    return InertiaResult(flat, enough, torch.zeros_like(enough))
