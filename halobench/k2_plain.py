"""A frozen copy of the port's plain inertia loop, for counting K2's work.

Copied from ``soap_tpu_torch/ops/inertia_loop.py::inertia_loop_plain``
and ``soap_tpu_torch/ops/inertia.py::sym_eigh_3x3`` at commit d6ae473,
unchanged but for the imports: the iterations each (halo, config) runs
on a call's own inputs are the work ``roofline.py`` charges K2 with, so
the count is the same whatever implements the loop.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 1.0e-4


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


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt; float64 pow rounds to the f32 cube root
    return torch.pow(x.to(torch.float64), 1.0 / 3.0).to(torch.float32)


def inertia_loop_plain(
    pos3: torch.Tensor,
    w: torch.Tensor,
    mw: torch.Tensor,
    R: torch.Tensor,
    reduced: torch.Tensor,
    limit: torch.Tensor,
    occ: torch.Tensor,
    done0: torch.Tensor,
    max_iterations: int,
    *,
    count_iterations: bool = False,
):
    """Plain PyTorch version of K2 (the port of the jnp while loop).
    With ``count_iterations`` it returns (tensors, (B, C) i32 iterations
    each config ran), the work a bound on the kernel's time counts.

    Each iteration computes only the (halo, config) pairs still running
    (a finished config's state no longer changes), over the rows before
    the last ``occ``: rows past a config's ``occ`` carry no selected
    bit.  It needs no extent stop either: rows past the ellipsoid's
    extent are never inside it, so it sweeps every row of the prefix."""
    B, _, K = pos3.shape
    C = R.shape[1]
    dev = pos3.device
    kmax = max(int(occ.max()), 1) if occ.numel() else 1
    pos3, w, mw = pos3[..., :kmax], w[:, :kmax], mw[..., :kmax]
    r2 = pos3[:, 0] * pos3[:, 0] + pos3[:, 1] * pos3[:, 1] + pos3[:, 2] * pos3[:, 2]
    w_inv = w * (1.0 / torch.where(torch.abs(r2) <= 1e-8, 1.0, r2))

    val = torch.ones((B, C, 3), dtype=torch.float32, device=dev)
    vec = torch.eye(3, dtype=torch.float32, device=dev).repeat(B, C, 1, 1)
    ten = torch.zeros((B, C, 6), dtype=torch.float32, device=dev)
    old_q = torch.full((B, C), 1000.0, dtype=torch.float32, device=dev)
    done = done0 != 0
    iterations = torch.zeros((B, C), dtype=torch.int32, device=dev)
    for i in range(max_iterations):
        b, c = (~done).nonzero(as_tuple=True)  # the pairs still running
        if not len(b):
            break
        x, y, z = pos3[b, 0], pos3[b, 1], pos3[b, 2]  # (n, K)
        mask = ((mw[b, c // 32] >> (c % 32)[:, None]) & 1).bool()
        v0, v1, v2 = val[b, c].unbind(-1)
        vc = vec[b, c]  # (n, 3, 3)
        q_now = torch.sqrt(v1 / v2)
        converged = torch.abs((old_q[b, c] - q_now) / torch.clamp(q_now, min=1e-37)) < TOL
        s = torch.sqrt(v0 / v2)
        p = torch.sqrt(v0 / v1)
        axis = R[b, c][:, None] * torch.stack(
            [_cbrt(s * p), _cbrt(q_now / p), 1.0 / _cbrt(q_now * s)], -1
        )
        ia = 1.0 / (axis * axis)  # (n, 3)

        def qf(i_, j_):
            return (
                vc[:, i_, 0] * vc[:, j_, 0] * ia[:, 0]
                + vc[:, i_, 1] * vc[:, j_, 1] * ia[:, 1]
                + vc[:, i_, 2] * vc[:, j_, 2] * ia[:, 2]
            )[:, None]

        q00, q11, q22 = qf(0, 0), qf(1, 1), qf(2, 2)
        q01, q02, q12 = 2.0 * qf(0, 1), 2.0 * qf(0, 2), 2.0 * qf(1, 2)
        rr = x * (q00 * x + q01 * y + q02 * z) + y * (q11 * y + q12 * z) + q22 * z * z
        inside = mask & (rr <= 1.0)
        w_in = w[b]
        wsel = torch.where(inside, w_in, 0.0)
        wi = torch.where(inside, torch.where(reduced[b, c].bool()[:, None], w_inv[b], w_in), 0.0)
        # f32 products, f64 sums: the kernel's arithmetic, so both round
        # every f32 quantity alike (see csrc/inertia_loop.cu)
        sums = [
            (wi * a * b_).to(torch.float64).sum(-1)
            for a, b_ in ((x, x), (x, y), (x, z), (y, y), (y, z), (z, z))
        ]
        inv = 1.0 / torch.clamp(wsel.to(torch.float64).sum(-1), min=1e-37)
        t_new = torch.stack([s_ * inv for s_ in sums], -1).to(torch.float32)
        xx, xy, xz, yy, yz, zz = t_new.unbind(-1)
        full = torch.stack(
            [
                torch.stack([xx, xy, xz], -1),
                torch.stack([xy, yy, yz], -1),
                torch.stack([xz, yz, zz], -1),
            ],
            -2,
        )
        val_n, vec_n = sym_eigh_3x3(full)
        val_n = torch.abs(val_n)
        degenerate = q_now == 0.0
        t_new = torch.where(degenerate[:, None], 0.0, t_new)
        stop = converged | degenerate | (i + 1 >= limit[b, c])
        upd = ~(converged | degenerate)
        ten[b, c] = torch.where(~converged[:, None], t_new, ten[b, c])
        val[b, c] = torch.where(upd[:, None], val_n, val[b, c])
        vec[b, c] = torch.where(upd[:, None, None], vec_n, vc)
        old_q[b, c] = torch.where(upd, q_now, old_q[b, c])
        done[b, c] = stop
        iterations[b, c] += 1
    return (ten, iterations) if count_iterations else ten
