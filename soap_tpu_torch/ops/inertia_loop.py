"""The iterative inertia loop (kernel K2) and its plain PyTorch version.

For each halo b and config c: start from the sphere of radius R[b, c];
each iteration, over the config's selected rows inside the current
ellipsoid (pos^T Q pos <= 1), sum w x_i x_j (times 1/r^2 when the
config is reduced) and sum w, normalise, eigendecompose, and reshape the
ellipsoid to the new axis ratios at fixed volume.  A config stops when
its axis ratio q changes by < TOL, when q == 0 (degenerate), or at its
iteration limit.  The update rules are those of the while loop in
``soap_tpu/ops/inertia.py`` (``inertia_tensor_multi``).

Layout (the JAX kernel's, unpacked from its (8, 128) rows):
 - pos3 (B, 3, K) f32 positions, rows radius-sorted;
 - w (B, K) f32 weights shared by all configs;
 - mw (B, W, K) i32 masks: config c selects a row when bit c % 32 of
   word c // 32 is set;
 - R (B, C) f32 sphere radii; reduced, limit, occ (index after the
   config's last selected row) and done0 (B, C) i32;
 - out (B, C, 6) f32 tensors as [xx, xy, xz, yy, yz, zz].

The CUDA kernel runs one cluster of G CTAs per halo (``cluster_size``)
and stops each config's sweep at the ellipsoid's extent when the rows
are radius-sorted (``radius_table``); see ``csrc/inertia_loop.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from soap_tpu_torch.ops import kernel_lib

#: configs one CUDA launch carries (state lives in shared memory)
MAX_C = 128
#: CTAs in one halo's cluster: at most 16 (a size Hopper allows only as
#: non-portable), each with at least MIN_CTA_ROWS of the halo's K rows
MAX_CLUSTER = 16
MIN_CTA_ROWS = 4096
#: rows of one shared-memory tile of the sweep: 2048 in a cluster (a
#: 160 KB ring, so one CTA per SM and a cluster spreads over G SMs),
#: 1024 for a lone CTA (an 80 KB ring, two CTAs per SM)
TILE_ROWS = 1024
CLUSTER_TILE_ROWS = 2048
#: radius-table entries per halo at most, and the fewest rows per entry
MAX_TABLE = 1024
MIN_TABLE_ROWS = 128
#: what the launch returns when the card cannot place one cluster
_NO_CLUSTER = -1


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
    from soap_tpu_torch.ops.inertia import TOL, sym_eigh_3x3

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


#: launches of the K2 CUDA kernel, from every thread (incremented only
#: where it launches, under ``kernel_lib.COUNT_LOCK``)
launches = 0
#: those launches by cluster size G
cluster_launches: Dict[int, int] = {}
_here = kernel_lib.ThreadCount()


def launches_here() -> int:
    """The K2 launches the calling thread made."""
    return _here.n


def cluster_launches_here() -> Dict[int, int]:
    """The calling thread's K2 launches by cluster size G."""
    return dict(_here.by)


def _count_launch(G: int) -> None:
    """One K2 launch in clusters of G CTAs, in the totals and in the
    calling thread's count."""
    global launches
    with kernel_lib.COUNT_LOCK:
        launches += 1
        cluster_launches[G] = cluster_launches.get(G, 0) + 1
    _here.n += 1
    _here.by[G] = _here.by.get(G, 0) + 1


def cluster_size(B: int, K: int, n_sm: int) -> int:
    """CTAs per halo: the largest power of two G with B * G <= n_sm, so
    that the B * G CTAs run in one wave of one CTA per SM, capped at
    MAX_CLUSTER and so that K / G >= MIN_CTA_ROWS (G >= 1).  Fewer,
    longer CTAs beat a second wave of shorter ones (``PERF.md``)."""
    G = 1
    while 2 * G <= MAX_CLUSTER and 2 * G * B <= n_sm and K >= 2 * G * MIN_CTA_ROWS:
        G *= 2
    return G


def table_rows(K: int) -> int:
    """Rows per radius-table entry: the smallest power of two, at least
    MIN_TABLE_ROWS, that needs at most MAX_TABLE entries for K rows."""
    T = MIN_TABLE_ROWS
    while T * MAX_TABLE < K:
        T *= 2
    return T


def radius_table(pos3: torch.Tensor, rows_radius_sorted: bool):
    """((B, ceil(K / T)) f32 table, T): the radius of the first row of
    each T-row tile, for the kernel's ellipsoid-extent stop, as a
    running maximum over the tiles, so that the zero rows of empty
    slots after a bucket's sorted rows do not extend the sweep.  The
    stop is valid only on rows ascending in radius; for any other rows
    every entry is -inf, and the kernel sweeps each config's whole
    prefix."""
    B, _, K = pos3.shape
    T = table_rows(K)
    if not rows_radius_sorted:
        n = -(-K // T)
        return torch.full((B, n), -torch.inf, dtype=torch.float32, device=pos3.device), T
    x, y, z = pos3[:, :, ::T].unbind(1)
    return torch.cummax(torch.sqrt(x * x + y * y + z * z), 1).values.contiguous(), T


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"inertia_loop: {name} must be contiguous {dtype} {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)}"
        )


def inertia_loop(
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
    rows_radius_sorted: bool = False,
) -> torch.Tensor:
    """(B, C, 6) final tensors.  CUDA tensors launch K2; CPU tensors take
    the plain version; anything else raises.  ``rows_radius_sorted``
    says the rows ascend in radius, which lets the kernel stop each
    sweep at the ellipsoid's extent."""
    args = (pos3, w, mw, R, reduced, limit, occ, done0)
    if all(t.device.type == "cpu" for t in args):
        return inertia_loop_plain(*args, max_iterations)
    dev = pos3.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError(
            "inertia_loop: tensors on " + ", ".join(str(t.device) for t in args)
        )
    B, _, K = pos3.shape
    C = R.shape[1]
    W = mw.shape[1]
    _check("pos3", pos3, torch.float32, (B, 3, K))
    _check("w", w, torch.float32, (B, K))
    _check("mw", mw, torch.int32, (B, W, K))
    _check("R", R, torch.float32, (B, C))
    for name, t in (("reduced", reduced), ("limit", limit), ("occ", occ), ("done0", done0)):
        _check(name, t, torch.int32, (B, C))
    if not 0 < C <= MAX_C or W * 32 < C:
        raise ValueError(f"inertia_loop: C={C} configs need 1..{MAX_C}, W={W} words")
    # the kernel copies rows in 16-byte chunks
    if K % 4 or any(t.data_ptr() % 16 for t in (pos3, w, mw)):
        raise ValueError(
            f"inertia_loop: K={K} must be a multiple of 4 and pos3, w, mw "
            "16-byte aligned"
        )
    out = torch.empty((B, C, 6), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    table, T = radius_table(pos3, rows_radius_sorted)
    G = cluster_size(B, K, _sm_count(dev))
    tile = TILE_ROWS if G == 1 else CLUSTER_TILE_ROWS
    lib = kernel_lib.load("inertia_loop")
    fn = lib.inertia_loop_f32
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    # on the tensors' device, whichever is current in this thread (see
    # ops/range_gather.py::range_gather_blocks)
    with torch.cuda.device(dev):
        rc = fn(
            dev.index, pos3.data_ptr(), w.data_ptr(), mw.data_ptr(), R.data_ptr(),
            reduced.data_ptr(), limit.data_ptr(), occ.data_ptr(), done0.data_ptr(),
            table.data_ptr(), B, K, W, C, int(max_iterations), G, tile, T, table.shape[1],
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc == _NO_CLUSTER:
        raise RuntimeError(f"inertia_loop_f32: the card cannot place a cluster of {G} CTAs")
    kernel_lib.check(rc, "inertia_loop_f32")
    _count_launch(G)
    return out
