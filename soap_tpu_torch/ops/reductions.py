"""Masked reductions over a batch of padded halo slices.

Every function takes a leading halo axis: per-particle arrays are
(B, K) or (B, K, D) with a (B, K) validity/selection mask, and reduce
over the particle axis (ported from ``soap_tpu/ops/reductions.py``).

On CUDA tensors every float particle sum runs kernel K3
(``csrc/particle_sum.cu``): it reads its input once, in its own dtype,
and accumulates in float64 in registers; CPU tensors take the plain
PyTorch expressions, which the kernel's results equal up to the order of
the float64 additions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from soap_tpu_torch.ops import kernel_lib

#: elements of one row that one warp of K3 sums (a multiple of 128); a
#: longer row is split into chunks of this size at fixed offsets, whose
#: float64 partials a second kernel adds.  Fixed, so that a row's order
#: of additions does not depend on its padded length
CHUNK = 8192
#: the dtypes K3 reads and writes, by the code its C interface takes
_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the particle axis (dim 1), accumulated in
    float64 on every device and rounded back to ``x``'s dtype.  PyTorch's
    CPU kernel accumulates float32 this way already (so the CPU result is
    bit for bit ``torch.cumsum``'s); its CUDA float32 scan associates
    by row length, which would make a halo's SO radius depend on the
    capacity of the bucket it shares with other halos."""
    return torch.cumsum(x, 1, dtype=torch.float64).to(x.dtype)


class Summand(NamedTuple):
    """What ``particle_sum`` sums, where that is more than a tensor:
    ``x`` over the elements ``mask`` selects (bool, broadcastable to
    ``x`` once trailing axes are added), as ``torch.where(mask, x, 0)``
    would give them, summed into float64 where ``out_dtype`` is
    ``torch.float64``, as ``x.to(torch.float64)`` would; on the card
    neither copy is written."""

    x: torch.Tensor
    mask: Optional[torch.Tensor] = None
    out_dtype: Optional[torch.dtype] = None


def particle_sum(x: torch.Tensor | Summand, dim: int = 1) -> torch.Tensor:
    """Sum over the particle axis ``dim``, accumulated in float64 and
    rounded once to ``x``'s dtype (float64 with ``Summand(...,
    out_dtype=torch.float64)``): every float reduction over particles in
    the property DAG goes through here.  PyTorch's CUDA float32 sum
    associates by the reduced length, so a halo's sums (and through its
    centre-of-mass velocity and angular momentum, which particles count
    as co-rotating or sit inside a shell) would depend on the capacity of
    the bucket it shares with other halos.  Integer sums are exact and
    stay as they are.

    ``x`` is a tensor or a ``Summand``, so that every particle sum,
    masked or not, passes through this one function of ``(x, dim)``
    (halobench's fault tests stand in for it).

    A CUDA float32 or float64 ``x`` runs K3, with no copy of ``x``, the
    mask or a float64 version of either; a layout K3 does not take
    raises."""
    x, mask, out_dtype = x if isinstance(x, Summand) else (x, None, None)
    if out_dtype not in (None, torch.float64):
        raise ValueError(f"particle_sum: out_dtype None or torch.float64, not {out_dtype}")
    if x.is_cuda and x.dtype.is_floating_point:
        return _kernel_sum(x, dim, mask, out_dtype or x.dtype)
    if mask is not None:
        x = torch.where(_trailing(mask, x.dim()), x, 0)
    if out_dtype is not None:
        x = x.to(out_dtype)
    if not x.dtype.is_floating_point:
        return x.sum(dim)
    return x.sum(dim, dtype=torch.float64).to(x.dtype)


def _trailing(mask: torch.Tensor, n_dim: int) -> torch.Tensor:
    """``mask`` with unit axes added at the end up to ``n_dim`` (a view)."""
    return mask.reshape(mask.shape + (1,) * (n_dim - mask.dim()))


#: K3 sums (one per call: a split row's finishing kernel is not counted
#: apart), from every thread (under ``kernel_lib.COUNT_LOCK``)
launches = 0
_here = kernel_lib.ThreadCount()
_fn = None
#: the current CUDA stream's handle on a device, bound when K3 is first
#: loaded: ``torch._C._cuda_getCurrentRawStream`` builds no
#: ``torch.cuda.Stream``, which ``torch.cuda.current_stream(dev).cuda_stream``
#: does (0.2 against 5.5 us a call on an H100's host, a third of a sum's)
_raw_stream = None
_sm_counts: Dict[int, int] = {}
#: launch plans by the tensors' layout, at most MAX_PLANS (then cleared)
_plans: Dict[tuple, tuple] = {}
MAX_PLANS = 4096


class Launch(ctypes.Structure):
    """K3's launch for one layout, as ``struct Launch`` in
    ``csrc/particle_sum.cu``: built once, so a call converts only its
    pointers.  The rows are up to three coordinates (outermost first)
    over the axes that are not reduced, with extents (n0,) n1, n2; the
    strides are in elements, of x (``xs*``, ``xk`` along the reduced
    axis) and of the mask (``ms*``, ``mk``; 0 without one)."""

    _fields_ = [(n, ctypes.c_int) for n in ("device", "in_f64", "out_f64", "warps_per_block")] + [
        (n, ctypes.c_longlong)
        for n in ("n1", "n2", "xs0", "xs1", "xs2", "xk", "ms0", "ms1", "ms2", "mk",
                  "n_rows", "K", "chunk", "n_chunks")
    ]


def launches_here() -> int:
    """The K3 sums the calling thread ran."""
    return _here.n


def _count_launch() -> None:
    global launches
    with kernel_lib.COUNT_LOCK:
        launches += 1
    _here.n += 1


def row_axes(
    shape: Sequence[int], strides: Sequence[Sequence[int]], dim: int
) -> List[Tuple[int, List[int]]]:
    """The axes other than ``dim`` as (extent, [stride of each tensor]),
    outermost first, with axes of extent 1 dropped and each axis merged
    into the one before it where every tensor steps over both as one."""
    axes: List[Tuple[int, List[int]]] = []
    for i, n in enumerate(shape):
        if i == dim or n == 1:
            continue
        st = [s[i] for s in strides]
        if axes and all(p == q * n for p, q in zip(axes[-1][1], st)):
            axes[-1] = (axes[-1][0] * n, st)
        else:
            axes.append((n, st))
    return axes


def warps_per_block(items: int, n_sm: int) -> int:
    """Warps (one chunk of one row each) per CTA: 8, halved while the
    CTAs would not give every SM two (few, long rows spread wider)."""
    w = 8
    while w > 1 and -(-items // w) < 2 * n_sm:
        w //= 2
    return w


def _plan(x, dim, mask, out_dtype) -> tuple:
    """K3's launch for tensors laid out as ``x`` and ``mask``: (output
    shape, ``Launch`` or None where there are no rows, float64 partials);
    raises where K3 does not take them."""
    if x.dim() == 0 or x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"particle_sum: K3 sums float32 or float64 particle axes, not a "
                         f"{x.dim()}-d {x.dtype} tensor")
    dim = dim % x.dim()
    shape = x.shape
    strides = [x.stride()]
    if mask is not None:
        if mask.device != x.device or mask.dtype != torch.bool:
            raise ValueError(f"particle_sum: a bool mask on {x.device} wanted, got "
                             f"{mask.dtype} on {mask.device}")
        strides.append(_trailing(mask, x.dim()).expand(shape).stride())
    axes = row_axes(shape, strides, dim)
    if len(axes) > 3:
        raise ValueError(f"particle_sum: K3 takes at most three row axes that do not merge, "
                         f"not shape {tuple(shape)} with strides {strides} over dim {dim}")
    axes = [(1, [0] * len(strides))] * (3 - len(axes)) + axes
    out_shape = shape[:dim] + shape[dim + 1 :]
    n_rows, K = math.prod(out_shape), shape[dim]
    if n_rows == 0:
        return out_shape, None, 0
    n_chunks = max(1, math.ceil(K / CHUNK))
    device = x.get_device()
    n_sm = _sm_counts.get(device)
    if n_sm is None:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = n_sm
    w = warps_per_block(n_rows * n_chunks, n_sm)
    if -(-n_rows * n_chunks // w) > 2**31 - 1:  # the grid's x extent
        raise ValueError(f"particle_sum: {n_rows} rows of {K} overflow K3's grid")
    ms = [st[1] for _, st in axes] + [strides[1][dim]] if mask is not None else [0] * 4
    launch = Launch(device, _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[out_dtype], w,
                    axes[1][0], axes[2][0], *(st[0] for _, st in axes), strides[0][dim], *ms,
                    n_rows, K, CHUNK, n_chunks)
    return out_shape, launch, n_rows * n_chunks if n_chunks > 1 else 0


def _load():
    global _fn, _raw_stream
    fn = kernel_lib.load("particle_sum").particle_sum
    fn.argtypes = [ctypes.POINTER(Launch)] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _fn = fn
    return fn


def _kernel_sum(x, dim, mask, out_dtype) -> torch.Tensor:
    """K3's sum (``particle_sum``'s on the card).  Plans are kept by
    layout: the DAG sums the same shapes bucket after
    bucket, and the host's time a sum is what launches it."""
    if mask is None:
        key = (x.shape, x.stride(), dim, x.dtype, out_dtype, x.device)
    else:
        key = (x.shape, x.stride(), dim, x.dtype, out_dtype, x.device,
               mask.shape, mask.stride(), mask.dtype, mask.device)
    plan = _plans.get(key, False)
    if plan is False:
        if len(_plans) >= MAX_PLANS:
            _plans.clear()
        plan = _plans[key] = _plan(x, dim, mask, out_dtype)
    out_shape, launch, n_partial = plan
    dev = x.device
    out = torch.empty(out_shape, dtype=out_dtype, device=dev)
    if launch is None:
        return out
    partial = torch.empty(n_partial, dtype=torch.float64, device=dev) if n_partial else None
    fn = _fn or _load()
    rc = fn(
        launch, x.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), _raw_stream(launch.device),
    )
    kernel_lib.check(rc, "particle_sum")
    _count_launch()
    return out


def particle_mean(
    w: torch.Tensor, x: torch.Tensor, wsum: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``w``-weighted sum of ``x`` over the particle axis over ``wsum``
    (clamped at 1e-37), over the ``mask``-selected particles if given;
    ``w`` is (B, K) and ``x`` (B, K) or (B, K, D)."""
    if x.dim() > w.dim():
        w, wsum = w[..., None], wsum[..., None]
    return particle_sum(Summand(w * x, mask)) / torch.clamp(wsum, min=1e-37)


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of x over the selected particles; x is (B, K) or (B, K, D)."""
    return particle_sum(Summand(x, mask))


def masked_count(mask: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Number of selected particles per halo."""
    return mask.sum(1).to(dtype)


def centre_of_mass(
    mass: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total mass (B,), centre of mass (B, 3)) over the selected
    particles, with halo-relative ``pos``."""
    mtot = particle_sum(Summand(mass, mask))
    com = particle_mean(mass, pos, mtot, mask)
    return mtot, torch.where(mtot[:, None] > 0, com, 0.0)


def centre_of_mass_velocity(
    mass: torch.Tensor, vel: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mass-weighted mean velocity (B, 3) of the selected particles."""
    mtot = particle_sum(Summand(mass, mask))
    v = particle_mean(mass, vel, mtot, mask)
    return torch.where(mtot[:, None] > 0, v, 0.0)


def velocity_dispersion_matrix(
    mass: torch.Tensor,  # (B, K)
    vel: torch.Tensor,  # (B, K, 3)
    vcom: torch.Tensor,  # (B, 3)
    mask: torch.Tensor,  # (B, K)
) -> torch.Tensor:
    """Mass-fraction-weighted velocity dispersion matrix (B, 6), in the
    reference's order XX, YY, ZZ, XY, XZ, YZ."""
    frac = mass / torch.clamp(particle_sum(Summand(mass, mask)), min=1e-37)[:, None]
    dv = vel - vcom[:, None, :]
    x, y, z = dv[..., 0], dv[..., 1], dv[..., 2]
    return torch.stack(
        [particle_sum(Summand(frac * a * b, mask))
         for a, b in ((x, x), (y, y), (z, z), (x, y), (x, z), (y, z))],
        1,
    )
