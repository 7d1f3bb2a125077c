"""The least time the card could take for the two kernels' work.

The peaks are NVIDIA's H100 SXM data sheet's, at its 700 W limit: HBM at
3.35 TB/s, 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the
tensor cores.  A call's least time is the largest of its bytes over the
HBM rate and its operations of each precision over that precision's
peak.  Work counts follow ``chip_smoke.py::k1_bound / k2_bound`` (commit
d6ae473):

- K1 (range gather): each output row written once, each distinct source
  row its table reaches read once, the table read once;
- K2 (inertia loop): each halo's rows up to its last selected row read
  once (positions, weight, mask words), the tensors and per-config state
  written once; per selected row, config and iteration, 27 float32
  operations (the ellipsoid's quadratic form 14, its test 1, the six
  weighted second moments 12) and 7 float64 ones (the seven sums),
  ``csrc/inertia_loop.cu``'s precisions; the iterations are those the
  frozen plain loop (``k2_plain.py``) runs on the call's own inputs.

``WorkCounter`` wraps the names the engine calls the two kernels through
and adds up each call's least time; the kernels themselves run as usual.
"""

from __future__ import annotations

import threading

import torch

from halobench import k2_plain

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
K2_F32_OPS_PER_ROW = 27
K2_F64_OPS_PER_ROW = 7


def least_seconds(n_bytes: float, f32_ops: float = 0.0, f64_ops: float = 0.0) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, f32_ops / F32_FLOPS, f64_ops / F64_FLOPS)


def k1_least_seconds(packed: torch.Tensor, table: torch.Tensor, S: int, capacity: int) -> float:
    N, F = packed.shape
    off = torch.arange(S, device=table.device)
    src = torch.clamp(table.to(torch.int64)[..., None] + off, 0, N - 1)
    n_src = int(torch.unique(src).numel())
    B = table.shape[0]
    return least_seconds((B * capacity + n_src) * F * 4 + table.numel() * 4)


def k2_least_seconds(args) -> float:
    pos3, _, mw, R, _, _, occ = args[:7]
    W = mw.shape[1]
    _, iters = k2_plain.inertia_loop_plain(*args, count_iterations=True)
    rows = occ.amax(1).to(torch.float64).sum().item()
    n_bytes = rows * (12 + 4 + 4 * W) + R.numel() * (6 * 4 + 5 * 4)
    row_iters = (iters.to(torch.float64) * occ).sum().item()
    return least_seconds(n_bytes, K2_F32_OPS_PER_ROW * row_iters,
                         K2_F64_OPS_PER_ROW * row_iters)


class WorkCounter:
    """While entered, every K1 and K2 call adds its least time
    (``k1_s``, ``k2_s``) and its count (``k1_calls``, ``k2_calls``)."""

    def __init__(self):
        self.k1_s = self.k2_s = 0.0
        self.k1_calls = self.k2_calls = 0
        self._lock = threading.Lock()

    def _k1(self, packed, table, S, capacity):
        out = self._gather(packed, table, S, capacity)
        if table.numel():
            t = k1_least_seconds(packed, table, S, capacity)
            with self._lock:
                self.k1_s += t
                self.k1_calls += 1
        return out

    def _k2(self, *args, **kw):
        out = self._loop(*args, **kw)
        if args[0].shape[0]:
            t = k2_least_seconds(args)
            with self._lock:
                self.k2_s += t
                self.k2_calls += 1
        return out

    def __enter__(self):
        from soap_tpu_torch.ops import inertia as inertia_ops
        from soap_tpu_torch.ops import range_gather as rg

        self._mods = rg, inertia_ops
        self._gather, self._loop = rg.range_gather_blocks, inertia_ops.inertia_loop
        rg.range_gather_blocks, inertia_ops.inertia_loop = self._k1, self._k2
        return self

    def __exit__(self, *exc):
        rg, inertia_ops = self._mods
        rg.range_gather_blocks, inertia_ops.inertia_loop = self._gather, self._loop
