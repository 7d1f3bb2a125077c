"""Timing analysis over a catalogue's per-halo timing datasets.

The port's copy of ``soap_tpu/tools/timing_analysis.py`` (reference
``misc/plot_time.py``, which plots ``process_time`` against halo size
from ``--record-halo-timings`` output): a terminal report of totals,
percentiles, the time-against-size scaling exponent, retry-ladder
counts, the share of time in the slowest halos, and the seconds of each
calculation group from ``--record-property-timings``' ``_time``
datasets.

Each function that reads a file has an array half: ``timing_stats``
over the ``InputHalos`` columns, ``group_seconds`` over named ``_time``
datasets and ``format_report`` over both.  Only the file halves import
h5py.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def timing_stats(process_time: np.ndarray, n_loop: np.ndarray,
                 size: Optional[np.ndarray] = None) -> Dict[str, object]:
    """Statistics of per-halo ``process_time`` seconds, ``n_loop`` rounds
    and (optional) bound particle counts."""
    t = np.asarray(process_time, np.float64)
    n_loop = np.asarray(n_loop)
    out: Dict[str, object] = {
        "n_halos": len(t),
        "total_seconds": float(t.sum()),
        "mean_ms": float(t.mean() * 1e3),
        "p50_ms": float(np.percentile(t, 50) * 1e3),
        "p90_ms": float(np.percentile(t, 90) * 1e3),
        "p99_ms": float(np.percentile(t, 99) * 1e3),
        "max_ms": float(t.max() * 1e3),
        "retried_halos": int((n_loop > 1).sum()),
        "max_n_loop": int(n_loop.max()) if len(n_loop) else 0,
    }
    # share of total time spent in the top 1% largest-time halos
    if len(t):
        k = max(1, len(t) // 100)
        top = np.sort(t)[-k:]
        out["top1pct_time_share"] = float(top.sum() / max(t.sum(), 1e-30))
    if size is not None and len(size) == len(t) and (size > 0).any():
        # scaling exponent: t ~ N^alpha via log-log least squares
        ok = (size > 0) & (t > 0)
        if ok.sum() > 2:
            a = np.polyfit(np.log(size[ok]), np.log(t[ok]), 1)
            out["time_vs_size_exponent"] = float(a[0])
    return out


def analyze(catalogue: str) -> Dict[str, object]:
    """``timing_stats`` of a catalogue file written with
    ``--record-halo-timings``."""
    import h5py

    with h5py.File(catalogue, "r") as f:
        if "InputHalos/process_time" not in f:
            raise KeyError(
                "no InputHalos/process_time — rerun halo-properties with "
                "--record-halo-timings"
            )
        t = np.asarray(f["InputHalos/process_time"], np.float64)
        n_loop = np.asarray(f["InputHalos/n_loop"])
        size = (np.asarray(f["InputHalos/NumberOfBoundParticles"])
                if "InputHalos/NumberOfBoundParticles" in f else None)
    return timing_stats(t, n_loop, size)


def group_seconds(datasets: Iterable[Tuple[str, object]], top: int = 15) -> Dict[str, float]:
    """Per-calculation-group seconds from ``(path, array)`` pairs in file
    order: the sum of the first ``<name>_time`` dataset of each group (all
    properties of a group share its program's attribution), the ``top``
    largest first."""
    groups: Dict[str, float] = {}
    for name, data in datasets:
        if name.endswith("_time"):
            group = name.rsplit("/", 1)[0]
            if group not in groups:
                groups[group] = float(np.asarray(data, np.float64).sum())
    return dict(sorted(groups.items(), key=lambda kv: -kv[1])[: top or None])


def analyze_properties(catalogue: str, top: int = 15) -> Dict[str, float]:
    """``group_seconds`` of a catalogue file's ``_time`` datasets
    (``--record-property-timings``)."""
    import h5py

    found = []
    with h5py.File(catalogue, "r") as f:
        # datasets, read only where group_seconds sums them
        f.visititems(lambda name, obj: found.append((name, obj))
                     if isinstance(obj, h5py.Dataset) else None)
        return group_seconds(found, top)


def format_report(s: Dict[str, object], per_prop: Dict[str, float]) -> str:
    """The report's text for ``timing_stats`` and ``group_seconds``."""
    lines = [
        f"halos: {s['n_halos']}, total attributed time: "
        f"{s['total_seconds']:.2f}s",
        f"per-halo ms: mean {s['mean_ms']:.2f}  p50 {s['p50_ms']:.2f}  "
        f"p90 {s['p90_ms']:.2f}  p99 {s['p99_ms']:.2f}  "
        f"max {s['max_ms']:.2f}",
        f"retry ladder: {s['retried_halos']} halos took >1 round "
        f"(max {s['max_n_loop']} rounds)",
        f"top 1% of halos hold {s.get('top1pct_time_share', 0.0):.1%} "
        "of the time",
    ]
    if "time_vs_size_exponent" in s:
        lines.append(
            f"time ~ N^{s['time_vs_size_exponent']:.2f} "
            "(log-log fit vs bound particle count)"
        )
    if per_prop:
        lines.append("per-calculation time (from _time datasets):")
        for group, sec in per_prop.items():
            lines.append(f"  {sec:8.3f}s  {group}")
    return "\n".join(lines)


def report(catalogue: str) -> str:
    return format_report(analyze(catalogue), analyze_properties(catalogue))
