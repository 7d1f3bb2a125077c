"""The card's activity over a traced window, from torch.profiler.

Only CUDA activity is recorded (kernels, copies, memsets), so a hydro
pass's ~10^5 launches stay cheap to trace, and the events are reduced in
memory: nothing is written to disk.  Busy time is the union of the
device intervals, so work on a side stream that overlaps compute counts
once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

#: characters of a kernel's name kept in the breakdown
NAME_CHARS = 120


def _short(name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    name = " ".join(name.split())
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _ns(event, what: str) -> int:
    f = getattr(event, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(event, f"{what}_us")() * 1000)


class DeviceTrace:
    """``with DeviceTrace() as t:`` records the card's activity; then
    ``t.events`` holds (name, start ns, end ns) of every device event."""

    def __init__(self):
        self.events: List[Tuple[str, int, int]] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.stop()
        results = self._prof.profiler.kineto_results
        cuda = torch.autograd.DeviceType.CUDA
        for e in results.events():
            if e.device_type() != cuda:
                continue
            start = _ns(e, "start")
            self.events.append((e.name(), start, start + _ns(e, "duration")))
        self.events.sort(key=lambda x: x[1])
        self._prof = None


def summarise(events: List[Tuple[str, int, int]], window_s: float,
              top: int = 10) -> Optional[Dict[str, object]]:
    """Busy seconds (union of intervals), seconds and count per name, the
    longest idle gaps inside the events' span (named by the events either
    side), and the ``breakdown`` of the result line; None without events."""
    if not events:
        return None
    by_name: Dict[str, List[float]] = {}
    busy_ns = 0
    cur_start, cur_end, cur_name = events[0][1], events[0][2], events[0][0]
    gaps: List[Tuple[int, str]] = []
    for name, start, end in events:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (end - start) * 1e-9
        if start > cur_end:
            busy_ns += cur_end - cur_start
            gaps.append((start - cur_end, f"{_short(cur_name)} -> {_short(name)}"))
            cur_start, cur_end, cur_name = start, end, name
        elif end > cur_end:
            cur_end, cur_name = end, name
    busy_ns += cur_end - cur_start
    gaps.sort(key=lambda g: -g[0])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": window_s,
        "by_name": {k: (int(v[0]), float(v[1])) for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[_short(k), float(v[1])] for k, v in ops[:top]],
            "idle_gaps": [[n, g * 1e-9] for g, n in gaps[:top]],
        },
    }
