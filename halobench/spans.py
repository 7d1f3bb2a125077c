"""The program's spans against the card's activity in a traced window.

What the readers of the span metrics (``metrics/engine.plan_s.py``,
``engine.issue_s``, ``engine.drain_s``, ``engine.resolve_s``,
``device.idle_in_engine_pct``) and the breakdown's ``idle_by_span`` and
``issue_by_family`` compute, from these keys of a run (none of them in a
run that recorded no spans, whose readers then read None):

- ``spans``: the program's spans over the traced passes, as
  ``soap_tpu_torch/utils/trace.py``'s ``Recorder.records()`` gives them
  (start and end in Unix ns, the clock of torch.profiler's events; the
  thread's native id);
- ``main_thread``: the native id of the thread that ran the passes;
- ``busy``: the card's busy intervals in the window, [start, end] ns,
  the union of its kernel, copy and memset intervals (as
  ``devtrace.summarise`` unites them);
- ``window``: the window's [start, end] in ns on the same clock;
- ``waits``: the host's CUDA runtime calls that block until the device
  catches up (``WAITS``: synchronizes and copies), [start, end, thread]
  with the native id of the thread that made the call, from the same
  profiler's host-side events (whose ``device_resource_id()`` gives that
  thread as the low 32 bits of its ``threading.get_ident()``, signed,
  not as its native id: the producer maps one onto the other).

``harness.run_cell`` puts none of them into its run yet, so these metrics
are no entries of ``BENCHMARK.json``: that takes ``run_cell`` entering
``trace.recording()`` beside ``DeviceTrace`` around the traced passes
(not the untimed roofline passes) and adding the five keys.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: the idle time no program span was open around
OUTSIDE = "(outside the program)"
#: the CUDA runtime calls in which the host waits for the device: every
#: synchronize, and the copies (a pageable copy returns once done, and
#: torch synchronizes the stream after a blocking one)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cudaMemcpyAsync")


def seconds_per_pass(run, name: str, less_waits: bool = False) -> Optional[float]:
    """Seconds in spans named ``name`` over the run's passes, per pass;
    with ``less_waits``, less the host's waits for the device in them on
    the span's own thread."""
    spans, passes = run.get("spans"), run.get("passes")
    if not spans or not passes:
        return None
    mine = [s for s in spans if s["name"] == name]
    total = sum(s["end"] - s["start"] for s in mine)
    for thread in {s["thread"] for s in mine} if less_waits else ():
        waits = union((a, b) for a, b, t in run.get("waits") or () if t == thread)
        if not waits:
            continue
        own = [s for s in mine if s["thread"] == thread]
        a, b = [s["start"] for s in own], [s["end"] for s in own]
        total -= int(_Cover(waits, min(a), max(b)).inside(a, b).sum())
    return total * 1e-9 / len(passes) if total else None


def union(intervals: Iterable[Tuple[int, int]]) -> List[List[int]]:
    """Sorted disjoint [start, end] covering the given intervals."""
    out: List[List[int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


class _Cover:
    """The ns of [lo, t] covered by disjoint sorted intervals, for any t."""

    def __init__(self, busy: Sequence[Sequence[int]], lo: int, hi: int):
        b = np.clip(np.asarray(busy, np.int64).reshape(-1, 2), lo, hi)
        b = b[b[:, 1] > b[:, 0]]
        self.starts, self.ends = b[:, 0], b[:, 1]
        self.cum = np.concatenate([[0], np.cumsum(self.ends - self.starts)])

    def upto(self, t) -> np.ndarray:
        t = np.asarray(t, np.int64)
        if not len(self.starts):
            return np.zeros_like(t)
        # before the first interval: j = 0 and the clip reads 0
        j = np.maximum(np.searchsorted(self.starts, t, side="right") - 1, 0)
        return self.cum[j] + np.clip(t - self.starts[j], 0, self.ends[j] - self.starts[j])

    def inside(self, a, b) -> np.ndarray:
        """Covered ns in each [a, b]."""
        return self.upto(b) - self.upto(a)

    def idle(self, a, b) -> np.ndarray:
        """Uncovered ns in each [a, b]."""
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        return (b - a) - self.inside(a, b)


def segments(run) -> List[Tuple[int, int, Optional[dict]]]:
    """The window cut into (start, end, span) pieces, each labelled with
    the innermost main-thread span open over it (None where none is)."""
    lo, hi = run["window"]
    main = [s for s in run["spans"] if s["thread"] == run["main_thread"]]
    children: Dict[Optional[int], List[dict]] = {}
    for s in main:
        children.setdefault(s["parent"], []).append(s)
    out: List[Tuple[int, int, Optional[dict]]] = []

    def walk(span, start, end, kids):
        cursor = start
        for k in sorted(kids, key=lambda s: s["start"]):
            a, b = max(k["start"], cursor), min(k["end"], end)
            if b <= a:
                continue
            out.append((cursor, a, span))
            walk(k, a, b, children.get(k["index"], []))
            cursor = b
        out.append((cursor, end, span))

    walk(None, lo, hi, children.get(None, []))
    return [seg for seg in out if seg[1] > seg[0]]


def idle_by_span(run) -> Optional[List[list]]:
    """Device idle seconds in the window by the name of the innermost
    main-thread span open at each idle instant (``OUTSIDE`` where none
    is), largest first."""
    if not run.get("spans") or not run.get("busy") or not run.get("window"):
        return None
    segs = segments(run)
    busy = _Cover(run["busy"], *run["window"])
    idle = busy.idle([s[0] for s in segs], [s[1] for s in segs])
    out: Dict[str, float] = {}
    for (_, _, span), ns in zip(segs, idle.tolist()):
        name = OUTSIDE if span is None else span["name"]
        out[name] = out.get(name, 0.0) + ns * 1e-9
    return sorted(([k, v] for k, v in out.items() if v > 0), key=lambda kv: -kv[1])


def idle_in_engine_pct(run) -> Optional[float]:
    """Percent of the ``engine.process`` spans' time the card was idle."""
    if not run.get("spans") or not run.get("busy") or not run.get("window"):
        return None
    eng = [s for s in run["spans"] if s["name"] == "engine.process"]
    if not eng:
        return None
    busy = _Cover(run["busy"], min(s["start"] for s in eng), max(s["end"] for s in eng))
    a = [s["start"] for s in eng]
    b = [s["end"] for s in eng]
    return 100.0 * float(busy.idle(a, b).sum()) / float(sum(y - x for x, y in zip(a, b)))


def issue_by_family(run, top: int = 10) -> Optional[List[list]]:
    """The ``dag.family`` first groups with the most host seconds over the
    window: [group, seconds, spans]."""
    fams = [s for s in run.get("spans") or () if s["name"] == "dag.family"]
    if not fams:
        return None
    by: Dict[str, List[float]] = {}
    for s in fams:
        rec = by.setdefault(s["attrs"]["group"], [0.0, 0])
        rec[0] += (s["end"] - s["start"]) * 1e-9
        rec[1] += 1
    ranked = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    return [[g, v[0], v[1]] for g, v in ranked]
