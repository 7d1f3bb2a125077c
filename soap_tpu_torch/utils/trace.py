"""Spans at the port's layer boundaries, kept in memory, on the clock of
torch.profiler's events.

    with trace.recording() as rec:
        build_catalogue(...)
    rec.records()   # [{index, name, start, end, parent, thread, attrs}, ...]

``span(name, **attrs)`` marks a block of host work as a context manager;
``start(name, t0, **attrs)`` opens a span that the caller ``stop``s,
where the code already stamps a block's start and end with
``time.perf_counter()``, so that one clock read serves both.  Only a
caller that enters ``recording()`` turns them on; otherwise both return
one shared no-op object after one check of a module global.  The
recorder is that one global, not an argument threaded through every
layer, so that the spans cost nothing where no one records.

Each span keeps its name, its start and end, the thread's native id (as
torch.profiler names threads) and its attrs; ``records()`` gives each the
innermost span of its thread whose interval holds it as its parent.
Spans are stamped with ``time.perf_counter_ns()``; ``records()`` gives
them on the Unix clock in ns, which is what torch.profiler's kineto
events read (``start_ns()``), through an offset sampled when recording
starts, so a span and a device event compare directly.  Under
``recording(ranges=True)``, which ``cli.py --profile`` enters inside its
profiler, a span also opens ``torch.profiler.record_function(name)``, so
the profiler's own trace shows the program's structure (a profiler of
CUDA activity alone records no event for such a range).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, List, Optional

from torch.profiler import record_function

#: the recorder while a ``recording()`` block is open, else None
_RECORDER: Optional["Recorder"] = None


class _NoSpan:
    """What ``span`` and ``start`` return while nothing records: one
    shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def stop(self, t1: Optional[float] = None) -> None:
        pass


NO_SPAN = _NoSpan()


def _unix_offset_ns() -> int:
    """Unix time minus ``perf_counter_ns``, from the tightest of a few
    paired reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


class Span:
    """One open or closed span of a recorder."""

    __slots__ = ("name", "attrs", "start", "end", "thread", "_range")

    def __init__(self, rec: "Recorder", name: str, attrs: dict, t0: Optional[float]):
        self.name, self.attrs, self.end = name, attrs, None
        self.thread = threading.get_native_id()
        self._range = None
        if rec.ranges:
            self._range = record_function(name)
            self._range.__enter__()
        self.start = time.perf_counter_ns() if t0 is None else round(t0 * 1e9)
        rec.spans.append(self)

    def stop(self, t1: Optional[float] = None) -> None:
        """Close the span now, or at the ``time.perf_counter()`` stamp ``t1``."""
        self.end = time.perf_counter_ns() if t1 is None else round(t1 * 1e9)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class Recorder:
    """The spans of one ``recording()`` block."""

    def __init__(self, ranges: bool):
        #: every span in the order opened (all threads)
        self.spans: List[Span] = []
        #: whether spans open profiler ranges
        self.ranges = ranges
        #: Unix ns minus ``perf_counter_ns`` at the block's start
        self.offset_ns = _unix_offset_ns()

    def records(self) -> List[dict]:
        """The closed spans as dicts: start and end in Unix ns, ``index``
        the span's place in ``spans``, ``parent`` the index of the
        innermost span of its thread whose interval holds it, or None."""
        closed = [(i, s) for i, s in enumerate(self.spans) if s.end is not None]
        parent = {}
        stacks = {}
        # a thread's spans nest: sorted by start, the widest first, each
        # one's parent is the last span on the stack that outlasts it
        for i, s in sorted(closed, key=lambda p: (p[1].thread, p[1].start, -p[1].end, p[0])):
            stack = stacks.setdefault(s.thread, [])
            while stack and self.spans[stack[-1]].end < s.end:
                stack.pop()
            parent[i] = stack[-1] if stack else None
            stack.append(i)
        return [dict(index=i, name=s.name, start=s.start + self.offset_ns,
                     end=s.end + self.offset_ns, thread=s.thread, parent=parent[i],
                     attrs=dict(s.attrs))
                for i, s in closed]


def span(name: str, **attrs):
    """A context manager marking one block of host work (a shared no-op
    while nothing records)."""
    rec = _RECORDER
    if rec is None:
        return NO_SPAN
    return Span(rec, name, attrs, None)


def start(name: str, t0: Optional[float] = None, **attrs):
    """Open a span at the ``time.perf_counter()`` stamp ``t0`` (or now);
    the caller closes it with ``stop`` (a shared no-op while nothing
    records)."""
    rec = _RECORDER
    if rec is None:
        return NO_SPAN
    return Span(rec, name, attrs, t0)


@contextlib.contextmanager
def recording(ranges: bool = False) -> Iterator[Recorder]:
    """Record every span of the process in this block; with ``ranges``,
    each span is a ``record_function`` range of the profiler that is on."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("a recording is already open")
    rec = Recorder(ranges)
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None
