"""The span metrics' readers and ``spans.py``'s breakdown on hand-made
runs: nothing from a run without spans, the sums per pass (less each
thread's own waits), the card's idle inside the engine's spans, and idle
time put down to the innermost span open over it."""

import pytest

from halobench import harness, spans
from halobench.tests.conftest import ROOT

READERS = ["engine.plan_s", "engine.issue_s", "engine.drain_s", "engine.resolve_s",
           "device.idle_in_engine_pct"]
MAIN = 7


def span(index, name, start, end, parent=None, thread=MAIN, **attrs):
    return dict(index=index, name=name, start=start, end=end, parent=parent, thread=thread,
                attrs=attrs)


def two_passes():
    """Two passes of 100 ns each: entry.prep, engine.process (a plan and
    a bucket with its issue, drain and resolve), entry.post; a worker
    thread's issue span beside the second bucket; the host waits for the
    device 2 ns in the first pass's second family and 3 ns in its drain,
    and the worker 3 ns in its issue."""
    out = []
    for p, t in ((0, 0), (1, 100)):
        i = len(out)
        out += [
            span(i, "entry.prep", t, t + 10),
            span(i + 1, "engine.process", t + 10, t + 80),
            span(i + 2, "engine.plan", t + 10, t + 20, i + 1),
            span(i + 3, "engine.bucket", t + 20, t + 78, i + 1, halos=4),
            span(i + 4, "engine.issue", t + 20, t + 40, i + 3),
            span(i + 5, "dag.family", t + 22, t + 32, i + 4, group="SO/200_crit", lanes=3),
            span(i + 6, "dag.family", t + 32, t + 38, i + 4, group="BoundSubhalo", lanes=1),
            span(i + 7, "engine.to_host", t + 40, t + 70, i + 3),
            span(i + 8, "engine.resolve", t + 70, t + 78, i + 3),
            span(i + 9, "entry.post", t + 80, t + 95),
        ]
    out.append(span(len(out), "engine.issue", 120, 130, thread=MAIN + 1))
    return dict(passes=[{}, {}], spans=out, main_thread=MAIN, window=[0, 200],
                waits=[[34, 36, MAIN], [41, 44, MAIN], [122, 125, MAIN + 1]])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_a_run_without_spans(name):
    read = harness.load_metric(name, ROOT)
    empty = dict(halos=0, window_s=0.0, setup_s=None, peak_bytes=0, passes=[], device=None,
                 work=None)
    assert read(empty) is None
    assert read(dict(empty, passes=[{}], spans=[])) is None


def test_span_sums_per_pass():
    run = two_passes()
    got = {n: harness.load_metric(n, ROOT)(run) for n in READERS[:4]}
    # ns to s, per pass; the worker thread's issue counts too, the
    # waits inside each issue not
    assert got == pytest.approx({"engine.plan_s": 10e-9, "engine.issue_s": 22.5e-9,
                                 "engine.drain_s": 30e-9, "engine.resolve_s": 8e-9})
    assert spans.issue_by_family(run) == [["SO/200_crit", pytest.approx(20e-9), 2],
                                          ["BoundSubhalo", pytest.approx(12e-9), 2]]


@pytest.mark.parametrize("thread,issue_s", [(MAIN, 46 / 2 * 1e-9), (MAIN + 1, 50 / 2 * 1e-9)])
def test_issue_less_only_its_own_threads_waits(thread, issue_s):
    # a wait of 4 ns inside the first main-thread issue (20-40): taken
    # from it when the main thread made it, not when the worker did
    run = dict(two_passes(), waits=[[24, 28, thread]])
    assert harness.load_metric("engine.issue_s", ROOT)(run) == pytest.approx(issue_s)


def test_idle_in_engine_on_known_intervals():
    run = two_passes()
    # busy 30-60 of the first engine span (10-80), and 90-190 of the
    # window: 40 of 70 idle, then 0 of 70
    run["busy"] = [[30, 60], [90, 190]]
    read = harness.load_metric("device.idle_in_engine_pct", ROOT)
    assert read(run) == pytest.approx(100.0 * 40 / 140)


def test_idle_put_down_to_the_innermost_span():
    run = two_passes()
    # idle 85-105: half in the first pass's entry.post (80-95, from 85),
    # half after it (95-105: outside any span to 100, then entry.prep);
    # and 45-50 in engine.to_host
    run["busy"] = [[0, 45], [50, 85], [105, 200]]
    got = dict(spans.idle_by_span(run))
    assert got == pytest.approx({"entry.post": 10e-9, spans.OUTSIDE: 5e-9,
                                 "entry.prep": 5e-9, "engine.to_host": 5e-9})
    # the window's whole idle time is accounted for
    assert sum(got.values()) == pytest.approx(25e-9)
